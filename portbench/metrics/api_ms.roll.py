"""Milliseconds of the program's API calls (``k8s.*`` spans) made in the
engine's passes, per pass in the window."""

from harness.layer_readers import api_ms_per_pass


def read(run):
    return api_ms_per_pass(run)
