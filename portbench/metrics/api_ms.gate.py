"""Milliseconds of the program's API calls (``k8s.*`` spans, each with
the stand-in server's configured latency) in the window over the
window's gates."""

from harness.layer_readers import api_ms_per_gate


def read(run):
    return api_ms_per_gate(run)
