"""The median time of a training step in the window while the job runs."""

from harness.readers import median_step_s


def read(run):
    dt = median_step_s(run)
    return None if dt is None else dt * 1e3
