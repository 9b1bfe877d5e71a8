"""The mean of the program's ``canary.enqueue`` span: the host's time to
launch a training step, without its wait for the loss."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "canary.enqueue")
