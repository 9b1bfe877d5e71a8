"""The mean of the roll's agents' probes, in flight and in the
background."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "battery")
