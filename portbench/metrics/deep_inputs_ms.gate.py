"""The mean of the program's ``deep.inputs`` span: the deep probe's host
RNG and its shards' copies to the members."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "deep.inputs")
