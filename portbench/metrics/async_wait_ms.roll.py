"""The mean of the program's ``engine.async_wait`` span: an engine
pass's wait for its drain and eviction workers."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.async_wait")
