"""The mean of the deep probe (ici_ring_attention_probe) inside the
battery."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "deep_probe")
