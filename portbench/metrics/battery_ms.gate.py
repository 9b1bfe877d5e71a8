"""The mean of the agent's probe (run_host_probe and the report), which
ends when every member's rows are on the host."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "battery")
