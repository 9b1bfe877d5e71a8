"""The mean of HealthAgent.publish (the report's JSON and the patch)."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "publish")
