"""The mean of NodeReportProber.probe over the window's verdicts."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "verdict")
