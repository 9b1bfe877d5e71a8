"""The mean of the engine's passes (build_state, apply_state and the wait
for its drain workers) in the window."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine_pass")
