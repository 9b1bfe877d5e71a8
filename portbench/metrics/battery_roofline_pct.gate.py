"""The least time the window's batteries need (bytes over 3.35 TB/s or
bf16 flops over 989 TFLOP/s, the larger) over the device time inside the
battery spans."""

from harness.readers import battery_roofline_pct


def read(run):
    return battery_roofline_pct(run)
