"""The mean of the program's ``battery.fused`` span less its
``fused.readback``: the fused battery's host time but for its wait on
the card."""

from harness.layer_readers import battery_host_ms


def read(run):
    return battery_host_ms(run)
