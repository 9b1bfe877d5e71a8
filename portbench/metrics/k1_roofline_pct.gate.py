"""K1's bytes in the window (the program's ``k1.bytes`` counter, a
battery's share of it times the window's batteries) over 3.35 TB/s, over
the device seconds of the ``stream_increment`` kernels in the trace."""

from harness.layer_readers import k1_roofline_pct


def read(run):
    return k1_roofline_pct(run)
