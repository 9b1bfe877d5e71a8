"""The step's flops (6·N·tokens + 12·L·B·S²·D) over the median step time
and the peak of the type the step computes its products in (read at a
step: fp32 67, TF32 495, bf16 989 TFLOP/s)."""

from harness.readers import canary_mfu_pct


def read(run):
    return canary_mfu_pct(run)
