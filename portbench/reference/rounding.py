"""Operand rounding: what "bf16 operands, fp32 accumulation" means, and
its fp8 control.

``round_to(x, "bf16")`` rounds to bfloat16 and back, forward and (for
autograd) backward, as a cast pair does.  ``"fp8"`` rounds to e4m3: in
training (``scaled=True``) each tensor is scaled so that its largest
magnitude maps to e4m3's largest, the way fp8 training computes; as a
plain cast (``scaled=False``) small values underflow.  ``"fp32"`` leaves
the value alone.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round(x: torch.Tensor, precision: str, scaled: bool) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "fp8":
        if not scaled:
            return x.to(torch.float8_e4m3fn).to(x.dtype)
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision, scaled):
        ctx.precision, ctx.scaled = precision, scaled
        return _round(x, precision, scaled)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision, ctx.scaled), None, None


def round_to(x: torch.Tensor, precision: str,
             scaled: bool = True) -> torch.Tensor:
    """``x`` rounded to ``precision``; its gradient rounded alike."""
    if x.requires_grad:
        return _Round.apply(x, precision, scaled)
    return _round(x, precision, scaled)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """A product of operands rounded to ``precision``, accumulated in
    fp32."""
    return torch.matmul(round_to(a, precision), round_to(b, precision))


class exact_fp32:
    """fp32 products computed as fp32: no TF32, no reduced-precision
    reductions, restored on exit."""

    def __enter__(self):
        m = torch.backends.cuda.matmul
        self._prev = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
                      m.allow_bf16_reduced_precision_reduction)
        m.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m.allow_bf16_reduced_precision_reduction = False
        return self

    def __exit__(self, *exc):
        m = torch.backends.cuda.matmul
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = self._prev
