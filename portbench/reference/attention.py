"""Causal scaled dot-product attention over a whole sequence: the deep
probe's answer.

``[B, S, H, D]`` fp32 inputs; scores ``q·k / sqrt(D)`` of operands
rounded to ``precision`` and accumulated in fp32; the causal softmax in
fp32; the probabilities rounded to ``precision`` before ``p·v``, which
accumulates in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.rounding import exact_fp32, round_to


def causal_attention(q, k, v, precision: str = "bf16") -> torch.Tensor:
    with exact_fp32():
        qh, kh, vh = (round_to(t.permute(0, 2, 1, 3), precision)
                      for t in (q, k, v))
        s = torch.matmul(qh, kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
        n = q.shape[1]
        mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(round_to(p, precision), vh)
    return out.permute(0, 2, 1, 3)


def probe_inputs(seq: int, batch: int, heads: int, head_dim: int,
                 seed: int = 0) -> list[torch.Tensor]:
    """The deep probe's q, k and v: standard normal draws of a NumPy
    generator seeded as the probe's specification gives it."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq, heads, head_dim)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(3)]
