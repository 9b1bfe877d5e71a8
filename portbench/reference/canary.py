"""The training job's model and optimizer, written plainly: a decoder-only
transformer language model trained by Adam on next-token cross entropy.

The architecture as the configuration states it (``canary`` of
``gpu-operator-pool4.json``): an embedding; per layer an RMS norm (gain,
eps 1e-6), a fused q|k|v product (q, k and v each ``d_model`` columns,
heads of ``d_model / n_heads`` in order), causal attention scaled by
``head_dim ** -0.5`` with masked scores at -1e30 and softmax in fp32, an
output projection, a residual, a second RMS norm and a tanh-GELU MLP
with a residual; a final RMS norm and an output product; the loss the
mean of ``-log_softmax`` (fp32) of each next token.  Every product takes
operands rounded to the stated precision (bf16) and accumulates in fp32;
gradients of the rounded operands are rounded alike.  Adam: b1 0.9, b2
0.999, eps 1e-8 outside the square root, bias corrections in fp32.

Parameters are a dict of leaves with the per-layer ones stacked on a
leading layer axis: ``embed [V, D]``, ``qkv [L, D, 3D]``, ``proj [L, D,
D]``, ``mlp_in [L, D, F]``, ``mlp_out [L, F, D]``, ``ln1 [L, D]``, ``ln2
[L, D]``, ``ln_f [D]``, ``out [D, V]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.rounding import exact_fp32, mm

MASKED = -1e30
B1, B2, EPS = 0.9, 0.999, 1e-8
LEAVES = ("embed", "qkv", "proj", "mlp_in", "mlp_out", "ln1", "ln2", "ln_f",
          "out")


def _rms(x, gain):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) * gain


def loss(params: dict, batch: torch.Tensor, cfg: dict,
         precision: str) -> torch.Tensor:
    tokens, targets = batch[:, :-1].long(), batch[:, 1:].long()
    B, S = tokens.shape
    H = cfg["n_heads"]
    D = cfg["d_model"]
    hd = D // H
    h = params["embed"][tokens]
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    for i in range(cfg["n_layers"]):
        x = _rms(h, params["ln1"][i])
        q, k, v = mm(x, params["qkv"][i], precision).split(D, dim=-1)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        s = mm(q, k.transpose(-1, -2), precision) * hd ** -0.5
        p = torch.softmax(torch.where(causal, s, MASKED), dim=-1)
        ctx = mm(p, v, precision).transpose(1, 2).reshape(B, S, D)
        h = h + mm(ctx, params["proj"][i], precision)
        x = _rms(h, params["ln2"][i])
        u = F.gelu(mm(x, params["mlp_in"][i], precision), approximate="tanh")
        h = h + mm(u, params["mlp_out"][i], precision)
    logits = mm(_rms(h, params["ln_f"]), params["out"], precision)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def train(params: dict, batches: list, cfg: dict, precision: str = "bf16"
          ) -> dict:
    """Adam over ``batches`` from ``params`` (left unchanged).  Returns
    each step's loss, each leaf's gradient norm at the first step, and
    each leaf's change after the last step, as norms."""
    lr = cfg["learning_rate"]
    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], {}
    with exact_fp32():
        for t, batch in enumerate(batches, start=1):
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            value = loss(leaves, batch, cfg, precision)
            grads = torch.autograd.grad(value, [leaves[k] for k in LEAVES])
            losses.append(float(value.detach()))
            with torch.no_grad():
                if t == 1:
                    first_grad = {k: float(g.norm())
                                  for k, g in zip(LEAVES, grads)}
                c1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** t)
                c2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** t)
                new = {}
                for k, g in zip(LEAVES, grads):
                    mu[k] = (1 - B1) * g + B1 * mu[k]
                    nu[k] = (1 - B2) * g * g + B2 * nu[k]
                    new[k] = p[k].detach() - lr * (mu[k] / c1) / (
                        torch.sqrt(nu[k] / c2) + EPS)
                p = new
            del value, grads, leaves
    change = {k: float((p[k] - params[k]).norm()) for k in LEAVES}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def worst_leaf_gap(got: dict, want: dict, excluded=()) -> float:
    """The widest gap between two per-leaf norms, each as a share of the
    reference leaf's norm or the median leaf's, whichever is larger."""
    kept = [k for k in want if k not in excluded]
    med = sorted(want[k] for k in kept)[len(kept) // 2] if kept else 0.0
    worst = 0.0
    for k in kept:
        d = abs(got.get(k, math.nan) - want[k]) / max(want[k], med, 1e-30)
        worst = max(worst, d if d == d else math.inf)
    return worst


def quiet_leaves(first_grad: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is nought to rounding: under
    ``share`` of the median leaf's."""
    norms = sorted(first_grad.values())
    med = norms[len(norms) // 2]
    return [k for k, v in first_grad.items() if v < share * med]
