"""Canary workload: a transformer LM train step on one device.

Counterpart of ``k8s_operator_libs_tpu.workloads.canary`` for one GPU:
the same decoder-only transformer, loss, Adam and step timestamps, as
torch ops.  Parameters are a nested dict with the JAX pytree's keys and
its stacked ``[L, ...]`` layer axis, so weights cross between the two
packages leaf by leaf through numpy (:func:`params_from_numpy`,
:func:`params_to_numpy`).

Numerics follow the JAX package's contract: every matmul takes bf16
operands and accumulates in fp32.  :func:`_matmul` writes that as an
fp32 product of bf16-rounded operands, and the train step lets CUDA run
fp32 products in TF32, where bf16 values are exact.  Autograd through
the two casts rounds each operand's gradient to bf16, as JAX's transpose
of ``astype(bfloat16)`` does.  ``jax.nn.gelu`` is the tanh form, masked
scores are -1e30, the attention probabilities are cast to bf16 after
normalising, and ``log_softmax`` is taken in fp32.

``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), the counterpart of ``jax.checkpoint`` on the
scanned layer.  :class:`CanaryRunner` timestamps every step: its gap
analysis is the workload-downtime metric.

The multi-GPU parts of the JAX module (``make_mesh``, ``param_specs``,
``make_sharded_train_step``, ``ElasticCanaryRunner``) are not ported yet.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from k8s_operator_libs_tpu_torch.health.probes import cuda_devices, device_kind
from k8s_operator_libs_tpu_torch.hw import mfu

MASKED = -1e30
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class CanaryConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 128
    batch: int = 8
    learning_rate: float = 1e-3
    # Recompute each layer in the backward pass: only the per-layer
    # input survives the forward pass instead of every layer's
    # attention temporaries (L·B·H·S·S floats).
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# -- parameter trees ------------------------------------------------------


def _tree_map(fn: Callable, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def param_shapes(cfg: CanaryConfig) -> dict:
    """The parameter tree's shapes: the JAX pytree's keys, with per-layer
    tensors stacked on a leading layer axis."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    return {
        "embed": (V, D),
        "layers": {
            "qkv": (L, D, 3 * D),
            "proj": (L, D, D),
            "mlp_in": (L, D, cfg.d_ff),
            "mlp_out": (L, cfg.d_ff, D),
            "ln1": (L, D),
            "ln2": (L, D),
        },
        "ln_f": (D,),
        "out": (D, V),
    }


def init_params(generator: torch.Generator, cfg: CanaryConfig) -> dict:
    """Parameter tree on the generator's device: weights normal, scaled
    by ``d_model**-0.5``; the norms' gains ones."""
    scale = cfg.d_model**-0.5
    dev = generator.device
    shapes = param_shapes(cfg)

    def norm(shape):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def ones(shape):
        return torch.ones(shape, device=dev)

    return {
        "embed": norm(shapes["embed"]),
        "layers": {
            k: (ones if k.startswith("ln") else norm)(shape)
            for k, shape in shapes["layers"].items()
        },
        "ln_f": ones(shapes["ln_f"]),
        "out": norm(shapes["out"]),
    }


def params_from_numpy(tree: dict, device) -> dict:
    """The port's parameters from a tree of numpy arrays (the JAX pytree
    converted leaf by leaf), as fp32 on ``device``."""
    return _tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device),
        tree,
    )


def params_to_numpy(params: dict) -> dict:
    """The parameter tree as numpy arrays on the host."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)


# -- the model -------------------------------------------------------------


def _rms_norm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * gain


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 accumulation: the MXU contract of the JAX
    package, as an fp32 product of bf16-rounded operands."""
    return torch.matmul(_bf16(a), _bf16(b))


def _layer(h: torch.Tensor, lp: dict, causal: torch.Tensor,
           cfg: CanaryConfig) -> torch.Tensor:
    B, S, _ = h.shape
    x = _rms_norm(h, lp["ln1"])
    qkv = _matmul(x, lp["qkv"])  # [B, S, 3D]
    q, k, v = torch.split(qkv, cfg.d_model, dim=-1)

    def heads(t):
        return t.reshape(B, S, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = _matmul(q, k.transpose(-1, -2)) * (cfg.head_dim**-0.5)
    scores = torch.where(causal, scores, MASKED)
    attn = torch.softmax(scores, dim=-1)
    ctx = _matmul(attn, v)  # [B, H, S, hd]
    ctx = ctx.transpose(1, 2).reshape(B, S, cfg.d_model)
    h = h + _matmul(ctx, lp["proj"])
    x = _rms_norm(h, lp["ln2"])
    mlp = F.gelu(_matmul(x, lp["mlp_in"]), approximate="tanh")
    return h + _matmul(mlp, lp["mlp_out"])


def forward(params: dict, tokens: torch.Tensor,
            cfg: CanaryConfig) -> torch.Tensor:
    """Logits [B, S, V] for integer tokens [B, S]."""
    S = tokens.shape[1]
    h = params["embed"][tokens.long()]  # [B, S, D] gather
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        if cfg.remat:
            h = checkpoint(_layer, h, lp, causal, cfg, use_reentrant=False)
        else:
            h = _layer(h, lp, causal, cfg)
    h = _rms_norm(h, params["ln_f"])
    return _matmul(h, params["out"])


def loss_fn(params: dict, batch: torch.Tensor,
            cfg: CanaryConfig) -> torch.Tensor:
    """Next-token cross entropy (batch carries S+1 tokens)."""
    tokens, targets = batch[:, :-1], batch[:, 1:]
    logits = forward(params, tokens, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])
    return -torch.mean(ll)


# -- the optimizer and the step --------------------------------------------


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


@dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, with the same moments, bias correction and update in the
    same order of fp32 operations."""

    learning_rate: float

    def init(self, params: dict) -> AdamState:
        return AdamState(
            0,
            _tree_map(torch.zeros_like, params),
            _tree_map(torch.zeros_like, params),
        )

    def update(self, grads: dict, state: AdamState):
        count = state.count + 1
        mu = _tree_map(
            lambda g, t: (1 - ADAM_B1) * g + ADAM_B1 * t, grads, state.mu
        )
        nu = _tree_map(
            lambda g, t: (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * t,
            grads, state.nu,
        )
        # The corrections are fp32 scalars, as optax takes them.
        c1 = float(1 - np.float32(ADAM_B1) ** np.float32(count))
        c2 = float(1 - np.float32(ADAM_B2) ** np.float32(count))
        updates = _tree_map(
            lambda m, v: (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
            * -self.learning_rate,
            mu,
            nu,
        )
        return updates, AdamState(count, mu, nu)


def apply_updates(params: dict, updates: dict) -> dict:
    return _tree_map(lambda p, u: p + u, params, updates)


@contextlib.contextmanager
def _tf32_matmul():
    """Let CUDA run fp32 products in TF32: exact for the bf16-rounded
    operands of :func:`_matmul`; restores the previous setting."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = prev


def make_train_step(cfg: CanaryConfig):
    """``(step, opt)``: ``step(params, opt_state, batch)`` returns
    ``(params, opt_state, loss)`` and leaves its arguments unchanged."""
    opt = Adam(cfg.learning_rate)

    def step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        with _tf32_matmul():
            loss = loss_fn(_unflatten(params, leaves), batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            grads = _unflatten(params, list(grads))
            updates, opt_state = opt.update(grads, opt_state)
            params = apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return step, opt


# -- the runner ------------------------------------------------------------


class CanaryRunner:
    """Run train steps and timestamp them; the gap analysis IS the
    workload-downtime metric.  ``device=None`` means the first CUDA
    device."""

    def __init__(self, cfg: CanaryConfig, device=None, seed: int = 0) -> None:
        self.cfg = cfg
        self.device = (
            torch.device(device) if device is not None else cuda_devices()[0]
        )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = init_params(gen, cfg)
        self._step, self.opt = make_train_step(cfg)
        self.opt_state = self.opt.init(self.params)
        self.step_times: list[float] = []
        self.losses: list[float] = []
        self.window_start = time.monotonic()
        self._batch_rng = np.random.default_rng(seed)

    def _make_batch(self) -> torch.Tensor:
        batch = self._batch_rng.integers(
            0, self.cfg.vocab, (self.cfg.batch, self.cfg.seq_len + 1),
            dtype=np.int32,
        )
        return torch.from_numpy(batch).to(self.device)

    def run_step(self) -> float:
        batch = self._make_batch()
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, batch
        )
        loss = float(loss)
        self.step_times.append(time.monotonic())
        self.losses.append(loss)
        return loss

    def reset_timing(self) -> None:
        """Start a fresh measurement window (call after warm-up steps so
        set-up time doesn't count as an interruption)."""
        self.step_times = []
        self.losses = []
        self.window_start = time.monotonic()

    def max_gap_seconds(self, until: Optional[float] = None) -> float:
        """Longest interruption between consecutive completed steps.

        ``until`` (a ``time.monotonic()`` timestamp) closes the window: if
        the workload is still disrupted when measurement ends, the OPEN
        interval since the last completed step counts as a gap.  With no
        completed steps at all, the whole window is the gap."""
        times = np.asarray(self.step_times)
        if times.size == 0:
            return float(max(0.0, until - self.window_start)) if until else 0.0
        gaps = np.diff(times) if times.size > 1 else np.asarray([0.0])
        closed = float(gaps.max()) if gaps.size else 0.0
        if until is not None:
            return max(closed, float(until - times[-1]))
        return closed

    # -- throughput / MFU ---------------------------------------------------

    def param_count(self) -> int:
        return int(sum(p.numel() for p in _leaves(self.params)))

    def flops_per_step(self) -> float:
        """Training FLOPs per step: the standard 6·N·tokens matmul term
        plus the 12·L·B·S²·D attention term (fwd+bwd, PaLM-appendix
        convention — the MFU denominator every report uses)."""
        cfg = self.cfg
        tokens = cfg.batch * cfg.seq_len
        matmul = 6.0 * self.param_count() * tokens
        attention = 12.0 * cfg.n_layers * cfg.batch * cfg.seq_len**2 * cfg.d_model
        return matmul + attention

    def perf_summary(self) -> dict:
        """tokens/s, achieved TFLOPS and MFU from the recorded steps, by
        the *median* inter-step time (upgrade pauses don't depress it)."""
        if len(self.step_times) < 2:
            return {"steps": len(self.step_times)}
        dt = float(np.median(np.diff(np.asarray(self.step_times))))
        if dt <= 0:
            return {"steps": len(self.step_times)}
        out = {
            "steps": len(self.step_times),
            "median_step_s": dt,
            "params": self.param_count(),
        }
        out.update(self._throughput_from_step_time(dt))
        return out

    def _throughput_from_step_time(self, dt: float) -> dict:
        """tokens/s, achieved TFLOPS, device kind and (when the card's
        spec is known) MFU for one per-step time."""
        kind = device_kind(self.device)
        achieved_tflops = self.flops_per_step() / dt / 1e12
        out = {
            "tokens_per_s": self.cfg.batch * self.cfg.seq_len / dt,
            "achieved_tflops": achieved_tflops,
            "device": kind,
        }
        mfu_frac = mfu(achieved_tflops, kind)
        if mfu_frac is not None:
            out["mfu"] = mfu_frac
        return out

    def sustained_perf_summary(self) -> dict:
        """Device-sustained step throughput via the health battery's slope
        estimator: steps are enqueued back to back and the k-vs-4k slope
        cancels the fixed dispatch and readback cost.  Trains further but
        records no step timestamps, so the downtime metric is untouched."""
        from k8s_operator_libs_tpu_torch.health.probes import (
            InconclusiveTiming,
            _timed_sustained,
        )

        batch = self._make_batch()

        def one(b):
            self.params, self.opt_state, loss = self._step(
                self.params, self.opt_state, b
            )
            return loss

        try:
            lat_ms, _out, iters = _timed_sustained(one, (batch,))
        except InconclusiveTiming as e:
            return {"timing_inconclusive": 1.0, "iters": float(e.applied)}
        dt = lat_ms / 1e3
        if dt <= 0:
            return {"timing_inconclusive": 1.0, "iters": float(iters)}
        out = {"device_step_s": dt, "iters": float(iters)}
        out.update(self._throughput_from_step_time(dt))
        return out
