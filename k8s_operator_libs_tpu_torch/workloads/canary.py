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

Over several members (:func:`make_mesh`, :func:`param_specs`,
:func:`make_sharded_train_step`, ``CanaryRunner(mesh=...)``,
:class:`ElasticCanaryRunner`) one process drives a ``("dp", "tp")`` grid
of devices, which may repeat one card: the collectives XLA inserts from
the JAX package's shardings are written out as list-level autograd
functions over ``kernels.collectives`` (kernels K4 and K5).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from k8s_operator_libs_tpu_torch.health.probes import cuda_devices, device_kind
from k8s_operator_libs_tpu_torch.hw import mfu
from k8s_operator_libs_tpu_torch.kernels.collectives import (
    all_reduce,
    copy_to_members,
    gather_from_members,
    reduce_from_members,
)

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


def _attend(qkv: torch.Tensor, n_heads: int, head_dim: int,
            causal: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``n_heads`` heads from a fused ``[B, S, 3 *
    n_heads * head_dim]`` q|k|v product; the context as ``[B, S, n_heads
    * head_dim]``."""
    B, S, _ = qkv.shape
    q, k, v = torch.split(qkv, n_heads * head_dim, dim=-1)

    def heads(t):
        return t.reshape(B, S, n_heads, head_dim).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = _matmul(q, k.transpose(-1, -2)) * (head_dim**-0.5)
    scores = torch.where(causal, scores, MASKED)
    attn = torch.softmax(scores, dim=-1)
    ctx = _matmul(attn, v)  # [B, H, S, hd]
    return ctx.transpose(1, 2).reshape(B, S, n_heads * head_dim)


def _layer(h: torch.Tensor, lp: dict, causal: torch.Tensor,
           cfg: CanaryConfig) -> torch.Tensor:
    x = _rms_norm(h, lp["ln1"])
    ctx = _attend(_matmul(x, lp["qkv"]), cfg.n_heads, cfg.head_dim, causal)
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


# -- the sharded step -------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A ``("dp", "tp")`` grid of devices: ``devices[i][j]`` holds the
    tp-shard ``j`` of the dp-replica ``i``.  A device may repeat
    (``[cuda:0] * 8`` is a dp 2 × tp 4 mesh of one card)."""

    devices: tuple

    axis_names = ("dp", "tp")

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def flat(self) -> list:
        """The members, dp-major: member ``i * tp + j`` is (i, j)."""
        return [d for row in self.devices for d in row]


def make_mesh(devices=None, tp: int = 0) -> Mesh:
    """A ``("dp", "tp")`` mesh over the given devices (default: every CUDA
    device).  ``tp=0`` picks the largest power of two ≤ min(4, n/2) that
    divides n, as the JAX package does."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else cuda_devices())
    n = len(devs)
    if tp <= 0:
        tp = 1
        while tp * 2 <= min(n // 2, 4) and n % (tp * 2) == 0:
            tp *= 2
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return Mesh(tuple(tuple(devs[i * tp:(i + 1) * tp])
                      for i in range(n // tp)))


def param_specs(cfg: CanaryConfig) -> dict:
    """The JAX package's Megatron-style split of each leaf, as a tuple of
    axis names (``None`` where an axis is not split): qkv and mlp_in
    column-parallel, proj and mlp_out row-parallel, the embedding split on
    d_model and the output on the vocab, the norms replicated.

    One placement differs from the JAX spec: the fused qkv leaf is split
    on its last axis by heads, member j holding the columns of heads
    ``[j·H/tp, (j+1)·H/tp)`` of q, of k and of v (XLA splits the 3D axis
    into contiguous pieces and reshards behind the annotation)."""
    return {
        "embed": (None, "tp"),
        "layers": {
            "qkv": (None, None, "tp"),
            "proj": (None, "tp", None),
            "mlp_in": (None, None, "tp"),
            "mlp_out": (None, "tp", None),
            "ln1": (None, None),
            "ln2": (None, None),
        },
        "ln_f": (None,),
        "out": (None, "tp"),
    }


def _shard_leaf(full: torch.Tensor, spec: tuple, j: int, tp: int,
                heads3: bool) -> torch.Tensor:
    """Member j's piece of a full leaf (a view where possible)."""
    if "tp" not in spec:
        return full
    ax = spec.index("tp")
    if heads3:  # [L, D, 3D]: by heads within each of q, k and v
        L, D, D3 = full.shape
        w = D3 // 3 // tp
        return full.reshape(L, D, 3, D3 // 3).narrow(3, j * w, w).reshape(
            L, D, 3 * w
        )
    w = full.shape[ax] // tp
    return full.narrow(ax, j * w, w)


def _unshard_leaf(pieces: list, spec: tuple, heads3: bool) -> np.ndarray:
    """The full leaf from its tp pieces (numpy)."""
    if "tp" not in spec:
        return pieces[0]
    if heads3:
        L, D, w3 = pieces[0].shape
        parts = [p.reshape(L, D, 3, w3 // 3) for p in pieces]
        return np.concatenate(parts, axis=3).reshape(L, D, 3 * len(pieces)
                                                     * (w3 // 3))
    return np.concatenate(pieces, axis=spec.index("tp"))


def _with_heads3(specs: dict) -> dict:
    """The spec tree with each leaf as ``(spec, split q|k|v by heads)``."""
    out = _tree_map(lambda sp: (sp, False), specs)
    out["layers"]["qkv"] = (specs["layers"]["qkv"], True)
    return out


def _spec_map(fn: Callable, specs: dict, *trees):
    """``fn(spec_and_heads3, *leaves)`` over the parameter tree."""
    if isinstance(specs, dict):
        return {k: _spec_map(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    return fn(specs, *trees)


def _column_inputs(xs: list) -> list:
    """The replicated input of a column-parallel product, rounded to
    bf16 before it reaches the members: backward, the members' fp32
    partial gradients are all-reduced first and the sum is rounded to
    bf16 once, as the one-device step rounds its whole gradient."""
    return copy_to_members([_bf16(x) for x in xs])


def _column_matmul(x16: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`_matmul` of an operand already rounded to bf16."""
    return torch.matmul(x16, _bf16(w))


def _tp_layer(hs: list, lps: list, causals: list, cfg: CanaryConfig,
              tp: int) -> list:
    """One layer over the tp members of one dp replica: each member's
    heads and d_ff columns, the partial sums all-reduced."""
    heads = cfg.n_heads // tp
    xs = _column_inputs([_rms_norm(h, lp["ln1"]) for h, lp in zip(hs, lps)])
    parts = [
        _matmul(_attend(_column_matmul(x, lp["qkv"]), heads, cfg.head_dim,
                        c), lp["proj"])
        for x, lp, c in zip(xs, lps, causals)
    ]
    hs = [h + r for h, r in zip(hs, reduce_from_members(parts))]
    xs = _column_inputs([_rms_norm(h, lp["ln2"]) for h, lp in zip(hs, lps)])
    parts = [
        _matmul(F.gelu(_column_matmul(x, lp["mlp_in"]), approximate="tanh"),
                lp["mlp_out"])
        for x, lp in zip(xs, lps)
    ]
    return [h + r for h, r in zip(hs, reduce_from_members(parts))]


def _tp_losses(trees: list, batches: list, cfg: CanaryConfig,
               tp: int) -> list:
    """Each tp member's copy of its dp replica's loss (the same value on
    every member: the logits are gathered whole)."""
    tokens = [b[:, :-1].long() for b in batches]
    S = tokens[0].shape[1]
    masks: dict = {}
    causals = [
        masks.setdefault(
            t.device,
            torch.ones((S, S), dtype=torch.bool, device=t.device).tril(),
        )
        for t in tokens
    ]
    hs = gather_from_members(
        [t["embed"][tok] for t, tok in zip(trees, tokens)], -1
    )
    for i in range(cfg.n_layers):
        lps = [{k: v[i] for k, v in t["layers"].items()} for t in trees]
        if cfg.remat:
            hs = checkpoint(_tp_layer, hs, lps, causals, cfg, tp,
                            use_reentrant=False, preserve_rng_state=False)
        else:
            hs = _tp_layer(hs, lps, causals, cfg, tp)
    hs = _column_inputs([_rms_norm(h, t["ln_f"]) for h, t in zip(hs, trees)])
    logits = gather_from_members(
        [_column_matmul(h, t["out"]) for h, t in zip(hs, trees)], -1
    )
    losses = []
    for lg, b in zip(logits, batches):
        logp = torch.log_softmax(lg.float(), dim=-1)
        ll = torch.gather(logp, -1, b[:, 1:].long()[..., None])
        losses.append(-torch.mean(ll))
    return losses


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().float()
    return torch.tensor(np.asarray(a), dtype=torch.float32)


class ShardedStep(NamedTuple):
    """The sharded train step and its placement helpers, in the order of
    the JAX package's five (step, opt, shard_params, shard_batch,
    shard_opt_state), then the gather back to numpy.

    ``step(params, opt_state, batch)`` returns ``(params, opt_state,
    loss)`` and leaves its arguments unchanged; ``params`` is a list of
    parameter trees and ``opt_state`` a list of :class:`AdamState`, one
    per member (dp-major), ``batch`` a list of token tensors, one per
    member; the loss is the mean over dp replicas of their batch means.
    ``shard_params`` and ``shard_opt_state`` place full trees (numpy
    arrays or tensors) on the members; ``unshard`` gathers a list of
    member trees, or of member optimizer states, back into full numpy
    leaves."""

    step: Callable
    opt: Adam
    shard_params: Callable
    shard_batch: Callable
    shard_opt_state: Callable
    unshard: Callable


def make_sharded_train_step(mesh: Mesh, cfg: CanaryConfig) -> ShardedStep:
    """The train step of JAX's ``make_sharded_train_step``, with its
    collectives written out: one process drives every member, member
    (i, j) holding tp-shard j of dp-replica i on ``mesh.devices[i][j]``.

    - the embedding (split on d_model) and the logits (split on the
      vocab) are all-gathered across the tp group, each member taking its
      slice of the gradient back;
    - the inputs of the column-parallel products (qkv, mlp_in, out) pass
      through unchanged and have their gradients all-reduced across the
      tp group; the outputs of the row-parallel products (proj, mlp_out)
      are all-reduced, their gradients passed through;
    - each tp member computes its dp replica's loss (the mean over its
      local batch) from the whole logits; every member backpropagates its
      own copy, which gives each the gradients of one loss;
    - the gradients of each tp index are flattened into one buffer per
      member and all-reduced across the dp group with divisor dp (JAX's
      mean over the global batch); Adam then updates every member alike,
      so replicated leaves stay equal on every member.

    The collectives are ``kernels.collectives``' all-reduce and all-gather
    (K4 and K5 on CUDA).  Raises ``ValueError`` when the heads, d_model,
    d_ff or vocab do not divide by tp or the batch by dp."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    for what, size, by in (
        ("n_heads", cfg.n_heads, tp), ("d_model", cfg.d_model, tp),
        ("d_ff", cfg.d_ff, tp), ("vocab", cfg.vocab, tp),
        ("batch", cfg.batch, dp),
    ):
        if size % by:
            raise ValueError(f"{what}={size} does not divide by {by}")
    members = mesh.flat
    opt = Adam(cfg.learning_rate)
    specs = _with_heads3(param_specs(cfg))

    def shard_tree(tree: dict) -> list:
        full = _tree_map(_as_tensor, tree)
        return [
            _spec_map(
                lambda sp, leaf: _shard_leaf(leaf, sp[0], m % tp, tp, sp[1])
                .to(dev, copy=True).contiguous(),
                specs, full,
            )
            for m, dev in enumerate(members)
        ]

    def shard_params(params: dict) -> list:
        return shard_tree(params)

    def shard_opt_state(params: list, opt_state: AdamState) -> list:
        mu, nu = shard_tree(opt_state.mu), shard_tree(opt_state.nu)
        return [AdamState(opt_state.count, m, n) for m, n in zip(mu, nu)]

    def shard_batch(batch) -> list:
        full = (batch if isinstance(batch, torch.Tensor)
                else torch.from_numpy(np.asarray(batch)))
        rows = full.shape[0] // dp
        placed = []
        for i in range(dp):
            mine = full[i * rows:(i + 1) * rows]
            by_device: dict = {}
            for dev in mesh.devices[i]:
                if dev not in by_device:
                    by_device[dev] = mine.to(dev, copy=True)
                placed.append(by_device[dev])
        return placed

    def unshard_tree(trees: list) -> dict:
        host = [params_to_numpy(t) for t in trees[:tp]]  # dp replica 0
        return _spec_map(
            lambda sp, *pieces: _unshard_leaf(list(pieces), sp[0], sp[1]),
            specs, *host,
        )

    def unshard(sharded: list):
        if isinstance(sharded[0], AdamState):
            return AdamState(sharded[0].count,
                             unshard_tree([s.mu for s in sharded]),
                             unshard_tree([s.nu for s in sharded]))
        return unshard_tree(sharded)

    def step(params: list, opt_state: list, batch: list):
        leaves = [[p.detach().requires_grad_(True) for p in _leaves(t)]
                  for t in params]
        with _tf32_matmul():
            losses = []
            for i in range(dp):
                group = range(i * tp, (i + 1) * tp)
                losses += _tp_losses(
                    [_unflatten(params[m], leaves[m]) for m in group],
                    [batch[m] for m in group], cfg, tp,
                )
            flat_grads = torch.autograd.grad(
                losses, [p for ls in leaves for p in ls]
            )
        with torch.no_grad():
            per = len(leaves[0])
            grads = [list(flat_grads[m * per:(m + 1) * per])
                     for m in range(len(members))]
            if dp > 1:
                for j in range(tp):
                    group = [i * tp + j for i in range(dp)]
                    summed = all_reduce(
                        [torch.cat([g.reshape(-1) for g in grads[m]])
                         for m in group],
                        divisor=float(dp),
                    )
                    for m, buf in zip(group, summed):
                        sizes = [g.numel() for g in grads[m]]
                        grads[m] = [
                            piece.view(g.shape) for piece, g in
                            zip(torch.split(buf, sizes), grads[m])
                        ]
            new_params, new_states = [], []
            for m, tree in enumerate(params):
                updates, state = opt.update(_unflatten(tree, grads[m]),
                                            opt_state[m])
                new_params.append(apply_updates(tree, updates))
                new_states.append(state)
            loss = losses[0].detach()
            for i in range(1, dp):
                loss = loss + losses[i * tp].detach().to(loss.device)
            loss = loss / dp
        return new_params, new_states, loss

    return ShardedStep(step, opt, shard_params, shard_batch,
                       shard_opt_state, unshard)


# -- the runner ------------------------------------------------------------


class CanaryRunner:
    """Run train steps and timestamp them; the gap analysis IS the
    workload-downtime metric.  ``device=None`` means the first CUDA
    device.  With a ``mesh`` the runner trains with the sharded step over
    it, from the weights a runner on ``mesh.devices[0][0]`` would start
    from, on the same batches."""

    def __init__(self, cfg: CanaryConfig, device=None, seed: int = 0,
                 mesh: Optional[Mesh] = None) -> None:
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            device = mesh.devices[0][0]
        self.device = (
            torch.device(device) if device is not None else cuda_devices()[0]
        )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = init_params(gen, cfg)
        if mesh is not None:
            sharded = make_sharded_train_step(mesh, cfg)
            self._step, self.opt = sharded.step, sharded.opt
            self._shard_batch = sharded.shard_batch
            self.params = sharded.shard_params(params)
            self.opt_state = [self.opt.init(p) for p in self.params]
        else:
            self._step, self.opt = make_train_step(cfg)
            self._shard_batch = lambda b: b
            self.params = params
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
        return self._shard_batch(torch.from_numpy(batch).to(self.device))

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
        """The model's parameters (the full leaves, however sharded)."""
        return int(sum(np.prod(shape) for shape in
                       _leaves(param_shapes(self.cfg))))

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
        if self.mesh is not None:
            # Per card: the step's FLOPs spread over the mesh's devices.
            cards = len(set(self.mesh.flat))
        else:
            cards = 1
        out = {
            "tokens_per_s": self.cfg.batch * self.cfg.seq_len / dt,
            "achieved_tflops": achieved_tflops,
            "device": kind,
        }
        mfu_frac = mfu(achieved_tflops / cards, kind)
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


# -- elastic mesh reshaping ---------------------------------------------------


@dataclass
class _ElasticBundle:
    """One sharded step for one exclusion set: the mesh over the
    surviving devices, its config and its placement helpers."""

    mesh: Mesh
    cfg: CanaryConfig
    sharded: ShardedStep


def _zeros_state(host_params: dict) -> AdamState:
    zeros = _tree_map(np.zeros_like, host_params)
    return AdamState(0, zeros, _tree_map(np.zeros_like, host_params))


class ElasticCanaryRunner(CanaryRunner):
    """Canary that reshapes its mesh around a slice under maintenance,
    as the JAX package's: a resize is checkpoint-free — gather params and
    optimizer state to numpy, switch to the bundle of the new exclusion
    set, place the snapshot through it and resume.

    - **physical** (the device count divides by ``n_slices`` and there
      is more than one slice): slice *i* owns a contiguous block of
      devices; excluding it rebuilds the mesh over the remaining blocks,
      the batch per dp replica held constant;
    - **logical** (an uneven split): the mesh keeps every device and an
      exclusion shrinks the global batch in proportion.

    ``precompile_exclusions`` builds the bundles a rolling upgrade visits
    and runs two steps in each on a throwaway placement of the initial
    weights (warming the kernels' build, cuBLAS, the allocator and the
    collectives' plans), so a resize pays only the host round trip; the
    runner's own parameters and optimizer state are untouched.
    ``exclude_slice`` and ``rejoin_slice`` are idempotent.
    ``devices=None`` means every CUDA device."""

    def __init__(
        self,
        cfg: CanaryConfig,
        devices=None,
        n_slices: int = 2,
        seed: int = 0,
        precompile: bool = True,
    ) -> None:
        if n_slices <= 0:
            raise ValueError(f"n_slices must be positive, got {n_slices}")
        self.base_cfg = cfg
        devs = ([torch.device(d) for d in devices] if devices is not None
                else cuda_devices())
        self.devices = devs
        self.device = devs[0]
        self.n_slices = n_slices
        self.physical = n_slices > 1 and len(devs) % n_slices == 0
        if self.physical:
            per = len(devs) // n_slices
            self.slice_devices = [
                devs[i * per:(i + 1) * per] for i in range(n_slices)
            ]
        else:
            self.slice_devices = [list(devs) for _ in range(n_slices)]
        base_dp = len(devs) // make_mesh(devs).shape["tp"]
        self._per_dp_batch = max(1, cfg.batch // base_dp)
        self.excluded: set[int] = set()
        self._bundles: dict[frozenset, _ElasticBundle] = {}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self._host_params = params_to_numpy(init_params(gen, cfg))
        self.resize_events: list[dict] = []
        self.step_times = []
        self.losses = []
        self._batch_rng = np.random.default_rng(seed)
        self._activate(frozenset(), self._host_params, None)
        if precompile:
            self.precompile_exclusions()
        self.window_start = time.monotonic()

    # -- bundles --

    def _build_bundle(self, excl: frozenset) -> _ElasticBundle:
        if len(excl) >= self.n_slices:
            raise ValueError("cannot exclude every slice of the workload")
        if self.physical:
            devs = [
                d
                for i in range(self.n_slices)
                if i not in excl
                for d in self.slice_devices[i]
            ]
            mesh = make_mesh(devs)
            batch = mesh.shape["dp"] * self._per_dp_batch
        else:
            mesh = make_mesh(self.devices)
            active = self.n_slices - len(excl)
            batch = mesh.shape["dp"] * max(
                1, self._per_dp_batch * active // self.n_slices
            )
        cfg = replace(self.base_cfg, batch=batch)
        return _ElasticBundle(mesh, cfg, make_sharded_train_step(mesh, cfg))

    def _bundle_for(self, excl: frozenset) -> _ElasticBundle:
        if excl not in self._bundles:
            self._bundles[excl] = self._build_bundle(excl)
        return self._bundles[excl]

    def precompile_exclusions(self, exclusion_sets=None) -> None:
        """Build the bundles resizes will switch to and run two steps in
        each on a throwaway placement.  Default: each single-slice
        exclusion (the shapes a rolling upgrade visits)."""
        sets = (
            [frozenset(s) for s in exclusion_sets]
            if exclusion_sets is not None
            else [frozenset({i}) for i in range(self.n_slices)]
        )
        for excl in sets:
            bundle = self._bundle_for(excl)
            sh = bundle.sharded
            p = sh.shard_params(self._host_params)
            o = sh.shard_opt_state(p, _zeros_state(self._host_params))
            zeros = np.zeros((bundle.cfg.batch, bundle.cfg.seq_len + 1),
                             np.int32)
            for _ in range(2):
                p, o, loss = sh.step(p, o, sh.shard_batch(zeros))
            float(loss)  # wait for the device

    def _activate(self, excl: frozenset, host_params, host_opt) -> None:
        bundle = self._bundle_for(excl)
        sh = bundle.sharded
        self.mesh = bundle.mesh
        self.cfg = bundle.cfg
        self.params = sh.shard_params(host_params)
        if host_opt is None:
            host_opt = _zeros_state(host_params)
        self.opt = sh.opt
        self.opt_state = sh.shard_opt_state(self.params, host_opt)
        self._step = sh.step
        self._shard_batch = sh.shard_batch
        self._unshard = sh.unshard

    # -- resizes --

    @property
    def active_slices(self) -> int:
        return self.n_slices - len(self.excluded)

    def active_device_count(self) -> int:
        return self.mesh.shape["dp"] * self.mesh.shape["tp"]

    def _resize(self, new_excl: frozenset, direction: str, index: int) -> None:
        t0 = time.monotonic()
        host_p = self._unshard(self.params)
        host_o = self._unshard(self.opt_state)
        self.excluded = set(new_excl)
        self._activate(new_excl, host_p, host_o)
        self.resize_events.append(
            {
                "direction": direction,
                "slice": index,
                "seconds": time.monotonic() - t0,
            }
        )

    def exclude_slice(self, index: int) -> None:
        if not 0 <= index < self.n_slices:
            raise ValueError(f"slice index {index} out of range")
        if index in self.excluded:
            return
        self._resize(frozenset(self.excluded | {index}), "down", index)

    def rejoin_slice(self, index: int) -> None:
        if index not in self.excluded:
            return
        self._resize(frozenset(self.excluded - {index}), "up", index)
