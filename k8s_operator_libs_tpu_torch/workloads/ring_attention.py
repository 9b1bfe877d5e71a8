"""Ring attention: context parallelism over a ring of devices.

Counterpart of ``k8s_operator_libs_tpu.workloads.ring_attention``.  The
sequence dimension is cut into one shard per ring member; K/V shards
rotate around the ring while each member accumulates its queries'
attention with online (flash-style) softmax, so attention spans a
sequence n times longer than any one device holds.  Each ring step is
one launch of the hand-written kernel K3 with the merge fused in
(:func:`~k8s_operator_libs_tpu_torch.kernels.block_attention_merge_`),
which updates the member's accumulator in place.

One process drives every listed device, as the JAX single-controller
mesh does.  A K/V shard moves to the next member with
``t.to(devices[(i + 1) % n], non_blocking=True)``: a peer copy over
NVLink between two cards of a host, a local copy on the CPU or on one
card.  A device list may name one device several times (``[cpu] * 8``
in the tests, ``[cuda:0] * 8`` on one card); the ring then runs every
(rank, kv_rank) mask case on that device.

It doubles as the deep health probe's soak (``ici_ring_attention``):
every member sends and receives one K and one V shard on each of its
n - 1 rotations.

Numerics: q·k and p·v in bf16 with fp32 accumulation, online-softmax
merge in fp32; checked against single-device full attention.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from k8s_operator_libs_tpu_torch.health.probes import cuda_devices
from k8s_operator_libs_tpu_torch.kernels import (
    block_attention,
    block_attention_merge_,
)
from k8s_operator_libs_tpu_torch.kernels.attention import NEG_INF

# Largest global sequence checked against the O(S²) full reference.
MAX_VERIFIED_SEQ = 4096
# The JAX package's tolerance for ring against full attention (bf16
# scores and merge).
RING_ATOL = 5e-2


def _synchronize(devices: Sequence[torch.device]) -> None:
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _normalise(num, den, dtype):
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).to(dtype)


def ring_attention(
    q_shards: Sequence[torch.Tensor],
    k_shards: Sequence[torch.Tensor],
    v_shards: Sequence[torch.Tensor],
    devices: Sequence[torch.device],
    causal: bool = True,
) -> list[torch.Tensor]:
    """Attention over the full, ring-distributed sequence.

    Shard ``i`` ([B, S_local, H, D], fp32, on ``devices[i]``) holds
    global positions ``[i * S_local, (i + 1) * S_local)``.  K/V rotate
    n - 1 times; queries never move.  Returns the output shards, one per
    member, on the members' devices."""
    n = len(devices)
    if not (len(q_shards) == len(k_shards) == len(v_shards) == n):
        raise ValueError(
            f"want one q, k and v shard per device ({n}), got "
            f"{len(q_shards)}, {len(k_shards)}, {len(v_shards)}"
        )
    B, S, H, D = q_shards[0].shape
    # Fresh accumulators each call: the fused step updates them in place.
    accs = [
        (
            torch.zeros((B, S, H, D), dtype=torch.float32, device=dev),
            torch.full((B, S, H), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, S, H), dtype=torch.float32, device=dev),
        )
        for dev in devices
    ]
    cur_k, cur_v = list(k_shards), list(v_shards)
    for step in range(n):
        for rank in range(n):
            # After ``step`` rotations member ``rank`` holds the block
            # that started at ``rank - step`` (mod n).
            kv_rank = (rank - step) % n
            block_attention_merge_(
                *accs[rank], q_shards[rank], cur_k[rank], cur_v[rank],
                q_offset=rank * S, k_offset=kv_rank * S, causal=causal,
            )
        if step + 1 < n:
            # Each member's block moves to the next member.  The lists
            # are built anew: ``.to()`` onto the same device returns the
            # same tensor, so no shard is ever updated in place.
            cur_k = [
                cur_k[(i - 1) % n].to(devices[i], non_blocking=True)
                for i in range(n)
            ]
            cur_v = [
                cur_v[(i - 1) % n].to(devices[i], non_blocking=True)
                for i in range(n)
            ]
    return [
        _normalise(num, den, q.dtype)
        for (num, _, den), q in zip(accs, q_shards)
    ]


def full_attention_reference(q, k, v, causal: bool = True):
    """Single-device full attention with the same bf16/fp32 contract: the
    numerical ground truth ring attention must match."""
    num, _, den = block_attention(q, k, v, 0, 0, causal)
    return _normalise(num, den, q.dtype)


def make_ring_attention(
    devices: Sequence[torch.device], causal: bool = True
):
    """``(fn, shard)`` for a ring over ``devices``: ``shard`` cuts a
    global [B, S, H, D] tensor along S into one contiguous shard per
    member, on the member's device; ``fn(q_shards, k_shards, v_shards)``
    returns the attention output shards."""
    devs = [torch.device(d) for d in devices]

    def fn(q_shards, k_shards, v_shards):
        return ring_attention(q_shards, k_shards, v_shards, devs, causal)

    def shard(x: torch.Tensor) -> list[torch.Tensor]:
        if x.shape[1] % len(devs):
            raise ValueError(
                f"sequence {x.shape[1]} does not split over {len(devs)} "
                "ring members"
            )
        return [
            part.contiguous().to(dev)
            for part, dev in zip(x.chunk(len(devs), dim=1), devs)
        ]

    return fn, shard


def _max_err(out_shards, ref) -> float:
    out = torch.cat([o.to(ref.device) for o in out_shards], dim=1)
    return float((out - ref).abs().max())


def ring_attention_soak(
    devices: Optional[Sequence[torch.device]] = None,
    seq_per_device: int = 128,
    batch: int = 1,
    heads: int = 4,
    head_dim: int = 64,
    rounds: int = 1,
) -> dict:
    """Run ring attention as a link soak: returns
    {ok, max_err, latency_ms, moved_bytes, link_gbps, devices,
    global_seq} after verifying round 0 against the single-device
    reference.  ``devices=None`` means every CUDA device."""
    devs = list(devices) if devices is not None else cuda_devices()
    n = len(devs)
    if n < 2:
        return {"ok": True, "latency_ms": 0.0, "moved_bytes": 0,
                "link_gbps": 0.0, "detail": "single device; no ring"}
    fn, shard = make_ring_attention(devs)
    S = seq_per_device * n
    rng = np.random.default_rng(0)
    shape = (batch, S, heads, head_dim)
    host = [
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for _ in range(3)
    ]
    q, k, v = (shard(x) for x in host)

    out = fn(q, k, v)
    _synchronize(devs)
    # One process addresses every member, so the O(S²) reference is
    # feasible wherever the sequence is bounded.
    if S <= MAX_VERIFIED_SEQ:
        ref = full_attention_reference(*(x.to(devs[0]) for x in host))
        err = _max_err(out, ref)
        ok = bool(err < RING_ATOL)
    else:
        ok = all(bool(torch.isfinite(o).all()) for o in out)
        err = float("nan")

    t0 = time.perf_counter()
    for _ in range(rounds):
        out = fn(q, k, v)
    _synchronize(devs)
    latency_ms = (time.perf_counter() - t0) / rounds * 1e3
    # Per round, each link carries (n-1) K and V shard transfers.
    shard_bytes = batch * seq_per_device * heads * head_dim * 4
    moved = 2 * (n - 1) * shard_bytes
    link_gbps = moved / (latency_ms * 1e-3) / 1e9
    return {
        "ok": ok,
        "max_err": err,
        "latency_ms": latency_ms,
        "moved_bytes": moved,
        "link_gbps": link_gbps,
        "devices": n,
        "global_seq": S,
    }


class ElasticRingSoak:
    """Ring attention that re-forms its ring around excluded slices.

    Devices are partitioned into ``n_slices`` contiguous blocks, and
    excluding a slice rebuilds the ring over the survivors (per-device
    sequence constant, so the global context shrinks with the ring;
    attention is stateless, so nothing migrates).  ``run_round`` checks
    the current ring against the single-device reference every time.
    ``exclude_slice``/``rejoin_slice`` are idempotent."""

    def __init__(
        self,
        devices: Optional[Sequence[torch.device]] = None,
        n_slices: int = 2,
        seq_per_device: int = 64,
        batch: int = 1,
        heads: int = 2,
        head_dim: int = 32,
        seed: int = 0,
    ) -> None:
        devs = list(devices) if devices is not None else cuda_devices()
        if n_slices <= 1 or len(devs) % n_slices != 0:
            raise ValueError(
                f"{len(devs)} devices do not partition into {n_slices} "
                "ring slices"
            )
        per = len(devs) // n_slices
        self.slice_devices = [
            devs[i * per : (i + 1) * per] for i in range(n_slices)
        ]
        self.n_slices = n_slices
        self.seq_per_device = seq_per_device
        self.batch = batch
        self.heads = heads
        self.head_dim = head_dim
        self.excluded: set[int] = set()
        self._rings: dict[frozenset, tuple] = {}
        self._rng = np.random.default_rng(seed)

    def _ring_for(self, excl: frozenset) -> tuple:
        if excl not in self._rings:
            if len(excl) >= self.n_slices:
                raise ValueError("cannot exclude every ring slice")
            devs = [
                d
                for i in range(self.n_slices)
                if i not in excl
                for d in self.slice_devices[i]
            ]
            if len(devs) < 2:
                raise ValueError("ring needs at least two devices")
            fn, shard = make_ring_attention(devs)
            self._rings[excl] = (fn, shard, devs)
        return self._rings[excl]

    def exclude_slice(self, index: int) -> None:
        if not 0 <= index < self.n_slices:
            raise ValueError(f"slice index {index} out of range")
        self.excluded.add(index)
        self._ring_for(frozenset(self.excluded))

    def rejoin_slice(self, index: int) -> None:
        self.excluded.discard(index)
        self._ring_for(frozenset(self.excluded))

    def run_round(self) -> dict:
        """One attention pass on the current ring, checked against the
        single-device full-attention reference."""
        fn, shard, devs = self._ring_for(frozenset(self.excluded))
        S = self.seq_per_device * len(devs)
        shape = (self.batch, S, self.heads, self.head_dim)
        host = [
            torch.from_numpy(
                self._rng.standard_normal(shape).astype(np.float32)
            )
            for _ in range(3)
        ]
        out = fn(*(shard(x) for x in host))
        ref = full_attention_reference(*(x.to(devs[0]) for x in host))
        err = _max_err(out, ref)
        return {
            "ok": bool(err < RING_ATOL),
            "max_err": err,
            "devices": len(devs),
            "global_seq": S,
        }
