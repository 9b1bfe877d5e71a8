"""The host's collectives in one process, built on the K4 kernel.

One process drives every member of a collective, as the JAX package's
probes drive the host's local mesh.  A member is a tensor on one device;
a list may repeat a device (``[cuda:0] * 8`` runs eight members on one
card, each on that card's current stream).

- ``peer_reduce(dst, srcs, off, divisor)`` (K4, ``csrc/collective_kernels
  .cu``): ``dst = (srcs[0][off:off+len] + ... + srcs[k-1][off:off+len])
  / divisor`` on ``dst``'s device, fp32 sums in index order and an IEEE
  division; each source may lie on any device of the host (peer access
  over NVLink).  At most ``MAX_SOURCES`` sources.
- ``all_reduce(shards, divisor)``: every member gets the index-order sum
  of all the shards over ``divisor`` (JAX's ``psum``, then a division),
  as a reduce-scatter (member j reduces chunk j from every member, one K4
  launch) and an all-gather (member j copies every other chunk from its
  owner, K4 at k = 1); at most ``MAX_SOURCES`` members, the GPUs of an
  HGX board.  Each member moves 2(n-1)/n of a shard over its links, what
  the bus-bandwidth formula of ``ici_allreduce_probe`` assumes.
- ``ring_shift(shards)``: member j gets member j-1's shard (JAX's
  ``ppermute`` by +1), one K4 launch at k = 1 on each member.

Ordering, with no host synchronisation: each member's work runs on its
device's current stream, and a barrier (every stream waits for the first
member's, which first waits for every other) stands before the first
read of the inputs, between the two phases and after the last read.
After a call returns, later work on any member's current stream is
ordered after every read of every input and output, so the caller may
overwrite or free them at once: the caching allocator reuses a block
only for later work on the stream that allocated it, which for tensors
made on a device's current stream is that member's stream.

Tensors on the CPU take K4's plain version, and the same algorithm runs
in program order; on CUDA tensors the wrapper launches the kernel or
raises.  ``peer_reduce.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from k8s_operator_libs_tpu_torch.kernels.build import check, load_library

# K4's cap on sources (kMaxSources in csrc/collective_kernels.cu).
MAX_SOURCES = 8

_PEERS_LOCK = threading.Lock()
# Ordered (device, peer) pairs whose peer access is on, process-wide as
# the CUDA state it mirrors.
_PEERS: set[tuple[int, int]] = set()


def _check_tensor(t, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: want a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: want float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{what}: is empty")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _check_reduce(dst, srcs, off: int) -> None:
    _check_tensor(dst, "peer_reduce: dst")
    if not 1 <= len(srcs) <= MAX_SOURCES:
        raise ValueError(
            f"peer_reduce: want 1 to {MAX_SOURCES} sources, got {len(srcs)}"
        )
    if off < 0:
        raise ValueError(f"peer_reduce: negative offset {off}")
    for i, s in enumerate(srcs):
        _check_tensor(s, f"peer_reduce: source {i}")
        if s.device.type != dst.device.type:
            raise ValueError(
                f"peer_reduce: source {i} is on {s.device}, dst on "
                f"{dst.device}"
            )
        if s.numel() < off + dst.numel():
            raise ValueError(
                f"peer_reduce: source {i} has {s.numel()} elements, want "
                f"at least {off} + {dst.numel()}"
            )


def enable_peer_access(device: int, peer: int) -> None:
    """Let CUDA device ``device`` read ``peer``'s memory (once per ordered
    pair; nothing for the same device).  Raises ``RuntimeError("peer
    access {device}->{peer} unavailable")`` when the pair has none: there
    is no staging through the host."""
    if device == peer or (device, peer) in _PEERS:
        return
    lib = load_library()
    with _PEERS_LOCK:
        code = lib.collective_peer_enable(device, peer)
        if code == -1:
            raise RuntimeError(f"peer access {device}->{peer} unavailable")
        check(lib, code, f"enabling peer access {device}->{peer}")
        _PEERS.add((device, peer))


def peer_reduce_plain(dst, srcs, off: int = 0, divisor: float = 1.0):
    """Plain version of K4: fp32 adds in index order on ``dst``'s device,
    then a division by a tensor (a scalar divisor may become a multiply
    by its reciprocal, which is not IEEE division)."""
    n = dst.numel()
    acc = srcs[0].reshape(-1)[off:off + n].to(dst.device, copy=True)
    for s in srcs[1:]:
        acc += s.reshape(-1)[off:off + n].to(dst.device)
    acc.div_(torch.full_like(acc, divisor))
    dst.view(-1).copy_(acc)
    return dst


def _launch(dst, ptrs: Sequence[int], off: int, divisor: float,
            stream) -> None:
    """One K4 launch on ``stream`` (of ``dst``'s device), inputs checked."""
    lib = load_library()
    k = len(ptrs)
    code = lib.collective_peer_reduce(
        (ctypes.c_void_p * k)(*ptrs), k, off, dst.numel(), dst.data_ptr(),
        divisor, dst.device.index, stream.cuda_stream,
    )
    check(lib, code, "peer_reduce")
    peer_reduce.launches += 1


def peer_reduce(dst, srcs, off: int = 0, divisor: float = 1.0):
    """K4: ``dst[:] = (srcs[0][off:off+len] + ...) / divisor`` for a
    contiguous fp32 ``dst`` of ``len`` elements and 1 to ``MAX_SOURCES``
    contiguous fp32 sources; returns ``dst``.  On CUDA it launches on
    the current stream of ``dst``'s device; the caller orders the
    sources' producers (on other devices' streams) before it."""
    srcs = list(srcs)
    _check_reduce(dst, srcs, off)
    if dst.device.type == "cpu":
        return peer_reduce_plain(dst, srcs, off, divisor)
    for s in srcs:
        enable_peer_access(dst.device.index, s.device.index)
    _launch(dst, [s.data_ptr() for s in srcs], off, divisor,
            torch.cuda.current_stream(dst.device))
    return dst


peer_reduce.launches = 0


class _Members:
    """The members of one collective call: their current streams, the
    ordering between them, and K4 launches on them."""

    def __init__(self, shards: list, what: str) -> None:
        if not shards:
            raise ValueError(f"{what}: no members")
        for i, s in enumerate(shards):
            _check_tensor(s, f"{what}: member {i}")
            if s.numel() != shards[0].numel():
                raise ValueError(
                    f"{what}: member {i} has {s.numel()} elements, member 0 "
                    f"{shards[0].numel()}"
                )
            if s.device.type != shards[0].device.type:
                raise ValueError(
                    f"{what}: member {i} is on {s.device}, member 0 on "
                    f"{shards[0].device}"
                )
        self.shards = shards
        self.cuda = shards[0].device.type == "cuda"
        if self.cuda:
            self.streams = [torch.cuda.current_stream(s.device) for s in shards]
            devices = sorted({s.device.index for s in shards})
            for d in devices:
                for p in devices:
                    enable_peer_access(d, p)

    def wait(self, j: int, i: int) -> None:
        """Member j's later work waits for member i's earlier work."""
        if self.cuda:
            self.streams[j].wait_stream(self.streams[i])

    def barrier(self) -> None:
        """Every member's later work waits for every member's earlier
        work (through member 0's stream)."""
        if self.cuda:
            for i in range(1, len(self.shards)):
                self.wait(0, i)
            for j in range(1, len(self.shards)):
                self.wait(j, 0)

    def reduce(self, j: int, dst, srcs: list, off: int,
               divisor: float) -> None:
        """Member j: ``dst = (srcs[0][off:] + ...) / divisor``."""
        if self.cuda:
            _launch(dst, [s.data_ptr() for s in srcs], off, divisor,
                    self.streams[j])
        else:
            peer_reduce_plain(dst, srcs, off, divisor)


def _chunks(elems: int, n: int) -> list[tuple[int, int]]:
    """Member j's chunk ``[start, end)`` of ``elems``: starts on multiples
    of 4 elements (16 bytes, so K4's float4 body stays aligned); the last
    chunks may be short or empty."""
    size = -(-elems // n)
    size = -(-size // 4) * 4
    return [(min(j * size, elems), min((j + 1) * size, elems))
            for j in range(n)]


def all_reduce(shards: Sequence[torch.Tensor],
               divisor: float = 1.0) -> list[torch.Tensor]:
    """Every member's new tensor holds ``(shards[0] + ... +
    shards[n-1]) / divisor``, summed in index order and divided by IEEE
    division, on that member's device; 1 to ``MAX_SOURCES`` members."""
    shards = list(shards)
    n = len(shards)
    if n > MAX_SOURCES:
        raise ValueError(
            f"all_reduce: at most {MAX_SOURCES} members, got {n}"
        )
    m = _Members(shards, "all_reduce")
    outs = [torch.empty_like(s) for s in shards]
    flat = [o.view(-1) for o in outs]
    bounds = _chunks(shards[0].numel(), n)
    m.barrier()  # the inputs' producers before any member reads them
    for j, (a, b) in enumerate(bounds):
        if a == b:
            continue
        m.reduce(j, flat[j][a:b], shards, a, divisor)
    m.barrier()  # every chunk reduced before any member copies it
    for j in range(n):
        for i, (a, b) in enumerate(bounds):
            if i != j and a < b:
                m.reduce(j, flat[j][a:b], [flat[i]], a, 1.0)
    m.barrier()  # every read done before any member's later work
    return outs


def ring_shift(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Member j's new tensor is a copy of member j-1's shard (mod n), on
    member j's device."""
    shards = list(shards)
    m = _Members(shards, "ring_shift")
    n = len(shards)
    outs = [torch.empty_like(s) for s in shards]
    for j in range(n):
        m.wait(j, (j - 1) % n)  # shard j-1's producer before j reads it
    for j in range(n):
        m.reduce(j, outs[j].view(-1), [shards[j - 1]], 0, 1.0)
    for j in range(n):
        m.wait((j - 1) % n, j)  # j's read before shard j-1's later work
    return outs
