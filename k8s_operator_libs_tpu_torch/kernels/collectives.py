"""The host's collectives in one process, built on the K4 and K5 kernels.

One process drives every member of a collective, as the JAX package's
probes drive the host's local mesh.  A member is a tensor on one device;
a list may repeat a device (``[cuda:0] * 8`` runs eight members on one
card, each on that card's current stream).

- ``peer_reduce(dst, srcs, off, divisor)`` (K4, ``csrc/collective_kernels
  .cu``): ``dst = (srcs[0][off:off+len] + ... + srcs[k-1][off:off+len])
  / divisor`` on ``dst``'s device, fp32 sums in index order and an IEEE
  division; each source may lie on any device of the host (peer access
  over NVLink).  At most ``MAX_SOURCES`` sources.
- ``peer_gather(dst, pieces, offsets, rows, pitch)`` (K5, same source):
  ``dst[off_i : off_i + len_i] = pieces[i]`` for up to ``MAX_SOURCES``
  pieces, or, with ``rows`` > 1, each piece's rows landing ``pitch``
  elements apart; a byte copy (any dtype), each piece on any device of
  the host.
- ``all_reduce(shards, divisor)``: every member gets the index-order sum
  of all the shards over ``divisor`` (JAX's ``psum``, then a division),
  as a reduce-scatter (member j reduces chunk j from every member, one K4
  launch) and an all-gather (member j copies every other chunk from its
  owner, one K5 launch); at most ``MAX_SOURCES`` members, the GPUs of an
  HGX board.  Each member moves 2(n-1)/n of a shard over its links, what
  the bus-bandwidth formula of ``ici_allreduce_probe`` assumes.
- ``all_reduce_init(shards, divisor, out)``: a persistent all-reduce
  (MPI's ``MPI_Allreduce_init``): checks, plan and pointers once, then
  one library call a round into the same outputs; what the bus-bandwidth
  probe times, as nccl-tests time rounds into buffers made beforehand.
- ``all_gather(shards, dim)``: every member gets the concatenation of all
  the shards along ``dim`` (JAX's ``all_gather(..., tiled=True)``), one
  K5 launch a member writing the gathered layout directly.
- ``ring_shift(shards)``: member j gets member j-1's shard (JAX's
  ``ppermute`` by +1), one K4 node at k = 1 on each member.

One host call a round.  On CUDA tensors ``all_reduce``, ``all_gather``
and ``ring_shift`` hand the round to a plan in the kernel library (one
per shape: the members' devices, the length and the kind), which keeps
the round's launches as a CUDA graph and enqueues it with one
``cudaGraphLaunch`` and the events that order it against the members'
streams: an all-reduce of n members is 2n kernels and two phases, a
ring shift n independent kernels, and launching them one by one cost
the host more than the device's work.  A
plan keeps two graphs, so rounds that alternate between two sets of
buffers replay without repointing, and repoints the one not used last
when a round's pointers are new; the outputs are always freshly
allocated tensors, so a round never writes a buffer that an earlier
round handed out.  A plan's failure raises; nothing falls back to launching from
Python.  The host's Python around the call is kept short (it is most of
a round's host time): one pass over the members checks them and reads
their devices, and the outputs of the members that share a device are
the rows of one allocation, their pointers computed from its base.

Ordering, with no host synchronisation: each member's work runs on its
device's current stream.  Before a round reads its inputs, the first
member's stream waits for every other member's; the round runs on the
first member's stream (its kernels on their members' devices, the
phases ordered by graph edges); after it, every other member's stream
waits for the first's.  After a call returns, later work on any member's
current stream is ordered after every read of every input and output, so
the caller may overwrite or free them at once: the caching allocator
reuses a block only for later work on the stream that allocated it,
which for tensors made on a device's current stream is that member's
stream.  The outputs of the members that share a device are the rows
of one allocation (one per device and round).

Tensors on the CPU take the kernels' plain versions, and the same
algorithms run in program order; on CUDA tensors the wrappers launch the
kernels or raise.  The standalone wrappers keep their host work short:
their checks are a few C-level passes over the sources (a second look
only to name a fault), the pointers are packed into one buffer, and
peer access is asked for only across devices.  ``peer_reduce.launches``
and ``peer_gather.launches`` count kernel launches, a round's graph
counting each of its kernels.

The list-level autograd functions ``copy_to_members``,
``reduce_from_members`` and ``gather_from_members`` wrap the collectives
for tensor parallelism (Megatron's conjugate pairs), as the sharded
canary step uses them.
"""

from __future__ import annotations

import ctypes
import math
import operator
import struct
import threading
from operator import attrgetter
from typing import Sequence

import torch

from k8s_operator_libs_tpu_torch.kernels.build import check, load_library

# K4's cap on sources (kMaxSources in csrc/collective_kernels.cu).
MAX_SOURCES = 8

_PEERS_LOCK = threading.Lock()
# Ordered (device, peer) pairs whose peer access is on, process-wide as
# the CUDA state it mirrors.
_PEERS: set[tuple[int, int]] = set()


def _check_tensor(t, what: str, dtype=torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: want a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: want {dtype}, got {t.dtype}")
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


def peer_reduce(dst, srcs, off: int = 0, divisor: float = 1.0):
    """K4: ``dst[:] = (srcs[0][off:off+len] + ...) / divisor`` for a
    contiguous fp32 ``dst`` of ``len`` elements and 1 to ``MAX_SOURCES``
    contiguous fp32 sources; returns ``dst``.  On CUDA it launches on
    the current stream of ``dst``'s device; the caller orders the
    sources' producers (on other devices' streams) before it."""
    # The checks are a few C-level passes over the sources; when one
    # fails, _check_reduce takes a second look and names the fault.
    if type(srcs) is not list:
        srcs = list(srcs)
    k = len(srcs)
    try:
        home = dst.get_device()
        n = dst.numel()
        devices = list(map(torch.Tensor.get_device, srcs))
        fine = (0 < k <= MAX_SOURCES and off >= 0 and n > 0
                and dst.dtype == torch.float32 and dst.is_contiguous()
                and list(map(_DTYPE, srcs)).count(torch.float32) == k
                and all(map(torch.Tensor.is_contiguous, srcs))
                and min(map(torch.Tensor.numel, srcs)) >= off + n
                and (min(devices) >= 0 if home >= 0
                     else dst.is_cpu and all(map(_IS_CPU, srcs))))
    except (TypeError, AttributeError):  # dst or a source not a tensor
        fine = False
    if not fine:
        _check_reduce(dst, srcs, off)
        raise AssertionError("peer_reduce: failed a check none names")
    if home < 0:
        return peer_reduce_plain(dst, srcs, off, divisor)
    if devices.count(home) != k:
        for peer in set(devices) - {home}:
            enable_peer_access(home, peer)
    lib = load_library()
    code = lib.collective_peer_reduce(
        _PACK_SOURCES[k](*map(torch.Tensor.data_ptr, srcs)), k, off, n,
        dst.data_ptr(), divisor, home,
        torch._C._cuda_getCurrentRawStream(home),
    )
    if code:
        check(lib, code, "peer_reduce")
    peer_reduce.launches += 1
    return dst


peer_reduce.launches = 0

# K4's source pointers packed as the C side reads them, by k.
_PACK_SOURCES = [struct.Struct(f"={k}Q").pack
                 for k in range(MAX_SOURCES + 1)]


def _check_gather(dst, pieces, offsets, rows: int, pitch: int):
    """Check a gather; returns the pieces' widths (elements a row) and
    their CUDA devices other than ``dst``'s (none on the CPU), whose peer
    access the launch needs.  The checks are a few C-level passes over
    the pieces (the standalone launch's host time is mostly this); on a
    fault, ``_gather_fault`` takes a second look and names it."""
    if not isinstance(dst, torch.Tensor):
        raise TypeError(f"peer_gather: want a tensor, got {type(dst).__name__}")
    k = len(pieces)
    if not 1 <= k <= MAX_SOURCES:
        raise ValueError(
            f"peer_gather: want 1 to {MAX_SOURCES} pieces, got {k}"
        )
    if len(offsets) != k:
        raise ValueError(f"peer_gather: {k} pieces, {len(offsets)} offsets")
    if rows < 1:
        raise ValueError(f"peer_gather: want at least one row, got {rows}")
    both = [dst, *pieces]
    try:
        devices = list(map(torch.Tensor.get_device, both))
        numels = list(map(torch.Tensor.numel, both))
        fine = (list(map(_DTYPE, both)).count(dst.dtype) == k + 1
                and all(map(torch.Tensor.is_contiguous, both))
                and min(numels) > 0
                and (min(devices) >= 0 if devices[0] >= 0
                     else all(map(_IS_CPU, both))))
    except TypeError:  # a piece that is not a tensor
        fine = False
    if fine:
        sizes = numels[1:]
        widths = sizes if rows == 1 else [n // rows for n in sizes]
        ends = list(map(operator.add, offsets, widths))
        if all(map(operator.le, ends, offsets[1:])):  # in order, disjoint
            first, last = offsets[0], ends[-1]
        else:
            spans = sorted(zip(offsets, ends))
            first, last = spans[0][0], max(ends)
            fine = all(end <= start for (_, end), (start, _)
                       in zip(spans, spans[1:]))
        fine = (fine and rows * sum(widths) == sum(sizes) and first >= 0
                and (rows == 1 or last <= pitch)
                and (rows - 1) * pitch + last <= numels[0])
    if not fine:
        _gather_fault(dst, pieces, offsets, rows, pitch)
    home = devices[0]
    return widths, [d for d in devices[1:] if d != home] if home >= 0 else []


def _gather_fault(dst, pieces, offsets, rows: int, pitch: int) -> None:
    """Raise naming the fault of a gather that failed its checks."""
    dtype = dst.dtype
    _check_tensor(dst, "peer_gather: dst", dtype)
    size = dst.numel()
    spans = []
    for i, (p, off) in enumerate(zip(pieces, offsets)):
        _check_tensor(p, f"peer_gather: piece {i}", dtype)
        if p.device.type != dst.device.type:
            raise ValueError(
                f"peer_gather: piece {i} is on {p.device}, dst on {dst.device}"
            )
        if p.numel() % rows:
            raise ValueError(
                f"peer_gather: piece {i} of {p.numel()} elements is not "
                f"{rows} rows"
            )
        width = p.numel() // rows
        if rows > 1 and off + width > pitch:
            raise ValueError(
                f"peer_gather: piece {i}'s rows at {off} + {width} overrun "
                f"the pitch {pitch}"
            )
        if off < 0 or (rows - 1) * pitch + off + width > size:
            raise ValueError(
                f"peer_gather: piece {i} at {off} + {width} in {rows} rows "
                f"overruns dst of {size} elements"
            )
        spans.append((off, off + width))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("peer_gather: the pieces' ranges overlap")
    raise AssertionError("peer_gather: failed a check none names")


def peer_gather_plain(dst, pieces, offsets, rows: int = 1, pitch: int = 0):
    """Plain version of K5: each piece copied into its range of ``dst``
    (row by row ``pitch`` elements apart when ``rows`` > 1)."""
    flat = dst.view(-1)
    for p, off in zip(pieces, offsets):
        if rows == 1:
            flat[off:off + p.numel()].copy_(p.reshape(-1))
        else:
            width = p.numel() // rows
            flat[off:].as_strided((rows, width), (pitch, 1)).copy_(
                p.reshape(rows, width)
            )
    return dst


def peer_gather(dst, pieces, offsets, rows: int = 1, pitch: int = 0):
    """K5: ``dst.view(-1)[off_i : off_i + pieces[i].numel()] = pieces[i]``
    for 1 to ``MAX_SOURCES`` contiguous pieces of ``dst``'s dtype, their
    ranges disjoint; returns ``dst``.  With ``rows`` > 1 each piece is
    ``rows`` rows of ``numel / rows`` elements, row r landing at ``off_i
    + r * pitch`` (the ranges within a row disjoint, each inside the
    pitch).  On CUDA it launches one byte copy on the current stream of
    ``dst``'s device; the caller orders the pieces' producers (on other
    devices' streams) before it."""
    pieces, offsets = list(pieces), list(map(int, offsets))
    rows, pitch = int(rows), int(pitch)
    widths, peers = _check_gather(dst, pieces, offsets, rows, pitch)
    if dst.device.type == "cpu":
        return peer_gather_plain(dst, pieces, offsets, rows, pitch)
    device = dst.device.index
    for peer in peers:
        enable_peer_access(device, peer)
    esz = dst.element_size()
    lib = load_library()
    # src[k], off[k], len[k] as uint64, the last two in bytes.
    packed = struct.pack(
        f"={3 * len(pieces)}Q", *map(torch.Tensor.data_ptr, pieces),
        *[o * esz for o in offsets], *[w * esz for w in widths],
    )
    code = lib.collective_peer_gather(
        packed, len(pieces), rows, pitch * esz, dst.data_ptr(), device,
        torch._C._cuda_getCurrentRawStream(device),
    )
    check(lib, code, "peer_gather")
    peer_gather.launches += 1
    return dst


peer_gather.launches = 0


_DTYPE = attrgetter("dtype")
_IS_CPU = attrgetter("is_cpu")


def _member_devices(shards: list, what: str, dtype=torch.float32):
    """Check a collective's members (contiguous, non-empty, of one shape,
    dtype and device type, CPU or CUDA); their CUDA device indices, or
    ``None`` when they lie on the CPU.  A few passes of C-level attribute
    reads (a round's host time is its cost); on a fault, a second look
    names it through ``_check_tensor``."""
    if not shards:
        raise ValueError(f"{what}: no members")
    n = len(shards)
    first = shards[0]
    try:
        devices = tuple(map(torch.Tensor.get_device, shards))
        if (list(map(torch.Tensor.size, shards)).count(first.shape) == n
                and list(map(_DTYPE, shards)).count(dtype) == n
                and all(map(torch.Tensor.is_contiguous, shards))
                and first.numel()):
            if min(devices) >= 0:
                return devices
            if all(map(_IS_CPU, shards)):
                return None
    except TypeError:  # a member that is not a tensor
        pass
    for i, s in enumerate(shards):
        _check_tensor(s, f"{what}: member {i}", dtype)
        if s.device.type != first.device.type:
            raise ValueError(
                f"{what}: member {i} is on {s.device}, member 0 on "
                f"{first.device}"
            )
        if s.shape != first.shape:
            raise ValueError(
                f"{what}: member {i} has shape {tuple(s.shape)}, "
                f"member 0 {tuple(first.shape)}"
            )
    raise AssertionError(f"{what}: members failed a check none names")


# The plans' kinds (Kind in csrc/collective_kernels.cu).
ALL_REDUCE, ALL_GATHER, RING_SHIFT = 0, 1, 2

_PLANS_LOCK = threading.Lock()
# Round plans of the kernel library by (kind, member devices, two sizes:
# elements and bytes a member for an all-reduce or a ring shift, rows and
# bytes a row for an all-gather).
_PLANS: dict[tuple, "_RoundPlan"] = {}


def _outputs(shards: list, devices: tuple, shape, nbytes: int):
    """A new tensor of ``shape`` (``nbytes`` bytes) and the shards' dtype
    for every member, and their pointers: one allocation for the members
    that share a device, whose outputs are its rows."""
    n = len(shards)
    if devices.count(devices[0]) == n:
        buf = shards[0].new_empty((n, *shape))
        base = buf.data_ptr()
        return buf.unbind(0), [base + j * nbytes for j in range(n)]
    groups: dict[int, list[int]] = {}
    for j, d in enumerate(devices):
        groups.setdefault(d, []).append(j)
    outs = [None] * n
    for members in groups.values():
        first = shards[members[0]]
        if len(members) == 1:
            outs[members[0]] = first.new_empty(shape)
            continue
        buf = first.new_empty((len(members), *shape))
        for j, t in zip(members, buf.unbind(0)):
            outs[j] = t
    return outs, [o.data_ptr() for o in outs]


class _RoundPlan:
    """A round of one shape in the kernel library: its graph, the K4 and
    K5 kernels one replay launches, and what the host needs per round."""

    def __init__(self, kind: int, devices: tuple, bounds: list,
                 rows: int, pitch: int) -> None:
        lib = load_library()
        n = len(devices)
        handle = ctypes.c_void_p()
        code = lib.collective_plan_create(
            kind, n, (ctypes.c_int * n)(*devices),
            (ctypes.c_size_t * n)(*(a for a, _ in bounds)),
            (ctypes.c_size_t * n)(*(b for _, b in bounds)),
            rows, pitch, ctypes.byref(handle),
        )
        check(lib, code, "creating a collective round plan")
        rs, ag = (ctypes.c_int * n)(), (ctypes.c_int * n)()
        lib.collective_plan_nodes(handle, rs, ag)
        self.handle = handle
        self.devices = devices
        self.one_device = devices.count(devices[0]) == n
        self.k4 = sum(rs)
        self.k5 = sum(ag)
        # Rounds launched (chip_smoke.py splits K4's launches by shape).
        self.rounds = 0
        # The round's pointers, packed as the C side reads them: in[n],
        # out[n], streams[n] as uint64.
        self.pack = struct.Struct(f"={3 * n}Q").pack
        self.launch_fn = lib.collective_plan_launch
        self.lib = lib

    def streams(self) -> list[int]:
        """Each member's current stream (a raw ``cudaStream_t``), looked
        up once per device."""
        get = torch._C._cuda_getCurrentRawStream
        if self.one_device:
            return [get(self.devices[0])] * len(self.devices)
        seen: dict[int, int] = {}
        return [seen[d] if d in seen else seen.setdefault(d, get(d))
                for d in self.devices]

    def run(self, shards: list, shape, nbytes: int, divisor: float,
            streams) -> list:
        """One round: fresh outputs of ``shape`` (``nbytes`` each), the
        graph launched with the members' streams (``None``: their current
        streams)."""
        outs, out_ptrs = _outputs(shards, self.devices, shape, nbytes)
        self.launch(
            self.pack(*map(torch.Tensor.data_ptr, shards), *out_ptrs,
                      *(self.streams() if streams is None else streams)),
            divisor,
        )
        return list(outs)

    def launch(self, packed: bytes, divisor: float) -> None:
        """One round of the packed pointers; counts its kernels."""
        code = self.launch_fn(self.handle, packed, divisor)
        if code:
            check(self.lib, code, "collective round")
        self.rounds += 1
        peer_reduce.launches += self.k4
        peer_gather.launches += self.k5

    def persistent(self, shards: list, outs: list, divisor: float,
                   streams):
        """A function that runs one round from ``shards`` into ``outs``
        each call and returns ``outs``, the pointers packed here once
        (``streams``: fixed raw streams, or ``None`` for the members'
        current streams at each call, repacked when they change)."""
        ptrs = [*map(torch.Tensor.data_ptr, shards),
                *map(torch.Tensor.data_ptr, outs)]
        fixed = streams is not None
        now = list(streams) if fixed else self.streams()
        state = [now, self.pack(*ptrs, *now)]

        def start(_keep=(shards, outs)) -> list:
            if not fixed:
                now = self.streams()
                if now != state[0]:
                    state[0], state[1] = now, self.pack(*ptrs, *now)
            self.launch(state[1], divisor)
            return outs

        return start


def _plan(kind: int, devices: tuple, a: int, b: int) -> _RoundPlan:
    """The plan of a round of ``kind`` over members on ``devices``, made
    on first use: an all-reduce or ring shift of ``a`` fp32 elements
    (``b`` bytes) a member, or an all-gather of members of ``a`` rows of
    ``b`` bytes."""
    key = (kind, devices, a, b)
    plan = _PLANS.get(key)
    if plan is None:
        with _PLANS_LOCK:
            plan = _PLANS.get(key)
            if plan is None:
                n = len(devices)
                if kind == ALL_REDUCE:
                    bounds, rows, pitch = _chunks(a, n), 1, 0
                elif kind == RING_SHIFT:
                    bounds, rows, pitch = [(0, a)] * n, 1, 0
                else:
                    bounds = [(i * b, (i + 1) * b) for i in range(n)]
                    rows, pitch = a, n * b
                for d in set(devices):
                    for p in set(devices):
                        enable_peer_access(d, p)
                plan = _PLANS[key] = _RoundPlan(kind, devices, bounds, rows,
                                                pitch)
    return plan


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
    division, on that member's device; 1 to ``MAX_SOURCES`` contiguous
    fp32 members of one shape."""
    return _all_reduce(list(shards), divisor)


def _all_reduce(shards: list, divisor: float, streams=None) -> list:
    """``all_reduce`` with the members' streams given (``None``: their
    current streams)."""
    n = len(shards)
    if n > MAX_SOURCES:
        raise ValueError(
            f"all_reduce: at most {MAX_SOURCES} members, got {n}"
        )
    devices = _member_devices(shards, "all_reduce")
    if devices is not None:
        first = shards[0]
        numel = first.numel()
        return _plan(ALL_REDUCE, devices, numel, 4 * numel).run(
            shards, first.shape, 4 * numel, float(divisor), streams
        )
    return _reduce_plain(shards, divisor, [torch.empty_like(s)
                                           for s in shards])


def _reduce_plain(shards: list, divisor: float, outs: list) -> list:
    """The round's schedule with the kernels' plain versions, into
    ``outs`` (which may be the shards themselves: a member's chunk is
    written only after every read of it)."""
    bounds = _chunks(shards[0].numel(), len(shards))
    flat = [o.view(-1) for o in outs]
    for j, (a, b) in enumerate(bounds):  # reduce-scatter
        if a < b:
            peer_reduce_plain(flat[j][a:b], shards, a, divisor)
    for j in range(len(shards)):  # all-gather
        own = [i for i, (a, b) in enumerate(bounds) if i != j and a < b]
        if own:
            peer_gather_plain(flat[j], [flat[i][bounds[i][0]:bounds[i][1]]
                                        for i in own],
                              [bounds[i][0] for i in own])
    return outs


def all_reduce_init(shards: Sequence[torch.Tensor], divisor: float = 1.0,
                    out: Sequence[torch.Tensor] | None = None):
    """A persistent all-reduce (MPI's ``MPI_Allreduce_init``): the
    returned function runs one round each call, writing ``(shards[0] +
    ... + shards[n-1]) / divisor`` of the shards' current values into
    ``out`` as ``all_reduce`` computes it, and returns ``out``.  ``out``
    (by default new tensors made here) holds one contiguous fp32 tensor
    of the shards' shape a member, on its member's device; each may be
    its member's shard (in place) and must otherwise overlap no shard.
    The checks, the plan and the round's pointers are done here, once,
    so a call costs the host one library call; the shards and outputs
    must keep their storage while the function is in use.  A round reads
    and writes on the members' current streams at the call, ordered as
    ``all_reduce``'s."""
    return _all_reduce_init(list(shards), divisor,
                            None if out is None else list(out))


def _all_reduce_init(shards: list, divisor: float, out, streams=None):
    """``all_reduce_init`` with the members' streams fixed (``None``:
    their current streams at each call)."""
    n = len(shards)
    if n > MAX_SOURCES:
        raise ValueError(
            f"all_reduce: at most {MAX_SOURCES} members, got {n}"
        )
    devices = _member_devices(shards, "all_reduce")
    outs = [torch.empty_like(s) for s in shards] if out is None else out
    if len(outs) != n:
        raise ValueError(f"all_reduce: {n} members, {len(outs)} outputs")
    if (_member_devices(outs, "all_reduce: output") != devices
            or outs[0].shape != shards[0].shape):
        raise ValueError(
            "all_reduce: each output must have its member's shape and device"
        )
    if devices is None:
        return lambda: _reduce_plain(shards, divisor, outs)
    numel = shards[0].numel()
    return _plan(ALL_REDUCE, devices, numel, 4 * numel).persistent(
        shards, outs, float(divisor), streams
    )


def all_gather(shards: Sequence[torch.Tensor],
               dim: int = 0) -> list[torch.Tensor]:
    """Every member's new tensor is the concatenation of all the shards
    along ``dim``, in member order, on that member's device; 1 to
    ``MAX_SOURCES`` contiguous members of one shape and dtype.  Each
    shard is ``rows`` rows (the product of the dimensions before
    ``dim``) of ``width`` elements (the rest); member i's rows land at
    ``i * width`` of the gathered rows, ``n * width`` apart, so the one
    K5 launch a member writes the gathered layout directly."""
    shards = list(shards)
    n = len(shards)
    if n > MAX_SOURCES:
        raise ValueError(
            f"all_gather: at most {MAX_SOURCES} members, got {n}"
        )
    if not shards:
        raise ValueError("all_gather: no members")
    devices = _member_devices(shards, "all_gather",
                              getattr(shards[0], "dtype", None))
    first = shards[0]
    piece = first.shape
    d = dim % len(piece)
    rows = math.prod(piece[:d])
    width = first.numel() // rows
    shape = (*piece[:d], n * piece[d], *piece[d + 1:])
    if devices is not None:
        esz = first.element_size()
        return _plan(ALL_GATHER, devices, rows, width * esz).run(
            shards, shape, n * width * rows * esz, 1.0, None
        )
    outs = [s.new_empty(shape) for s in shards]
    for out in outs:
        peer_gather_plain(out, shards, [i * width for i in range(n)], rows,
                          n * width)
    return outs


def ring_shift(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Member j's new tensor is a copy of member j-1's shard (mod n), on
    member j's device; contiguous fp32 members of one shape (on CUDA at
    most ``MAX_SOURCES``)."""
    shards = list(shards)
    devices = _member_devices(shards, "ring_shift")
    n = len(shards)
    if devices is None:
        outs = [torch.empty_like(s) for s in shards]
        for j in range(n):
            peer_reduce_plain(outs[j].view(-1), [shards[j - 1]], 0, 1.0)
        return outs
    if n > MAX_SOURCES:
        raise ValueError(
            f"ring_shift: at most {MAX_SOURCES} members on CUDA, got {n}"
        )
    first = shards[0]
    numel = first.numel()
    return _plan(RING_SHIFT, devices, numel, 4 * numel).run(
        shards, first.shape, 4 * numel, 1.0, None
    )


# -- autograd over a list of members (tensor parallelism) -------------------
#
# Megatron's conjugate pairs, for members whose later computation is
# replicated (every member of the group computes the same function of the
# same values, so each carries the whole gradient of its own copy of the
# loss): the group's loss is the sum of the members' identical losses and
# each member's gradients are those of one loss.


class _CopyToMembers(torch.autograd.Function):
    """Forward: identity.  Backward: all-reduce (each member's partial
    gradient of a replicated input, summed)."""

    @staticmethod
    def forward(ctx, *xs):
        return xs

    @staticmethod
    def backward(ctx, *grads):
        return tuple(all_reduce([g.contiguous() for g in grads]))


class _ReduceFromMembers(torch.autograd.Function):
    """Forward: all-reduce (the members' partial sums).  Backward:
    identity."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(all_reduce(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        return grads


class _GatherFromMembers(torch.autograd.Function):
    """Forward: all-gather along ``dim``.  Backward: each member's slice
    of its own gradient."""

    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim % xs[0].dim()
        ctx.size = xs[0].shape[ctx.dim]
        return tuple(all_gather(list(xs), ctx.dim))

    @staticmethod
    def backward(ctx, *grads):
        m = ctx.size
        return (None, *(g.narrow(ctx.dim, j * m, m)
                        for j, g in enumerate(grads)))


def copy_to_members(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The input of a column-parallel product: identity forward, gradient
    all-reduced over the members backward."""
    xs = list(xs)
    return xs if len(xs) == 1 else list(_CopyToMembers.apply(*xs))


def reduce_from_members(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The output of a row-parallel product: all-reduced forward, the
    gradient passed through backward."""
    xs = list(xs)
    return xs if len(xs) == 1 else list(_ReduceFromMembers.apply(*xs))


def gather_from_members(xs: Sequence[torch.Tensor],
                        dim: int = -1) -> list[torch.Tensor]:
    """Pieces split along ``dim`` (a vocab- or width-split product):
    all-gathered forward, each member's slice of its gradient backward."""
    xs = list(xs)
    return xs if len(xs) == 1 else list(_GatherFromMembers.apply(dim, *xs))
