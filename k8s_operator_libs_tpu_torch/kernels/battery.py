"""Wrappers of the battery's two CUDA kernels, with their plain versions.

- ``stream_increment_`` (K1): ``x += 1`` in place, one launch per pass.
- ``stream_increment_verify_`` (K1's second entry): one such pass that
  also returns ``verify_stats`` of the updated ``x``, so a chain's check
  does not read the buffer again.
- ``verify_stats`` (K2): ``(min(x), max(x), max|x - center|)`` as an fp32
  tensor of 3 on ``x``'s device, NaN-propagating.

Each wrapper checks its input, then takes the plain PyTorch version only
for a tensor on the CPU; for a CUDA tensor it launches the kernel on the
current stream or raises.  ``<wrapper>.launches`` counts kernel launches,
so a run can show that its path went through the kernels; with layer
spans on, the counters ``k1.launches``, ``k1.bytes``, ``k2.launches``
and ``k2.bytes`` count them and the bytes they read and write.  The
kernel sources (``csrc/battery_kernels.cu``) say which XLA programs they
replace and what bounds them.
"""

from __future__ import annotations

import torch

from k8s_operator_libs_tpu_torch.kernels.build import check, load_library
from k8s_operator_libs_tpu_torch.layers import count

# 8 blocks of 256 threads (the library's block size) fill an SM's 2048
# thread slots; K2's grid-stride loops cover the rest of the array.
BLOCKS_PER_SM = 8
# K1's tiles, 16-byte vectors a thread (kStreamVecs and kVerifyVecs in
# csrc/battery_kernels.cu): one tile a block.
STREAM_VECS = 1
VERIFY_VECS = 4

_VERIFY_ENTRY = {
    torch.float32: "battery_verify_stats_f32",
    torch.bfloat16: "battery_verify_stats_bf16",
}


def _check_input(x: torch.Tensor, dtypes, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: want a tensor, got {type(x).__name__}")
    if x.dtype not in dtypes:
        names = ", ".join(str(d) for d in dtypes)
        raise TypeError(f"{what}: want dtype {names}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{what}: input is empty")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def grid_blocks(lib, device: torch.device, vectors: int) -> int:
    """Blocks for a grid-stride pass over ``vectors`` 16-byte chunks:
    enough to fill every SM, never more than there is work for."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    needed = -(-vectors // lib.battery_threads_per_block())
    return max(1, min(sms * BLOCKS_PER_SM, needed))


def tile_blocks(lib, n: int, vecs: int) -> int:
    """K1's grid over ``n`` fp32: one block a tile of ``vecs`` vectors a
    thread."""
    return max(1, -(-n // (4 * vecs * lib.battery_threads_per_block())))


def stream_increment_plain_(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1."""
    return x.add_(1.0)


def stream_increment_(x: torch.Tensor) -> torch.Tensor:
    """K1: ``x += 1.0`` in place over a contiguous fp32 tensor; returns
    ``x``."""
    _check_input(x, (torch.float32,), "stream_increment_")
    if x.device.type == "cpu":
        return stream_increment_plain_(x)
    lib = load_library()
    n = x.numel()
    code = lib.battery_stream_increment(
        x.data_ptr(),
        n,
        x.device.index,
        tile_blocks(lib, n, STREAM_VECS),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(lib, code, "stream_increment_")
    stream_increment_.launches += 1
    _count_k1(n)
    return x


def _count_k1(n: int) -> None:
    """One K1 pass over ``n`` fp32: read once, written once."""
    count("k1.launches")
    count("k1.bytes", 8 * n)


stream_increment_.launches = 0


def stream_increment_verify_plain_(x: torch.Tensor,
                                   center: float) -> torch.Tensor:
    """Plain version of ``stream_increment_verify_``."""
    return verify_stats_plain(stream_increment_plain_(x), center)


def stream_increment_verify_(x: torch.Tensor, center: float) -> torch.Tensor:
    """One K1 pass ``x += 1.0`` in place over a contiguous fp32 tensor,
    returning what ``verify_stats(x, center)`` returns on the updated
    ``x`` (fp32[3] on ``x``'s device; a NaN anywhere makes all three
    NaN) without reading ``x`` again.  Counts as a K1 launch too."""
    _check_input(x, (torch.float32,), "stream_increment_verify_")
    if x.device.type == "cpu":
        return stream_increment_verify_plain_(x, center)
    lib = load_library()
    n = x.numel()
    blocks = tile_blocks(lib, n, VERIFY_VECS)
    # out[0:3], then the blocks' partials and their merges.
    scratch = torch.empty(3 + lib.battery_verify_scratch_floats(blocks),
                          dtype=torch.float32, device=x.device)
    code = lib.battery_stream_increment_verify_f32(
        x.data_ptr(),
        n,
        float(center),
        scratch.data_ptr() + 12,
        scratch.data_ptr(),
        x.device.index,
        blocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(lib, code, "stream_increment_verify_")
    stream_increment_.launches += 1
    stream_increment_verify_.launches += 1
    _count_k1(n)
    return scratch[:3]


stream_increment_verify_.launches = 0


def verify_stats_plain(x: torch.Tensor, center: float) -> torch.Tensor:
    """Plain version of K2."""
    xf = x.float()
    return torch.stack([xf.amin(), xf.amax(), (xf - center).abs().amax()])


def verify_stats(x: torch.Tensor, center: float) -> torch.Tensor:
    """K2: ``(min(x), max(x), max|x - center|)`` over a contiguous fp32 or
    bf16 tensor, as fp32[3] on ``x``'s device.  A NaN anywhere in ``x``
    makes all three NaN."""
    _check_input(x, tuple(_VERIFY_ENTRY), "verify_stats")
    if x.device.type == "cpu":
        return verify_stats_plain(x, center)
    lib = load_library()
    per_chunk = 16 // x.element_size()
    blocks = grid_blocks(lib, x.device, -(-x.numel() // per_chunk))
    partials = torch.empty(3 * blocks, dtype=torch.float32, device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    code = getattr(lib, _VERIFY_ENTRY[x.dtype])(
        x.data_ptr(),
        x.numel(),
        float(center),
        partials.data_ptr(),
        out.data_ptr(),
        x.device.index,
        blocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(lib, code, "verify_stats")
    verify_stats.launches += 1
    count("k2.launches")
    count("k2.bytes", x.numel() * x.element_size())
    return out


verify_stats.launches = 0
