"""Wrapper of ring attention's block kernel (K3), with its plain version.

``block_attention(q, k, v, q_offset, k_offset, causal)`` returns the
unnormalised online-softmax contribution ``(num, m, l)`` of one kv block
to one q block, as ``_block_attention`` of the JAX package does, with the
causal mask given by the blocks' global offsets: query ``i`` sees key
``j`` iff ``q_offset + i >= k_offset + j``.

The wrapper checks its inputs, then takes the plain PyTorch version only
for tensors on the CPU; for CUDA tensors it launches the kernel
(``csrc/attention_kernels.cu``) on the current stream or raises.
``block_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from k8s_operator_libs_tpu_torch.kernels.build import check, load_library

NEG_INF = -1e30
MAX_HEAD_DIM = 128


def _check_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(
                f"block_attention: {name} must be a tensor, got "
                f"{type(t).__name__}"
            )
        if t.dtype != torch.float32:
            raise TypeError(
                f"block_attention: {name} must be float32, got {t.dtype}"
            )
        if t.dim() != 4 or t.numel() == 0:
            raise ValueError(
                f"block_attention: {name} must be a non-empty [B, S, H, D] "
                f"tensor, got shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"block_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(
                f"block_attention: {name} is on {t.device}, q on {q.device}"
            )
    B, _, H, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(
            "block_attention: want q [B, Sq, H, D] and k, v [B, Sk, H, D], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(
            f"block_attention: head dim must be a multiple of 8 up to "
            f"{MAX_HEAD_DIM}, got {D}"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_attention: unsupported device {q.device}")


def _causal_mask(sq: int, sk: int, q_offset: int, k_offset: int,
                 device=None) -> torch.Tensor:
    """[Sq, Sk] bool: query ``i`` sees key ``j``."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = k_offset + torch.arange(sk, device=device)
    return qpos[:, None] >= kpos[None, :]


def block_attention_plain(q, k, v, q_offset: int = 0, k_offset: int = 0,
                          causal: bool = True):
    """Plain version of K3, the same arithmetic as the JAX function:
    bf16-rounded operands, fp32 products and sums."""
    bf16 = torch.bfloat16
    scores = torch.einsum(
        "bqhd,bkhd->bqhk", q.to(bf16).float(), k.to(bf16).float()
    ) * q.shape[-1] ** -0.5
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset,
                            q.device)
        scores = torch.where(mask[None, :, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1)
    # Rows with no visible keys: pin the max so p is exp(NEG_INF) = 0.
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(scores - m[..., None])
    num = torch.einsum(
        "bqhk,bkhd->bqhd", p.to(bf16).float(), v.to(bf16).float()
    )
    return num, m, p.sum(dim=-1)


def block_attention(q, k, v, q_offset: int = 0, k_offset: int = 0,
                    causal: bool = True):
    """K3: ``(num [B, Sq, H, D], m [B, Sq, H], l [B, Sq, H])``, fp32, on
    q's device, for contiguous fp32 ``q [B, Sq, H, D]`` and
    ``k, v [B, Sk, H, D]`` with D a multiple of 8 up to 128."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, q_offset, k_offset, causal)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(
                "block_attention: inputs must be 16-byte aligned"
            )
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    lib = load_library()
    num = torch.empty_like(q)
    m = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    code = lib.attention_block_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        num.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, Sq, Sk, H, D,
        int(q_offset), int(k_offset), int(bool(causal)), D**-0.5,
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(lib, code, "block_attention")
    block_attention.launches += 1
    return num, m, l


block_attention.launches = 0
