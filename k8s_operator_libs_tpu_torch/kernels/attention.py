"""Wrapper of ring attention's block kernel (K3), with its plain version.

``block_attention(q, k, v, q_offset, k_offset, causal)`` returns the
unnormalised online-softmax contribution ``(num, m, l)`` of one kv block
to one q block, as ``_block_attention`` of the JAX package does, with the
causal mask given by the blocks' global offsets: query ``i`` sees key
``j`` iff ``q_offset + i >= k_offset + j``.

``block_attention_merge_(acc_num, acc_m, acc_l, q, k, v, q_offset,
k_offset, causal)`` is the ring's whole step: the same block contribution
folded into the running online-softmax accumulator in place, as
``_merge`` of the JAX package does (:func:`merge_plain`), in one launch.

The wrappers check their inputs, then take the plain PyTorch version only
for tensors on the CPU; for CUDA tensors they launch the kernel
(``csrc/attention_kernels.cu``) on the current stream or raise.
``block_attention.launches`` counts the launches of both entries, and
``block_attention_merge_.launches`` those of the fused entry alone.
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


def _check_aligned(*tensors) -> None:
    # The kernel moves q, k, v and num as 16-byte vectors.
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                "block_attention: inputs must be 16-byte aligned"
            )


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


def merge_plain(acc_num, acc_m, acc_l, num, m, l):
    """Merge a block's ``(num, m, l)`` into the online-softmax
    accumulator (``_merge`` of the JAX package); returns new tensors."""
    new_m = torch.maximum(acc_m, m)
    a = torch.exp(acc_m - new_m)
    b = torch.exp(m - new_m)
    return (
        acc_num * a[..., None] + num * b[..., None],
        new_m,
        acc_l * a + l * b,
    )


def block_attention_merge_plain(acc_num, acc_m, acc_l, q, k, v,
                                q_offset: int = 0, k_offset: int = 0,
                                causal: bool = True):
    """Plain version of the fused ring step: :func:`block_attention_plain`
    followed by :func:`merge_plain`, written into the accumulator."""
    merged = merge_plain(
        acc_num, acc_m, acc_l,
        *block_attention_plain(q, k, v, q_offset, k_offset, causal),
    )
    for acc, new in zip((acc_num, acc_m, acc_l), merged):
        acc.copy_(new)
    return acc_num, acc_m, acc_l


def block_attention(q, k, v, q_offset: int = 0, k_offset: int = 0,
                    causal: bool = True):
    """K3: ``(num [B, Sq, H, D], m [B, Sq, H], l [B, Sq, H])``, fp32, on
    q's device, for contiguous fp32 ``q [B, Sq, H, D]`` and
    ``k, v [B, Sk, H, D]`` with D a multiple of 8 up to 128."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, q_offset, k_offset, causal)
    _check_aligned(q, k, v)
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


def block_attention_merge_(acc_num, acc_m, acc_l, q, k, v,
                           q_offset: int = 0, k_offset: int = 0,
                           causal: bool = True):
    """The ring step in one launch: K3's ``(num, m, l)`` for ``q``
    against ``k, v``, merged in place into the fp32 accumulator
    ``acc_num [B, Sq, H, D]``, ``acc_m, acc_l [B, Sq, H]`` on q's device
    (which must not overlap the inputs); returns the accumulator.  Given
    the same ``(num, m, l)``, the kernel's merge rounds as
    :func:`merge_plain` does on the card, operation by operation."""
    _check_inputs(q, k, v)
    B, Sq, H, D = q.shape
    for name, t, shape in (("acc_num", acc_num, (B, Sq, H, D)),
                           ("acc_m", acc_m, (B, Sq, H)),
                           ("acc_l", acc_l, (B, Sq, H))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(
                f"block_attention_merge_: {name} must be a float32 tensor"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"block_attention_merge_: {name} must be a contiguous "
                f"{list(shape)} tensor, got {tuple(t.shape)}"
            )
        if t.device != q.device:
            raise ValueError(
                f"block_attention_merge_: {name} is on {t.device}, q on "
                f"{q.device}"
            )
    if q.device.type == "cpu":
        return block_attention_merge_plain(acc_num, acc_m, acc_l, q, k, v,
                                           q_offset, k_offset, causal)
    _check_aligned(q, k, v, acc_num)
    lib = load_library()
    code = lib.attention_block_merge_f32(
        acc_num.data_ptr(), acc_m.data_ptr(), acc_l.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        B, Sq, k.shape[1], H, D,
        int(q_offset), int(k_offset), int(bool(causal)), D**-0.5,
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(lib, code, "block_attention_merge_")
    block_attention.launches += 1
    block_attention_merge_.launches += 1
    return acc_num, acc_m, acc_l


block_attention_merge_.launches = 0
