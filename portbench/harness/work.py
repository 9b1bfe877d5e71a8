"""The work a call needs, counted from its algorithm and sizes, and the
card's published peaks.

A roofline share is the least time the work needs on the card (the
larger of bytes over peak bandwidth and operations over the peak of the
type they are computed in) over the device time it took.  Every count
here is of what the algorithm needs, whatever implements it: each input
byte read once, each output byte written once.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA's data sheet for the H100 SXM5 80 GB (dense, no sparsity), at its
# full 700 W.  TF32 is the tensor cores' rate on fp32 operands.
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of a card by its ``torch.cuda`` name, or None
    for a card this table does not hold (no share is then reported)."""
    name = (device_name or "").lower()
    if "h100" in name and ("hbm3" in name or "sxm" in name):
        return H100_SXM
    return None


# -- the battery (health/fused.py's algorithm) ------------------------------

MATMUL_CHAIN = 8  # C <- C @ B, bf16 operands, fp32 accumulation
STREAM_PASSES = 8  # x <- x + 1 over the fp32 buffer
PSUM_ROUNDS = 4  # s <- all_reduce(s) / n
BF16 = 2
FP32 = 4


def battery_work(members: int, matmul_n: int, hbm_mib: int,
                 allreduce_elems: int) -> dict:
    """One battery over ``members``: bf16 flops and bytes.

    Per member: the GEMM chain reads both operands and writes the
    product of each of its 8 products; the stream reads and writes the
    buffer once a pass; the check of C reads it once.  The check of x
    needs no pass of its own: it rides on the stream's last pass.  With
    two members or more, each all-reduce round reads and writes every
    member's ramp once, and the ring moves one value a member."""
    n = matmul_n
    elems = (hbm_mib * 1024 * 1024) // FP32
    flops = MATMUL_CHAIN * 2.0 * n**3
    gemm_bytes = MATMUL_CHAIN * 3.0 * n * n * BF16
    stream_bytes = STREAM_PASSES * 2.0 * elems * FP32
    check_bytes = n * n * BF16
    per_member = gemm_bytes + stream_bytes + check_bytes
    coll_bytes = 0.0
    if members >= 2:
        coll_bytes = PSUM_ROUNDS * 2.0 * allreduce_elems * FP32 + 2.0 * FP32
    return {
        "bf16_flops": members * flops,
        "bytes": members * (per_member + coll_bytes),
    }


# -- the deep probe (workloads/ring_attention.py's soak) -------------------

DEEP_SEQ_PER_MEMBER = 128
DEEP_BATCH, DEEP_HEADS, DEEP_HEAD_DIM = 1, 4, 64
# The soak's attention passes: the checked ring pass, the single-member
# full attention it is checked against, and the timed ring pass.
DEEP_PASSES = 3


def deep_probe_work(members: int) -> dict:
    """The deep probe's causal attention passes over the ring's global
    sequence: bf16 flops of q·k and p·v over the causal half, and q, k,
    v read and the output written once a pass (fp32)."""
    if members < 2:
        return {"bf16_flops": 0.0, "bytes": 0.0}
    s = DEEP_SEQ_PER_MEMBER * members
    bhd = DEEP_BATCH * DEEP_HEADS * DEEP_HEAD_DIM
    flops = 2.0 * 2.0 * bhd * s * s / 2.0
    nbytes = 4.0 * s * bhd * FP32
    return {"bf16_flops": DEEP_PASSES * flops, "bytes": DEEP_PASSES * nbytes}


def least_time_s(work: dict, peak: dict, dtype: str = "bf16") -> float:
    """The larger of bytes over bandwidth and flops over the type's peak."""
    return max(work["bytes"] / peak["hbm_bytes_per_s"],
               work["bf16_flops"] / peak["flops_per_s"][dtype])


# -- the canary (workloads/canary.py's decoder LM) -------------------------


def canary_params(vocab: int, d_model: int, n_layers: int, d_ff: int) -> int:
    """Parameters: the embedding, per layer q|k|v, the projection, the
    MLP's two matrices and two norm gains, the final norm and the output."""
    d = d_model
    per_layer = 3 * d * d + d * d + 2 * d * d_ff + 2 * d
    return vocab * d + n_layers * per_layer + d + d * vocab


def canary_flops_per_step(vocab: int, d_model: int, n_heads: int,
                          n_layers: int, d_ff: int, seq_len: int,
                          batch: int) -> float:
    """Training flops of one step: 6·N·tokens for the products, plus
    12·L·B·S²·D for attention, forward and backward (the PaLM appendix's
    convention, as ``CanaryRunner.flops_per_step`` counts them)."""
    del n_heads  # the attention term does not depend on the head count
    n = canary_params(vocab, d_model, n_layers, d_ff)
    tokens = batch * seq_len
    return 6.0 * n * tokens + 12.0 * n_layers * batch * seq_len**2 * d_model
