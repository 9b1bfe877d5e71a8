"""The node battery's known answers, computed afresh.

Each of a node's members runs the same battery (the configuration's
``battery``): a chain of 8 products ``C <- C @ B`` from ``A = 0.5`` and
``B = 1/n`` (bf16 operands, fp32 accumulation, the product stored in
bf16), 8 passes ``x <- x + 1`` over an fp32 buffer of ``hbm_mib`` MiB
from zero, 4 rounds ``s <- (s_0 + ... + s_{m-1}) / m`` of a ramp whose
member ``i`` starts at ``i + 1``, and one ring shift of the value ``i``
to member ``i + 1`` (with one member: no round and no shift).

A member's row is ``[min C, max C, max |C - 0.5|, min x, max x, max |x|,
s_i[0], ring_i]``.

A plant ``(kind, member, index, value)`` sets one input element of one
member before the battery runs: ``"stream"`` the buffer's element
``index``, ``"ramp"`` the ramp's first element, ``"ring"`` the ring's
value.  The rows then follow from the planted inputs as from any other.
"""

from __future__ import annotations

import torch

from reference.rounding import exact_fp32, round_to

MATMUL_CHAIN = 8
STREAM_PASSES = 8
PSUM_ROUNDS = 4


def expected_rows(members: int, matmul_n: int, hbm_mib: int,
                  device, precision: str = "bf16",
                  plant: tuple | None = None) -> list[list[float]]:
    """Every member's row at these sizes, computed on ``device``, from
    the stated inputs with ``plant`` applied.  With ``precision="fp8"``
    (the control) the chain's operands and products are plain e4m3
    casts: the battery scales nothing."""
    kind, planted, index, value = plant or (None, -1, 0, 0.0)
    n = matmul_n
    store = torch.bfloat16 if precision == "bf16" else torch.float8_e4m3fn
    with exact_fp32():
        a = torch.full((n, n), 0.5, device=device)
        b = round_to(torch.full((n, n), 1.0 / n, device=device), precision,
                     scaled=False)
        c = round_to(a, precision, scaled=False)
        for _ in range(MATMUL_CHAIN):
            c = torch.matmul(c, b).to(store).float()
        c_row = [float(c.min()), float(c.max()), float((c - 0.5).abs().max())]
        del a, b, c
    elems = stream_elems(hbm_mib)
    x_row = stream_row(elems, device)
    x_rows = [stream_row(elems, device, index, value)
              if kind == "stream" and i == planted else x_row
              for i in range(members)]
    s = [float(i + 1) for i in range(members)]
    ring = [float(i) for i in range(members)]
    if kind == "ramp":
        s[planted] = float(value)
    elif kind == "ring":
        ring[planted] = float(value)
    if members >= 2:
        for _ in range(PSUM_ROUNDS):
            total = torch.zeros((), dtype=torch.float32)
            for v in s:  # in member order, in fp32, as stated
                total = total + torch.tensor(v, dtype=torch.float32)
            s = [float(total / members)] * members
        ring = [ring[(i - 1) % members] for i in range(members)]
    return [c_row + x_rows[i] + [s[i], ring[i]] for i in range(members)]


def stream_elems(hbm_mib: int) -> int:
    return max(1, (hbm_mib * 1024 * 1024) // 4)


def stream_row(elems: int, device, index: int = 0,
               value: float | None = None) -> list[float]:
    """``[min x, max x, max |x|]`` after the passes over a zeroed buffer
    (with ``value`` at ``index``)."""
    x = torch.zeros(elems, dtype=torch.float32, device=device)
    if value is not None:
        x[index] = value
    for _ in range(STREAM_PASSES):
        x += 1.0
    return [float(x.min()), float(x.max()), float(x.abs().max())]


# The check each entry of a row answers.
ENTRY_CHECK = ("mxu_matmul",) * 3 + ("hbm_bandwidth",) * 3 + (
    "ici_allreduce", "ici_ring")


def failing_checks(rows: list, want: list) -> set:
    """The checks a battery with these rows has to fail: those with an
    entry that differs from the reference's (every one, when a member's
    row is missing)."""
    if len(rows) != len(want):
        return set(ENTRY_CHECK)
    bad = set()
    for got, w in zip(rows, want):
        if len(got) != len(w):
            return set(ENTRY_CHECK)
        bad |= {c for c, g, x in zip(ENTRY_CHECK, got, w) if g != x}
    return bad


def row_gap(got: list, want: list) -> float:
    """The widest gap between a row the port returned and the reference's
    (infinite when a value is missing or not a number)."""
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for g, w in zip(got, want):
        d = abs(float(g) - float(w))
        if d != d:  # NaN
            return float("inf")
        worst = max(worst, d)
    return worst
