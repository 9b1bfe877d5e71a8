"""Critical-path makespan attribution over a completed roll trace.

Answers the operator question "the roll took 40 minutes — where did
they go?" by walking the span tree backward from roll completion:

- at every point in time the walk picks the **latest-finishing
  activity** (phase or wait span) that explains the interval ending at
  the current frontier, preferring wait spans over phase spans when
  both cover it (a wait is the more specific explanation);
- the chosen interval's seconds are charged to that activity's
  **bucket** — phase-time, budget-wait, window-hold, quarantine,
  negotiation, API-retry — and uncovered gaps are charged to idle;
- the frontier jumps to the chosen activity's start and the walk
  repeats until it reaches the roll start.

By construction the bucket totals sum **exactly** to the measured
makespan (each frontier decrement charges precisely its length), which
is what lets the acceptance gate check ``sum(buckets) == makespan``.

The per-phase actuals are then compared against the
``PhaseClocks``/plan projection, and the top drift contributors are
published into CR status (``makespanBreakdown``), metrics, and the
``make trace`` / status-CLI rendering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.obs.trace import (
    KIND_GROUP,
    KIND_PHASE,
    KIND_ROLL,
    KIND_WAIT,
    WAIT_API_RETRY,
    WAIT_BUDGET,
    WAIT_NEGOTIATE,
    WAIT_QUARANTINE,
    WAIT_RUNG_PREFIX,
    WAIT_WINDOW,
    CompletedTrace,
    Span,
)

# Makespan buckets + the structural remainder.
BUCKET_PHASE = "phase"
BUCKET_BUDGET = "budget_wait"
BUCKET_WINDOW = "window_hold"
BUCKET_QUARANTINE = "quarantine"
BUCKET_NEGOTIATION = "negotiation"
BUCKET_API_RETRY = "api_retry"
BUCKET_IDLE = "idle"
ALL_BUCKETS = (
    BUCKET_PHASE,
    BUCKET_BUDGET,
    BUCKET_WINDOW,
    BUCKET_QUARANTINE,
    BUCKET_NEGOTIATION,
    BUCKET_API_RETRY,
    BUCKET_IDLE,
)

_WAIT_BUCKET = {
    WAIT_BUDGET: BUCKET_BUDGET,
    WAIT_WINDOW: BUCKET_WINDOW,
    WAIT_QUARANTINE: BUCKET_QUARANTINE,
    WAIT_NEGOTIATE: BUCKET_NEGOTIATION,
    WAIT_API_RETRY: BUCKET_API_RETRY,
}

_BUCKET_CAMEL = {
    BUCKET_PHASE: "phaseSeconds",
    BUCKET_BUDGET: "budgetWaitSeconds",
    BUCKET_WINDOW: "windowHoldSeconds",
    BUCKET_QUARANTINE: "quarantineSeconds",
    BUCKET_NEGOTIATION: "negotiationSeconds",
    BUCKET_API_RETRY: "apiRetrySeconds",
    BUCKET_IDLE: "idleSeconds",
}


def bucket_of(span: Span) -> Optional[str]:
    """Bucket for an activity span; None for structural spans."""
    if span.kind == KIND_PHASE:
        return BUCKET_PHASE
    if span.kind != KIND_WAIT:
        return None
    reason = span.name
    if reason.startswith("wait:"):
        reason = reason[len("wait:"):]
    if reason.startswith(WAIT_RUNG_PREFIX):
        # Eviction-ladder rungs are drain work, finer-grained: they
        # refine WHERE phase time went, not a different bucket.
        return BUCKET_PHASE
    return _WAIT_BUCKET.get(reason, BUCKET_PHASE)


def _pool_of_span(span: Span) -> str:
    # Deterministic ids are "<trace>/<pool>/..." paths; trace ids never
    # contain '/'.
    parts = span.span_id.split("/")
    return parts[1] if len(parts) > 1 else ""


@dataclass
class PathSegment:
    """One critical-path interval attributed to a span (or to idle)."""

    span_id: Optional[str]
    name: str
    bucket: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return max(0.0, self.end - self.start)


@dataclass
class Attribution:
    trace_id: str
    makespan: float
    buckets: dict = field(default_factory=dict)
    segments: list = field(default_factory=list)  # list[PathSegment]
    # (pool, phase state value) -> [per-group durations]
    phase_samples: dict = field(default_factory=dict)
    group_count: int = 0

    def bucket_total(self) -> float:
        return sum(self.buckets.values())


def analyze(trace: CompletedTrace) -> Attribution:
    """Walk the completed span tree; charge every makespan second to a
    bucket.  Bucket totals sum exactly to the makespan."""
    out = Attribution(trace_id=trace.trace_id, makespan=trace.makespan)
    out.buckets = {b: 0.0 for b in ALL_BUCKETS}
    start, end = trace.start, trace.end
    activities = []
    for span in trace.spans:
        if span.kind == KIND_GROUP:
            out.group_count += 1
        if span.kind == KIND_PHASE and span.end is not None:
            key = (_pool_of_span(span), span.name)
            out.phase_samples.setdefault(key, []).append(
                span.duration()
            )
        b = bucket_of(span)
        if b is None or span.end is None:
            continue
        a_start = max(span.start, start)
        a_end = min(span.end, end)
        if a_end <= start or a_start >= end:
            continue
        activities.append((a_start, a_end, b, span))
    if end <= start:
        return out
    frontier = end
    eps = 1e-9
    max_steps = 4 * len(activities) + 16
    steps = 0
    while frontier > start + eps and steps < max_steps:
        steps += 1
        best = None
        best_key = None
        for (a_start, a_end, b, span) in activities:
            if a_start >= frontier - eps:
                continue
            cover = min(a_end, frontier)
            if cover <= start:
                continue
            # Latest-finishing first; prefer waits; then earliest start
            # (one long segment beats many slivers).
            key = (cover, span.kind == KIND_WAIT, -a_start)
            if best_key is None or key > best_key:
                best_key = key
                best = (a_start, a_end, b, span)
        if best is None:
            out.buckets[BUCKET_IDLE] += frontier - start
            out.segments.append(
                PathSegment(None, "idle", BUCKET_IDLE, start, frontier)
            )
            frontier = start
            break
        a_start, a_end, b, span = best
        cover = min(a_end, frontier)
        if cover < frontier - eps:
            out.buckets[BUCKET_IDLE] += frontier - cover
            out.segments.append(
                PathSegment(None, "idle", BUCKET_IDLE, cover, frontier)
            )
        seg_start = max(a_start, start)
        out.buckets[b] += cover - seg_start
        out.segments.append(
            PathSegment(span.span_id, span.name, b, seg_start, cover)
        )
        frontier = seg_start
    if frontier > start + eps:
        # Step-capped (pathological tree): close the books as idle so
        # the sum-to-makespan invariant still holds.
        out.buckets[BUCKET_IDLE] += frontier - start
        out.segments.append(
            PathSegment(None, "idle", BUCKET_IDLE, start, frontier)
        )
    out.segments.reverse()  # chronological
    return out


@dataclass
class DriftContributor:
    pool: str
    phase: str
    expected_s: float
    actual_s: float
    samples: int

    @property
    def excess_s(self) -> float:
        """Total seconds of drift this (pool, phase) contributed."""
        return (self.actual_s - self.expected_s) * self.samples


def phase_drift(
    attribution: Attribution,
    expected: Callable[[str, str], Optional[float]],
    top: int = 5,
) -> list:
    """Compare per-(pool, phase) actual means against the projection.

    ``expected(pool, state_value)`` returns the projected seconds for a
    group in that phase (PhaseClocks/plan), or None when unprojected.
    Returns the ``top`` contributors ordered by absolute total excess.
    """
    contributors = []
    for (pool, phase), samples in attribution.phase_samples.items():
        if not samples:
            continue
        try:
            exp = expected(pool, phase)
        except Exception:  # noqa: BLE001 — projections are advisory
            exp = None
        if exp is None:
            continue
        actual = sum(samples) / len(samples)
        contributors.append(
            DriftContributor(
                pool=pool or "default",
                phase=phase,
                expected_s=exp,
                actual_s=actual,
                samples=len(samples),
            )
        )
    contributors.sort(key=lambda c: abs(c.excess_s), reverse=True)
    return contributors[:top]


def expected_from_tracker(clock_tracker, base=None):
    """Adapt a ``PhaseClockTracker`` into the ``expected(pool, state)``
    callable :func:`phase_drift` wants (None when the tracker lacks a
    clock for that phase)."""
    from k8s_operator_libs_tpu_torch.planning.clocks import PHASE_OF_STATE

    def expected(pool: str, state_value: str) -> Optional[float]:
        attr = PHASE_OF_STATE.get(state_value)
        if attr is None:
            return None
        pool_key = "" if pool in ("", "default") else pool
        clocks = clock_tracker.clocks_for(pool_key, base)
        return getattr(clocks, attr, None)

    return expected


def makespan_breakdown(
    attribution: Attribution,
    drift: Optional[list] = None,
    top_segments: int = 5,
) -> dict:
    """CR-status-shaped ``makespanBreakdown`` block."""
    segs = sorted(
        (s for s in attribution.segments if s.span_id is not None),
        key=lambda s: s.seconds,
        reverse=True,
    )[:top_segments]
    out = {
        "traceId": attribution.trace_id,
        "makespanSeconds": round(attribution.makespan, 3),
        "groups": attribution.group_count,
        "buckets": {
            _BUCKET_CAMEL[b]: round(v, 3)
            for b, v in attribution.buckets.items()
        },
        "criticalPath": [
            {
                "span": s.name,
                "bucket": _BUCKET_CAMEL[s.bucket],
                "seconds": round(s.seconds, 3),
            }
            for s in segs
        ],
    }
    if drift:
        out["topDrift"] = [
            {
                "pool": c.pool,
                "phase": c.phase,
                "expectedSeconds": round(c.expected_s, 3),
                "actualSeconds": round(c.actual_s, 3),
                "excessSeconds": round(c.excess_s, 3),
            }
            for c in drift
        ]
    return out


def render_tree(trace: CompletedTrace, max_spans: int = 400) -> str:
    """ASCII rendering of a completed roll's span tree (``make trace``
    and the status CLI)."""
    children: dict[Optional[str], list[Span]] = {}
    by_id = {s.span_id: s for s in trace.spans}
    for span in trace.spans:
        parent = span.parent_id if span.parent_id in by_id else None
        children.setdefault(parent, []).append(span)
    for kids in children.values():
        kids.sort(key=lambda s: (s.start, s.span_id))
    lines: list[str] = []
    origin = trace.start

    def emit(span: Span, depth: int) -> None:
        if len(lines) >= max_spans:
            return
        dur = span.duration(trace.end)
        mark = "" if span.end is not None else "  [OPEN]"
        offset = span.start - origin
        extra = ""
        if span.kind == KIND_WAIT:
            extra = ""
        elif span.attrs.get("reopened"):
            extra = "  (reopened)"
        lines.append(
            f"{'  ' * depth}{span.kind:<6} {span.name:<28} "
            f"+{offset:8.3f}s  {dur:8.3f}s{mark}{extra}"
        )
        for kid in children.get(span.span_id, ()):
            emit(kid, depth + 1)

    roots = children.get(None, [])
    roots.sort(key=lambda s: (s.kind != KIND_ROLL, s.start))
    for root in roots:
        emit(root, 0)
    if len(lines) >= max_spans:
        lines.append(f"... ({len(trace.spans)} spans total, truncated)")
    return "\n".join(lines)


def render_breakdown(breakdown: dict) -> str:
    """Human rendering of a ``makespanBreakdown`` block."""
    lines = [
        f"trace     {breakdown.get('traceId', '?')}",
        f"makespan  {breakdown.get('makespanSeconds', 0.0):.3f}s over "
        f"{breakdown.get('groups', 0)} group(s)",
        "buckets:",
    ]
    for key, val in (breakdown.get("buckets") or {}).items():
        lines.append(f"  {key:<22} {val:10.3f}s")
    path = breakdown.get("criticalPath") or []
    if path:
        lines.append("critical path (top contributors):")
        for seg in path:
            lines.append(
                f"  {seg['span']:<28} {seg['seconds']:8.3f}s"
                f"  [{seg['bucket']}]"
            )
    drift = breakdown.get("topDrift") or []
    if drift:
        lines.append("top drift vs projection:")
        for c in drift:
            lines.append(
                f"  {c['pool']}/{c['phase']:<24} expected "
                f"{c['expectedSeconds']:7.3f}s actual "
                f"{c['actualSeconds']:7.3f}s excess "
                f"{c['excessSeconds']:+8.3f}s"
            )
    return "\n".join(lines)
