"""Robust fleet baselines for measured probe telemetry.

Pure math, no I/O and no Kubernetes types: the telemetry plane
(obs/telemetry.py) feeds per-node representative stats in and gets
per-(generation, pool) baselines, per-node badness and health scores
back.  Everything here is deliberately boring and deterministic so the
straggler verdict is explainable from the CR status alone:

- **median + MAD** per cohort and stat.  Median absolute deviation is
  the textbook robust scale estimate — a single degraded node cannot
  drag the baseline toward itself the way a mean/stddev pair would,
  which is exactly the failure mode a straggler detector must not have.
- **robust z-score** ``0.6745 * (x - median) / MAD`` (the 0.6745
  factor makes MAD consistent with the standard deviation under
  normality, so the configured threshold reads like a familiar
  z-score).
- **orientation map**: throughput stats (TFLOPs, GB/s, bus GB/s, MFU)
  are lower-is-worse; latency stats (battery execute ms) are
  higher-is-worse.  Stats outside the map ride the history and the
  ``probe_measured`` metric family but never feed a verdict — an
  unknown key must not be able to quarantine a node.
- **minimum-cohort guard**: a cohort smaller than ``min_cohort`` nodes
  produces no baseline and therefore no verdicts — two nodes cannot
  meaningfully out-vote each other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

# Consistency factor: MAD * 1.4826 ≈ stddev under normality, i.e.
# z = 0.6745 * (x - median) / MAD.
MAD_TO_SIGMA = 0.6745

# Stat name → orientation.  -1: lower-is-worse (throughput), +1:
# higher-is-worse (latency/duration).  Anything absent is informational
# only and never contributes to badness.
STAT_ORIENTATION: Dict[str, int] = {
    "tflops": -1,
    "mfu": -1,
    "gbps": -1,
    "busbw_gbps": -1,
    "battery_execute_ms": +1,
}

# Default minimum cohort size before a (generation, pool) baseline is
# trusted for verdicts.
DEFAULT_MIN_COHORT = 4


def median(values: Iterable[float]) -> float:
    """Plain middle-value median (mean of the middle pair for even n).

    Raises ValueError on an empty input — callers guard with the
    min-cohort check first.
    """
    ordered = sorted(float(v) for v in values)
    n = len(ordered)
    if n == 0:
        raise ValueError("median of empty sequence")
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return (ordered[mid - 1] + ordered[mid]) / 2.0


def mad(values: Iterable[float], med: Optional[float] = None) -> float:
    """Median absolute deviation around ``med`` (computed if omitted)."""
    vals = [float(v) for v in values]
    if med is None:
        med = median(vals)
    return median(abs(v - med) for v in vals)


@dataclass(frozen=True)
class BaselineStat:
    """One cohort's robust location/scale for one measured stat."""

    median: float
    mad: float
    count: int

    def zscore(self, value: float) -> float:
        """Robust z of ``value`` against this baseline.

        A zero MAD (identical cohort) gets a tiny relative floor so the
        division is defined: identical nodes score z == 0 exactly, while
        a node 25% off an otherwise-identical cohort still produces a
        huge |z| and flags.  The floor scales with the median so the
        units of the stat don't matter.
        """
        scale = max(self.mad, abs(self.median) * 1e-6 + 1e-9)
        return MAD_TO_SIGMA * (value - self.median) / scale


def compute_baselines(
    node_stats: Mapping[str, Mapping[str, float]],
    node_cohort: Mapping[str, Tuple[str, str]],
    min_cohort: int = DEFAULT_MIN_COHORT,
) -> Dict[Tuple[str, str], Dict[str, BaselineStat]]:
    """Fold per-node representative stats into per-cohort baselines.

    ``node_stats``: node name → {stat: value} (each node's ring median).
    ``node_cohort``: node name → (generation, pool).  Nodes missing
    from the cohort map are skipped.  Cohorts with fewer than
    ``min_cohort`` contributing nodes for a stat produce no baseline
    for that stat.
    """
    per_cohort: Dict[Tuple[str, str], Dict[str, list]] = {}
    for node, stats in node_stats.items():
        cohort = node_cohort.get(node)
        if cohort is None:
            continue
        bucket = per_cohort.setdefault(cohort, {})
        for stat, value in stats.items():
            try:
                bucket.setdefault(stat, []).append(float(value))
            except (TypeError, ValueError):
                continue
    out: Dict[Tuple[str, str], Dict[str, BaselineStat]] = {}
    for cohort, stats in per_cohort.items():
        folded: Dict[str, BaselineStat] = {}
        for stat, values in stats.items():
            if len(values) < min_cohort:
                continue
            med = median(values)
            folded[stat] = BaselineStat(
                median=med, mad=mad(values, med), count=len(values)
            )
        if folded:
            out[cohort] = folded
    return out


def node_badness(
    stats: Mapping[str, float],
    baseline: Mapping[str, BaselineStat],
) -> Tuple[float, Dict[str, float]]:
    """Per-node badness against a cohort baseline.

    Badness per stat is the robust z oriented so that positive means
    *worse than the cohort* regardless of whether the stat is a
    throughput (lower-is-worse) or a duration (higher-is-worse).
    Returns ``(worst_badness, {stat: badness})`` over the oriented
    stats only; both are empty/0.0 when nothing overlaps the baseline.
    """
    per_stat: Dict[str, float] = {}
    for stat, value in stats.items():
        orientation = STAT_ORIENTATION.get(stat)
        if orientation is None:
            continue
        base = baseline.get(stat)
        if base is None:
            continue
        try:
            z = base.zscore(float(value))
        except (TypeError, ValueError):
            continue
        per_stat[stat] = orientation * z
    worst = max(per_stat.values(), default=0.0)
    return worst, per_stat


def health_score(badness: float) -> float:
    """Map badness to a 0–100 health score.

    At-or-better-than-baseline scores 100; each badness unit (robust
    sigma) costs 12.5 points, bottoming out at 0 beyond 8 sigma.  The
    scale is chosen so the default straggler threshold (3 sigma) reads
    as a 62.5 score — visibly degraded but not yet zero.
    """
    return max(0.0, 100.0 - 12.5 * max(0.0, badness))
