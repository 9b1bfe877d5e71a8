"""Fleet health telemetry plane: durable per-node probe history,
robust baselines, health scores and straggler verdicts.

Every probe battery (fused or classic) measures real throughput — MXU
TFLOPs, HBM GB/s, ICI bus bandwidth, battery execute time — and until
now threw the numbers away the moment they cleared a static floor.
This module keeps them:

- **Capture**: the validation manager hands every ProbeResult's
  measured per-node stats to :meth:`TelemetryPlane.observe_validation`
  (fail-open — telemetry can never fail a gate).
- **Durability**: each node's last K samples ride the existing
  combined state-label patch as one bounded ring annotation
  (:meth:`annotation_source` is a provider transition-annotation
  source, the same mechanism as the trace anchor), so history costs
  **zero extra API write verbs** and survives controller restarts:
  :meth:`adopt_node` re-seeds rings from annotations on adoption,
  deduplicating by sample sequence number.  The ring is longitudinal —
  unlike the trace anchor it is never cleared on terminal states.
- **Baselines & verdicts**: :meth:`recompute` folds ring medians into
  per-(generation, pool) median+MAD baselines (obs/baseline.py) and
  maintains a per-node consecutive-battery streak; a node flags as a
  straggler only after ``confirm_batteries`` consecutive samples beyond
  ``z_threshold`` robust sigmas — one slow battery never flags.

Everything is observe-only by default.  The design rules match the
rest of ``obs/``: fail-open (a telemetry bug degrades to missing data,
never to a wedged roll — ``drops`` counts swallowed errors), no wall
clocks in verdict math, and no new upgrade states.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import node_accelerator
from k8s_operator_libs_tpu_torch.obs.baseline import (
    DEFAULT_MIN_COHORT,
    BaselineStat,
    compute_baselines,
    health_score,
    median,
    node_badness,
)

logger = get_logger(__name__)

# Ring wire format version (annotation payload).
RING_VERSION = 1

# Stat → probe check attribution for the probe_measured metric family.
# Stats outside this map are attributed to the battery as a whole.
STAT_CHECK: Dict[str, str] = {
    "tflops": "mxu_matmul",
    "mfu": "mxu_matmul",
    "gbps": "hbm_bandwidth",
    "busbw_gbps": "ici_allreduce",
}
_BATTERY_CHECK = "fused_battery"


def _failopen(method):
    """Observability must never take down the roll: swallow, count,
    keep going (same contract as obs/trace.py)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        try:
            return method(self, *args, **kwargs)
        except Exception:  # noqa: BLE001 — deliberate fail-open
            self.drops += 1
            logger.debug(
                "telemetry drop in %s", method.__name__, exc_info=True
            )
            return None

    return wrapper


def format_ring(samples: List[Tuple[int, float, Dict[str, float]]]) -> str:
    """Serialize a ring to its compact annotation payload."""
    return json.dumps(
        {
            "v": RING_VERSION,
            "s": [
                [
                    int(seq),
                    round(float(epoch), 3),
                    {k: round(float(v), 3) for k, v in metrics.items()},
                ]
                for seq, epoch, metrics in samples
            ],
        },
        separators=(",", ":"),
        sort_keys=True,
    )


def parse_ring(raw: object) -> List[Tuple[int, float, Dict[str, float]]]:
    """Parse a ring annotation; garbage reads as an empty history
    (adoption is fail-open — a corrupt annotation must not wedge)."""
    if not raw or not isinstance(raw, str):
        return []
    try:
        data = json.loads(raw)
        samples = data.get("s") or []
        out = []
        for entry in samples:
            seq, epoch, metrics = entry[0], entry[1], entry[2]
            out.append(
                (
                    int(seq),
                    float(epoch),
                    {
                        str(k): float(v)
                        for k, v in dict(metrics).items()
                    },
                )
            )
        out.sort(key=lambda s: s[0])
        return out
    except (ValueError, TypeError, KeyError, IndexError, AttributeError):
        return []


class TelemetryPlane:
    """Longitudinal per-node health from measured probe telemetry."""

    def __init__(
        self,
        history_len: int = 8,
        z_threshold: float = 3.0,
        confirm_batteries: int = 3,
        min_cohort: int = DEFAULT_MIN_COHORT,
        epoch_clock: Callable[[], float] = time.time,
    ) -> None:
        self.history_len = history_len
        self.z_threshold = z_threshold
        self.confirm_batteries = confirm_batteries
        self.min_cohort = min_cohort
        self.epoch_clock = epoch_clock
        # Set by the manager's wiring (UpgradeKeys.telemetry_history_
        # annotation); None leaves the plane in-memory only.
        self.annotation_key: Optional[str] = None
        # Swallowed-error count (fail-open contract).
        self.drops = 0
        self.samples_total = 0
        self._lock = threading.RLock()
        # node → sorted [(seq, epoch, {stat: value})], bounded.
        self._rings: Dict[str, List[Tuple[int, float, Dict[str, float]]]] = {}
        self._next_seq: Dict[str, int] = {}
        # Nodes whose ring has samples not yet persisted to the
        # annotation (a crash before the next transition loses at most
        # these — fail-open by design).
        self._dirty: set = set()
        self._node_pool: Dict[str, str] = {}
        self._node_generation: Dict[str, str] = {}
        # Verdict state (rebuilt from rings by recompute()).
        self._streak: Dict[str, int] = {}
        self._last_scored_seq: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        self._badness: Dict[str, Dict[str, float]] = {}
        self._confirmed: Dict[str, dict] = {}
        self._reported: set = set()
        self._baselines: Dict[
            Tuple[str, str], Dict[str, BaselineStat]
        ] = {}

    # ------------------------------------------------------------------
    # capture

    def seed_pools(self, node_pool: Mapping[str, str]) -> None:
        """Refresh node → pool attribution (same feed as the phase
        clocks and the trace recorder get each full pass)."""
        with self._lock:
            self._node_pool.update(
                {str(k): str(v or "") for k, v in node_pool.items()}
            )

    @_failopen
    def observe_validation(self, group, result) -> None:
        """Validation-manager sink: record one battery's measured
        per-node stats.  Called for every probe verdict (healthy or
        not) on both the sync and async paths."""
        telemetry = getattr(result, "telemetry", None)
        if not telemetry:
            return
        generations = {}
        for node in getattr(group, "nodes", []) or []:
            gen = node_accelerator(node)
            if gen:
                generations[node.name] = gen
        now = self.epoch_clock()
        for node_name, stats in telemetry.items():
            if not stats:
                continue
            self.ingest(
                node_name,
                stats,
                generation=generations.get(node_name, ""),
                now_epoch=now,
            )

    def ingest(
        self,
        node_name: str,
        metrics: Mapping[str, float],
        generation: str = "",
        pool: Optional[str] = None,
        now_epoch: Optional[float] = None,
    ) -> None:
        """Append one measured sample to a node's ring (in memory; the
        annotation persists at the node's next transition)."""
        clean: Dict[str, float] = {}
        for k, v in dict(metrics).items():
            try:
                clean[str(k)] = float(v)
            except (TypeError, ValueError):
                continue
        if not clean:
            return
        epoch = self.epoch_clock() if now_epoch is None else now_epoch
        with self._lock:
            ring = self._rings.setdefault(node_name, [])
            seq = self._next_seq.get(node_name)
            if seq is None:
                seq = (ring[-1][0] + 1) if ring else 1
            ring.append((seq, float(epoch), clean))
            del ring[: -self.history_len]
            self._next_seq[node_name] = seq + 1
            self._dirty.add(node_name)
            self.samples_total += 1
            if generation:
                self._node_generation[node_name] = generation
            if pool is not None:
                self._node_pool[node_name] = pool

    # ------------------------------------------------------------------
    # durability (rides the combined transition patch)

    @_failopen
    def annotation_source(self, node, new_state) -> Optional[dict]:
        """Provider transition-annotation source: when this node's ring
        has unpersisted samples, ride them on the state-label patch the
        provider is about to stage anyway — zero extra write verbs.
        Unlike the trace anchor the ring is longitudinal: it persists
        through terminal states and is never deleted."""
        key = self.annotation_key
        if key is None:
            return {}
        with self._lock:
            name = getattr(node, "name", None)
            if name not in self._dirty:
                return {}
            ring = self._rings.get(name)
            if not ring:
                self._dirty.discard(name)
                return {}
            self._dirty.discard(name)
            return {key: format_ring(ring)}

    @_failopen
    def adopt_node(self, node) -> bool:
        """Re-seed one node's ring from its durable annotation (crash /
        leader-handoff adoption).  Merges by sequence number: samples
        already in memory are never duplicated and newer in-memory
        samples are never clobbered.  Returns True when any sample was
        adopted."""
        key = self.annotation_key
        if key is None:
            return False
        raw = (getattr(node, "annotations", None) or {}).get(key)
        adopted = parse_ring(raw)
        if not adopted:
            return False
        name = node.name
        with self._lock:
            ring = self._rings.get(name, [])
            have = {seq for seq, _, _ in ring}
            merged = ring + [s for s in adopted if s[0] not in have]
            merged.sort(key=lambda s: s[0])
            del merged[: -self.history_len]
            self._rings[name] = merged
            self._next_seq[name] = merged[-1][0] + 1 if merged else 1
        return True

    # ------------------------------------------------------------------
    # baselines & verdicts

    def recompute(self) -> None:
        """Fold rings into cohort baselines and update scores, streaks
        and straggler confirmations.  Idempotent per sample: a ring
        sample feeds a node's streak exactly once (tracked by sequence
        number), so calling this every pass is safe."""
        with self._lock:
            reps: Dict[str, Dict[str, float]] = {}
            cohorts: Dict[str, Tuple[str, str]] = {}
            for name, ring in self._rings.items():
                if not ring:
                    continue
                stats: Dict[str, List[float]] = {}
                for _, _, metrics in ring:
                    for k, v in metrics.items():
                        stats.setdefault(k, []).append(v)
                reps[name] = {k: median(v) for k, v in stats.items()}
                cohorts[name] = (
                    self._node_generation.get(name, ""),
                    self._node_pool.get(name, ""),
                )
            self._baselines = compute_baselines(
                reps, cohorts, min_cohort=self.min_cohort
            )
            self._scores = {}
            self._badness = {}
            confirmed: Dict[str, dict] = {}
            for name, ring in self._rings.items():
                baseline = self._baselines.get(cohorts.get(name))
                if not baseline:
                    # Cohort too small (or unknown): no verdicts, and
                    # any running streak is void.
                    self._streak.pop(name, None)
                    continue
                worst, per_stat = node_badness(
                    reps.get(name, {}), baseline
                )
                self._scores[name] = round(health_score(worst), 1)
                self._badness[name] = per_stat
                # Streak: each NEW sample (by seq) beyond the threshold
                # extends it; one at-baseline sample resets it.  Replay
                # from the ring so an adopted history rebuilds the same
                # streak a crashed controller had accumulated.
                last_scored = self._last_scored_seq.get(name, 0)
                streak = self._streak.get(name, 0)
                for seq, _, metrics in ring:
                    if seq <= last_scored:
                        continue
                    sample_worst, _ = node_badness(metrics, baseline)
                    streak = (
                        streak + 1
                        if sample_worst > self.z_threshold
                        else 0
                    )
                    last_scored = seq
                self._streak[name] = streak
                self._last_scored_seq[name] = last_scored
                if streak >= self.confirm_batteries:
                    worst_stat = max(
                        per_stat, key=per_stat.get, default=""
                    )
                    confirmed[name] = {
                        "node": name,
                        "generation": cohorts[name][0],
                        "pool": cohorts[name][1],
                        "score": self._scores[name],
                        "streak": streak,
                        "worstStat": worst_stat,
                        "z": round(per_stat.get(worst_stat, 0.0), 2),
                    }
            self._confirmed = confirmed
            self._reported &= set(confirmed)

    def is_straggler(self, node_name: str) -> bool:
        with self._lock:
            return node_name in self._confirmed

    def consume_straggler(self, node_name: str) -> bool:
        """Acknowledge a confirmed straggler (quarantine routing): the
        streak resets so re-confirmation needs ``confirm_batteries``
        fresh batteries — a parked node cannot be re-parked by the same
        stale verdict the moment it rejoins."""
        with self._lock:
            was = node_name in self._confirmed
            self._confirmed.pop(node_name, None)
            self._reported.discard(node_name)
            self._streak[node_name] = 0
            return was

    def new_confirmations(self) -> List[dict]:
        """Stragglers confirmed since the last call (event dedup: the
        NodeHealthDegraded Warning fires once per confirmation, not
        once per pass)."""
        with self._lock:
            fresh = [
                dict(v)
                for k, v in sorted(self._confirmed.items())
                if k not in self._reported
            ]
            self._reported |= set(self._confirmed)
            return fresh

    def stragglers_by_pool(self) -> Dict[str, List[str]]:
        """Confirmed stragglers grouped by pool (planner surface: the
        phase clocks annotate 'this pool's ETA is inflated by ...')."""
        with self._lock:
            out: Dict[str, List[str]] = {}
            for name, info in self._confirmed.items():
                out.setdefault(info.get("pool", ""), []).append(name)
            return {k: sorted(v) for k, v in out.items()}

    # ------------------------------------------------------------------
    # publication

    def to_status(self) -> dict:
        """CR status block: ``healthSummary`` + ``stragglers``.  Output
        only — baselines re-derive from the rings on adoption, so
        nothing here is ever read back."""
        with self._lock:
            cohorts = []
            for (gen, pool), baseline in sorted(self._baselines.items()):
                cohorts.append(
                    {
                        "generation": gen,
                        "pool": pool,
                        "nodes": max(
                            (b.count for b in baseline.values()),
                            default=0,
                        ),
                        "baseline": {
                            stat: {
                                "median": round(b.median, 3),
                                "mad": round(b.mad, 3),
                            }
                            for stat, b in sorted(baseline.items())
                        },
                    }
                )
            summary: dict = {}
            if cohorts:
                summary["cohorts"] = cohorts
            if self._scores:
                summary["scoredNodes"] = len(self._scores)
                summary["meanScore"] = round(
                    sum(self._scores.values()) / len(self._scores), 1
                )
            out: dict = {}
            if summary:
                out["healthSummary"] = summary
            stragglers = [
                dict(v) for _, v in sorted(self._confirmed.items())
            ]
            if stragglers:
                out["stragglers"] = stragglers
            return out

    def metrics_view(self) -> dict:
        """Everything UpgradeMetrics.observe_telemetry publishes:
        per-node scores, per-cohort straggler counts, and fleet-median
        measured stats attributed to their probe check."""
        with self._lock:
            straggler_counts: Dict[Tuple[str, str], int] = {}
            for info in self._confirmed.values():
                key = (info.get("generation", ""), info.get("pool", ""))
                straggler_counts[key] = straggler_counts.get(key, 0) + 1
            measured: Dict[Tuple[str, str], float] = {}
            per_stat: Dict[str, List[float]] = {}
            for ring in self._rings.values():
                if not ring:
                    continue
                for k, v in ring[-1][2].items():
                    per_stat.setdefault(k, []).append(v)
            for stat, values in per_stat.items():
                check = STAT_CHECK.get(stat)
                if check is None:
                    if not stat.startswith("battery_"):
                        continue
                    check = _BATTERY_CHECK
                measured[(check, stat)] = round(median(values), 3)
            return {
                "scores": dict(self._scores),
                "stragglers": straggler_counts,
                "measured": measured,
                "samples_total": self.samples_total,
                "drops": self.drops,
            }

    def export(self) -> dict:
        """Flight-recorder snapshot: compact, bounded, redactable."""
        with self._lock:
            return {
                "nodes": len(self._rings),
                "samples_total": self.samples_total,
                "drops": self.drops,
                "cohorts": [
                    {"generation": g, "pool": p, "stats": sorted(b)}
                    for (g, p), b in sorted(self._baselines.items())
                ],
                "stragglers": [
                    dict(v) for _, v in sorted(self._confirmed.items())
                ],
                "streaks": {
                    k: v
                    for k, v in sorted(self._streak.items())
                    if v > 0
                },
            }
