"""Per-pool EWMA phase clocks measured from observed transitions.

The planner ships static default :class:`~.planner.PhaseClocks`
(planner.py ``DEFAULT_*``) — production-shaped, but blind to the fleet
actually being rolled.  :class:`PhaseClockTracker` closes that gap: the
node-state provider reports every group-level transition through
``transition_observer`` (one callback per
``change_nodes_upgrade_state`` batch, fired BEFORE the new labels are
staged, so the old state is still readable), the tracker charges the
elapsed wall time to the phase the group is leaving, and folds it into
an exponentially weighted moving average keyed by ``(pool, phase)``.

The drift watchdog feeds ``pool_clocks()`` into every anchor/re-plan
via ``PlanAssumptions.pool_clocks``, so projections tighten as the roll
progresses; pools with no samples yet fall back to the assumption-level
clocks.  Aggregates ride the policy CR status (``phaseClocks``) through
the write plane and are re-seeded on controller adoption, so a restart
or failover does not reset the estimate to the static defaults.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Iterable, Optional

from k8s_operator_libs_tpu_torch.planning.planner import PhaseClocks
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState

# The phase a group is *in* while its nodes carry this state label —
# the duration charged when the group transitions onward.
PHASE_OF_STATE = {
    UpgradeState.CORDON_REQUIRED.value: "cordon_s",
    UpgradeState.WAIT_FOR_JOBS_REQUIRED.value: "wait_for_jobs_s",
    UpgradeState.POD_DELETION_REQUIRED.value: "pod_deletion_s",
    UpgradeState.DRAIN_REQUIRED.value: "drain_s",
    UpgradeState.POD_RESTART_REQUIRED.value: "pod_restart_s",
    UpgradeState.VALIDATION_REQUIRED.value: "validation_s",
    UpgradeState.UNCORDON_REQUIRED.value: "uncordon_s",
    UpgradeState.NEGOTIATE_REQUIRED.value: "negotiate_s",
    UpgradeState.REJOIN_RESIZE_REQUIRED.value: "rejoin_s",
}

_PHASE_TO_CAMEL = {
    "cordon_s": "cordonSeconds",
    "wait_for_jobs_s": "waitForJobsSeconds",
    "pod_deletion_s": "podDeletionSeconds",
    "drain_s": "drainSeconds",
    "pod_restart_s": "podRestartSeconds",
    "validation_s": "validationSeconds",
    "uncordon_s": "uncordonSeconds",
    "negotiate_s": "negotiateSeconds",
    "rejoin_s": "rejoinSeconds",
}
_CAMEL_TO_PHASE = {v: k for k, v in _PHASE_TO_CAMEL.items()}

# Serialized name for the pool-less bucket ("" internally): CR status
# keys read better than an empty string.
_DEFAULT_POOL_KEY = "default"

DEFAULT_EWMA_ALPHA = 0.3


class PhaseClockTracker:
    """EWMA of measured per-(pool, phase) durations.

    Thread-safe: transitions are reported from both the reconcile
    thread and fenced worker threads.
    """

    def __init__(self, alpha: float = DEFAULT_EWMA_ALPHA) -> None:
        self.alpha = alpha
        self._lock = threading.Lock()
        self._ewma: dict[tuple[str, str], float] = {}
        self._samples: dict[tuple[str, str], int] = {}
        # group key -> (state value occupied, entry timestamp)
        self._entered: dict[str, tuple[str, float]] = {}
        # node name -> pool name ("" = pool-less); refreshed each full
        # pass by the controller from the policy's pool selectors.
        self._node_pool: dict[str, str] = {}
        # Confirmed health stragglers (fed by the telemetry plane each
        # pass): the status block annotates which pools' measured
        # clocks — and therefore the planner's ETA — are inflated by a
        # slow node rather than by the phase itself.
        self._straggler_nodes: set[str] = set()

    # -- wiring --------------------------------------------------------

    def seed_pools(self, node_pool: dict[str, str]) -> None:
        """Refresh the node→pool attribution map (full pass scope)."""
        with self._lock:
            self._node_pool.update(node_pool)

    def set_straggler_nodes(self, names: Iterable[str]) -> None:
        """Replace the confirmed-straggler set (telemetry plane feed,
        once per pass; a cleared verdict drops the annotation)."""
        with self._lock:
            self._straggler_nodes = {str(n) for n in names}

    # -- observation ---------------------------------------------------

    def observe_group_transition(
        self, nodes: Iterable, new_state, now: Optional[float] = None
    ) -> None:
        """One group-level transition (called before labels change).

        ``nodes`` is the group's member list; the group key is the
        lexicographically-first node name (stable for a slice).  The
        phase being LEFT is charged ``now - entry``; the phase being
        ENTERED starts its clock.
        """
        names = sorted(
            n.name for n in nodes if getattr(n, "name", None) is not None
        )
        if not names:
            return
        key = names[0]
        ts = time.monotonic() if now is None else now
        new_value = getattr(new_state, "value", new_state)
        with self._lock:
            # Idempotent re-issue of the current state (crash replay,
            # re-driven pass): keep the original entry clock running.
            cur = self._entered.get(key)
            if cur is not None and cur[0] == new_value:
                return
            # First sight of a group has no entry timestamp, so there is
            # no duration to charge — only the new phase's clock opens.
            prev = self._entered.pop(key, None)
            if prev is not None:
                prev_value, entered_at = prev
                phase = PHASE_OF_STATE.get(prev_value)
                if phase is not None and ts >= entered_at:
                    self._record_locked(key, phase, ts - entered_at)
            if new_value in PHASE_OF_STATE:
                self._entered[key] = (new_value, ts)

    def _record_locked(self, node: str, phase: str, duration: float) -> None:
        pool = self._node_pool.get(node, "")
        k = (pool, phase)
        cur = self._ewma.get(k)
        if cur is None:
            self._ewma[k] = duration
        else:
            self._ewma[k] = self.alpha * duration + (1 - self.alpha) * cur
        self._samples[k] = self._samples.get(k, 0) + 1

    # -- consumption ---------------------------------------------------

    def clocks_for(
        self, pool: str, base: Optional[PhaseClocks] = None
    ) -> PhaseClocks:
        """Measured clocks for ``pool`` over ``base`` defaults."""
        base = base if base is not None else PhaseClocks()
        with self._lock:
            overrides = {
                phase: val
                for (p, phase), val in self._ewma.items()
                if p == pool
            }
        return replace(base, **overrides) if overrides else base

    def pool_clocks(
        self, base: Optional[PhaseClocks] = None
    ) -> dict[str, PhaseClocks]:
        """All pools with at least one measured phase."""
        with self._lock:
            pools = {p for (p, _phase) in self._ewma}
        return {p: self.clocks_for(p, base) for p in sorted(pools)}

    def sample_count(self) -> int:
        with self._lock:
            return sum(self._samples.values())

    # -- durability (CR status via the write plane) --------------------

    def to_status(self) -> dict:
        """``{pool: {camelPhase: seconds}}`` for the CR status block.

        Pools containing a confirmed health straggler additionally carry
        ``stragglersInflatingEta`` (the slow nodes by name), so an
        operator reading a pool's inflated measured clocks can tell
        "this pool's ETA is inflated by node X" apart from "this phase
        is slow fleet-wide".  ``load_status`` ignores the key on
        adoption — verdicts re-derive from the telemetry rings, never
        from the status echo."""
        with self._lock:
            out: dict[str, dict] = {}
            for (pool, phase), val in sorted(self._ewma.items()):
                name = pool or _DEFAULT_POOL_KEY
                out.setdefault(name, {})[_PHASE_TO_CAMEL[phase]] = round(
                    val, 3
                )
            for node in sorted(self._straggler_nodes):
                name = self._node_pool.get(node, "") or _DEFAULT_POOL_KEY
                out.setdefault(name, {}).setdefault(
                    "stragglersInflatingEta", []
                ).append(node)
            return out

    def load_status(self, data: Optional[dict]) -> None:
        """Re-seed the EWMA from a CR status block (adoption path).

        Loaded values never overwrite a live sample — adoption happens
        before any transition is observed, and a later stale re-load
        must not clobber fresher measurements.
        """
        if not isinstance(data, dict):
            return
        with self._lock:
            for pool_name, phases in data.items():
                if not isinstance(phases, dict):
                    continue
                pool = "" if pool_name == _DEFAULT_POOL_KEY else str(pool_name)
                for camel, val in phases.items():
                    phase = _CAMEL_TO_PHASE.get(camel)
                    if phase is None:
                        continue
                    try:
                        seconds = float(val)
                    except (TypeError, ValueError):
                        continue
                    k = (pool, phase)
                    if k not in self._ewma:
                        self._ewma[k] = seconds
                        self._samples[k] = self._samples.get(k, 0) + 1
