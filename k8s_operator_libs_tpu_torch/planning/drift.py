"""Live drift watchdog: is the active roll on its admitted plan?

On the first pass that sees an active roll the watchdog anchors a
:class:`~planner.RollPlan` from that snapshot.  Every subsequent pass it
compares actual completions against the plan's projected finish times:

    drift_seconds = elapsed − planned finish of the NEXT group due

positive drift means the roll is behind its projection (the next
planned completion is overdue), negative means ahead.  The ETA is
republished continuously (``projectedCompletion`` + ``planDriftSeconds``
in CR status, metrics, and the status CLI), and when drift exceeds the
policy threshold the watchdog re-plans from the live snapshot — bounded
by ``maxReplans`` so a pathological fleet cannot turn planning into the
hot path.

Infeasibility (window starvation, budget deadlock, elastic-decline
storms — see :func:`planner.find_infeasibilities`) is surfaced every
pass: a roll that will provably never finish is reported as
plan-infeasible, not silence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.planning.planner import (
    PlanAssumptions,
    RollPlan,
    find_infeasibilities,
    plan_roll,
)
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    IN_PROGRESS_STATES,
    UpgradeState,
)

logger = get_logger(__name__)

DEFAULT_DRIFT_THRESHOLD_S = 300.0
DEFAULT_REPLAN_INTERVAL_S = 60.0
DEFAULT_MAX_REPLANS = 5
# A plan older than this no longer guides admission (packed mode falls
# back to greedy until the next anchor/re-plan refreshes it).  Generous
# vs the re-plan cadence: any healthy watchdog re-anchors well inside
# it; only a stalled watchdog leaves a plan to age out.
DEFAULT_PLAN_STALENESS_S = 600.0


@dataclass
class DriftReport:
    """One pass's verdict, consumed by metrics + CR status."""

    active: bool = False
    drift_seconds: float = 0.0
    projected_completion_epoch: float = 0.0
    wave_count: int = 0
    completed_groups: int = 0
    planned_groups: int = 0
    infeasible: list[str] = field(default_factory=list)
    replans: int = 0
    replanned: bool = False
    plan: Optional[RollPlan] = None


class DriftWatchdog:
    """Anchors the active roll to its plan and measures divergence."""

    def __init__(
        self,
        keys,
        threshold_s: float = DEFAULT_DRIFT_THRESHOLD_S,
        replan_interval_s: float = DEFAULT_REPLAN_INTERVAL_S,
        max_replans: int = DEFAULT_MAX_REPLANS,
        assumptions: Optional[PlanAssumptions] = None,
    ) -> None:
        self.keys = keys
        self.threshold_s = threshold_s
        self.replan_interval_s = replan_interval_s
        self.max_replans = max_replans
        self.assumptions = assumptions
        self.plan: Optional[RollPlan] = None
        self.replans = 0
        self._last_replan_epoch = 0.0
        self._last_observe_epoch = 0.0
        self.last_report: Optional[DriftReport] = None
        # Freshness bound for fresh_plan() (plan-guided admission).
        self.plan_staleness_s = DEFAULT_PLAN_STALENESS_S
        # Optional PhaseClockTracker (planning/clocks.py): when set,
        # every anchor/re-plan folds its per-pool EWMA estimates into
        # the assumptions so projections tighten as the roll runs.
        self.clock_tracker = None
        # Scoped-pass activity fed by ShardedReconciler.progress_observer
        # (dirty ticks between full resyncs): evidence the engine is
        # working the plan even when no full pass has run yet.
        self.scoped_ticks = 0
        self.scoped_pools_walked = 0

    def note_tick(self, tick_report) -> None:
        """ShardedReconciler.progress_observer target: record scoped
        dirty-tick activity between full resyncs."""
        self.scoped_ticks += 1
        self.scoped_pools_walked += getattr(
            tick_report, "pools_walked", 0
        )

    def configure(self, planning_spec) -> None:
        """Adopt the CR's planning knobs (None leaves defaults)."""
        if planning_spec is None:
            return
        self.threshold_s = float(planning_spec.drift_threshold_second)
        self.replan_interval_s = float(
            planning_spec.replan_interval_second
        )
        self.max_replans = int(planning_spec.max_replans)
        # A fresh plan must outlive at least one threshold+re-plan
        # cycle, but never shrink below the default admission window.
        self.plan_staleness_s = max(
            DEFAULT_PLAN_STALENESS_S,
            self.threshold_s + self.replan_interval_s,
        )

    def reset(self) -> None:
        """Drop the anchor (roll finished, or policy changed)."""
        self.plan = None
        self.replans = 0
        self._last_replan_epoch = 0.0
        self._last_observe_epoch = 0.0

    def fresh_plan(self, now: Optional[float] = None) -> Optional[RollPlan]:
        """The anchored plan IF the watchdog is still maintaining it.

        Freshness is measured from the last active ``observe`` pass,
        not plan creation — a healthy long roll keeps its anchor fresh
        every full pass, while a wedged controller lets it age out.
        Returns None when stale: packed admission and targeted wakeups
        must fall back to greedy/blanket behavior rather than chase a
        projection nobody is validating."""
        if self.plan is None:
            return None
        now = time.time() if now is None else now
        if now - self._last_observe_epoch > self.plan_staleness_s:
            return None
        return self.plan

    def _plan_assumptions(self) -> Optional[PlanAssumptions]:
        """Assumptions for an anchor/re-plan, with the clock tracker's
        measured per-pool EWMA folded in when any samples exist."""
        base = self.assumptions
        tracker = self.clock_tracker
        if tracker is None:
            return base
        try:
            pool_clocks = tracker.pool_clocks(
                base.clocks if base is not None else None
            )
        except Exception:  # never let telemetry break planning
            logger.exception("drift watchdog: clock tracker failed")
            return base
        if not pool_clocks:
            return base
        if base is None:
            return PlanAssumptions(pool_clocks=pool_clocks)
        merged = dict(pool_clocks)
        merged.update(base.pool_clocks)  # explicit what-ifs win
        return replace(base, pool_clocks=merged)

    def _roll_active(self, state, manager=None) -> bool:
        if state.groups_in(UpgradeState.UPGRADE_REQUIRED):
            return True
        if any(state.groups_in(s) for s in IN_PROGRESS_STATES):
            return True
        # Window-held groups are dropped from the post-pass snapshot but
        # the roll is still live — and possibly window-starved, which is
        # exactly when the watchdog must keep watching.
        return bool(getattr(manager, "window_held_groups", 0))

    def observe(
        self, manager, state, policy, now: Optional[float] = None
    ) -> DriftReport:
        """Run after a FULL reconcile pass (scoped passes see one pool
        and cannot measure fleet progress)."""
        now = time.time() if now is None else now
        report = DriftReport()
        if not self._roll_active(state, manager):
            if self.plan is not None:
                logger.info(
                    "drift watchdog: roll complete; dropping plan anchor"
                )
            self.reset()
            self.last_report = report
            return report
        report.active = True
        self._last_observe_epoch = now

        if self.plan is None:
            self.plan = plan_roll(
                manager, state, policy, now=now,
                assumptions=self._plan_assumptions(),
            )
            self._last_replan_epoch = now
            logger.info(
                "drift watchdog: anchored plan (%d waves, %ds projected)",
                self.plan.wave_count,
                int(self.plan.projected_duration_s),
            )
        plan = self.plan

        # Completion ledger: which planned groups reached DONE.
        done_ids = {
            g.id for g in state.groups_in(UpgradeState.DONE)
        }
        planned = sorted(
            plan.groups,
            key=lambda g: (g.start_offset_s + g.duration_s, g.group_id),
        )
        completed = sum(1 for g in planned if g.group_id in done_ids)
        report.completed_groups = completed
        report.planned_groups = len(planned)
        report.wave_count = plan.wave_count

        elapsed = now - plan.created_epoch
        if completed >= len(planned):
            drift = elapsed - plan.projected_duration_s
        else:
            next_due = planned[completed]
            drift = elapsed - (
                next_due.start_offset_s + next_due.duration_s
            )
        report.drift_seconds = drift
        report.projected_completion_epoch = (
            plan.projected_completion_epoch + max(0.0, drift)
        )

        # Infeasibility: structural reasons from the live snapshot plus
        # anything the anchored plan already knew.
        reasons = find_infeasibilities(manager, state, policy, now=now)
        for reason in plan.infeasible:
            if reason not in reasons:
                reasons.append(reason)
        report.infeasible = reasons

        if (
            drift > self.threshold_s
            and self.replans < self.max_replans
            and now - self._last_replan_epoch >= self.replan_interval_s
        ):
            self.plan = plan_roll(
                manager, state, policy, now=now,
                assumptions=self._plan_assumptions(),
            )
            self.replans += 1
            self._last_replan_epoch = now
            report.replanned = True
            report.projected_completion_epoch = (
                self.plan.projected_completion_epoch
            )
            logger.warning(
                "drift watchdog: drift %.0fs over threshold %.0fs; "
                "re-planned (%d/%d): %d waves, new ETA +%ds",
                drift,
                self.threshold_s,
                self.replans,
                self.max_replans,
                self.plan.wave_count,
                int(self.plan.projected_duration_s),
            )
        report.replans = self.replans
        report.plan = self.plan
        self.last_report = report
        return report
