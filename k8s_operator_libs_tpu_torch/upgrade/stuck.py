"""Stuck-state detection: loud telemetry for non-transitions.

The reference events every state *transition*
(node_upgrade_state_provider.go:123-130) but nothing ever reports a node
that stops transitioning — operators notice a wedged upgrade by reading
logs.  Under this framework's 2-minute downtime budget a silent stall is
itself a failure mode, so the detector watches every in-progress group
across reconcile passes and, when one dwells in the same state beyond a
policy threshold, emits a Warning event per host carrying the *reason*
progress is blocked (the validation prober's rejection, the drain
manager's last transient error) and publishes a
``slice_stuck_seconds{slice,state}`` gauge.

The detector is deliberately read-only: it never advances or fails a
group (the validation timeout already does that, validation_manager.py)
— it exists to make the wait attributable while it is happening.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    IN_PROGRESS_STATES,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade.util import (
    EVENT_TYPE_WARNING,
    EventRecorder,
    UpgradeKeys,
    log_event,
)

logger = get_logger(__name__)

# A group sitting in one in-progress state longer than this is "stuck".
# Half the reference's 600 s validation timeout: loud well before the
# engine gives up and fails the slice.
DEFAULT_STUCK_THRESHOLD_S = 300.0
# Re-emit cadence once stuck (every tick would flood the event stream).
DEFAULT_RE_EMIT_INTERVAL_S = 60.0


def _reason_slug(reason: str) -> str:
    """Stable low-cardinality metric label from a reason string: the
    ``kind:`` prefix (``window-starvation``, ``budget-deadlock``,
    ``elastic-decline-storm``)."""
    return reason.split(":", 1)[0].strip() or "unknown"


@dataclass
class StuckGroup:
    """One currently-stuck group, as reported by observe()."""

    group_id: str
    state: str
    stuck_seconds: float
    reason: str


class StuckStateDetector:
    """Tracks per-group state dwell time across reconcile passes."""

    def __init__(
        self,
        keys: UpgradeKeys,
        event_recorder: Optional[EventRecorder] = None,
        threshold_s: float = DEFAULT_STUCK_THRESHOLD_S,
        re_emit_interval_s: float = DEFAULT_RE_EMIT_INTERVAL_S,
        # Anything with .set(name, value, **labels) — the metrics
        # registry; duck-typed to avoid a package cycle.
        registry=None,
    ) -> None:
        self.keys = keys
        self.event_recorder = event_recorder
        self.threshold_s = threshold_s
        self.re_emit_interval_s = re_emit_interval_s
        self.registry = registry
        # group id -> (state value, entered-at monotonic)
        self._entered: dict[str, tuple[str, float]] = {}
        self._last_emit: dict[str, float] = {}
        # group id -> state label of the gauge series last published, so
        # the exact series can be dropped when the group moves on (a
        # stale nonzero series would keep alerts firing forever).
        self._published: dict[str, str] = {}
        # group id -> last known progress blocker, supplied by the
        # engine's sub-managers (validation rejection, drain error).
        self._reason_sources: list[Callable[[str], Optional[str]]] = []
        # FAILED is normally excluded from tracking (see observe), but a
        # failed group with an OUTSTANDING safety action — e.g. a
        # rollback eviction blocked by a PDB, workload pods still on
        # gate-rejected hardware — is not settled: these sources opt
        # such groups back into dwell tracking, with the source's reason.
        self._failed_reason_sources: list[
            Callable[[str], Optional[str]]
        ] = []
        # Fleet-level "will this roll ever finish" signal (see
        # observe_fleet): the planner's structural infeasibility reasons
        # from the last full pass, for metrics/status/the controller.
        self.fleet_infeasibility: list[str] = []
        self._fleet_last_emit: dict[str, float] = {}
        self._fleet_published: set[str] = set()
        # Observability taps (obs/): a black box to trigger on stuck /
        # infeasible, and a ``() -> " (trace=<id>)" | ""`` source so the
        # Warning events carry the active roll-trace id.  Both optional
        # and fail-open — the detector stays read-only either way.
        self.flight_recorder = None
        self.trace_suffix_source: Optional[Callable[[], str]] = None

    def _trace_suffix(self) -> str:
        source = self.trace_suffix_source
        if source is None:
            return ""
        try:
            return source() or ""
        except Exception:
            return ""

    def _blackbox(self, trigger_reason: str, **context) -> None:
        # Parameter deliberately NOT named "reason": context carries a
        # ``detail=<progress-blocker reason>`` and a same-named keyword
        # would collide at the call site — outside any fail-open guard.
        recorder = self.flight_recorder
        if recorder is None:
            return
        try:
            recorder.trigger(trigger_reason, **context)
        except Exception:
            logger.debug("flight-recorder trigger failed", exc_info=True)

    def add_reason_source(
        self, source: Callable[[str], Optional[str]]
    ) -> None:
        """Register a ``group_id -> reason | None`` lookup (e.g. the
        validation manager's last rejection)."""
        self._reason_sources.append(source)

    def add_failed_reason_source(
        self, source: Callable[[str], Optional[str]]
    ) -> None:
        """Register a lookup that opts FAILED groups into stuck tracking
        while it returns a reason (an unresolved safety action, e.g. the
        validation manager's pending rollback evictions)."""
        self._failed_reason_sources.append(source)

    def _failed_reason(self, group_id: str) -> Optional[str]:
        for source in self._failed_reason_sources:
            reason = source(group_id)
            if reason:
                return reason
        return None

    def reason_for(self, group_id: str) -> str:
        for source in self._reason_sources:
            reason = source(group_id)
            if reason:
                return reason
        return "no progress-blocker reason recorded"

    def observe(self, state, now: Optional[float] = None) -> list[StuckGroup]:
        """One pass over the snapshot; returns currently-stuck groups.

        Call after apply_state each reconcile (the state manager does
        this automatically)."""
        now = time.monotonic() if now is None else now
        stuck: list[StuckGroup] = []
        seen: set[str] = set()
        # FAILED is excluded — UNLESS a failed-reason source reports an
        # outstanding action for the group: a terminally failed group
        # has already had its own loud failure event, and re-warning
        # "stuck" per host every minute until manual intervention would
        # flood the event stream; but a failed group whose rollback
        # eviction is still blocked has workload pods running on
        # hardware the gate rejected, and THAT wait must stay loud and
        # attributable until it resolves.
        for st in IN_PROGRESS_STATES:
            for group in state.groups_in(st):
                failed_reason = None
                if st == UpgradeState.FAILED:
                    failed_reason = self._failed_reason(group.id)
                    if failed_reason is None:
                        continue
                seen.add(group.id)
                entered = self._entered.get(group.id)
                if entered is None or entered[0] != st.value:
                    self._entered[group.id] = (st.value, now)
                    self._last_emit.pop(group.id, None)
                    self._drop_series(group.id)
                    continue
                dwell = now - entered[1]
                if self.threshold_s and dwell > self.threshold_s:
                    reason = failed_reason or self.reason_for(group.id)
                    stuck.append(
                        StuckGroup(group.id, st.value, dwell, reason)
                    )
                    self._publish(group, st.value, dwell, reason, now)
        # Groups that left the tracked lattice: clear tracking + gauge.
        for gone in set(self._entered) - seen:
            del self._entered[gone]
            self._last_emit.pop(gone, None)
            self._drop_series(gone)
        return stuck

    def observe_fleet(
        self, state, policy, manager=None, now: Optional[float] = None
    ) -> list[str]:
        """Fleet-level stuck signal: will this roll EVER finish?

        Per-group dwell (observe) catches a slice wedged in one state;
        it is silent about a roll that makes no progress for structural
        reasons — a maintenance window that never opens, a budget that
        can never admit the smallest pending group, an elastic-decline
        storm burning offer timeouts.  This pass asks the planner's
        cheap feasibility scan those questions every full resync and
        reports the answers as plan infeasibility: a
        ``fleet_roll_infeasible{reason}`` gauge per reason plus a
        throttled RollInfeasible Warning on one representative node per
        pending group's fleet.  Read-only, like everything here."""
        if manager is None:
            self.fleet_infeasibility = []
            return []
        now_mono = time.monotonic() if now is None else now
        # Lazy import: planning imports the fleet helpers; importing it
        # at module top would cycle through the upgrade package.
        from k8s_operator_libs_tpu_torch.planning.planner import (
            find_infeasibilities,
        )

        reasons = find_infeasibilities(manager, state, policy)
        self.fleet_infeasibility = reasons
        slugs = {_reason_slug(r): r for r in reasons}
        if self.registry is not None:
            for slug in set(self._fleet_published) - set(slugs):
                self.registry.remove("fleet_roll_infeasible", reason=slug)
                self._fleet_published.discard(slug)
            for slug in slugs:
                self.registry.set("fleet_roll_infeasible", 1, reason=slug)
                self._fleet_published.add(slug)
        if not reasons:
            self._fleet_last_emit.clear()
            return reasons
        anchor = None
        for group in state.groups_in(UpgradeState.UPGRADE_REQUIRED):
            if group.nodes:
                anchor = group.nodes[0].name
                break
        if anchor is None:
            # Window-starved rolls have no visible pending group (the
            # hold drops them from the snapshot): anchor on a held
            # group's recorded node so the Warning still lands somewhere
            # describable.
            held_info = getattr(manager, "window_held_info", None) or {}
            for entries in held_info.values():
                for entry in entries:
                    if len(entry) >= 3 and entry[2]:
                        anchor = entry[2]
                        break
                if anchor is not None:
                    break
        if anchor is None:
            for group in state.all_groups():
                if group.nodes:
                    anchor = group.nodes[0].name
                    break
        for slug, reason in slugs.items():
            last = self._fleet_last_emit.get(slug)
            if (
                last is not None
                and now_mono - last < self.re_emit_interval_s
            ):
                continue
            self._fleet_last_emit[slug] = now_mono
            message = (
                f"Roll is plan-infeasible: {reason}{self._trace_suffix()}"
            )
            logger.warning("%s", message)
            if anchor is not None:
                log_event(
                    self.event_recorder,
                    anchor,
                    EVENT_TYPE_WARNING,
                    "RollInfeasible",
                    message,
                )
            self._blackbox("infeasible", slug=slug, detail=reason)
        return reasons

    def _drop_series(self, group_id: str) -> None:
        state_label = self._published.pop(group_id, None)
        if state_label is not None and self.registry is not None:
            self.registry.remove(
                "slice_stuck_seconds", slice=group_id, state=state_label
            )

    def _publish(
        self, group, state_value: str, dwell: float, reason: str, now: float
    ) -> None:
        if self.registry is not None:
            self.registry.set(
                "slice_stuck_seconds", dwell, slice=group.id,
                state=state_value,
            )
            self._published[group.id] = state_value
        last = self._last_emit.get(group.id)
        if last is not None and now - last < self.re_emit_interval_s:
            return
        self._last_emit[group.id] = now
        message = (
            f"Upgrade stuck: group {group.id} has been in "
            f"'{state_value}' for {dwell:.0f}s (threshold "
            f"{self.threshold_s:.0f}s): {reason}{self._trace_suffix()}"
        )
        logger.warning("%s", message)
        for node in group.nodes:
            log_event(
                self.event_recorder,
                node.name,
                EVENT_TYPE_WARNING,
                self.keys.event_reason,
                message,
            )
        self._blackbox(
            "stuck",
            group=group.id,
            state=state_value,
            stuck_seconds=round(dwell, 1),
            detail=reason,
        )
