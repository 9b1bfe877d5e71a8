"""Validation manager: post-upgrade health gate.

Capability parity with the reference's ``ValidationManager``
(validation_manager.go:35-175): after the driver restarts, hold the unit in
``validation-required`` until validation succeeds, with a start-time
annotation and a timeout that fails the upgrade
(validation_manager.go:139-175, 600 s default).

TPU redesign: validation is a pluggable **slice health prober**.  The
reference can only check that a validation pod is Ready (the actual
nvidia-smi check lives in out-of-repo consumer operators, SURVEY.md §2.3);
here the prober interface is first-class and ships with:

- :class:`PodValidationProber` — reference-parity: pods matching
  ``pod_selector`` on every host of the group are Running+Ready;
- ``health.JaxSliceProber`` (see k8s_operator_libs_tpu_torch/health) — the real
  TPU gate: device re-enumeration + MXU matmul + ICI all-reduce across the
  slice, "validated" = 100 % slice re-formation + collective completes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Protocol

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.objects import Pod, PodPhase
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState
from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (
    NodeUpgradeStateProvider,
)
from k8s_operator_libs_tpu_torch.upgrade.types import UpgradeGroup
from k8s_operator_libs_tpu_torch.upgrade.util import (
    group_clock_start,
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    EventRecorder,
    UpgradeKeys,
    WorkerTracker,
    log_event,
)

logger = get_logger(__name__)

# Reference validation_manager.go:31-33.
VALIDATION_TIMEOUT_SECONDS_DEFAULT = 600


@dataclass
class ProbeResult:
    healthy: bool
    detail: str = ""
    # Measured side-channel telemetry per node ({node name: {stat:
    # value}}), populated by probers that have real numbers (the report
    # aggregator, the local device battery).  Observability only: the
    # verdict above is the gate; telemetry rides along to the fleet
    # telemetry plane (obs/telemetry.py) and never affects healthy.
    telemetry: Optional[dict] = None


class SliceProber(Protocol):
    """Anything that can render a health verdict for an upgrade group."""

    def probe(self, group: UpgradeGroup) -> ProbeResult: ...


class PodValidationProber:
    """Reference-parity prober: validation pods Ready on every host
    (validation_manager.go:71-136)."""

    def __init__(self, client: KubeClient, pod_selector: str) -> None:
        self.client = client
        self.pod_selector = pod_selector

    def _is_pod_ready(self, pod: Pod) -> bool:
        return (
            pod.status.phase == PodPhase.RUNNING and pod.all_containers_ready()
        )

    def probe(self, group: UpgradeGroup) -> ProbeResult:
        if not self.pod_selector:
            return ProbeResult(True, "no pod selector; validation disabled")
        for node in group.nodes:
            pods = self.client.list_pods(
                label_selector=self.pod_selector, node_name=node.name
            )
            if not pods:
                return ProbeResult(
                    False, f"no validation pods found on node {node.name}"
                )
            for pod in pods:
                if not self._is_pod_ready(pod):
                    return ProbeResult(
                        False,
                        f"validation pod {pod.name} on {node.name} not ready",
                    )
        return ProbeResult(True, "all validation pods ready")


class ValidationManager:
    def __init__(
        self,
        client: KubeClient,
        node_state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        prober: Optional[SliceProber] = None,
        event_recorder: Optional[EventRecorder] = None,
        timeout_seconds: int = VALIDATION_TIMEOUT_SECONDS_DEFAULT,
        escalation_stats=None,
    ) -> None:
        self.client = client
        self.provider = node_state_provider
        self.keys = keys
        self.prober = prober
        self.event_recorder = event_recorder
        self.timeout_seconds = timeout_seconds
        # Shared per-rung eviction counters (rollback evictions count
        # their evict-rung entries alongside the drain/pod managers').
        self.escalation_stats = escalation_stats
        # Last rejection reason per group id, consumed by the stuck-state
        # detector so a long validation wait is attributable in events.
        self.last_rejection: dict[str, str] = {}
        # Pipelined validation (optimistic uncordon): the group's hosts
        # were readmitted before the gate passed, so a timed-out gate
        # must take them back out of service.  Wired by the state
        # manager; set per apply_state from the policy.
        self.cordon_manager = None
        self.recordon_on_timeout = False
        # Sharded-mode companion to recordon_on_timeout: the pipelined
        # gate released the group's ledger claim at optimistic uncordon
        # (its hosts were serving again); when the gate times out the
        # hosts come back OUT of service, so the manager wires this to a
        # forced ledger re-claim — keeping unavailable_used honest until
        # the next full resync re-baselines from FAILED state.
        self.on_pipeline_recordon = None
        # Rollback workers evicting the readmitted workload (joinable via
        # wait_idle, test/bench convenience).
        self._tracker = WorkerTracker()
        # Drain settings for the rollback eviction; force=True because the
        # gate rejected the hardware outright — even unmanaged pods must
        # not keep running on it.
        self.rollback_drain_timeout_s = 300.0
        self.rollback_poll_interval_s = 1.0
        # group id -> blocker reason for rollback evictions that FAILED
        # (PDB, API fault): consumed by the stuck detector (a FAILED
        # group with workload pods still on gate-rejected hardware is an
        # outstanding safety action, not a settled terminal state) and by
        # retry_pending_rollbacks, which re-attempts on later passes.
        self.pending_rollback: dict[str, str] = {}
        # Groups with a live rollback worker (never stack two).
        self._rollback_active: set[str] = set()
        self._rollback_lock = threading.Lock()
        # Retry cadence: a FAST-failing blocker (apiserver 500s, auth
        # fault) would otherwise re-spawn — and re-event per node —
        # every reconcile pass, flooding the event stream the instant a
        # watch-driven controller wakes sub-second.  Same rationale as
        # the engine's recovery_probe_backoff_s.
        self.rollback_retry_backoff_s = 30.0
        self._rollback_last_attempt: dict[str, float] = {}
        # group id -> node names whose eviction failed on the last
        # attempt: the completion Normal event fires only for nodes that
        # actually had a failure to close out (not the whole group).
        self._rollback_failed_nodes: dict[str, list[str]] = {}
        # group id -> rollback attempt count (mirrored into the
        # rollback-attempts node annotation so it survives a controller
        # crash and surfaces in the status CLI).
        self.rollback_attempts: dict[str, int] = {}
        # Crash-safety hooks wired by the upgrade manager: leadership
        # fence for the async rollback workers + durable rung store for
        # their eviction ladders.  term_fence adds the adoption-stamp
        # term check (quorum read, worker entry only).
        self.fence = None
        self.term_fence = None
        self.rung_store = None
        # Roll tracing (obs/trace.py): fanned in by the state
        # manager; feeds eviction-rung entries into the span tree.
        self.trace_recorder = None
        # Fleet telemetry capture (obs/telemetry.py): wired by the state
        # manager to TelemetryPlane.observe_validation.  Called with
        # (group, result) for EVERY probe verdict — healthy or not, sync
        # or async — exactly once per battery.  Fail-open: a raising
        # sink never affects the gate.
        self.telemetry_sink = None
        # -- async (pipelined) probing ----------------------------------
        # A prober that marks itself ``async_probe = True`` (the fused
        # device battery — real XLA work, up to seconds even warm) runs
        # on a worker thread instead of on the reconcile thread:
        # validate() schedules the probe on first call and consumes the
        # verdict on a later pass, so one slice's battery never blocks
        # the tick — group N+1's validation overlaps group N's uncordon
        # (the existing pipeline slot math already keeps maxUnavailable
        # honest for VALIDATION_REQUIRED groups).  Cheap probers
        # (annotation aggregation, pod-Ready) stay synchronous.
        self._probe_lock = threading.Lock()
        self._probe_inflight: set[str] = set()
        self._probe_verdicts: dict[str, ProbeResult] = {}
        # Monotonically-increasing epoch per group: bumped whenever the
        # group leaves validation (timeout), so a verdict from a probe
        # scheduled before the exit can never pass a LATER gate entry.
        self._probe_epoch: dict[str, int] = {}
        # Gate wall-clock per group: first validate() call -> gate pass.
        # Terminal wall times land in validation_wall_s (metrics/bench:
        # the per-slice validation wall-time the fused battery shrinks).
        self._gate_started: dict[str, float] = {}
        self.validation_wall_s: dict[str, float] = {}

    # -- durable rollback clocks --------------------------------------------

    def _persist_rollback_attempt(self, group: UpgradeGroup) -> int:
        """Increment the group's rollback-attempts annotation and stamp
        the last-attempt epoch (best-effort: a lost write degrades to a
        restarted backoff window after a crash, never fails the pass)."""
        from k8s_operator_libs_tpu_torch.upgrade.durable import parse_int

        attempts = max(
            (
                parse_int(
                    n.annotations.get(self.keys.rollback_attempts_annotation)
                )
                for n in group.nodes
            ),
            default=0,
        )
        attempts = max(attempts, self.rollback_attempts.get(group.id, 0)) + 1
        self.rollback_attempts[group.id] = attempts
        try:
            # One coalesced metadata patch per node (attempts + last-
            # attempt epoch together) — this runs on rollback worker
            # threads, which the thread-safe write plan now coalesces
            # just like the engine pass.
            with self.provider.batched():
                self.provider.change_nodes_upgrade_annotation(
                    group.nodes,
                    self.keys.rollback_attempts_annotation,
                    str(attempts),
                )
                self.provider.change_nodes_upgrade_annotation(
                    group.nodes,
                    self.keys.rollback_last_attempt_annotation,
                    str(int(time.time())),
                )
        except Exception as e:  # noqa: BLE001 — best-effort persistence
            logger.warning(
                "failed to persist rollback clock for group %s: %s",
                group.id,
                e,
            )
        return attempts

    def adopt(self, state) -> int:
        """Re-adoption pass (leader acquisition): rebuild the pending-
        rollback ledger from the persisted record instead of from zero.

        A FAILED group whose nodes carry a rollback-attempts annotation
        had an in-flight (or blocked) rollback eviction under the old
        leader; re-enter it in ``pending_rollback`` so
        :meth:`retry_pending_rollbacks` re-drives it, with the persisted
        last-attempt epoch rebased onto this process's monotonic clock so
        the backoff window CONTINUES rather than restarting.  Returns the
        number of groups adopted."""
        from k8s_operator_libs_tpu_torch.upgrade.durable import (
            monotonic_from_epoch,
            parse_epoch,
            parse_int,
        )

        adopted = 0
        for group in state.groups_in(UpgradeState.FAILED):
            attempts = max(
                (
                    parse_int(
                        n.annotations.get(
                            self.keys.rollback_attempts_annotation
                        )
                    )
                    for n in group.nodes
                ),
                default=0,
            )
            if attempts <= 0:
                continue
            self.rollback_attempts[group.id] = max(
                attempts, self.rollback_attempts.get(group.id, 0)
            )
            if group.id not in self.pending_rollback:
                self.pending_rollback[group.id] = (
                    f"re-adopted after leader change ({attempts} prior "
                    "rollback attempt(s)); eviction completeness unknown"
                )
                adopted += 1
            last_epoch = max(
                (
                    parse_epoch(
                        n.annotations.get(
                            self.keys.rollback_last_attempt_annotation
                        )
                    )
                    or 0
                    for n in group.nodes
                ),
                default=0,
            )
            if last_epoch > 0:
                self._rollback_last_attempt[group.id] = monotonic_from_epoch(
                    last_epoch
                )
        return adopted

    def clear_pending_rollback(self, group_id: str) -> None:
        """Stop tracking a group's pending rollback eviction: clears the
        blocker record AND the retry-backoff stamp (and the failed-node
        list).  Popping only ``pending_rollback`` — the old recovery-path
        behavior — left the backoff stamp behind, silently delaying the
        group's NEXT failure's first rollback retry by a stale window."""
        self.pending_rollback.pop(group_id, None)
        self._rollback_last_attempt.pop(group_id, None)
        self._rollback_failed_nodes.pop(group_id, None)
        self.rollback_attempts.pop(group_id, None)

    def validate(self, group: UpgradeGroup) -> bool:
        """Probe the group; on failure run the timeout clock
        (validation_manager.go:94-115 lifted to groups).  Returns True when
        validation passed and the group may advance.

        Probers with ``async_probe = True`` are dispatched to a worker
        thread (see ``_probe_inflight`` in __init__): this call then
        returns False while the probe runs and consumes the verdict on a
        later reconcile pass — the timeout clock keeps ticking against
        the same start annotation either way."""
        if self.prober is None:
            return True
        self._gate_started.setdefault(group.id, time.monotonic())
        if getattr(self.prober, "async_probe", False):
            result = self._async_probe_result(group)
            if result is None:
                # In flight (or just scheduled): the gate stays open and
                # the timeout clock keeps running — a hung battery must
                # still fail the upgrade at the deadline.
                self._handle_timeout(group)
                return False
        else:
            result = self.prober.probe(group)
        if self.telemetry_sink is not None:
            # One battery = one capture, whatever the verdict (a slow
            # node that still clears the floor is exactly the sample the
            # straggler baseline needs).  Async verdicts are consumed
            # once, so this also fires once per battery on that path.
            try:
                self.telemetry_sink(group, result)
            except Exception:  # noqa: BLE001 — observability is fail-open
                logger.debug(
                    "telemetry sink failed for group %s",
                    group.id,
                    exc_info=True,
                )
        if not result.healthy:
            logger.info("group %s validation pending: %s", group.id, result.detail)
            self.last_rejection[group.id] = result.detail
            if self.trace_recorder is not None:
                self.trace_recorder.note_gate(group, result.detail)
            self._handle_timeout(group)
            return False
        self.last_rejection.pop(group.id, None)
        started = self._gate_started.pop(group.id, None)
        if started is not None:
            self.validation_wall_s[group.id] = time.monotonic() - started
        # Passed: clear the start-time annotation.
        self.provider.change_nodes_upgrade_annotation(
            [
                n
                for n in group.nodes
                if self.keys.validation_start_time_annotation in n.annotations
            ],
            self.keys.validation_start_time_annotation,
            "null",
        )
        return True

    def _async_probe_result(self, group: UpgradeGroup) -> Optional[ProbeResult]:
        """Consume a completed async verdict, or schedule a probe worker
        and return None while one is (now) in flight.

        An unhealthy verdict is consumed ONCE (the next pass schedules a
        fresh probe) — same retry cadence as the sync path, one probe
        per rejection, but off the reconcile thread."""
        with self._probe_lock:
            if group.id in self._probe_verdicts:
                return self._probe_verdicts.pop(group.id)
            if group.id in self._probe_inflight:
                return None
            self._probe_inflight.add(group.id)
            epoch = self._probe_epoch.get(group.id, 0)

        def _probe() -> None:
            try:
                result = self.prober.probe(group)
            except Exception as e:  # noqa: BLE001 — a crashed probe rejects
                result = ProbeResult(False, f"prober raised: {e}")
            with self._probe_lock:
                self._probe_inflight.discard(group.id)
                if self._probe_epoch.get(group.id, 0) == epoch:
                    self._probe_verdicts[group.id] = result
                # else: the group left validation (timeout) while this
                # probe ran — its verdict must not leak into a later
                # gate entry for the same group.

        try:
            self._tracker.spawn(_probe, name=f"validation-probe-{group.id}")
        except Exception as e:  # noqa: BLE001 — retry next pass
            # A failed spawn must not strand the in-flight claim (the
            # same leak shape as the rollback-spawn fix below); unlike
            # the rollback path this one swallows the error — validate()
            # runs on the reconcile thread and simply retries next pass.
            with self._probe_lock:
                self._probe_inflight.discard(group.id)
            logger.warning(
                "failed to spawn validation probe for group %s: %s",
                group.id,
                e,
            )
        return None

    def _discard_probe_state(self, group_id: str) -> None:
        """The group left validation: invalidate any in-flight probe
        (epoch bump) and drop an unconsumed verdict + the gate clock."""
        with self._probe_lock:
            self._probe_epoch[group_id] = (
                self._probe_epoch.get(group_id, 0) + 1
            )
            self._probe_verdicts.pop(group_id, None)
        self._gate_started.pop(group_id, None)

    def _handle_timeout(self, group: UpgradeGroup) -> None:
        key = self.keys.validation_start_time_annotation
        now = int(time.time())
        start = group_clock_start(self.provider, group, key, now)
        if start is None:
            return  # freshly stamped; clock evaluated next pass
        if self.timeout_seconds and now > start + self.timeout_seconds:
            logger.info("group %s validation timed out -> failed", group.id)
            # The group leaves validation: a stale rejection must not be
            # attributed to a future stall in a different phase, and a
            # still-running async probe's verdict must not pass a future
            # re-entry of the gate.
            self.last_rejection.pop(group.id, None)
            self._discard_probe_state(group.id)
            if self.recordon_on_timeout and self.cordon_manager is not None:
                # Optimistic-uncordon rollback: the workload was
                # readmitted before the gate; an unvalidated slice must
                # not keep serving it.  Cordon alone only blocks NEW
                # scheduling — the readmitted pods would keep running on
                # hardware the gate rejected — so also evict them (async:
                # eviction honors PDBs and can block; FAILED groups have
                # no drain processor to pick this up later).
                self.cordon_manager.cordon_nodes(group.nodes)
                self._schedule_rollback_eviction(group)
                if self.on_pipeline_recordon is not None:
                    self.on_pipeline_recordon(group)
            for node in group.nodes:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_WARNING,
                    self.keys.event_reason,
                    "Validation timed out for the driver upgrade",
                )
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.FAILED
            )
            self.provider.change_nodes_upgrade_annotation(group.nodes, key, "null")

    def _schedule_rollback_eviction(self, group: UpgradeGroup) -> None:
        """Evict the workload pods readmitted by the optimistic uncordon.

        A failure (PDB-blocked eviction, API fault) is NOT log-and-
        forget: workload pods still running on hardware the gate
        rejected is an outstanding safety action.  Each failure
        publishes a Warning event per affected node, records the blocker
        in ``pending_rollback`` (surfaced through the stuck detector's
        ``slice_stuck_seconds`` + events), and the engine re-attempts on
        later passes via :meth:`retry_pending_rollbacks` — the drain is
        idempotent, so eviction completes once the blocker clears."""
        from k8s_operator_libs_tpu_torch.k8s.drain import DrainHelper, FencedError

        if self.fence is not None and not self.fence():
            return  # deposed leader: the new leader re-adopts this work
        if self.term_fence is not None and not self.term_fence(group.nodes):
            return  # a higher term already adopted these nodes
        with self._rollback_lock:
            if group.id in self._rollback_active:
                return  # a worker is already evicting this group
            self._rollback_active.add(group.id)

        self._persist_rollback_attempt(group)
        helper = DrainHelper(
            self.client,
            force=True,
            ignore_all_daemon_sets=True,
            delete_empty_dir_data=True,
            timeout_s=self.rollback_drain_timeout_s,
            poll_interval_s=self.rollback_poll_interval_s,
            escalation_stats=self.escalation_stats,
            fence=self.fence,
            rung_store=self.rung_store,
            trace_hook=(
                self.trace_recorder.rung_entered
                if self.trace_recorder is not None
                else None
            ),
        )
        node_names = [n.name for n in group.nodes]
        had_failed_before = group.id in self.pending_rollback

        def _rollback() -> None:
            failures: list[tuple[str, Exception]] = []
            try:
                for name in node_names:
                    try:
                        helper.run_node_drain(name)
                    except FencedError:
                        # Leadership moved mid-rollback: stop acting.  The
                        # persisted rollback-attempts annotation lets the
                        # new leader re-adopt the unfinished eviction.
                        return
                    except Exception as e:  # noqa: BLE001 — retried later
                        failures.append((name, e))
                        logger.error(
                            "rollback eviction of node %s (group %s) "
                            "failed: %s — workload pods may still be "
                            "running on unvalidated hardware; will retry "
                            "while the group stays failed",
                            name,
                            group.id,
                            e,
                        )
                        log_event(
                            self.event_recorder,
                            name,
                            EVENT_TYPE_WARNING,
                            self.keys.event_reason,
                            "Rollback eviction after validation timeout "
                            f"failed: {e} — workload pods may still be "
                            "running on unvalidated hardware (will retry)",
                        )
                if failures:
                    self.pending_rollback[group.id] = (
                        "rollback eviction incomplete on "
                        f"{len(failures)}/{len(node_names)} node(s) "
                        f"({', '.join(n for n, _ in failures)}): "
                        f"{failures[0][1]}"
                    )
                    self._rollback_failed_nodes[group.id] = [
                        n for n, _ in failures
                    ]
                elif self.pending_rollback.pop(group.id, None) is not None:
                    # A previously-blocked eviction finally completed:
                    # close the loop for the operator watching events —
                    # on the nodes that actually had a failure to close
                    # out, not the whole group (nodes that drained clean
                    # on the first attempt never warned, so a completion
                    # Normal there would be noise with no Warning pair).
                    healed = self._rollback_failed_nodes.pop(
                        group.id, None
                    )
                    self._rollback_last_attempt.pop(group.id, None)
                    for name in healed if healed is not None else node_names:
                        log_event(
                            self.event_recorder,
                            name,
                            EVENT_TYPE_NORMAL,
                            self.keys.event_reason,
                            "Rollback eviction completed after earlier "
                            "failures; no workload pods remain on the "
                            "unvalidated hardware",
                        )
                if not failures:
                    # Eviction is complete: retire the durable rollback
                    # clocks so a later leader does not re-adopt finished
                    # work (best-effort; re-adopting a finished eviction
                    # is idempotent anyway).
                    try:
                        # Both clock deletes coalesce into one metadata
                        # patch per node via the write plan (this runs on
                        # a rollback worker thread).
                        with self.provider.batched():
                            for key in (
                                self.keys.rollback_attempts_annotation,
                                self.keys.rollback_last_attempt_annotation,
                            ):
                                self.provider.change_nodes_upgrade_annotation(
                                    [
                                        n
                                        for n in group.nodes
                                        if key in n.annotations
                                    ],
                                    key,
                                    "null",
                                )
                    except Exception as e:  # noqa: BLE001
                        logger.warning(
                            "failed to clear rollback clocks for group "
                            "%s: %s",
                            group.id,
                            e,
                        )
            finally:
                with self._rollback_lock:
                    self._rollback_active.discard(group.id)

        if had_failed_before:
            logger.info(
                "re-attempting blocked rollback eviction for group %s",
                group.id,
            )
        try:
            self._tracker.spawn(
                _rollback, name=f"validation-rollback-{group.id}"
            )
        except Exception:
            # A failed spawn (thread limit, interpreter shutdown) must
            # not strand the active claim: that would silently skip
            # every future retry for this group while workload pods sit
            # on gate-rejected hardware.
            with self._rollback_lock:
                self._rollback_active.discard(group.id)
            raise

    def retry_pending_rollbacks(self, state) -> None:
        """Re-attempt rollback evictions that previously failed, for
        groups still in FAILED (the engine calls this every pass).
        Groups that left FAILED (recovered after the gate passed, or
        relabeled by an operator) stop being tracked — recovery means
        the hardware was re-validated, so the eviction is moot."""
        if not self.pending_rollback:
            return
        failed = {g.id: g for g in state.groups_in(UpgradeState.FAILED)}
        now = time.monotonic()
        for gid in list(self.pending_rollback):
            group = failed.get(gid)
            if group is None:
                self.clear_pending_rollback(gid)
                continue
            last = self._rollback_last_attempt.get(gid)
            if (
                last is not None
                and now - last < self.rollback_retry_backoff_s
            ):
                continue
            self._rollback_last_attempt[gid] = now
            self._schedule_rollback_eviction(group)

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Join outstanding workers (rollback evictions + async probes)."""
        return self._tracker.wait_idle(timeout_s)
