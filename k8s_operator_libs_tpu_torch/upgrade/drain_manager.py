"""Async drain manager.

Capability parity with the reference's ``DrainManager``
(drain_manager.go:48-155): asynchronous drain workers deduplicated across
reconcile passes by a :class:`StringSet`, cordon-then-drain, success moves
the unit to ``pod-restart-required`` and failure to ``upgrade-failed`` —
the "async actor + label mailbox" idiom (SURVEY.md §3.4).

TPU redesign: the schedulable unit is an :class:`UpgradeGroup` (one ICI
slice).  All hosts of a slice drain **concurrently inside one worker**, and
the state transition happens once, at the group barrier — all-or-nothing:
if any host fails to drain, the whole slice goes to ``upgrade-failed``
(the torus would be split either way; a half-drained slice is not a
usable TPU).  ``IgnoreAllDaemonSets`` stays true because the libtpu
driver/device-plugin itself runs as a DaemonSet (reference
drain_manager.go:80-81 has the same rationale for OFED pods).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

from k8s_operator_libs_tpu_torch.api.v1alpha1 import DrainSpec
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.drain import (
    DrainError,
    DrainHelper,
    EscalationStats,
    FencedError,
    escalation_from_spec,
)
from k8s_operator_libs_tpu_torch.k8s.objects import Node
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState
from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (
    NodeUpgradeStateProvider,
)
from k8s_operator_libs_tpu_torch.upgrade.types import NodeUpgradeState, UpgradeGroup
from k8s_operator_libs_tpu_torch.upgrade.util import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    EventRecorder,
    StringSet,
    UpgradeKeys,
    WorkerTracker,
    log_event,
)

logger = get_logger(__name__)


@dataclass
class DrainConfiguration:
    """Drain spec + the groups to drain (reference DrainConfiguration,
    drain_manager.go:32-36, lifted to groups)."""

    spec: Optional[DrainSpec]
    groups: list[UpgradeGroup] = field(default_factory=list)


class DrainManager:
    def __init__(
        self,
        client: KubeClient,
        node_state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        event_recorder: Optional[EventRecorder] = None,
        max_hosts_concurrency: int = 32,
        poll_interval_s: float = 1.0,
        escalation_stats: Optional[EscalationStats] = None,
    ) -> None:
        self.client = client
        self.provider = node_state_provider
        self.keys = keys
        self.event_recorder = event_recorder
        self.max_hosts_concurrency = max_hosts_concurrency
        # Per-rung eviction-escalation counters, usually shared with the
        # other DrainHelper owners by the upgrade manager so one metrics
        # read covers every drain path.
        self.escalation_stats = escalation_stats
        # Apiserver-facing poll cadence for eviction/deletion waits; the
        # production default (1 s, kubectl-like) is deliberately NOT the
        # test default of the cache-sync polls.
        self.poll_interval_s = poll_interval_s
        # Crash-safety hooks wired by the upgrade manager: a leadership
        # fence every async worker consults before mutating, and the
        # annotation-backed store that persists each node's eviction-
        # ladder rung so a fresh leader resumes mid-escalation.
        # term_fence adds the adoption-stamp term check (quorum read,
        # worker entry + group barrier only).
        self.fence = None
        self.term_fence = None
        self.rung_store = None
        # Roll tracing (obs/trace.py): fanned in by the state
        # manager; feeds eviction-rung entries into the span tree.
        self.trace_recorder = None
        # Dedup of in-flight drains across reconcile passes
        # (drain_manager.go:103: drainingNodes StringSet), keyed by group id.
        self._draining = StringSet()
        self._tracker = WorkerTracker()
        # Last drain error per group id (policy or transient), consumed by
        # the stuck-state detector for attributable stall events.
        self.last_error: dict[str, str] = {}

    def schedule_groups_drain(self, config: DrainConfiguration) -> None:
        """Schedule async drain for each group not already draining."""
        if not config.groups:
            logger.info("Drain Manager: no groups scheduled to drain")
            return
        if config.spec is None:
            raise ValueError("drain spec should not be empty")
        if not config.spec.enable:
            logger.info("Drain Manager: drain is disabled")
            return

        for group in config.groups:
            if self._draining.has(group.id):
                logger.info("group %s already draining, skipping", group.id)
                continue
            self._draining.add(group.id)
            for node in group.nodes:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_NORMAL,
                    self.keys.event_reason,
                    "Scheduling drain of the node",
                )
            self._tracker.spawn(
                lambda g=group, s=config.spec: self._drain_group(g, s),
                name=f"drain-{group.id}",
            )

    # Reference-parity shim: drain a list of nodes as singleton groups.
    def schedule_nodes_drain(
        self, spec: Optional[DrainSpec], nodes: Sequence[Node]
    ) -> None:
        groups = [
            UpgradeGroup(id=n.name, members=[NodeUpgradeState(node=n)])
            for n in nodes
        ]
        self.schedule_groups_drain(DrainConfiguration(spec=spec, groups=groups))

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Join outstanding drain workers (test/bench convenience; the
        reference relies on Eventually-style polling instead)."""
        return self._tracker.wait_idle(timeout_s)

    # -- worker -------------------------------------------------------------

    def _drain_group(self, group: UpgradeGroup, spec: DrainSpec) -> None:
        """Drain worker with failure CLASSIFICATION.

        The reference marks any drain error ``upgrade-failed``
        (drain_manager.go:111-127) and leaves recovery to a manual
        runbook.  Under a 2-minute downtime budget that is wrong for
        *transient* apiserver errors: only a policy-level
        :class:`DrainError` (undrainable pod per filters, PDB/timeout
        exhausted) fails the slice; any other exception leaves the group
        in ``drain-required`` so the next idempotent pass simply retries
        the drain."""
        try:
            if self.fence is not None and not self.fence():
                return  # deposed leader: abandon without acting
            if self.term_fence is not None and not self.term_fence(
                group.nodes
            ):
                return  # a higher term already adopted these nodes
            helper = DrainHelper(
                self.client,
                force=spec.force,
                ignore_all_daemon_sets=True,
                delete_empty_dir_data=spec.delete_empty_dir,
                timeout_s=float(spec.timeout_second),
                pod_selector=spec.pod_selector,
                poll_interval_s=self.poll_interval_s,
                escalation=escalation_from_spec(
                    getattr(spec, "eviction_escalation", None)
                ),
                escalation_stats=self.escalation_stats,
                fence=self.fence,
                rung_store=self.rung_store,
                trace_hook=(
                    self.trace_recorder.rung_entered
                    if self.trace_recorder is not None
                    else None
                ),
            )
            policy_failed: list[str] = []
            transient: list[str] = []
            # Phase 1: cordon every host first (no half-schedulable slice),
            # then drain hosts concurrently.
            for node in group.nodes:
                try:
                    helper.run_cordon_or_uncordon(node, True)
                except Exception as e:  # noqa: BLE001 — API error: retry
                    logger.error("failed to cordon %s: %s", node.name, e)
                    transient.append(node.name)
            # (Cordon errors are always transient — policy failures can
            # only arise in the drain phase below.)
            if not transient:
                with ThreadPoolExecutor(
                    max_workers=min(self.max_hosts_concurrency, group.size())
                ) as pool:
                    futures = {
                        pool.submit(helper.run_node_drain, node.name): node
                        for node in group.nodes
                    }
                    for fut, node in futures.items():
                        try:
                            fut.result()
                        except FencedError:
                            # Leadership moved mid-drain: abandon quietly.
                            # The new leader re-adopts from the persisted
                            # rungs; any transition here would race it.
                            return
                        except DrainError as e:
                            logger.error(
                                "failed to drain %s: %s", node.name, e
                            )
                            log_event(
                                self.event_recorder,
                                node.name,
                                EVENT_TYPE_WARNING,
                                self.keys.event_reason,
                                f"Failed to drain the node, {e}",
                            )
                            policy_failed.append(node.name)
                        except Exception as e:  # noqa: BLE001 — transient
                            logger.warning(
                                "transient error draining %s (will retry): "
                                "%s",
                                node.name,
                                e,
                            )
                            transient.append(node.name)

            # Group barrier: all-or-nothing transition — fenced, so a
            # deposed leader's worker cannot flip the slice after handoff.
            # The term fence re-checks here too: a successor elected
            # mid-drain has stamped its term by the time we transition.
            if self.fence is not None and not self.fence():
                return
            if self.term_fence is not None and not self.term_fence(
                group.nodes
            ):
                return
            if policy_failed:
                self.last_error[group.id] = (
                    f"drain policy failure on host(s) {policy_failed}"
                )
                self._set_group_state(group, UpgradeState.FAILED)
            elif transient:
                # No transition: the group stays drain-required and the
                # next reconcile pass re-schedules the (idempotent) drain.
                self.last_error[group.id] = (
                    f"transient drain errors on host(s) {transient}; retrying"
                )
                logger.info(
                    "group %s drain will be retried next pass "
                    "(transient errors on %s)",
                    group.id,
                    transient,
                )
            else:
                self.last_error.pop(group.id, None)
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_NORMAL,
                        self.keys.event_reason,
                        "Successfully drained the node",
                    )
                self._set_group_state(group, UpgradeState.POD_RESTART_REQUIRED)
        finally:
            self._draining.remove(group.id)

    def _set_group_state(self, group: UpgradeGroup, state: UpgradeState) -> None:
        try:
            self.provider.change_nodes_upgrade_state(group.nodes, state)
        except Exception as e:  # noqa: BLE001 — async actor: next pass re-drives
            logger.error("failed to set group %s state %s: %s", group.id, state, e)
