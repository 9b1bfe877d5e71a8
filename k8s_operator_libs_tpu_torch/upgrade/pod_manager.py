"""Pod manager: job-completion waits, workload eviction, driver-pod restart.

Capability parity with the reference's ``PodManager`` (pod_manager.go):

- revision-hash detection of outdated driver pods — pod's
  ``controller-revision-hash`` label vs the DaemonSet's newest
  ControllerRevision (pod_manager.go:87-121) — the up-to-date/outdated
  detector for the whole machine;
- ``schedule_check_on_pod_completion`` — wait (with optional timeout
  annotation) for user jobs to finish (pod_manager.go:259-320, 334-371);
- ``schedule_pod_eviction`` — async deletion of workload pods matched by a
  consumer-supplied filter via the drain helper, with fallback to drain or
  upgrade-failed on partial failure (pod_manager.go:125-232, 396-406);
- ``schedule_pods_restart`` — delete outdated driver pods so the DaemonSet
  recreates them (pod_manager.go:236-254).

TPU redesign: all three run at :class:`UpgradeGroup` granularity with
group-barrier transitions — a slice advances only when **every** host is
clear, and partial eviction failure fails (or drains) the whole slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from k8s_operator_libs_tpu_torch.api.v1alpha1 import (
    PodDeletionSpec,
    WaitForCompletionSpec,
)
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.drain import (
    DrainHelper,
    EscalationConfig,
    EscalationStats,
    FencedError,
)
from k8s_operator_libs_tpu_torch.k8s.objects import DaemonSet, Pod, PodPhase
from k8s_operator_libs_tpu_torch.k8s.selectors import selector_from_match_labels
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
    StringSet,
    UpgradeKeys,
    WorkerTracker,
    log_event,
    run_batch,
)

logger = get_logger(__name__)

# Label key holding a pod's controller revision hash (pod_manager.go:70-73).
POD_CONTROLLER_REVISION_HASH_LABEL_KEY = "controller-revision-hash"

# A PodDeletionFilter returns True if the pod must be deleted before the
# driver upgrade (consumer-supplied, pod_manager.go:75-76).
PodDeletionFilter = Callable[[Pod], bool]


@dataclass
class PodManagerConfig:
    """Selector/config for one scheduling call (pod_manager.go:62-68,
    lifted from nodes to groups)."""

    groups: list[UpgradeGroup] = field(default_factory=list)
    deletion_spec: Optional[PodDeletionSpec] = None
    wait_for_completion_spec: Optional[WaitForCompletionSpec] = None
    drain_enabled: bool = False


class PodManager:
    def __init__(
        self,
        client: KubeClient,
        node_state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        pod_deletion_filter: Optional[PodDeletionFilter] = None,
        event_recorder: Optional[EventRecorder] = None,
        max_hosts_concurrency: int = 32,
        poll_interval_s: float = 1.0,
        escalation_stats: Optional[EscalationStats] = None,
    ) -> None:
        self.client = client
        self.provider = node_state_provider
        self.keys = keys
        self.pod_deletion_filter = pod_deletion_filter
        self.event_recorder = event_recorder
        self.max_hosts_concurrency = max_hosts_concurrency
        # Eviction-escalation ladder: PodDeletionSpec carries no ladder
        # knobs of its own, so the upgrade manager derives the config from
        # the policy's drain spec each pass and sets it here; the stats
        # object is shared across every DrainHelper owner.
        self.escalation: Optional[EscalationConfig] = None
        self.escalation_stats = escalation_stats
        # Crash-safety hooks wired by the upgrade manager (see
        # drain_manager.py): leadership fence + durable rung store.
        # term_fence adds the adoption-stamp term check (quorum read,
        # worker entry only).
        self.fence = None
        self.term_fence = None
        self.rung_store = None
        # Roll tracing (obs/trace.py): fanned in by the state
        # manager; feeds eviction-rung entries into the span tree.
        self.trace_recorder = None
        # Apiserver-facing poll cadence for eviction waits (kubectl-like
        # 1 s in production; tests pass the suite's fast interval).
        self.poll_interval_s = poll_interval_s
        self._groups_in_progress = StringSet()  # pod_manager.go:47 analogue
        self._tracker = WorkerTracker()

    # -- revision hashes (the outdated-pod detector) -------------------------

    def get_pod_controller_revision_hash(self, pod: Pod) -> str:
        try:
            return pod.labels[POD_CONTROLLER_REVISION_HASH_LABEL_KEY]
        except KeyError:
            raise ValueError(
                f"controller-revision-hash label not present for pod {pod.name}"
            ) from None

    def get_daemonset_controller_revision_hash(self, daemonset: DaemonSet) -> str:
        """Newest ControllerRevision hash for the DaemonSet
        (pod_manager.go:94-121)."""
        selector = selector_from_match_labels(daemonset.spec.selector.match_labels)
        revisions = [
            r
            for r in self.client.list_controller_revisions(
                daemonset.namespace, selector
            )
            if r.metadata.name.startswith(daemonset.name)
        ]
        if not revisions:
            raise ValueError(f"no revision found for daemonset {daemonset.name}")
        newest = max(revisions, key=lambda r: r.revision)
        return newest.metadata.name.removeprefix(f"{daemonset.name}-")

    # -- wait-for-jobs -------------------------------------------------------

    def schedule_check_on_pod_completion(self, config: PodManagerConfig) -> None:
        """Check each group for running workload pods; a group advances to
        pod-deletion-required only when every host is clear (or the
        wait timeout expired)."""
        spec = config.wait_for_completion_spec
        if spec is None:
            raise ValueError("wait-for-completion spec should not be empty")
        for group in config.groups:
            running = False
            for node in group.nodes:
                pods = self.client.list_pods(
                    label_selector=spec.pod_selector, node_name=node.name
                )
                if any(self.is_pod_running_or_pending(p) for p in pods):
                    running = True
                    break
            if running:
                logger.info("workload pods still running in group %s", group.id)
                if spec.timeout_second != 0:
                    self._handle_timeout_on_pod_completions(
                        group, int(spec.timeout_second)
                    )
                continue
            # All hosts clear: drop the tracking annotation, advance group.
            self.provider.change_nodes_upgrade_annotation(
                group.nodes,
                self.keys.pod_completion_start_time_annotation,
                "null",
            )
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.POD_DELETION_REQUIRED
            )
            logger.info(
                "group %s -> %s", group.id, UpgradeState.POD_DELETION_REQUIRED
            )

    def _handle_timeout_on_pod_completions(
        self, group: UpgradeGroup, timeout_seconds: int
    ) -> None:
        """Start-time annotation + timeout handling (pod_manager.go:334-371),
        tracked on every host of the group."""
        key = self.keys.pod_completion_start_time_annotation
        now = int(time.time())
        start = group_clock_start(self.provider, group, key, now)
        if start is None:
            return  # freshly stamped; clock evaluated next pass
        if now > start + timeout_seconds:
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.POD_DELETION_REQUIRED
            )
            self.provider.change_nodes_upgrade_annotation(group.nodes, key, "null")
            logger.info("group %s wait-for-jobs timed out", group.id)

    # -- pod eviction --------------------------------------------------------

    def schedule_pod_eviction(self, config: PodManagerConfig) -> None:
        """Async per-group eviction of workload pods matching the deletion
        filter (pod_manager.go:125-232)."""
        if not config.groups:
            logger.info("no groups scheduled for pod deletion")
            return
        if config.deletion_spec is None:
            raise ValueError("pod deletion spec should not be empty")
        if self.pod_deletion_filter is None:
            raise ValueError("pod deletion filter is not configured")
        for group in config.groups:
            if self._groups_in_progress.has(group.id):
                logger.info("group %s already deleting pods, skipping", group.id)
                continue
            self._groups_in_progress.add(group.id)
            self._tracker.spawn(
                lambda g=group, s=config.deletion_spec, d=config.drain_enabled: (
                    self._evict_group(g, s, d)
                ),
                name=f"evict-{group.id}",
            )

    def _evict_group(
        self, group: UpgradeGroup, spec: PodDeletionSpec, drain_enabled: bool
    ) -> None:
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
                additional_filters=[self.pod_deletion_filter],
                poll_interval_s=self.poll_interval_s,
                escalation=self.escalation,
                escalation_stats=self.escalation_stats,
                fence=self.fence,
                rung_store=self.rung_store,
                trace_hook=(
                    self.trace_recorder.rung_entered
                    if self.trace_recorder is not None
                    else None
                ),
            )
            total_to_delete = 0
            failed = False
            deletable: list[Pod] = []
            for node in group.nodes:
                pods = self.client.list_pods(node_name=node.name)
                to_delete = [p for p in pods if self.pod_deletion_filter(p)]
                total_to_delete += len(to_delete)
                if not to_delete:
                    continue
                delete_list, errors = helper.get_pods_for_deletion(node.name)
                if len(delete_list.pods()) != len(to_delete) or errors:
                    for err in errors:
                        logger.error(
                            "drain helper error on %s: %s", node.name, err
                        )
                    failed = True
                    break
                deletable.extend(delete_list.pods())

            if failed:
                self._update_group_to_drain_or_failed(group, drain_enabled)
                return
            if total_to_delete == 0:
                logger.info("no pods require deletion in group %s", group.id)
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.POD_RESTART_REQUIRED
                )
                return
            try:
                helper.delete_or_evict_pods(deletable)
            except FencedError:
                # Leadership moved mid-eviction: abandon quietly; the new
                # leader resumes from the persisted ladder rungs.
                return
            except Exception as e:  # noqa: BLE001
                logger.error("failed to delete pods in group %s: %s", group.id, e)
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_WARNING,
                        self.keys.event_reason,
                        f"Failed to delete workload pods for the driver upgrade, {e}",
                    )
                self._update_group_to_drain_or_failed(group, drain_enabled)
                return
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.POD_RESTART_REQUIRED
            )
            for node in group.nodes:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_NORMAL,
                    self.keys.event_reason,
                    "Deleted workload pods on the node for the driver upgrade",
                )
        finally:
            self._groups_in_progress.remove(group.id)

    def _update_group_to_drain_or_failed(
        self, group: UpgradeGroup, drain_enabled: bool
    ) -> None:
        """Partial-failure fallback (pod_manager.go:396-406), group-atomic."""
        next_state = UpgradeState.FAILED
        if drain_enabled:
            logger.info(
                "pod deletion failed for group %s but drain is enabled; "
                "will attempt a drain",
                group.id,
            )
            next_state = UpgradeState.DRAIN_REQUIRED
        try:
            self.provider.change_nodes_upgrade_state(group.nodes, next_state)
        except Exception as e:  # noqa: BLE001 — next pass re-drives
            logger.error("failed to set group %s state: %s", group.id, e)

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        return self._tracker.wait_idle(timeout_s)

    # -- driver pod restart --------------------------------------------------

    def schedule_pods_restart(self, pods: Sequence[Pod]) -> None:
        """Delete outdated driver pods so the DaemonSet controller recreates
        them with the new template (pod_manager.go:236-254).  Deletes run
        concurrently — on a 16-host slice the restart wave is one batch."""
        pods = list(pods)
        if not pods:
            logger.info("no pods scheduled to restart")
            return

        def _delete(pod: Pod) -> None:
            try:
                self.client.delete_pod(pod.namespace, pod.name)
            except Exception as e:  # noqa: BLE001 — logged + re-raised
                logger.error("failed to delete pod %s: %s", pod.name, e)
                log_event(
                    self.event_recorder,
                    pod.name,
                    EVENT_TYPE_WARNING,
                    self.keys.event_reason,
                    f"Failed to restart driver pod {e}",
                )
                raise

        run_batch(
            [(lambda p=p: _delete(p)) for p in pods],
            self.max_hosts_concurrency,
        )

    # -- helpers -------------------------------------------------------------

    def is_pod_running_or_pending(self, pod: Pod) -> bool:
        return pod.status.phase in (PodPhase.RUNNING, PodPhase.PENDING)
