"""Digital-twin validation of an analytic plan.

Clones a cluster's driver-managed objects into a fresh ``FakeCluster``
and runs the REAL upgrade engine (`upgrade_state.py`, optionally through
`upgrade/sharded.py`) against the clone on an accelerated fake clock —
so the projection in a :class:`~planner.RollPlan` is validated against
actual engine behavior (admission order, budget arbitration, window
gating, elastic timeouts), not against a second model of it.

What-if knobs ride through :class:`~planner.PlanAssumptions` plus twin
options: inject preemptions (stamp the platform preemption annotation),
decline-all elastic offers (no responder answers, so every offer ages
out at ``offerTimeoutSeconds`` under the accelerated clock — the
decline-equivalent fallback to the classic drain path), or close a
window (pass a policy whose pool cron is out-of-window).

The twin observes WAVES the same way the fuzz cross-check defines them:
a wave is the set of groups first admitted (state-label set leaves the
settled lattice) in the same reconcile tick.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.artifacts.dag import artifact_dag_of
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s import (
    ContainerStatus,
    FakeCluster,
    ObjectMeta,
    Pod,
    PodPhase,
)
from k8s_operator_libs_tpu_torch.k8s.objects import PodSpec, PodStatus
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    NODE_PREEMPTION_ANNOTATION,
    UpgradeState,
)

logger = get_logger(__name__)

# Label values that do NOT mean "this group is being worked on".
_SETTLED = {
    "",
    UpgradeState.UPGRADE_REQUIRED.value,
    UpgradeState.DONE.value,
}


class AcceleratedClock:
    """Additive offset over the process clocks, installed module-wide.

    The engine's durable clocks read ``time.time()`` and its dwell
    tracking reads ``time.monotonic()``; patching both lets the twin
    skip hours of offer timeouts / window closures in milliseconds.
    ``time.sleep`` is left real so worker polling still yields.  Always
    uninstall in a ``finally`` — the patch is process-global.
    """

    def __init__(self) -> None:
        self.offset = 0.0
        self._real_time = time.time
        self._real_monotonic = time.monotonic
        self._installed = False

    def now(self) -> float:
        return self._real_time() + self.offset

    def install(self) -> None:
        if self._installed:
            return
        time.time = self.now
        time.monotonic = lambda: self._real_monotonic() + self.offset
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        time.time = self._real_time
        time.monotonic = self._real_monotonic
        self._installed = False

    def advance(self, seconds: float) -> None:
        self.offset += seconds


@dataclass
class TwinResult:
    """What the real engine actually did to the cloned fleet."""

    waves: list[list[str]] = field(default_factory=list)
    node_wave: dict[str, int] = field(default_factory=dict)
    converged: bool = False
    ticks: int = 0
    virtual_duration_s: float = 0.0
    unfinished: list[str] = field(default_factory=list)
    held: list[str] = field(default_factory=list)
    elastic_negotiations: dict[str, int] = field(default_factory=dict)
    write_verbs: int = 0
    # Engine admission telemetry: the ordering mode actually used over
    # the roll (packed requires a fresh anchored plan) and the
    # cumulative manager.admission_stats counters.
    admission_mode: str = "greedy"
    admission: dict = field(default_factory=dict)

    @property
    def wave_count(self) -> int:
        return len(self.waves)

    def wave_of(self, group_id: str) -> Optional[int]:
        for i, wave in enumerate(self.waves):
            if group_id in wave:
                return i
        return None


def clone_cluster(
    source_client,
    namespace: str,
    driver_labels: dict[str, str],
    artifact_selectors: Optional[dict[str, dict[str, str]]] = None,
) -> FakeCluster:
    """Deep-copy every driver-managed object the engine reads — nodes,
    driver DaemonSets + their ControllerRevisions, driver pods, and
    (multi-artifact stacks) every artifact selector's DaemonSets and
    pods — into a fresh FakeCluster.  Read-only against the source."""
    twin = FakeCluster()
    for node in source_client.list_nodes():
        twin.create_node(copy.deepcopy(node))
    seen_ds: set = set()
    seen_pods: set = set()
    selector_sets = [driver_labels] + list(
        (artifact_selectors or {}).values()
    )
    for sel in selector_sets:
        for ds in source_client.list_daemon_sets(namespace, sel):
            key = (ds.namespace, ds.name)
            if key in seen_ds:
                continue
            seen_ds.add(key)
            twin.create_daemon_set(copy.deepcopy(ds))
    for rev in source_client.list_controller_revisions(namespace):
        twin.create_controller_revision(copy.deepcopy(rev))
    for sel in selector_sets:
        for pod in source_client.list_pods(
            namespace=namespace, match_labels=sel
        ):
            key = (pod.namespace, pod.name)
            if key in seen_pods:
                continue
            seen_pods.add(key)
            twin.create_pod(copy.deepcopy(pod))
    return twin


def _install_kubelet(twin: FakeCluster, manager) -> None:
    """Emulate the DaemonSet controller + kubelet on the twin: a deleted
    driver pod is recreated Ready from the owning DaemonSet's NEWEST
    revision (same contract as the test fixtures' recreate hook)."""

    def hook(pod: Pod) -> None:
        owners = pod.metadata.owner_references
        if not owners:
            return
        try:
            ds = twin.get_daemon_set(pod.namespace, owners[0].name)
        except Exception:
            return
        if owners[0].uid != ds.metadata.uid:
            return
        try:
            ds_hash = (
                manager.pod_manager
                .get_daemonset_controller_revision_hash(ds)
            )
        except ValueError:
            return
        labels = dict(ds.spec.selector.match_labels)
        labels["controller-revision-hash"] = ds_hash
        twin.create_pod(
            Pod(
                metadata=ObjectMeta(
                    name=pod.name,
                    namespace=pod.namespace,
                    labels=labels,
                    owner_references=list(owners),
                ),
                spec=PodSpec(node_name=pod.spec.node_name),
                status=PodStatus(
                    phase=PodPhase.RUNNING,
                    container_statuses=[ContainerStatus(ready=True)],
                ),
            )
        )

    twin.on_pod_deleted(hook)


def _group_states(
    twin: FakeCluster, keys, membership: dict[str, list[str]]
) -> dict[str, set]:
    """group id -> set of member state-label values, quorum-read."""
    out: dict[str, set] = {}
    for gid, nodes in membership.items():
        out[gid] = {
            twin.get_node(n, cached=False).labels.get(
                keys.state_label, ""
            )
            for n in nodes
        }
    return out


def run_twin(
    source_client,
    namespace: str,
    driver_labels: dict[str, str],
    policy,
    keys=None,
    preempt_groups: Optional[set] = None,
    sharded: bool = False,
    shards: int = 4,
    max_ticks: int = 400,
    stall_advance_s: float = 60.0,
    max_virtual_s: float = 14 * 86400.0,
) -> TwinResult:
    """Clone the fleet and roll it with the real engine until every
    rollable group is DONE (or the tick/virtual-time budget runs out).

    ``preempt_groups``: group ids whose nodes get the platform
    preemption annotation stamped on the clone — the engine must hold
    them budget-free and the roll must complete around them.
    ``sharded=True`` drives the roll through ``ShardedReconciler``'s
    full-resync path instead of direct apply_state, so ledger
    arbitration is exercised exactly as in a --sharded controller.
    """
    from k8s_operator_libs_tpu_torch.upgrade import (
        ClusterUpgradeStateManager,
        UpgradeKeys,
    )

    keys = keys or UpgradeKeys()
    # Multi-artifact policies: the twin must hold every artifact's
    # DaemonSet + pods, or the engine would see them vacuously synced
    # and skip the serialized steps the plan is meant to validate.
    try:
        dag = artifact_dag_of(policy)
    except Exception:
        dag = None
    artifact_selectors = None
    if dag is not None:
        primary = dag.primary()
        artifact_selectors = {
            name: dict(dag.artifact(name).match_labels)
            for name in dag.topo_order()
            if name != primary
        }
    twin = clone_cluster(
        source_client,
        namespace,
        driver_labels,
        artifact_selectors=artifact_selectors,
    )
    policy = copy.deepcopy(policy)

    clock = AcceleratedClock()
    result = TwinResult()
    clock.install()
    try:
        mgr = ClusterUpgradeStateManager(
            twin, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0
        )
        _install_kubelet(twin, mgr)
        # Plan-guided admission needs the same wiring the controller
        # has: a drift watchdog anchored before each apply so packed
        # mode orders admission off a fresh plan.  Greedy twins skip it
        # (the engine would ignore the plan and per-tick observe costs
        # a plan_roll + find_infeasibilities).
        watchdog = None
        planning_spec = getattr(policy, "planning", None)
        if (
            planning_spec is not None
            and getattr(planning_spec, "admission_mode", "greedy")
            == "packed"
        ):
            from k8s_operator_libs_tpu_torch.planning.drift import DriftWatchdog

            watchdog = DriftWatchdog(keys)
            watchdog.configure(planning_spec)
            mgr.drift_watchdog = watchdog

        sharded_reconciler = None
        if sharded:
            from k8s_operator_libs_tpu_torch.upgrade.sharded import (
                ShardedReconciler,
            )

            sharded_reconciler = ShardedReconciler(
                mgr, namespace, driver_labels, shards=shards
            )

        # Membership + what-if preemptions from the initial snapshot.
        state = mgr.build_state(namespace, driver_labels, policy)
        membership = {
            g.id: [n.name for n in g.nodes] for g in state.all_groups()
        }
        for gid in preempt_groups or ():
            for node_name in membership.get(gid, []):
                twin.patch_node_annotations(
                    node_name, {NODE_PREEMPTION_ANNOTATION: "true"}
                )
                result.held.append(gid)

        admitted_at: dict[str, int] = {}
        last_states = _group_states(twin, keys, membership)
        writes_before = _write_verbs(twin)
        t0 = clock.now()
        tick = 0
        while tick < max_ticks and clock.now() - t0 <= max_virtual_s:
            tick += 1
            state = mgr.build_state(namespace, driver_labels, policy)
            if watchdog is not None:
                # Mirror reconcile_once: anchor/refresh the plan from
                # this snapshot BEFORE acting on it.
                watchdog.observe(mgr, state, policy, now=clock.now())
            if sharded_reconciler is not None:
                started = sharded_reconciler.observe_full_state(
                    state, policy, started=clock.now()
                )
                mgr.apply_state(state, policy)
                sharded_reconciler.complete_full_resync(started)
                sharded_reconciler.wait_idle(30.0)
            else:
                mgr.apply_state(state, policy)
            mgr.wait_for_async_work(30.0)

            states = _group_states(twin, keys, membership)
            for gid, values in states.items():
                if gid in admitted_at:
                    continue
                was, now_settled = last_states.get(gid, set()), values
                left_settled = bool(now_settled - _SETTLED)
                completed_in_one = (
                    was
                    and was != {UpgradeState.DONE.value}
                    and now_settled == {UpgradeState.DONE.value}
                )
                if left_settled or completed_in_one:
                    admitted_at[gid] = tick
            progressed = states != last_states
            last_states = states

            pending = [
                gid
                for gid, values in states.items()
                if gid not in (preempt_groups or set())
                and values != {UpgradeState.DONE.value}
            ]
            if not pending:
                break
            if not progressed:
                clock.advance(stall_advance_s)
        result.ticks = tick
        result.virtual_duration_s = clock.now() - t0
        result.write_verbs = _write_verbs(twin) - writes_before
        result.elastic_negotiations = dict(mgr.elastic_negotiations)
        # The final tick sees an inactive roll (plan dropped), so the
        # live mode flag has already fallen back — report packed if any
        # admission during the roll actually used the packed ordering.
        result.admission = dict(mgr.admission_stats)
        result.admission_mode = (
            "packed" if result.admission.get("packed_admitted") else "greedy"
        )

        # Assemble waves from admission ticks.
        by_tick: dict[int, list[str]] = {}
        for gid, at in admitted_at.items():
            by_tick.setdefault(at, []).append(gid)
        for at in sorted(by_tick):
            wave = sorted(by_tick[at])
            index = len(result.waves)
            result.waves.append(wave)
            for gid in wave:
                for node_name in membership.get(gid, []):
                    result.node_wave[node_name] = index
        final = _group_states(twin, keys, membership)
        result.unfinished = sorted(
            gid
            for gid, values in final.items()
            if gid not in (preempt_groups or set())
            and values != {UpgradeState.DONE.value}
        )
        result.converged = not result.unfinished
        if sharded_reconciler is not None:
            sharded_reconciler.shutdown()
        return result
    finally:
        clock.uninstall()


def _write_verbs(cluster: FakeCluster) -> int:
    prefixes = ("patch", "create", "delete", "evict", "update", "post", "put")
    return sum(
        count
        for verb, count in cluster.stats.items()
        if verb.lower().startswith(prefixes)
    )
