"""A GPU node's DCN ring reaches the engine.

A GPU node carries no TPU labels, so the engine gives it no slice, and
the reference reads a group's DCN ring from its slice alone.  The port
reads it through ``fleet.profiles.group_dcn_group``: the slice's ring,
else the node's ``keys.dcn_group_label``, then its JobSet.  So on four
GFD-labelled H100 nodes in two rings, with two upgrades at a time and
anti-affinity on, the port never has two nodes of one ring in flight,
walks the states the JAX engine walks on the TPU analogue (four one-host
slices in the same rings), and the same holds through the sharded
budget ledger, the planner's waves, the status rows and the gate's
``require_dcn_check``.
"""

from __future__ import annotations

import time

import pytest

from k8s_operator_libs_tpu.planning.planner import plan_roll as jplan_roll
from k8s_operator_libs_tpu_torch.fleet import profiles as tprofiles
from k8s_operator_libs_tpu_torch.health.probes import CheckResult
from k8s_operator_libs_tpu_torch.health.report import HealthReport
from k8s_operator_libs_tpu_torch.health.slice_prober import NodeReportProber
from k8s_operator_libs_tpu_torch.keys import driver_keys
from k8s_operator_libs_tpu_torch.planning.planner import plan_roll as tplan_roll
from k8s_operator_libs_tpu_torch.status import gather
from k8s_operator_libs_tpu_torch.topology.slices import (
    JOBSET_NAME_LABEL,
    JOBSET_NAMESPACE_LABEL,
)
from k8s_operator_libs_tpu_torch.upgrade.sharded import ShardedReconciler
from tests.test_torch_control_plane import ENGINES, ScriptedProber

N = 4
# pool-0 and pool-1 back one data-parallel job, pool-2 and pool-3 another.
RINGS = ("ring-a", "ring-a", "ring-b", "ring-b")
GFD = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
       "nvidia.com/gpu.count": "8"}
SETTLED = ("", "upgrade-required", "upgrade-done")


def _ring_labels(keys, source: str, i: int) -> dict:
    """Pool ``i``'s ring as a label of ``source``: the ring label, or a
    JobSet (ring-b's namespaced, so both JobSet forms are read)."""
    if source == "label":
        return {keys.dcn_group_label: RINGS[i]}
    labels = {JOBSET_NAME_LABEL: f"train-{RINGS[i][-1]}"}
    if RINGS[i] == "ring-b":
        labels[JOBSET_NAMESPACE_LABEL] = "team-b"
    return labels


def _ring_of(i: int, source: str) -> str:
    if source == "label":
        return RINGS[i]
    return "team-b/train-b" if RINGS[i] == "ring-b" else "train-a"


def _policy(api):
    return api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=2,
        max_unavailable=api.IntOrString("50%"),
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
        dcn_anti_affinity=True,
    )


def _fleet(engine: str, fleet: str, source: str):
    """``fleet`` "gfd": four GFD-labelled H100 nodes ``pool-i`` (no
    slice) under the GPU operator's keys; "tpu": four one-host TPU
    slices ``pool-i`` under the reference's keys.  Returns the cluster,
    keys, fixtures module and each pool's node name."""
    api, k8s, upgrade, fixtures = ENGINES[engine]
    cluster = k8s.FakeCluster()
    keys = driver_keys() if fleet == "gfd" else upgrade.UpgradeKeys()
    fx = fixtures.ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = []
    for i in range(N):
        labels = _ring_labels(keys, source, i)
        if fleet == "gfd":
            nodes.append(fx.node(name=f"pool-{i}", labels={**GFD, **labels}))
        else:
            nodes += fx.tpu_slice(f"pool-{i}", hosts=1, labels=labels)
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    fx.auto_recreate_driver_pods(ds, "h2")
    return cluster, keys, fixtures, [n.name for n in nodes]


def _ring_roll(engine: str, fleet: str, source: str, sharded: bool = False):
    """Roll ``_fleet`` from h1 to h2 with two upgrades at a time and
    anti-affinity on, one pass a tick (with ``sharded`` the passes are a
    ``ShardedReconciler``'s full resyncs, its budget ledger admitting).
    Returns each pool's states (repeats collapsed), the most nodes of one
    ring and of the fleet in flight after any pass, the probed groups,
    and the rings the ledger held."""
    api, k8s, upgrade, _ = ENGINES[engine]
    cluster, keys, fixtures, names = _fleet(engine, fleet, source)
    policy = _policy(api)
    mgr = upgrade.ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0
    )
    prober = ScriptedProber(upgrade)
    mgr.with_validation_enabled(prober)
    reconciler = (
        ShardedReconciler(mgr, fixtures.NAMESPACE, fixtures.DRIVER_LABELS,
                          shards=2)
        if sharded else None
    )
    seen: dict[int, list[str]] = {i: [] for i in range(N)}
    ring_high = concurrent_high = 0
    ledger_rings: set = set()
    try:
        for _ in range(120):
            state = mgr.build_state(fixtures.NAMESPACE,
                                    fixtures.DRIVER_LABELS, policy)
            if reconciler is not None:
                started = reconciler.observe_full_state(state, policy)
                ledger_rings |= set(reconciler.ledger._dcn_of.values())
            mgr.apply_state(state, policy)
            if reconciler is not None:
                reconciler.complete_full_resync(started)
            assert mgr.wait_for_async_work(30.0)
            states = [cluster.get_node(n).labels.get(keys.state_label, "")
                      for n in names]
            for i, s in enumerate(states):
                if not seen[i] or seen[i][-1] != s:
                    seen[i].append(s)
            busy = [s not in SETTLED for s in states]
            ring_high = max(ring_high, sum(busy[:2]), sum(busy[2:]))
            concurrent_high = max(concurrent_high, sum(busy))
            if all(s == "upgrade-done" for s in states):
                break
        else:
            raise AssertionError(f"{engine} {fleet} roll did not converge: "
                                 f"{seen}")
    finally:
        if reconciler is not None:
            reconciler.shutdown()
    calls = [c.split("-w")[0] for c in prober.calls]
    return seen, ring_high, concurrent_high, calls, ledger_rings


@pytest.mark.parametrize("source", ["label", "jobset"])
def test_a_gfd_fleet_in_two_rings_rolls_as_the_tpu_analogue(source):
    port, ring_high, concurrent, port_calls, _ = _ring_roll(
        "port", "gfd", source)
    ref, ref_ring_high, ref_concurrent, ref_calls, _ = _ring_roll(
        "jax", "tpu", source)
    # Never two of one ring, but two of different rings at once.
    assert (ring_high, concurrent) == (1, 2)
    assert (ref_ring_high, ref_concurrent) == (1, 2)
    assert port == ref
    assert port_calls == ref_calls
    # Admitted by id, the ring's second node deferred: pool-0 and pool-2
    # first, then pool-1 and pool-3.
    assert port_calls[:2] == ["pool-0", "pool-2"]
    for states in port.values():
        assert states[-1] == "upgrade-done"


@pytest.mark.parametrize("source", ["label", "jobset"])
def test_the_sharded_ledger_holds_a_gfd_ring(source):
    seen, ring_high, concurrent, calls, ledger_rings = _ring_roll(
        "port", "gfd", source, sharded=True)
    assert (ring_high, concurrent) == (1, 2)
    assert ledger_rings == {_ring_of(0, source), _ring_of(2, source)}
    assert calls[:2] == ["pool-0", "pool-2"]
    assert all(s[-1] == "upgrade-done" for s in seen.values())


def _gfd_state(states: dict, source: str = "label"):
    """The port's engine over four GFD ring nodes at ``states`` (pool
    index -> UpgradeState), the rest at upgrade-required."""
    api, k8s, upgrade, fixtures = ENGINES["port"]
    cluster = k8s.FakeCluster()
    keys = driver_keys()
    fx = fixtures.ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    for i in range(N):
        node = fx.node(
            name=f"pool-{i}",
            state=states.get(i, upgrade.UpgradeState.UPGRADE_REQUIRED),
            labels={**GFD, **_ring_labels(keys, source, i)},
        )
        fx.driver_pod(node, ds, hash_suffix="h1")
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    mgr = upgrade.ClusterUpgradeStateManager(cluster, keys=keys)
    policy = _policy(api)
    state = mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS,
                            policy)
    return cluster, keys, mgr, policy, state


@pytest.mark.parametrize("anti_affinity", [True, False])
def test_a_gfd_rejoin_waits_for_its_ring_in_the_ledger(anti_affinity):
    """pool-0 drains while pool-1, of its ring, is parked in quarantine:
    the ledger records pool-0's ring only with the knob on, and then
    the rejoin claim is refused (the reference's ledger rule, on GFD
    nodes)."""
    from k8s_operator_libs_tpu_torch.upgrade.sharded import BudgetLedger

    UpgradeState = ENGINES["port"][2].UpgradeState
    _, _, mgr, policy, state = _gfd_state({
        0: UpgradeState.DRAIN_REQUIRED, 1: UpgradeState.QUARANTINED,
    })
    policy.dcn_anti_affinity = anti_affinity
    policy.max_unavailable = ENGINES["port"][0].IntOrString("100%")
    ledger = BudgetLedger()
    ledger.sync_from_state(mgr, state, policy)
    mgr.budget_ledger = ledger
    group = next(g for g in state.all_groups() if g.id == "pool-1")
    assert ledger._dcn_of == ({"pool-0": "ring-a"} if anti_affinity else {})
    assert mgr._rejoin_budget_free(state, policy, group) is (
        not anti_affinity)


@pytest.mark.parametrize("source", ["label", "jobset"])
def test_the_planner_waves_a_gfd_fleet_by_ring(source):
    _, _, mgr, policy, state = _gfd_state({}, source)
    plan = tplan_roll(mgr, state, policy, now=1_700_000_000.0)
    waves = {g.group_id: g.wave for g in plan.groups}
    assert waves["pool-0"] == waves["pool-2"] < waves["pool-1"] == (
        waves["pool-3"])
    # The JAX planner waves the TPU analogue the same way.
    api, _, upgrade, fixtures = ENGINES["jax"]
    cluster, keys, _, _ = _fleet("jax", "tpu", source)
    jmgr = upgrade.ClusterUpgradeStateManager(cluster, keys=keys)
    jpolicy = _policy(api)
    jstate = jmgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS,
                              jpolicy)
    jplan = jplan_roll(jmgr, jstate, jpolicy, now=1_700_000_000.0)
    assert {g.group_id: g.wave for g in jplan.groups} == waves


def test_the_status_rows_show_a_gfd_ring():
    cluster, keys, _, _, _ = _gfd_state({}, "jobset")
    fixtures = ENGINES["port"][3]
    status = gather(cluster, fixtures.NAMESPACE, fixtures.DRIVER_LABELS,
                    keys=keys)
    assert {g["group"]: g["dcn_group"] for g in status["groups"]} == {
        f"pool-{i}": _ring_of(i, "jobset") for i in range(N)
    }


def _report(node: str, dcn_check: str = "") -> str:
    checks = [CheckResult("device_enumeration", True, 0.0, "8 devices",
                          {"devices": 8.0})]
    if dcn_check:
        checks.append(CheckResult(dcn_check, True, 1.0, "ok"))
    return HealthReport(node_name=node, driver_revision="", checks=checks,
                        timestamp=time.time(), visible_devices=8).to_json()


@pytest.mark.parametrize(
    "ring, dcn_check, healthy",
    [
        (True, "", False),
        (True, "dcn_collective", True),
        (True, "dcn_reachability", True),
        (False, "", True),
    ],
    ids=["ring_no_check", "ring_collective", "ring_reachability", "no_ring"],
)
def test_the_gate_holds_a_gfd_ring_node_to_a_dcn_check(ring, dcn_check,
                                                       healthy):
    cluster, keys, mgr, policy, _ = _gfd_state({})
    fixtures = ENGINES["port"][3]
    if not ring:
        cluster.patch_node_labels("pool-0", {keys.dcn_group_label: None})
    cluster.patch_node_annotations(
        "pool-0", {keys.health_report_annotation: _report("pool-0",
                                                          dcn_check)})
    state = mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS,
                            policy)
    group = next(g for g in state.all_groups() if g.id == "pool-0")
    assert group.slice_info is None
    prober = NodeReportProber(keys)
    prober.require_dcn_check = True
    verdict = prober.probe(group)
    assert verdict.healthy is healthy, verdict.detail
    if not healthy:
        assert "pool-0" in verdict.detail
        assert "dcn_check is enabled" in verdict.detail
    prober.require_dcn_check = False
    assert prober.probe(group).healthy


def test_a_group_ring_reads_the_slice_then_the_node():
    keys = driver_keys()
    k8s = ENGINES["port"][1]

    def node(labels):
        return k8s.Node(metadata=k8s.ObjectMeta(name="n", labels=labels))

    assert tprofiles.node_dcn_group(node({}), keys) is None
    assert tprofiles.node_dcn_group(
        node({JOBSET_NAME_LABEL: "job"}), keys) == "job"
    assert tprofiles.node_dcn_group(node({
        JOBSET_NAME_LABEL: "job", JOBSET_NAMESPACE_LABEL: "ns",
    }), keys) == "ns/job"
    # The explicit label wins over the JobSet.
    assert tprofiles.node_dcn_group(node({
        JOBSET_NAME_LABEL: "job", keys.dcn_group_label: "ring-x",
    }), keys) == "ring-x"

    class Group:
        slice_info = None
        nodes = [node({keys.dcn_group_label: "ring-x"})]

    assert tprofiles.group_dcn_group(Group, keys) == "ring-x"
    Group.nodes = []
    assert tprofiles.group_dcn_group(Group, keys) is None

    class Slice:
        dcn_group = "ring-s"

    Group.slice_info = Slice
    Group.nodes = [node({keys.dcn_group_label: "ring-x"})]
    assert tprofiles.group_dcn_group(Group, keys) == "ring-s"
