"""The port's federated control plane (``federation/``) against the JAX
package's, on the CPU.

- The 29 tests of ``tests/test_federation.py``, run against the port
  (``port_module``: their source with the package prefix rewritten, on
  the port's fixtures).
- Lockstep: the same federated roll, cluster ``b`` partitioned for
  ``PARTITION_TICKS`` ticks once it holds budget, on both packages (each
  its own copy of that file's ``Member`` and ``make_federation``): the
  same phase, partitioned members and node states after every tick, and
  the same ledger, registry, store-write and transition figures.
- A GPU fleet: ``plan_federated`` over clusters of GPU Feature
  Discovery-labelled nodes gives every group its H100 part.
- The port's bench stage, ``bench.federation_roll`` on 3 × 8 nodes with
  a 5-tick partition, gives the JAX package's figures.
- ``UpgradeMetrics.observe_federation`` renders the same exposition from
  both packages' coordinators.
"""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import tests.test_federation as jfed
from k8s_operator_libs_tpu_torch import bench
from k8s_operator_libs_tpu_torch.federation import (
    ClusterHealth,
    plan_federated,
)
from k8s_operator_libs_tpu_torch.fleet.profiles import generation_of
from k8s_operator_libs_tpu_torch.metrics import UpgradeMetrics as TMetrics
from k8s_operator_libs_tpu.metrics import UpgradeMetrics as JMetrics
from tests.test_torch_control_plane import ENGINES, port_module, port_tests

tfed = port_module("test_federation.py")
globals().update(port_tests(tfed))

PARTITION_TICKS = 5
MODULES = {"jax": jfed, "port": tfed}


def _states(mod, member) -> tuple[str, ...]:
    """``member``'s node states, read past its partition (the fault
    schedule set aside for the read)."""
    schedule, member.fake.fault_schedule = member.fake.fault_schedule, None
    try:
        return tuple(mod.state_of(member.fake, mod.KEYS, n.name)
                     for n in member.nodes)
    finally:
        member.fake.fault_schedule = schedule


def _partitioned_roll(package: str):
    """Three clusters (canary ``a`` in r1, ``b`` and ``c`` in r2) roll;
    ``b`` is cut off once it holds budget and healed ``PARTITION_TICKS``
    ticks later.  Returns each tick's (phase, skipped, node states) and
    the roll's figures."""
    mod = MODULES[package]
    members = [mod.Member("a", "r1"), mod.Member("b", "r2"),
               mod.Member("c", "r2")]
    b = members[1]
    coord, registry, store, _ = mod.make_federation(members)
    coord.adopt()
    for m in members:
        m.start_roll()
    trace = []
    cut = healed = None
    for tick in range(1, 201):
        summary = coord.tick()
        trace.append((coord.phase, tuple(summary["skippedPartitioned"]),
                      {m.name: _states(mod, m) for m in members}))
        if cut is None and coord.global_ledger.cluster_used("b") > 0:
            b.partition()
            cut = tick
        elif cut is not None and healed is None and (
                tick - cut >= PARTITION_TICKS):
            b.heal()
            healed = tick
        if coord.phase == mod.PHASE_DONE:
            break
    ledger = coord.global_ledger
    return trace, {
        "cut": cut, "healed": healed,
        "violations": ledger.violations, "denials": ledger.denials,
        "peak_unavailable": ledger.peak_unavailable,
        "store_writes": store.writes,
        "registry": dict(registry.stats),
        "coordinator": dict(coord.stats),
        "transitions": {m.name: Counter(m.transitions) for m in members},
        "done": [m.all_done() for m in members],
    }


def test_both_federations_roll_in_lockstep():
    port_trace, port = _partitioned_roll("port")
    ref_trace, ref = _partitioned_roll("jax")
    assert port_trace == ref_trace
    assert port == ref
    # The roll went through a partition and healed.
    assert ref["cut"] is not None and ref["healed"] is not None
    assert ref["done"] == [True] * 3
    assert ref["violations"] == 0
    assert ref["registry"]["partitions"] == ref["registry"]["heals"] == 1
    skipped = [t for t in port_trace if t[1] == ("b",)]
    assert len(skipped) >= PARTITION_TICKS - 1
    assert port_trace[-1][0] == tfed.PHASE_DONE


# GPU Feature Discovery's product label of each H100 part.
GFD_PRODUCTS = {
    "h100-pcie": "NVIDIA-H100-PCIe",
    "h100-sxm": "NVIDIA-H100-80GB-HBM3",
    "h100-nvl": "NVIDIA-H100-NVL",
}


def test_plan_federated_reads_a_gpu_group_generation():
    """Two clusters of GFD-labelled nodes in no slice: every planned
    group carries its node's product, an H100 generation of the port's
    profiles, never an unknown one."""
    fixtures = ENGINES["port"][3]
    entries = []
    expected = {}
    for name, region, parts in (("a", "r1", ("h100-sxm", "h100-pcie")),
                                ("b", "r2", ("h100-nvl", "h100-sxm"))):
        cluster = tfed.FakeCluster()
        fx = fixtures.ClusterFixture(cluster, keys=tfed.KEYS)
        ds = fx.daemon_set()
        for i, part in enumerate(parts):
            node = fx.node(name=f"{name}-n{i}", labels={
                "nvidia.com/gpu.product": GFD_PRODUCTS[part],
                "nvidia.com/gpu.count": "8",
            })
            fx.driver_pod(node, ds)
            expected[node.name] = part
        fx.bump_daemon_set_template(ds, "hash-2", 2)
        mgr = tfed.ClusterUpgradeStateManager(cluster, keys=tfed.KEYS)
        policy = tfed.make_policy([("a", "r1"), ("b", "r2")])
        entries.append((
            SimpleNamespace(name=name, region=region, manager=mgr,
                            frozen_groups={}),
            mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS,
                            policy),
            ClusterHealth.REACHABLE,
        ))
    fed = plan_federated(entries, policy, canary_region="r1", now=1000.0)
    seen = {}
    for cluster in ("a", "b"):
        for group in fed.cluster_plan(cluster).plan.groups:
            seen[group.group_id] = generation_of(group.accelerator)
    assert seen == expected


# The JAX package's federated stage at the same size
# (tools/bench_guard.py measure_federation(3, slices=8, hosts=1,
# partition_ticks=5)); at its full size, 3 clusters of 64 one-host
# slices and 20 ticks, both give 79 ticks, 19 skips, a peak of 32.
JAX_STAGE_3X8 = {
    "stage": "federation", "clusters": 3, "nodes_per_cluster": 8,
    "nodes": 24, "ticks": 36, "converged": True, "partition_started": True,
    "partition_window_ticks": 5, "partition_window_skips": 4,
    "partition_window_writes": 0, "global_budget_violations": 0,
    "global_budget_denials": 0, "peak_global_unavailable": 8,
    "store_writes": 3, "partitions_detected": 1, "heals": 1,
}


def test_the_bench_stage_gives_the_jax_stage_figures():
    assert bench.federation_roll(3, 8, 5) == JAX_STAGE_3X8


def _exposition(package: str) -> str:
    """The federation families after a partition of ``b``, rendered."""
    mod = MODULES[package]
    a = mod.Member("a", "r1", slices=1, hosts=1)
    b = mod.Member("b", "r2", slices=1, hosts=1)
    coord, _, _, _ = mod.make_federation([a, b], soak_second=0)
    coord.adopt()
    for m in (a, b):
        m.start_roll()
    b.partition()
    for epoch in range(1000, 1200, 10):
        summary = coord.tick(now_epoch=float(epoch))
        if summary.get("skippedPartitioned") == ["b"]:
            break
    metrics = (TMetrics if package == "port" else JMetrics)()
    metrics.observe_federation(coord)
    return "\n".join(line for line in metrics.registry.render().splitlines()
                     if "federation" in line)


def test_both_packages_expose_the_same_federation_metrics():
    text = _exposition("port")
    assert text == _exposition("jax")
    assert ('tpu_operator_federation_cluster_health{cluster="b",'
            'region="r2"} 2') in text
