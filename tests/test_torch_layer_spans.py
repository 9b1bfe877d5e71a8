"""The port's layer spans and counters (``k8s_operator_libs_tpu_torch.layers``).

Off records nothing; on, the agent's battery, the deep probe, the
prober, the engine's passes, the drain workers, ``FakeCluster``'s calls
and the canary's step each give their spans, nested under one request
per unit of work, on ``time.perf_counter_ns``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter, defaultdict

import pytest
import torch

from k8s_operator_libs_tpu_torch import layers
from k8s_operator_libs_tpu_torch.api import DrainSpec, TPUUpgradePolicySpec
from k8s_operator_libs_tpu_torch.bench_fleet import (
    DRIVER_LABELS,
    NAMESPACE,
    ClusterFixture,
)
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
from k8s_operator_libs_tpu_torch.health.slice_prober import NodeReportProber
from k8s_operator_libs_tpu_torch.k8s import FakeCluster
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    NodeUpgradeState,
    UpgradeGroup,
    UpgradeKeys,
)
from k8s_operator_libs_tpu_torch.workloads.canary import (
    CanaryConfig,
    CanaryRunner,
)

CPU = torch.device("cpu")
GPU_LABELS = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
              "nvidia.com/gpu.count": "2"}


@pytest.fixture(autouse=True)
def clean_layers():
    layers.record_layers(False)
    layers.take_layers()
    yield
    layers.record_layers(False)
    layers.take_layers()


def recorded(fn):
    """``(result, spans, counters, t0, t1)`` of ``fn()`` with recording
    on, between ``perf_counter_ns`` readings taken around it."""
    layers.record_layers(True)
    t0 = time.perf_counter_ns()
    out = fn()
    t1 = time.perf_counter_ns()
    layers.record_layers(False)
    spans, counters = layers.take_layers()
    return out, spans, counters, t0, t1


def children(spans: list) -> dict:
    kids = defaultdict(list)
    for rec in spans:
        kids[rec[3]].append(rec)
    return kids


def names(recs: list) -> list:
    return [r[0] for r in recs]


def assert_nested(spans: list, t0: int, t1: int) -> None:
    """Every span closed, inside [t0, t1], inside its parent, on its
    parent's thread; a parent's children sum to no more than it."""
    kids = children(spans)
    for i, (name, s, e, parent, _, thread) in enumerate(spans):
        assert e is not None, name
        assert t0 <= s <= e <= t1, name
        if parent >= 0:
            p = spans[parent]
            assert p[1] <= s and e <= p[2], (name, p[0])
            assert p[5] == thread, name
        assert sum(c[2] - c[1] for c in kids[i]) <= e - s, name


def agent_on(cluster: FakeCluster, deep: bool = False) -> HealthAgent:
    return HealthAgent(cluster, "gpu-0", UpgradeKeys(), driver_revision="r1",
                       devices=[CPU, CPU], matmul_n=64, hbm_mib=1,
                       allreduce_elems=64, deep=deep, fused=True)


def gpu_cluster() -> FakeCluster:
    cluster = FakeCluster()
    fx = ClusterFixture(cluster)
    fx.node(name="gpu-0", labels=GPU_LABELS)
    return cluster


def test_off_records_nothing():
    cluster = gpu_cluster()
    agent = agent_on(cluster)
    agent.publish(agent.probe_once())
    assert layers.layer_span("a") is layers.layer_span("b", "c")
    with layers.layer_span("a") as request:
        assert request is None
    layers.count("c")
    assert layers.take_layers() == ([], {})


def test_agent_probe_gives_the_battery_spans_under_one_request():
    cluster = gpu_cluster()
    agent = agent_on(cluster, deep=True)
    agent.probe_once()  # the battery's warm-up, outside the record

    def gate():
        report = agent.probe_once()
        agent.publish(report)
        return report

    report, spans, counters, t0, t1 = recorded(gate)
    assert report.healthy, report.to_json()
    assert_nested(spans, t0, t1)
    kids = children(spans)
    (probe_i,) = [i for i, r in enumerate(spans) if r[0] == "agent.probe"]
    probe = spans[probe_i]
    assert probe[3] == -1
    assert names(kids[probe_i]) == ["battery.inventory", "battery.fused",
                                    "battery.deep", "agent.report"]
    fused_i = spans.index(next(r for r in spans if r[0] == "battery.fused"))
    assert names(kids[fused_i]) == ["fused.prepare", "fused.inputs",
                                    "fused.enqueue", "fused.collectives",
                                    "fused.readback", "fused.checks"]
    deep_i = spans.index(next(r for r in spans if r[0] == "battery.deep"))
    # The checked ring, its reference, then the timed ring.
    assert names(kids[deep_i]) == ["deep.inputs", "deep.ring",
                                   "deep.reference", "deep.ring"]
    (publish_i,) = [i for i, r in enumerate(spans)
                    if r[0] == "agent.publish"]
    assert names(kids[publish_i]) == ["agent.report",
                                      "k8s.patch_node"]
    # The probe and its publish are one request, and only they.
    assert {r[4] for r in spans} == {probe[4]}
    assert counters == {"fused.batteries": 1, "deep.ring_steps": 2 * 2 * 2}


def test_the_prober_gives_its_spans():
    cluster = gpu_cluster()
    agent = agent_on(cluster)
    agent.publish(agent.probe_once())
    node = cluster.get_node("gpu-0", cached=False)
    group = UpgradeGroup(id=node.name, members=[NodeUpgradeState(
        node=node, driver_pod=None, driver_daemon_set=None)])
    prober = NodeReportProber(UpgradeKeys(), max_report_age_s=600.0)
    result, spans, _, t0, t1 = recorded(lambda: prober.probe(group))
    assert result.healthy, result.reason
    assert_nested(spans, t0, t1)
    assert names(spans) == ["prober.probe", "prober.parse", "prober.judge"]
    assert [r[3] for r in spans] == [-1, 0, 0]


def test_the_canary_step_gives_its_spans():
    runner = CanaryRunner(CanaryConfig(vocab=64, d_model=32, n_heads=2,
                                       n_layers=1, d_ff=64, seq_len=16,
                                       batch=4), device=CPU)
    runner.run_step()
    loss, spans, _, t0, t1 = recorded(runner.run_step)
    assert loss == loss
    assert_nested(spans, t0, t1)
    assert names(spans) == ["canary.step", "canary.batch", "canary.enqueue",
                            "canary.sync"]
    assert [r[3] for r in spans] == [-1, 0, 0, 0]


def test_a_roll_gives_each_pass_its_engine_roots_and_every_api_call():
    cluster = FakeCluster()
    fx = ClusterFixture(cluster)
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = [fx.node(name=f"pool-{i}", labels=GPU_LABELS) for i in range(2)]
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
        fx.workload_pod(n, labels={"app": "train"})
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    fx.auto_recreate_driver_pods(ds, "h2")
    keys = UpgradeKeys()
    mgr = ClusterUpgradeStateManager(cluster, keys=keys,
                                     poll_interval_s=0.005,
                                     poll_timeout_s=2.0)
    policy = TPUUpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=1,
        drain_spec=DrainSpec(enable=True, timeout_second=5))
    stats0 = Counter(cluster.stats)

    def roll():
        for _ in range(60):
            mgr.apply_state(mgr.build_state(NAMESPACE, DRIVER_LABELS), policy)
            assert mgr.wait_for_async_work(30.0)
            if all(cluster.get_node(n.name).labels.get(keys.state_label)
                   == "upgrade-done" for n in nodes):
                return
        raise AssertionError("the roll did not converge")

    _, spans, counters, t0, t1 = recorded(roll)
    assert_nested(spans, t0, t1)
    roots = [r for r in spans if r[0] in (
        "engine.build_state", "engine.apply_state", "engine.async_wait")]
    by_pass = defaultdict(list)
    for r in roots:
        by_pass[r[4]].append(r[0])
    assert len(by_pass) == counters["engine.passes"] > 2
    for pass_roots in by_pass.values():
        assert pass_roots == ["engine.build_state", "engine.apply_state",
                              "engine.async_wait"]
    for i, r in enumerate(spans):
        if r[0].startswith("engine.") and r not in roots:
            assert spans[r[3]][0] == "engine.apply_state", r[0]
            assert r[4] == spans[r[3]][4]
    assert {r[0] for r in spans} >= {"engine.cordon_required",
                                     "engine.drain", "drain.node",
                                     "engine.uncordon_required"}
    # Each drain worker is a request of its own, on its own thread.
    drains = [r for r in spans if r[0] == "drain.node"]
    assert len(drains) == 2 and all(r[3] == -1 for r in drains)
    assert not {r[4] for r in drains} & set(by_pass)
    assert counters["drain.evictions"] == 2
    verbs = Counter(r[0][len("k8s."):] for r in spans
                    if r[0].startswith("k8s."))
    assert verbs == Counter(cluster.stats) - stats0


def test_perf_counter_is_the_monotonic_clock():
    for _ in range(5):
        a = time.perf_counter_ns()
        m = time.monotonic_ns()
        b = time.perf_counter_ns()
        assert a - 1_000_000 <= m <= b + 1_000_000


def test_the_buffer_drops_past_its_bound(monkeypatch):
    monkeypatch.setattr(layers, "LAYER_BUFFER", 4)
    layers.record_layers(True)
    with layers.layer_span("outer"):
        for _ in range(5):
            with layers.layer_span("inner"):
                pass
    spans, counters = layers.take_layers()
    assert names(spans) == ["outer", "inner", "inner", "inner"]
    assert counters == {"layers.dropped": 2}
    assert all(r[2] is not None for r in spans)


def test_a_request_is_opened_by_a_root_and_joined_by_name():
    layers.record_layers(True)
    with layers.layer_span("a") as first:
        with layers.layer_span("b") as inner:
            assert inner == first
        with layers.layer_span("c", root=True) as root:
            assert root != first
    with layers.layer_span("d", request=first) as joined:
        assert joined == first
    spans, _ = layers.take_layers()
    assert [(r[0], r[3]) for r in spans] == [("a", -1), ("b", 0), ("c", 0),
                                             ("d", -1)]
    assert [r[4] for r in spans] == [first, first, root, first]


def test_a_thread_s_stack_stays_its_own():
    layers.record_layers(True)
    seen = {}

    def other():
        with layers.layer_span("other") as request:
            seen["request"] = request

    with layers.layer_span("main") as main:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with layers.layer_span("child"):
            pass
    spans, _ = layers.take_layers()
    by_name = {r[0]: r for r in spans}
    assert by_name["other"][3] == -1
    assert seen["request"] != main
    assert by_name["other"][5] != by_name["main"][5]
    assert by_name["child"][3] == spans.index(by_name["main"])


def test_threads_record_every_span_and_count_under_contention():
    threads, rounds = 32, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        layers.record_layers(True)

        def work():
            for _ in range(rounds):
                with layers.layer_span("outer"):
                    with layers.layer_span("inner"):
                        layers.count("n")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60.0)
        assert not any(t.is_alive() for t in pool)
        spans, counters = layers.take_layers()
    finally:
        sys.setswitchinterval(switch)
    assert counters == {"n": threads * rounds}
    assert Counter(names(spans)) == {"outer": threads * rounds,
                                     "inner": threads * rounds}
    for name, _, end, parent, request, thread in spans:
        assert end is not None
        if name == "inner":
            outer = spans[parent]
            assert outer[0] == "outer"
            assert (outer[4], outer[5]) == (request, thread)


def test_a_span_open_across_take_closes_into_nothing():
    layers.record_layers(True)
    with layers.layer_span("open"):
        spans, _ = layers.take_layers()
        with layers.layer_span("after"):
            pass
    assert spans[0][0] == "open" and spans[0][2] is None
    later, _ = layers.take_layers()
    assert [(r[0], r[3]) for r in later] == [("after", -1)]


def test_recording_fails_open(monkeypatch):
    def broken():
        raise RuntimeError("clock")

    layers.record_layers(True)
    monkeypatch.setattr(layers.time, "perf_counter_ns", broken)
    with layers.layer_span("a"):
        value = 1
    monkeypatch.undo()
    spans, counters = layers.take_layers()
    assert value == 1
    assert spans == [] and counters == {"layers.errors": 2}


@pytest.mark.cuda
def test_the_battery_kernels_count_their_launches_and_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from k8s_operator_libs_tpu_torch.kernels import (
        stream_increment_,
        stream_increment_verify_,
        verify_stats,
    )

    dev = torch.device("cuda", 0)
    x = torch.zeros(1 << 20, device=dev)
    c = torch.zeros((256, 256), dtype=torch.bfloat16, device=dev)

    def passes():
        stream_increment_(x)
        stream_increment_verify_(x, 0.0)
        verify_stats(c, 0.5)
        torch.cuda.synchronize(dev)

    _, _, counters, _, _ = recorded(passes)
    assert counters == {"k1.launches": 2, "k1.bytes": 2 * 8 * (1 << 20),
                        "k2.launches": 1, "k2.bytes": 2 * 256 * 256}
