"""The port's operator loop: driver and agent DaemonSets, safe-load init,
metrics, and the controller end to end on the fake cluster.

The first thirteen tests mirror ``tests/test_driver_and_controller.py``
against the port, on the port's default keys (the NVIDIA GPU operator's,
``keys.py``).  Then: both packages' controllers roll the same TPU-slice
fixture in lockstep, each gated by its own package's agents on the CPU,
to the same per-node states in the same pass and the same metric series;
the port's controller rolls GPU Feature Discovery-labelled H100 nodes on
its default keys with agents keyed from the agent DaemonSet's env; and
the DaemonSets are the GPU's.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest
import torch

from k8s_operator_libs_tpu import api as japi
from k8s_operator_libs_tpu import controller as jcontroller
from k8s_operator_libs_tpu import k8s as jk8s
from k8s_operator_libs_tpu.health.agent import HealthAgent as JaxAgent
from k8s_operator_libs_tpu_torch import bench
from k8s_operator_libs_tpu_torch import controller as tcontroller
from k8s_operator_libs_tpu_torch import k8s as tk8s
from k8s_operator_libs_tpu_torch.api import DrainSpec, TPUUpgradePolicySpec
from k8s_operator_libs_tpu_torch.controller import (
    ControllerConfig,
    UpgradeController,
    load_policy,
)
from k8s_operator_libs_tpu_torch.driver import (
    AgentDaemonSetSpec,
    DriverDaemonSetSpec,
    DriverSetReconciler,
    announce_and_wait,
    build_daemon_set,
)
from k8s_operator_libs_tpu_torch.driver.daemonset import (
    TEMPLATE_HASH_ANNOTATION,
    template_hash,
)
from k8s_operator_libs_tpu_torch.fleet.profiles import group_accelerator
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
from k8s_operator_libs_tpu_torch.k8s import FakeCluster
from k8s_operator_libs_tpu_torch.keys import driver_keys, keys_from_env
from k8s_operator_libs_tpu_torch.metrics import MetricsRegistry, MetricsServer
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    NODE_PREEMPTION_ANNOTATION,
)
from tests.test_torch_control_plane import _fixtures

PORT_FIXTURES = _fixtures("k8s_operator_libs_tpu_torch")
ClusterFixture = PORT_FIXTURES.ClusterFixture
DRIVER_LABELS = PORT_FIXTURES.DRIVER_LABELS
NAMESPACE = PORT_FIXTURES.NAMESPACE
CPU = torch.device("cpu")
# The reference test's agent size, on the CPU.
SMALL = dict(matmul_n=64, hbm_mib=1, allreduce_elems=64)


# --- DaemonSet builder/reconciler ------------------------------------------


def test_build_daemon_set_shape():
    spec = DriverDaemonSetSpec(version="1.2.3",
                               accelerator="NVIDIA-H100-80GB-HBM3")
    ds = build_daemon_set(spec)
    pod = ds.spec.template.pod_spec
    assert pod["containers"][0]["image"].endswith(":1.2.3")
    assert pod["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"
    }
    # Safe-load init container present by default.
    assert pod["initContainers"][0]["name"] == "safe-load"
    # Driver must tolerate its own cordon.
    assert any(
        t["key"] == "node.kubernetes.io/unschedulable"
        for t in pod["tolerations"]
    )
    assert TEMPLATE_HASH_ANNOTATION in ds.metadata.annotations


def test_template_hash_tracks_content():
    a = DriverDaemonSetSpec(version="1")
    b = DriverDaemonSetSpec(version="2")
    assert template_hash(a) == template_hash(a)
    assert template_hash(a) != template_hash(b)
    no_init = DriverDaemonSetSpec(version="1", safe_load=False)
    assert template_hash(a) != template_hash(no_init)
    assert "initContainers" not in build_daemon_set(no_init).spec.template.pod_spec


def test_agent_daemon_set_shape():
    spec = AgentDaemonSetSpec(
        version="1.0", driver_revision="rev-7", probe_interval_s=15.0,
        deep=True, dcn_peers=("peer-0.node-b:8471", "peer-0.node-c"),
        dcn_group="ring-a", dcn_expected_groups=("ring-a", "ring-b"),
    )
    ds = build_daemon_set(spec)
    pod = ds.spec.template.pod_spec
    container = pod["containers"][0]
    assert container["command"][-1] == (
        "k8s_operator_libs_tpu_torch.health.agent"
    )
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert env["DRIVER_REVISION"] == "rev-7"
    assert env["HEALTH_PROBE_INTERVAL_S"] == "15.0"
    assert env["HEALTH_DEEP_PROBE"] == "1"
    assert env["HEALTH_DCN_PEERS"] == "peer-0.node-b:8471,peer-0.node-c"
    assert env["HEALTH_DCN_GROUP"] == "ring-a"
    assert env["HEALTH_DCN_GROUPS"] == "ring-a,ring-b"
    # Must keep probing cordoned hosts mid-upgrade.
    assert any(
        t["key"] == "node.kubernetes.io/unschedulable"
        for t in pod["tolerations"]
    )
    # Distinct selector from the driver DS.
    assert ds.spec.selector.match_labels == {"app": "nvidia-health-agent"}
    # Revision is part of the template hash: a new driver revision is a
    # template change (agents restart and re-report).
    spec.driver_revision = "rev-8"
    assert (
        template_hash(spec)
        != ds.metadata.annotations[TEMPLATE_HASH_ANNOTATION]
    )


def test_update_strategy_split_survives_the_wire():
    """Driver DS is OnDelete (the engine rolls pods node-atomically);
    agent DS is RollingUpdate (a DRIVER_REVISION template change must
    restart agents or their reports stay pinned to the old revision and
    the gate never passes).  Both must survive JSON round-trips."""
    from k8s_operator_libs_tpu_torch.k8s.rest import (
        daemon_set_from_json,
        daemon_set_to_json,
    )

    driver_ds = build_daemon_set(DriverDaemonSetSpec())
    agent_ds = build_daemon_set(AgentDaemonSetSpec())
    assert driver_ds.spec.update_strategy == "OnDelete"
    assert agent_ds.spec.update_strategy == "RollingUpdate"
    assert (
        daemon_set_to_json(agent_ds)["spec"]["updateStrategy"]["type"]
        == "RollingUpdate"
    )
    round_tripped = daemon_set_from_json(daemon_set_to_json(agent_ds))
    assert round_tripped.spec.update_strategy == "RollingUpdate"
    assert (
        daemon_set_from_json(
            daemon_set_to_json(driver_ds)
        ).spec.update_strategy
        == "OnDelete"
    )


def _agent_env(cluster) -> dict:
    live = cluster.get_daemon_set(NAMESPACE, "nvidia-health-agent")
    return {
        e["name"]: e.get("value")
        for e in live.spec.template.pod_spec["containers"][0]["env"]
    }


def test_controller_keeps_agent_revision_pinned():
    """The controller re-reconciles the agent DaemonSet with the driver's
    CURRENT ControllerRevision: bumping the driver template updates the
    agents' DRIVER_REVISION env."""
    cluster = FakeCluster()
    keys = driver_keys()
    fx = ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    node = fx.tpu_node("pool-a", 0)
    fx.driver_pod(node, ds, hash_suffix="v1")
    config = ControllerConfig(
        namespace=NAMESPACE,
        driver_labels=DRIVER_LABELS,
        policy=TPUUpgradePolicySpec(auto_upgrade=False),
        agent_spec=AgentDaemonSetSpec(namespace=NAMESPACE),
        hbm_floor_fraction=0.0,
    )
    controller = UpgradeController(cluster, config)
    controller.reconcile_once()
    assert _agent_env(cluster)["DRIVER_REVISION"] == "v1"
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    controller.reconcile_once()
    assert _agent_env(cluster)["DRIVER_REVISION"] == "v2"


def test_controller_agent_survives_driver_without_revision():
    """A just-created driver DS has no ControllerRevision yet: the agent
    reconcile must proceed with an empty revision, not abort the pass."""
    cluster = FakeCluster()
    config = ControllerConfig(
        namespace=NAMESPACE,
        driver_labels=DRIVER_LABELS,
        policy=TPUUpgradePolicySpec(auto_upgrade=False),
        daemonset_spec=DriverDaemonSetSpec(namespace=NAMESPACE),
        agent_spec=AgentDaemonSetSpec(namespace=NAMESPACE),
        hbm_floor_fraction=0.0,
    )
    controller = UpgradeController(cluster, config)
    # First pass creates the driver DS; no revision exists (FakeCluster
    # has no DS controller). Must not raise.
    controller.reconcile_once()
    assert _agent_env(cluster)["DRIVER_REVISION"] == ""


def test_reconciler_create_unchanged_update():
    cluster = FakeCluster()
    spec = DriverDaemonSetSpec(version="1")
    rec = DriverSetReconciler(cluster, spec)
    assert rec.reconcile() == "created"
    assert rec.reconcile() == "unchanged"
    spec.version = "2"
    assert rec.reconcile() == "updated"
    live = cluster.get_daemon_set(spec.namespace, spec.name)
    assert live.spec.template.pod_spec["containers"][0]["image"].endswith(":2")
    assert rec.reconcile() == "unchanged"


# --- safe-load init container ----------------------------------------------


def test_safe_load_announce_and_wait_unblocks():
    cluster = FakeCluster()
    fx = ClusterFixture(cluster)
    fx.node("host-0")
    keys = driver_keys()

    def controller_side():
        # wait until announced, then unblock (what the state machine does
        # after quiescing the node).
        for _ in range(100):
            n = cluster.get_node("host-0", cached=False)
            if keys.safe_load_annotation in n.annotations:
                cluster.patch_node_annotations(
                    "host-0", {keys.safe_load_annotation: None}
                )
                return
            time.sleep(0.01)

    t = threading.Thread(target=controller_side)
    t.start()
    assert announce_and_wait(cluster, "host-0", keys, poll_interval_s=0.01)
    t.join()


def test_safe_load_timeout():
    cluster = FakeCluster()
    ClusterFixture(cluster).node("host-0")
    assert not announce_and_wait(
        cluster, "host-0", poll_interval_s=0.01, timeout_s=0.05
    )
    # Annotation stays: the node still must go through safe-load handling.
    n = cluster.get_node("host-0", cached=False)
    # Given no keys, the wait uses the port's default driver's.
    assert driver_keys().safe_load_annotation in n.annotations


# --- metrics ----------------------------------------------------------------


def test_metrics_registry_render():
    r = MetricsRegistry()
    r.describe("nodes_by_state", "Nodes per state", "state")
    r.set("nodes_by_state", 3, state="upgrade-done")
    r.describe("reconcile_total", "passes")
    r.inc("reconcile_total")
    r.inc("reconcile_total")
    text = r.render()
    assert 'tpu_operator_nodes_by_state{state="upgrade-done"} 3' in text
    assert "tpu_operator_reconcile_total 2" in text
    assert "# HELP tpu_operator_nodes_by_state Nodes per state" in text


def test_metrics_server_serves_text():
    r = MetricsRegistry()
    r.describe("nodes_total", "total")
    r.set("nodes_total", 5)
    server = MetricsServer(r, port=0)
    server.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=5
        ).read().decode()
        assert "tpu_operator_nodes_total 5" in body
    finally:
        server.stop()


# --- controller end-to-end ---------------------------------------------------


def test_controller_rolls_cluster_end_to_end():
    """Full loop: driver DS outdated -> controller reconciles until every
    slice is upgrade-done, gated by NodeReportProber on agent-published
    reports pinned to the new revision."""
    cluster = FakeCluster()
    keys = driver_keys()
    fx = ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=2, topology="2x2x2")
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="v1")
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")

    config = ControllerConfig(
        namespace=NAMESPACE,
        driver_labels=DRIVER_LABELS,
        interval_s=0.01,
        policy=TPUUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            drain_spec=DrainSpec(enable=True, timeout_second=5),
        ),
        # The probe "hosts" here are CPU devices, which can't meet a real
        # accelerator's bandwidth floor.
        hbm_floor_fraction=0.0,
    )
    controller = UpgradeController(cluster, config)
    controller.manager.provider.poll_interval_s = 0.01
    controller.manager.provider.poll_timeout_s = 2.0

    for tick in range(40):
        controller.reconcile_once()
        controller.manager.wait_for_async_work(10.0)
        # probe agents publish per-host reports under the new revision
        for n in nodes:
            HealthAgent(
                cluster, n.name, keys, driver_revision="v2",
                devices=[CPU] * 4, **SMALL,
            ).run_once()
        states = {
            n.name: cluster.get_node(n.name, cached=False).labels.get(
                keys.state_label, ""
            )
            for n in nodes
        }
        if all(s == "upgrade-done" for s in states.values()):
            break
    else:
        pytest.fail(f"controller never converged: {states}")

    # One more pass so the metrics snapshot observes the final state.
    controller.reconcile_once()
    text = controller.registry.render()
    assert 'nodes_by_state{state="upgrade-done"} 2' in text
    assert "slice_upgrade_seconds" in text


def test_load_policy_yaml(tmp_path):
    p = tmp_path / "policy.yaml"
    p.write_text(
        "autoUpgrade: true\n"
        "maxParallelUpgrades: 2\n"
        "maxUnavailable: 25%\n"
        "drain: {enable: true, timeoutSeconds: 120}\n"
        "sliceAtomic: true\n"
        "unavailabilityUnit: slice\n"
        "healthGate: {enable: true, timeoutSeconds: 300}\n"
    )
    policy = load_policy(str(p))
    assert policy.auto_upgrade
    assert policy.max_parallel_upgrades == 2
    assert policy.max_unavailable.value == "25%"
    assert policy.drain_spec.timeout_second == 120
    assert policy.health_gate.timeout_second == 300
    assert policy.unavailability_unit == "slice"


# --- both packages' controllers, lockstep -----------------------------------

JAX_FIXTURES = _fixtures("k8s_operator_libs_tpu")
# The generation tables differ by design: the port's holds the H100s, the
# JAX package's the TPUs.  The fixture's slices are labelled v5p, a
# generation the JAX package names and the port counts as "unknown", so
# the generation series are compared with that one name mapped: their
# counts must agree.  GPU generations are held by the GFD roll below.
PARITY_GENERATIONS = {'generation="v5p"': 'generation="unknown"'}
# The pass after which one node of pool-b is preempted, and the pass
# after which it returns.
PREEMPT_AT, RETURN_AT = 2, 4


def _parity_controller(package: str, cpu_devices):
    """A controller of ``package`` with its default keys over two 2-host
    slices whose driver DaemonSet was bumped, and a function running
    every node's agent of the same package."""
    if package == "jax":
        api, k8s, ctl, fixtures = japi, jk8s, jcontroller, JAX_FIXTURES
    else:
        from k8s_operator_libs_tpu_torch import api

        k8s, ctl, fixtures = tk8s, tcontroller, PORT_FIXTURES
    cluster = k8s.FakeCluster()
    controller = ctl.UpgradeController(cluster, ctl.ControllerConfig(
        namespace=fixtures.NAMESPACE,
        driver_labels=fixtures.DRIVER_LABELS,
        interval_s=0.01,
        policy=api.TPUUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            drain_spec=api.DrainSpec(enable=True, timeout_second=5),
        ),
        hbm_floor_fraction=0.0,
    ))
    controller.manager.provider.poll_interval_s = 0.01
    controller.manager.provider.poll_timeout_s = 2.0
    keys = controller.keys
    fx = fixtures.ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    nodes = [
        n for pool in ("pool-a", "pool-b")
        for n in fx.tpu_slice(pool, hosts=2, topology="2x2x2")
    ]
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="v1")
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")
    if package == "jax":
        def agent(name):
            return JaxAgent(cluster, name, keys, driver_revision="v2",
                            devices=cpu_devices[:4], **SMALL)
    else:
        def agent(name):
            # The port's agent takes its keys as its pod does.
            return HealthAgent(cluster, name, keys_from_env(),
                               driver_revision="v2", devices=[CPU] * 4,
                               **SMALL)
    return cluster, controller, [n.name for n in nodes], agent


def _series(text: str, names: dict[str, str]) -> set[str]:
    """The state, generation and preemption series of a render, with the
    generation names in ``names`` mapped."""
    series = set()
    for line in text.splitlines():
        if line.startswith((
            "tpu_operator_nodes_by_state", "tpu_operator_fleet_nodes",
            "tpu_operator_preemptions_total",
        )):
            for name, mapped in names.items():
                line = line.replace(name, mapped)
            series.add(line)
    return series


def _accelerators(controller, read) -> dict[str, str]:
    """Each group's accelerator, as ``read`` takes it from the group."""
    state = controller.manager.build_state(
        PORT_FIXTURES.NAMESPACE, PORT_FIXTURES.DRIVER_LABELS
    )
    return {g.id: read(g) for groups in state.groups.values() for g in groups}


def test_both_controllers_roll_in_lockstep(cpu_devices, monkeypatch):
    """Every node is in the same state after every pass, so each
    transition falls in the same pass on both sides; the state series
    agree exactly and the generation series once v5p is mapped."""
    monkeypatch.delenv("DRIVER_NAME", raising=False)
    rolls = {p: _parity_controller(p, cpu_devices) for p in ("jax", "port")}
    history = {p: [] for p in rolls}
    for tick in range(40):
        for package, (cluster, controller, names, agent) in rolls.items():
            if tick in (PREEMPT_AT, RETURN_AT):
                cluster.patch_node_annotations("pool-b-w1", {
                    NODE_PREEMPTION_ANNOTATION:
                        "true" if tick == PREEMPT_AT else None,
                })
            controller.reconcile_once()
            controller.manager.wait_for_async_work(10.0)
            for name in names:
                agent(name).run_once()
            history[package].append({
                n: cluster.get_node(n, cached=False).labels.get(
                    controller.keys.state_label, "")
                for n in names
            })
        assert history["port"][-1] == history["jax"][-1], tick
        if set(history["port"][-1].values()) == {"upgrade-done"}:
            break
    else:
        pytest.fail(f"the rolls never converged: {history['port'][-1]}")
    assert history["port"] == history["jax"]
    renders = {}
    for package, (_, controller, _, _) in rolls.items():
        controller.reconcile_once()
        renders[package] = controller.registry.render()
    assert 'tpu_operator_fleet_nodes{generation="v5p"} 4' in renders["jax"]
    assert 'tpu_operator_preemptions_total{generation="v5p"} 1' in (
        renders["jax"]
    )
    assert _series(renders["port"], {}) == _series(
        renders["jax"], PARITY_GENERATIONS
    )
    renders = {p: _series(text, {}) for p, text in renders.items()}
    assert 'tpu_operator_nodes_by_state{state="upgrade-done"} 4' in (
        renders["port"]
    )
    assert 'tpu_operator_fleet_nodes{generation="unknown"} 4' in (
        renders["port"]
    )
    assert 'tpu_operator_preemptions_total{generation="unknown"} 1' in (
        renders["port"]
    )
    # The port reads a labelled slice's accelerator as the JAX package
    # reads it from the slice.
    port_accel = _accelerators(rolls["port"][1], group_accelerator)
    assert port_accel == _accelerators(
        rolls["jax"][1], lambda g: g.slice_info.accelerator
    )
    assert set(port_accel.values()) == {"tpu-v5p-slice"}


# --- GPU Feature Discovery-labelled nodes on default keys -------------------


def test_the_controller_rolls_gfd_nodes_on_default_keys(monkeypatch):
    """``bench.controller_roll`` on the CPU: the default controller owns
    both DaemonSets, agents keyed from the agent DaemonSet's env report
    under the controller's keys, the pool is admitted in the profiles'
    order, and metrics and status count the nodes by generation."""
    monkeypatch.delenv("DRIVER_NAME", raising=False)
    r = bench.controller_roll([CPU] * 8, size=bench.BatterySize(**SMALL))
    assert r["complete"], r["final_states"]
    assert r["final_states"] == {f"pool-{i}": "upgrade-done" for i in range(4)}
    # PCIe, then both SXM, then NVL.
    assert r["admitted"] == ["pool-3", "pool-1", "pool-2", "pool-0"]
    assert r["keys"] == "nvidia.com/gpu-driver-upgrade-state"
    assert r["agent_env"] == {"DRIVER_NAME": "gpu",
                              "DRIVER_REVISION": r["revisions"][1]}
    assert r["revisions"][0] != r["revisions"][1]
    assert r["fleet_nodes"] == {"h100-pcie": 1.0, "h100-sxm": 2.0,
                                "h100-nvl": 1.0}
    assert r["nodes_by_state"]["upgrade-done"] == 4.0
    assert {g: row["nodes"] for g, row in r["status_generations"].items()} == {
        "h100-pcie": 1, "h100-sxm": 2, "h100-nvl": 1,
    }
    # One report a node before the roll, then at least one in flight.
    assert r["batteries"] >= 8
    assert all(w is not None for w in r["node_windows_s"].values())


def test_agent_keys_follow_driver_name(monkeypatch):
    monkeypatch.delenv("DRIVER_NAME", raising=False)
    assert keys_from_env() == driver_keys()
    assert keys_from_env().state_label == "nvidia.com/gpu-driver-upgrade-state"
    monkeypatch.setenv("DRIVER_NAME", "datacenter")
    assert keys_from_env().state_label == (
        "nvidia.com/datacenter-driver-upgrade-state"
    )
    # A pod's env given as a mapping, as the bench's agents read theirs.
    assert keys_from_env({"DRIVER_NAME": "x"}) == driver_keys("x")
    assert keys_from_env({}) == driver_keys()


def test_node_side_defaults_are_the_controllers():
    """An agent and a safe-load wait given no keys write the annotations
    a controller of the default config reads."""
    keys = UpgradeController(FakeCluster(), ControllerConfig()).keys
    cluster = FakeCluster()
    ClusterFixture(cluster).node("host-0")
    HealthAgent(cluster, "host-0", devices=[CPU], **SMALL).run_once()
    assert not announce_and_wait(cluster, "host-0", poll_interval_s=0.01,
                                 timeout_s=0.02)
    annotations = cluster.get_node("host-0", cached=False).annotations
    assert keys.health_report_annotation in annotations
    assert annotations[keys.safe_load_annotation] == "true"


def test_controller_defaults_are_the_gpu_operators():
    config = ControllerConfig()
    assert config.driver_labels == {"app": "nvidia-driver-daemonset"}
    assert config.driver_name == "gpu"
    assert config.lease_name == "gpu-upgrade-controller"
    # The controller selects the driver pods of the DaemonSet it deploys.
    assert DriverDaemonSetSpec().selector_labels == config.driver_labels
    controller = UpgradeController(FakeCluster(), config)
    assert controller.keys == driver_keys()


def test_safe_load_main_reads_its_keys_from_env(monkeypatch):
    from k8s_operator_libs_tpu_torch.driver import safe_load_init

    cluster = FakeCluster()
    ClusterFixture(cluster).node("host-0")
    monkeypatch.setattr("k8s_operator_libs_tpu_torch.k8s.get_default_client",
                        lambda timeout_s=30.0: cluster)
    monkeypatch.setenv("NODE_NAME", "host-0")
    monkeypatch.setenv("DRIVER_NAME", "gpu")
    monkeypatch.setenv("SAFE_LOAD_POLL_S", "0.01")
    annotation = driver_keys().safe_load_annotation
    assert annotation.startswith("nvidia.com/")
    seen = threading.Event()

    def controller_side():
        for _ in range(500):
            node = cluster.get_node("host-0", cached=False)
            if annotation in node.annotations:
                seen.set()
                cluster.patch_node_annotations("host-0", {annotation: None})
                return
            time.sleep(0.01)

    t = threading.Thread(target=controller_side)
    t.start()
    safe_load_init.main()
    t.join()
    assert seen.is_set()


# --- the DaemonSets are the GPU's --------------------------------------------


@pytest.mark.parametrize("spec", [DriverDaemonSetSpec, AgentDaemonSetSpec],
                         ids=["driver", "agent"])
def test_daemon_sets_are_the_gpus(spec):
    pod = build_daemon_set(spec(accelerator="NVIDIA-H100-PCIe")).spec.template.pod_spec
    blob = json.dumps(pod)
    assert "google.com/tpu" not in blob
    assert "libtpu" not in blob
    assert "gke-tpu-accelerator" not in blob
    assert {"key": "nvidia.com/gpu", "operator": "Exists"} in pod["tolerations"]
    assert pod["nodeSelector"] == {"nvidia.com/gpu.product": "NVIDIA-H100-PCIe"}
    for container in pod["containers"] + pod.get("initContainers", []):
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["DRIVER_NAME"] == "gpu"
        # No container asks for the node's GPUs as a resource.
        assert "nvidia.com/gpu" not in json.dumps(container.get("resources", {}))
        assert "resources" not in container
    if spec is AgentDaemonSetSpec:
        agent = pod["containers"][0]
        assert agent["command"] == [
            "python", "-m", "k8s_operator_libs_tpu_torch.health.agent",
        ]
        env = {e["name"]: e.get("value") for e in agent["env"]}
        assert env["NVIDIA_VISIBLE_DEVICES"] == "all"
        assert agent["securityContext"] == {"privileged": True}
        assert "volumes" not in pod
    else:
        assert pod["initContainers"][0]["command"][-1] == (
            "k8s_operator_libs_tpu_torch.driver.safe_load_init"
        )
