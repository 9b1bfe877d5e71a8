"""The port's read-only status CLI: mid-roll truth for operators.

The eight tests of ``tests/test_status.py`` against the port, on its
default keys, then the per-generation rows of a GPU Feature
Discovery-labelled fleet."""

from __future__ import annotations

import json

from k8s_operator_libs_tpu_torch.api.schema import (
    POLICY_GROUP,
    POLICY_PLURAL,
    POLICY_VERSION,
    register_policy_crd,
)
from k8s_operator_libs_tpu_torch.controller import ControllerConfig, UpgradeController
from k8s_operator_libs_tpu_torch.k8s import FakeCluster
from k8s_operator_libs_tpu_torch.status import gather, render
from k8s_operator_libs_tpu_torch.keys import CONTROLLER_NAME, driver_keys
from tests.test_torch_control_plane import _fixtures

PORT_FIXTURES = _fixtures("k8s_operator_libs_tpu_torch")
ClusterFixture = PORT_FIXTURES.ClusterFixture
DRIVER_LABELS = PORT_FIXTURES.DRIVER_LABELS
NAMESPACE = PORT_FIXTURES.NAMESPACE


def _mid_roll_cluster():
    cluster = FakeCluster()
    register_policy_crd(cluster)
    keys = driver_keys()
    fx = ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    slices = {
        f"pool-{i}": fx.tpu_slice(f"pool-{i}", hosts=2, topology="2x2x2",
                                  dcn_group="ring-a" if i < 2 else None)
        for i in range(3)
    }
    for nodes in slices.values():
        for n in nodes:
            fx.driver_pod(n, ds, hash_suffix="v1")
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")
    cluster.create_custom_object(
        POLICY_GROUP,
        POLICY_VERSION,
        POLICY_PLURAL,
        NAMESPACE,
        {
            "metadata": {"name": "rollout"},
            "spec": {
                "autoUpgrade": True,
                "maxParallelUpgrades": 1,
                "drain": {"enable": True, "timeoutSeconds": 5},
                "healthGate": {"enable": False},
            },
        },
    )
    controller = UpgradeController(
        cluster,
        ControllerConfig(
            namespace=NAMESPACE,
            driver_labels=DRIVER_LABELS,
            interval_s=0.01,
            policy=None,
            policy_ref=(NAMESPACE, "rollout"),
            hbm_floor_fraction=0.0,
        ),
    )
    controller.manager.provider.poll_interval_s = 0.01
    controller.manager.provider.poll_timeout_s = 2.0
    # A few passes: slice 0 mid-flight, others pending (1 slot).
    for _ in range(3):
        controller.reconcile_once()
        controller.manager.wait_for_async_work(10.0)
    return cluster, keys


def test_gather_mid_roll_snapshot():
    cluster, keys = _mid_roll_cluster()
    status = gather(
        cluster, NAMESPACE, DRIVER_LABELS, keys=keys,
        policy_ref=(NAMESPACE, "rollout"),
    )
    assert status["totalManagedNodes"] == 6
    assert status["totalManagedGroups"] == 3
    assert status["upgradesInProgress"] >= 1  # one slice holds the slot
    by_id = {g["group"]: g for g in status["groups"]}
    assert len(by_id) == 3
    moving = [g for g in status["groups"] if g["state"] not in
              ("idle", "upgrade-required", "upgrade-done")]
    assert moving, status["groups"]
    sample = status["groups"][0]
    assert sample["hosts"] == 2
    assert sample["topology"] == "2x2x2"
    assert by_id["pool-0"]["dcn_group"] == "ring-a"
    assert by_id["pool-2"]["dcn_group"] == ""
    # Per-member drill-down matches the live labels.
    for g in status["groups"]:
        for node_name, state in g["members"].items():
            assert (
                cluster.get_node(node_name, cached=False).labels.get(
                    keys.state_label, ""
                )
                == state
            )
    # Policy section carries spec + conditions from the CR.
    assert status["policy"]["spec"]["maxParallelUpgrades"] == 1
    cond_types = {c["type"] for c in status["policy"]["conditions"]}
    assert {"Progressing", "Degraded", "Complete"} <= cond_types


def test_render_and_json_shapes():
    cluster, keys = _mid_roll_cluster()
    status = gather(
        cluster, NAMESPACE, DRIVER_LABELS, keys=keys,
        policy_ref=(NAMESPACE, "rollout"),
    )
    text = render(status)
    assert "GROUP" in text and "pool-0" in text
    assert "condition Progressing" in text
    # The dict is JSON-serializable as-is (the --json mode contract).
    round_tripped = json.loads(json.dumps(status))
    assert round_tripped["totalManagedGroups"] == 3


def test_missing_policy_cr_and_warnings_render():
    cluster = FakeCluster()
    register_policy_crd(cluster)
    keys = driver_keys()
    fx = ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    node = fx.tpu_slice("pool-a", hosts=1, topology="2x2x1")[0]
    fx.driver_pod(node, ds, hash_suffix="v1")
    cluster.create_event(
        NAMESPACE,
        {
            "metadata": {"name": "n.w"},
            "involvedObject": {"kind": "Node", "name": node.name},
            "type": "Warning",
            "reason": "DrainFailed",
            "message": "boom",
        },
    )
    status = gather(
        cluster, NAMESPACE, DRIVER_LABELS, keys=keys,
        policy_ref=(NAMESPACE, "absent"),
    )
    assert status["policy"] == {"error": "policy CR not found"}
    assert status["recentWarnings"] == [
        {"object": node.name, "reason": "DrainFailed", "message": "boom"}
    ]
    text = render(status)
    assert "policy CR not found" in text
    assert "DrainFailed: boom" in text


def test_gather_reports_incoherent_snapshot():
    cluster = FakeCluster()
    keys = driver_keys()
    fx = ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    node = fx.tpu_slice("pool-a", hosts=1, topology="2x2x1")[0]
    fx.driver_pod(node, ds, hash_suffix="v1")
    # Desired count mismatch: BuildStateError path.
    ds.status.desired_number_scheduled = 5
    cluster.update_daemon_set(ds)
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert "error" in status
    assert "retry" in render(status)


def test_status_cli_unused_policy_section_absent():
    cluster, keys = _mid_roll_cluster()
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert "policy" not in status


def test_status_shows_election_leader():
    """With HA replicas the operator's first question is 'who is
    driving' — the status surfaces the Lease holder."""
    from k8s_operator_libs_tpu_torch.k8s.leader import (
        LeaderElector,
        ensure_lease_kind,
    )

    cluster, keys = _mid_roll_cluster()
    # No lease registered/held → no leader section, render still clean.
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert "leader" not in status
    ensure_lease_kind(cluster)
    # The port's controller elects on its own Lease name, which the status
    # CLI reads by default.
    elector = LeaderElector(
        cluster, identity="replica-7", namespace=NAMESPACE,
        name=CONTROLLER_NAME,
    )
    assert elector.acquire_or_renew()
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert status["leader"]["holder"] == "replica-7"
    assert status["leader"]["renewTime"]
    assert "leader: replica-7" in render(status)
    # Released (between terms): holder shows as none.
    elector.release()
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert status["leader"]["holder"] == ""
    assert "(none — between terms)" in render(status)


def test_status_follows_custom_lease_name_and_namespace():
    """A controller run with --lease-name/--lease-namespace must still
    get a leader section here — the status CLI plumbs the same flags
    (advisor r3: the hardcoded name silently showed no leader)."""
    from k8s_operator_libs_tpu_torch.k8s.leader import (
        LeaderElector,
        ensure_lease_kind,
    )

    cluster, keys = _mid_roll_cluster()
    ensure_lease_kind(cluster)
    elector = LeaderElector(
        cluster,
        identity="replica-9",
        namespace="infra-system",
        name="custom-election",
    )
    assert elector.acquire_or_renew()
    # Default lease coordinates: no leader section (lease is elsewhere).
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert "leader" not in status
    # The controller's coordinates: leader surfaces.
    status = gather(
        cluster,
        NAMESPACE,
        DRIVER_LABELS,
        keys=keys,
        lease_name="custom-election",
        lease_namespace="infra-system",
    )
    assert status["leader"]["holder"] == "replica-9"


def test_status_cli_main_end_to_end(monkeypatch, capsys):
    """python -m k8s_operator_libs_tpu_torch.status --json against a stubbed
    default client: the operator entry point, not just gather()."""
    import pytest

    from k8s_operator_libs_tpu_torch import status as status_mod

    cluster, _keys = _mid_roll_cluster()
    monkeypatch.setattr(
        "k8s_operator_libs_tpu_torch.k8s.get_default_client",
        lambda timeout_s=30.0: cluster,
    )
    status_mod.main(
        ["--namespace", NAMESPACE, "--selector", "app=libtpu-driver",
         "--policy-cr", f"{NAMESPACE}/rollout", "--json"]
    )
    out = json.loads(capsys.readouterr().out)
    assert out["totalManagedGroups"] == 3
    assert out["policy"]["spec"]["autoUpgrade"] is True
    # Human rendering path.
    status_mod.main(
        ["--namespace", NAMESPACE, "--selector", "app=libtpu-driver"]
    )
    assert "GROUP" in capsys.readouterr().out
    # Malformed --policy-cr is a usage error, not a traceback.
    with pytest.raises(SystemExit):
        status_mod.main(["--policy-cr", "missing-slash"])


def test_status_counts_a_gfd_fleet_by_generation():
    """GPU nodes carry no slice: the generation rows and each group's
    accelerator come from GPU Feature Discovery's product label."""
    cluster = FakeCluster()
    keys = driver_keys()
    fx = ClusterFixture(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    products = {
        "gpu-0": "NVIDIA-H100-PCIe",
        "gpu-1": "NVIDIA-H100-80GB-HBM3",
        "gpu-2": "NVIDIA-H100-80GB-HBM3",
        "gpu-3": "NVIDIA-H100-NVL",
    }
    for name, product in products.items():
        node = fx.node(name=name, labels={
            "nvidia.com/gpu.product": product, "nvidia.com/gpu.count": "8",
        })
        fx.driver_pod(node, ds, hash_suffix="v1")
    cluster.patch_node_annotations(
        "gpu-2", {"tpu.google.com/node-preempted": "true"}
    )
    status = gather(cluster, NAMESPACE, DRIVER_LABELS, keys=keys)
    assert status["fleet"]["generations"] == {
        "h100-pcie": {"nodes": 1, "groups": 1, "preempted": 0},
        "h100-sxm": {"nodes": 2, "groups": 2, "preempted": 1},
        "h100-nvl": {"nodes": 1, "groups": 1, "preempted": 0},
    }
    by_id = {g["group"]: g for g in status["groups"]}
    assert {n: by_id[n]["accelerator"] for n in products} == products
    assert "h100-sxm" in render(status)
