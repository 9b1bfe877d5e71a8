"""The port's install manifests: shape, drift, and — the real gate — RBAC
pinned against the engine's actual wire traffic in BOTH directions: every
verb the port's controller issued must be granted (no 403 on a real
cluster), and every granted verb must have been observed (no
over-privilege ships).  The seven tests of ``tests/test_manifests.py``
against the port; the drift check is the port's own
(``python -m k8s_operator_libs_tpu_torch.manifests --check``)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from k8s_operator_libs_tpu_torch.api.schema import (
    POLICY_GROUP,
    POLICY_PLURAL,
    POLICY_VERSION,
    register_policy_crd,
)
from k8s_operator_libs_tpu_torch.controller import ControllerConfig, UpgradeController
from k8s_operator_libs_tpu_torch.driver import DriverDaemonSetSpec, DriverSetReconciler
from k8s_operator_libs_tpu_torch.k8s import (
    FakeCluster,
    KubeApiServer,
    KubeConfig,
    RestClient,
)
from k8s_operator_libs_tpu_torch.manifests import (
    CONTROLLER_NAMESPACED_RULES,
    CONTROLLER_NAME,
    CONTROLLER_RBAC_RULES,
    NODE_REPORTER_NAME,
    NODE_REPORTER_RBAC_RULES,
    controller_manifests,
    required_grants,
    rule_grants,
    uncovered,
)
from k8s_operator_libs_tpu_torch.k8s.leader import LeaderElector, ensure_lease_kind
from k8s_operator_libs_tpu_torch.keys import driver_keys
from tests.test_torch_control_plane import _fixtures

PORT_FIXTURES = _fixtures("k8s_operator_libs_tpu_torch")
ClusterFixture = PORT_FIXTURES.ClusterFixture
DRIVER_LABELS = PORT_FIXTURES.DRIVER_LABELS
NAMESPACE = PORT_FIXTURES.NAMESPACE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_manifest_shapes():
    docs = controller_manifests(namespace="tpu-system", image="img:1")
    kinds = [d["kind"] for d in docs]
    assert kinds == [
        "ServiceAccount",
        "ClusterRole",
        "ClusterRoleBinding",
        "Role",
        "RoleBinding",
        "ServiceAccount",
        "ClusterRole",
        "ClusterRoleBinding",
        "Deployment",
    ]
    names = [d["metadata"]["name"] for d in docs]
    # SA, ClusterRole, CRB, Role, RoleBinding, Deployment
    assert names.count(CONTROLLER_NAME) == 6
    # The lease grant is namespaced (Role), never cluster-wide: a
    # cluster-scoped lease write could rewrite node heartbeats.
    role = docs[3]
    assert role["kind"] == "Role"
    assert role["metadata"]["namespace"] == "tpu-system"
    assert role["rules"] == CONTROLLER_NAMESPACED_RULES
    assert not any(
        "leases" in r.get("resources", []) for r in CONTROLLER_RBAC_RULES
    )
    assert names.count(NODE_REPORTER_NAME) == 3
    deploy = docs[-1]
    # Two replicas under leader election: standby buys fast failover.
    assert deploy["spec"]["replicas"] == 2
    tmpl = deploy["spec"]["template"]["spec"]
    assert tmpl["serviceAccountName"] == CONTROLLER_NAME
    assert tmpl["containers"][0]["image"] == "img:1"
    assert "--leader-elect" in tmpl["containers"][0]["args"]
    # The Deployment runs the port's controller.
    assert tmpl["containers"][0]["command"] == [
        "python", "-m", "k8s_operator_libs_tpu_torch.controller",
    ]
    binding = docs[2]
    assert binding["subjects"][0]["namespace"] == "tpu-system"


def test_driver_and_agent_pods_run_under_the_reporter_sa():
    """The SA the manifests create must actually be attached to the pods
    the controller creates, or the RBAC sits unused and every node-patch
    403s on a real cluster."""
    from k8s_operator_libs_tpu_torch.driver.daemonset import (
        AgentDaemonSetSpec,
        build_daemon_set,
    )

    for spec in (DriverDaemonSetSpec(), AgentDaemonSetSpec()):
        pod = build_daemon_set(spec).spec.template.pod_spec
        assert pod["serviceAccountName"] == NODE_REPORTER_NAME, type(spec)


def test_policy_cr_flag_flows_into_args():
    docs = controller_manifests(policy_cr="kube-system/rollout")
    args = docs[-1]["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--policy-cr" in args
    assert args[args.index("--policy-cr") + 1] == "kube-system/rollout"


def test_checked_in_manifests_are_current():
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "k8s_operator_libs_tpu_torch.manifests",
            "--check",
        ],
        capture_output=True,
        text=True,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_node_reporter_rbac_is_minimal():
    grants = rule_grants(NODE_REPORTER_RBAC_RULES)
    assert grants == {("", "nodes", "get"), ("", "nodes", "patch")}


@pytest.fixture(scope="module")
def roll_stats():
    """Record the controller's complete wire traffic: a full rolling
    upgrade (policy from a CR, eviction, drain, restarts, status
    write-back) plus a DaemonSet create + template-update reconcile."""
    store = FakeCluster()
    register_policy_crd(store)
    # Server-side Lease registration (a real apiserver serves
    # coordination.k8s.io natively; ensure_lease_kind through RestClient
    # is deliberately a no-op).
    ensure_lease_kind(store)
    keys = driver_keys()
    fx = ClusterFixture(store, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=2, topology="2x2x2")
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="v1")
        fx.workload_pod(n, namespace=NAMESPACE)  # exercise eviction
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")
    store.create_custom_object(
        POLICY_GROUP,
        POLICY_VERSION,
        POLICY_PLURAL,
        NAMESPACE,
        {
            "metadata": {"name": "rollout"},
            "spec": {
                "autoUpgrade": True,
                "podDeletion": {"force": True, "timeoutSeconds": 5},
                "drain": {"enable": True, "timeoutSeconds": 5},
                "healthGate": {"enable": False},
            },
        },
    )
    with KubeApiServer(store) as server:
        client = RestClient(KubeConfig(host=server.host), timeout_s=10.0)
        # DaemonSet ownership traffic (an "aux" driver so it never
        # collides with the roll's fixture DS): create, then update.
        recon = DriverSetReconciler(
            client, DriverDaemonSetSpec(namespace=NAMESPACE, driver_name="aux")
        )
        recon.reconcile()
        recon.spec.version = "2.0"
        recon.reconcile()
        controller = UpgradeController(
            client,
            ControllerConfig(
                namespace=NAMESPACE,
                driver_labels=DRIVER_LABELS,
                interval_s=0.01,
                policy=None,
                policy_ref=(NAMESPACE, "rollout"),
                hbm_floor_fraction=0.0,
                leader_elect=True,
                identity="manifest-roll",
            ),
        )
        # retry_period 0: every round renews, so the recorded traffic
        # contains lease get+create+update — the verbs RBAC grants.
        controller.elector = LeaderElector(
            client,
            identity="manifest-roll",
            namespace=NAMESPACE,
            lease_duration_s=5.0,
            renew_deadline_s=3.0,
            retry_period_s=0.0,
        )
        controller.manager.with_pod_deletion_enabled(
            lambda p: not p.is_daemonset_pod()
        )
        controller.manager.provider.poll_interval_s = 0.01
        controller.manager.provider.poll_timeout_s = 2.0
        for _ in range(40):
            assert controller._election_round()
            controller.reconcile_once()
            controller.manager.wait_for_async_work(10.0)
            states = {
                n.name: client.get_node(n.name, cached=False).labels.get(
                    keys.state_label, ""
                )
                for n in nodes
            }
            if all(s == "upgrade-done" for s in states.values()):
                break
        else:
            pytest.fail(f"roll never converged: {states}")
        controller.reconcile_once()  # status write-back observes final state
        return dict(client.stats)


def test_controller_rbac_covers_a_full_roll_on_the_wire(roll_stats):
    """Forward direction: every wire verb the engine issued is granted."""
    all_rules = CONTROLLER_RBAC_RULES + CONTROLLER_NAMESPACED_RULES
    assert not uncovered(roll_stats.keys(), all_rules), uncovered(
        roll_stats.keys(), all_rules
    )
    # The roll must actually have exercised the interesting surface, or
    # the coverage claim is vacuous.
    kinds = {k.split(" ", 1)[1] for k in roll_stats}
    assert {
        "nodes",
        "pods",
        "eviction",
        "daemonsets",
        "controllerrevisions",
        POLICY_PLURAL,
        f"{POLICY_PLURAL}/status",
        "leases",
    } <= kinds, kinds
    # And no stat key is unmapped (required_grants raises on unknowns).
    required_grants(roll_stats.keys())


def test_no_unused_controller_grants(roll_stats):
    """Reverse direction, verb-granular: every granted verb was observed
    in the recorded traffic.  Adding an over-broad verb (say, delete on
    nodes) fails here before it ships."""
    observed: set[tuple[str, str, str]] = set()
    for group, resource, verbs in required_grants(roll_stats.keys()):
        for verb in verbs:
            # GET maps to get|list: observing either satisfies both.
            observed.add((group, resource, verb))
    over_privileged = [
        grant
        for grant in sorted(
            rule_grants(CONTROLLER_RBAC_RULES + CONTROLLER_NAMESPACED_RULES)
        )
        if grant not in observed
    ]
    assert not over_privileged, over_privileged


def test_check_fails_on_a_stale_render(tmp_path, monkeypatch, capsys):
    """``--check`` compares the checked-in render with a fresh one: a
    missing or edited file fails, a rewrite makes it pass."""
    from k8s_operator_libs_tpu_torch import manifests_cli as manifests

    path = tmp_path / "deploy" / "controller.yaml"
    monkeypatch.setattr(manifests, "RENDERED_PATH", path)
    assert manifests.main(["--check"]) == 1
    assert manifests.main([]) == 0
    assert manifests.main(["--check"]) == 0
    path.write_text(path.read_text().replace("gpu-node-reporter", "x"))
    assert manifests.main(["--check"]) == 1
    assert "stale" in capsys.readouterr().out
