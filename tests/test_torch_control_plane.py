"""The port's copy of the upgrade engine, held to the JAX package's.

The port carries the engine's jax-free closure (the control plane:
``k8s/``, ``api/``, ``upgrade/``, ``planning/``, ``obs/`` and the rest)
as its own modules, with the package prefix rewritten.  Each copy must
stay the reference's code: its AST, docstrings stripped and the prefix
rewritten, must equal the reference's.  Then both engines roll the same
fleets behind the same scripted prober verdicts (the two scenarios of
``test_e2e_rolling_upgrade.py`` and four GPU-labelled nodes with no
slice) and must walk every node through the same states.
"""

from __future__ import annotations

import ast
import re
import types
from pathlib import Path

import pytest

import k8s_operator_libs_tpu as jpkg
import k8s_operator_libs_tpu_torch as tpkg
from k8s_operator_libs_tpu import api as japi
from k8s_operator_libs_tpu import k8s as jk8s
from k8s_operator_libs_tpu import upgrade as jup
from k8s_operator_libs_tpu_torch import api as tapi
from k8s_operator_libs_tpu_torch import k8s as tk8s
from k8s_operator_libs_tpu_torch import upgrade as tup

ROOT = Path(__file__).resolve().parents[1]
REF = Path(jpkg.__file__).resolve().parent
PORT = Path(tpkg.__file__).resolve().parent
PREFIX = re.compile(r"\bk8s_operator_libs_tpu\b")

# Every module of the engine's closure that the port copies.  The
# closure's accelerator-side modules (hw.py, fleet/profiles.py,
# artifacts/gates.py) and the package's __init__ are the port's own.
COPIED = (
    "consts.py",
    "api/__init__.py", "api/schema.py", "api/v1alpha1.py",
    "artifacts/__init__.py", "artifacts/dag.py",
    "fleet/__init__.py", "fleet/scheduler.py", "fleet/windows.py",
    "k8s/__init__.py", "k8s/apiserver.py", "k8s/client.py", "k8s/drain.py",
    "k8s/faults.py", "k8s/informer.py", "k8s/interface.py", "k8s/leader.py",
    "k8s/objects.py", "k8s/rest.py", "k8s/retry.py", "k8s/selectors.py",
    "k8s/writeplan.py",
    "topology/__init__.py", "topology/slices.py",
    "obs/__init__.py", "obs/baseline.py", "obs/critical.py",
    "obs/flightrec.py", "obs/telemetry.py", "obs/trace.py",
    "planning/__init__.py", "planning/clocks.py", "planning/drift.py",
    "planning/planner.py", "planning/twin.py",
    "upgrade/__init__.py", "upgrade/consts.py", "upgrade/types.py",
    "upgrade/util.py", "upgrade/node_state_provider.py",
    "upgrade/cordon_manager.py", "upgrade/drain_manager.py",
    "upgrade/pod_manager.py", "upgrade/validation_manager.py",
    "upgrade/safe_driver_load_manager.py", "upgrade/stuck.py",
    "upgrade/durable.py", "upgrade/matview.py", "upgrade/sharded.py",
    "upgrade/upgrade_state.py",
)


def _code(source: str) -> str:
    """``ast.dump`` of ``source`` without its module, class and function
    docstrings."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIED)
def test_copy_is_the_reference_code(module):
    ref = PREFIX.sub("k8s_operator_libs_tpu_torch", (REF / module).read_text())
    assert _code((PORT / module).read_text()) == _code(ref)


def test_the_copies_are_the_whole_closure():
    """Every module of the reference's engine closure is copied, or is
    one of the port's own accelerator-side modules."""
    own = {"__init__.py", "hw.py", "fleet/profiles.py", "artifacts/gates.py"}
    for package in ("api", "k8s", "obs", "planning", "topology", "upgrade"):
        for path in (REF / package).glob("*.py"):
            assert str(path.relative_to(REF)) in COPIED
    assert not own & set(COPIED)
    assert all((PORT / m).is_file() for m in own)


# -- both engines on the same fleets ----------------------------------------


def _fixtures(package: str) -> types.ModuleType:
    """``tests/fixtures.py`` building objects of ``package``: for the
    port, the same source with the package prefix rewritten."""
    source = (ROOT / "tests" / "fixtures.py").read_text()
    if package != "k8s_operator_libs_tpu":
        source = PREFIX.sub(package, source)
    module = types.ModuleType(f"_fixtures_{package}")
    exec(compile(source, f"fixtures[{package}]", "exec"), module.__dict__)
    return module


ENGINES = {
    "jax": (japi, jk8s, jup, _fixtures("k8s_operator_libs_tpu")),
    "port": (tapi, tk8s, tup, _fixtures("k8s_operator_libs_tpu_torch")),
}


class ScriptedProber:
    """Rejects each group's first probe, then passes: both engines see
    the same verdicts, the rejection included."""

    def __init__(self, upgrade) -> None:
        self.result = upgrade.ProbeResult
        self.calls: list[str] = []

    def probe(self, group):
        first = group.id not in self.calls
        self.calls.append(group.id)
        if first:
            return self.result(False, f"scripted rejection of {group.id}")
        return self.result(True, "scripted pass")


def _two_slices(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=4) + fx.tpu_slice("pool-b", hosts=4)
    nodes.append(fx.node(name="plain-0"))
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
        fx.workload_pod(n, labels={"app": "train"})
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        max_unavailable=api.IntOrString("34%"),
        unavailability_unit="slice",
        pod_deletion=api.PodDeletionSpec(timeout_second=5),
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
        wait_for_completion=api.WaitForCompletionSpec(),
    )
    return ds, nodes, policy


def _node_unit(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=2)
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=4,
        max_unavailable=api.IntOrString("100%"),
        unavailability_unit="node",
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
    )
    return ds, nodes, policy


def _gpu_nodes(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = [
        fx.node(name=f"pool-{i}", labels={
            "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
            "nvidia.com/gpu.count": "8",
        })
        for i in range(4)
    ]
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
    )
    return ds, nodes, policy


def _roll(engine: str, scenario) -> tuple[dict, list]:
    """Roll ``scenario`` on ``engine`` from h1 to h2; returns each node's
    states, one a pass with repeats collapsed, and the probed groups."""
    api, k8s, upgrade, fixtures = ENGINES[engine]
    cluster = k8s.FakeCluster()
    fx = fixtures.ClusterFixture(cluster)
    ds, nodes, policy = scenario(fx, api)
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    fx.auto_recreate_driver_pods(ds, "h2")
    keys = upgrade.UpgradeKeys()
    prober = ScriptedProber(upgrade)
    mgr = upgrade.ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0
    )
    if policy.pod_deletion is not None:
        mgr.with_pod_deletion_enabled(
            lambda p: p.labels.get("app") == "train"
        )
    mgr.with_validation_enabled(prober)
    seen: dict[str, list[str]] = {n.name: [] for n in nodes}
    for _ in range(80):
        mgr.apply_state(
            mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS),
            policy,
        )
        assert mgr.wait_for_async_work(30.0)
        for name, states in seen.items():
            state = cluster.get_node(name).labels.get(keys.state_label, "")
            if not states or states[-1] != state:
                states.append(state)
        if all(s[-1] == "upgrade-done" for s in seen.values()):
            break
    else:
        raise AssertionError(f"{engine} roll did not converge: {seen}")
    for n in nodes:
        pods = [p for p in cluster.list_pods(node_name=n.name)
                if p.labels.get("app") == fixtures.DRIVER_LABELS["app"]]
        assert [p.labels["controller-revision-hash"] for p in pods] == ["h2"]
        assert not cluster.get_node(n.name).spec.unschedulable
    return seen, prober.calls


@pytest.mark.parametrize(
    "scenario", [_two_slices, _node_unit, _gpu_nodes],
    ids=["two_slices", "node_unit", "four_gpu_nodes"],
)
def test_both_engines_walk_the_same_states(scenario):
    port, port_calls = _roll("port", scenario)
    ref, ref_calls = _roll("jax", scenario)
    assert port == ref
    # The generation tables differ (the port's holds the H100s, the JAX
    # package's the TPUs), and the engine admits the oldest generation
    # first: TPU slices, unknown to the port, may be probed in another
    # order.  Every node of the GPU pool is one generation to both.
    assert sorted(port_calls) == sorted(ref_calls)
    if scenario is _gpu_nodes:
        assert port_calls == ref_calls
    assert len(port_calls) > len(set(port_calls))  # the rejections ran
    for states in port.values():
        assert states[-1] == "upgrade-done"
        assert "validation-required" in states
