"""The port's network-path artifact gate against the JAX package's.

``run_network_path_checks`` and ``NetworkPathGateProber`` of both
packages, on the CPU in one process (no distributed world, so one
process is visible): the JAX side over the first n of the
``cpu_devices`` fixture's devices, the port over
``[torch.device("cpu")] * n``, for n in 1, 2, 3 and 8 (the port's
reduce-scatter chunks start on 16 bytes, so the gate's 8 elements make
two chunks of 4 and leave the other members' chunks empty), healthy and
with a ring member that keeps its own value.  Verdicts and details must be equal.  Then the fail-closed cases
of the JAX package's gate tests, and a multi-artifact roll of the JAX
engine gated by either prober, which must walk the same transitions.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from k8s_operator_libs_tpu.artifacts import gates as jgates  # noqa: E402
from k8s_operator_libs_tpu.health import fused as jfused  # noqa: E402
from k8s_operator_libs_tpu.upgrade import UpgradeState  # noqa: E402
from k8s_operator_libs_tpu_torch.artifacts import (  # noqa: E402
    GateResult,
    NetworkPathGateProber,
)
from k8s_operator_libs_tpu_torch.health import fused as tfused  # noqa: E402
from k8s_operator_libs_tpu_torch.kernels import collectives  # noqa: E402
from tests.test_artifacts import (  # noqa: E402
    KEYS,
    THREE_EDGES,
    THREE_STACK,
    _policy,
    _spec,
    _StackEnv,
)

CPU = torch.device("cpu")
MEMBERS = [1, 2, 3, 8]
# The fused battery's timed figures, which no two runs share.
TIMED_METRICS = ("battery_compile_ms", "battery_execute_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_caches():
    # The JAX battery's compiled program holds the ring it was traced
    # with, so a fault must reach a fresh cache.
    jfused.reset_battery_cache()
    tfused.reset_battery_cache()
    yield
    jfused.reset_battery_cache()
    tfused.reset_battery_cache()


def _ring_fault(monkeypatch):
    """Every member keeps its own value: no traffic crossed a link."""
    monkeypatch.setattr(jax.lax, "ppermute", lambda x, axis_name, perm: x)
    monkeypatch.setattr(collectives, "ring_shift",
                        lambda shards: [s.clone() for s in shards])


def _shape(checks):
    return [
        (c.name, c.ok, c.detail,
         {k: v for k, v in c.metrics.items() if k not in TIMED_METRICS})
        for c in checks
    ]


@pytest.mark.parametrize("expected", [None, 1, 2])
@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("n", MEMBERS)
def test_network_path_checks_match_jax(cpu_devices, monkeypatch, n, fault,
                                       expected):
    if fault:
        _ring_fault(monkeypatch)
    ref = jfused.run_network_path_checks(cpu_devices[:n], expected)
    port = tfused.run_network_path_checks([CPU] * n, expected)
    assert _shape(port) == _shape(ref)
    assert [c.name for c in port] == ["dcn_reachability", "ici_link_state"]
    reach, link = port
    assert reach.ok == (expected != 2)
    if expected == 2:
        assert reach.detail == "only 1 of 2 expected process(es) visible over DCN"
    else:
        assert reach.detail == (
            "all 1 expected process(es) visible over DCN (1 enumerated)"
        )
    assert link.ok == (n == 1 or not fault)
    if n > 1 and fault:
        assert link.detail == (
            f"link {n - 1}->0 delivered 0.0, expected {float(n - 1)}"
        )
    # The gate's own sizes, under a warm-up-cache key of their own.
    key = tfused.battery_key([CPU] * n, tfused.NETWORK_MATMUL_N,
                             tfused.NETWORK_HBM_MIB,
                             tfused.NETWORK_ALLREDUCE_ELEMS, False)
    assert key in tfused._CACHE


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("n", MEMBERS)
def test_network_path_battery_is_exact_at_its_sizes(cpu_devices, monkeypatch,
                                                    n, fault):
    """The whole battery behind ``ici_link_state`` at the gate's sizes:
    the all-reduce of 8 elements over n members (empty chunks for all but
    two members past 2) is exact, as in the JAX package."""
    if fault:
        _ring_fault(monkeypatch)
    sizes = dict(matmul_n=tfused.NETWORK_MATMUL_N,
                 hbm_mib=tfused.NETWORK_HBM_MIB,
                 allreduce_elems=tfused.NETWORK_ALLREDUCE_ELEMS)
    ref = jfused.run_fused_battery(cpu_devices[:n], **sizes)
    port = tfused.run_fused_battery([CPU] * n, **sizes)
    assert _shape(port) == _shape(ref)
    assert [c.ok for c in port[:3]] == [True] * 3


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("n", MEMBERS)
def test_gate_probers_agree(cpu_devices, monkeypatch, n, fault):
    if fault:
        _ring_fault(monkeypatch)
    group = type("G", (), {"id": "g"})()
    ref = jgates.NetworkPathGateProber(
        runner=lambda: jfused.run_network_path_checks(cpu_devices[:n])
    ).probe(group, "net")
    port = NetworkPathGateProber(
        runner=lambda: tfused.run_network_path_checks([CPU] * n)
    ).probe(group, "net")
    assert (port.passed, port.detail, port.checks) == (
        ref.passed, ref.detail, ref.checks
    )
    assert port.passed == (n == 1 or not fault)
    if port.passed:
        assert port.detail == "dcn_reachability, ici_link_state verified"


# --- fail-closed, as the JAX package's gate tests ------------------------------


def test_prober_fail_closed_on_probe_error():
    def exploding_runner():
        raise RuntimeError("transport down")

    group = type("G", (), {"id": "g"})()
    port = NetworkPathGateProber(runner=exploding_runner).probe(group, "net")
    ref = jgates.NetworkPathGateProber(runner=exploding_runner).probe(
        group, "net"
    )
    assert (port.passed, port.detail, port.checks) == (
        ref.passed, ref.detail, ref.checks
    ) == (False, "probe error: transport down", {})


def test_prober_reports_failing_checks():
    class _Check:
        def __init__(self, name, ok, detail=""):
            self.name = name
            self.ok = ok
            self.detail = detail

    def runner():
        return [
            _Check("dcn_reachability", True),
            _Check("ici_link_state", False, "port 3 down"),
        ]

    group = type("G", (), {"id": "g"})()
    port = NetworkPathGateProber(runner=runner).probe(group, "net")
    ref = jgates.NetworkPathGateProber(runner=runner).probe(group, "net")
    assert (port.passed, port.detail, port.checks) == (
        ref.passed, ref.detail, ref.checks
    )
    assert not port.passed
    assert port.detail == "ici_link_state: port 3 down"
    assert port.checks == {"dcn_reachability": True, "ici_link_state": False}


def test_default_runner_without_a_card_holds_the_gate(monkeypatch):
    """The default runner probes the host's CUDA devices; without one the
    gate holds (a probe error), never passes on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verdict = NetworkPathGateProber(expected_processes=1).probe(None, "net")
    assert verdict == GateResult(
        False,
        "probe error: no CUDA device is visible "
        "(torch.cuda.is_available() is False)",
    )


# --- the JAX engine's multi-artifact roll behind either prober ------------------


def _gated_roll(prober_for, fault_passes: int):
    """Roll one 2-host slice through the three-artifact stack with the
    network artifact gated; the ring drops its traffic for the first
    ``fault_passes`` passes.  Returns the collapsed node states, the
    restart order per node, the gate's holds and its Warning events."""
    env = _StackEnv(THREE_STACK, n_slices=1, hosts=2)
    policy = _policy(
        artifacts=_spec(THREE_STACK, THREE_EDGES, gates={"net": "network-path"})
    )
    policy.validate()
    fault = {"on": fault_passes > 0}
    env.mgr.artifact_gate_prober = prober_for(fault)
    seen: dict[str, list[str]] = {n.name: [] for n in env.nodes}
    for _ in range(60):
        env.tick(policy)
        if env.mgr.artifact_gate_holds.get("net", 0) >= fault_passes:
            fault["on"] = False
        for name, states in seen.items():
            state = env.cluster.get_node(name, cached=False).labels.get(
                KEYS.state_label, ""
            )
            if not states or states[-1] != state:
                states.append(state)
        if env.node_states() == {UpgradeState.DONE.value}:
            break
    else:
        raise AssertionError(f"no convergence: {env.node_states()}")
    env.assert_pods_current()
    holds = [e.message for e in env.events.events
             if e.reason == "ArtifactGateHeld"]
    return seen, env.deletes, dict(env.mgr.artifact_gate_holds), holds


def _port_prober(fault):
    def runner():
        if fault["on"]:
            with pytest.MonkeyPatch.context() as mp:
                _ring_fault(mp)
                return tfused.run_network_path_checks([CPU] * 2)
        return tfused.run_network_path_checks([CPU] * 2)

    return NetworkPathGateProber(runner=runner)


def _jax_prober(devices):
    def make(fault):
        def runner():
            # A fresh cache each pass, so the compiled ring follows the
            # fault's state.
            jfused.reset_battery_cache()
            if fault["on"]:
                with pytest.MonkeyPatch.context() as mp:
                    _ring_fault(mp)
                    return jfused.run_network_path_checks(devices)
            return jfused.run_network_path_checks(devices)

        return jgates.NetworkPathGateProber(runner=runner)

    return make


@pytest.mark.parametrize("fault_passes", [0, 3])
def test_engine_roll_walks_the_same_transitions(cpu_devices, fault_passes):
    port = _gated_roll(_port_prober, fault_passes)
    ref = _gated_roll(_jax_prober(cpu_devices[:2]), fault_passes)
    assert port == ref
    states, deletes, holds, warnings = port
    for seq in deletes.values():
        assert seq == ["driver", "net", "plugin"]
    for seq in states.values():
        assert seq[-1] == UpgradeState.DONE.value
    if fault_passes:
        assert holds["net"] >= fault_passes
        assert len(warnings) == 1
        assert warnings[0].endswith(
            "network-path gate not passed: ici_link_state: link 1->0 "
            "delivered 0.0, expected 1.0"
        )
    else:
        assert holds == {} and warnings == []
