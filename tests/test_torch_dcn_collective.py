"""The port's cross-host collective (D6) against the JAX package's.

In one process there is no world: the probe's three fail-closed
contracts must read as the JAX package's, and a collective that raises
must fail with its prefix.  Across processes, each child
(``torch_dcn_worker.py``) models one host of a multi-node job: it joins
a ``jax.distributed`` world (CPU, gloo collectives, 2 virtual devices)
and a gloo ``torch.distributed`` world on a ``FileStore``, both formed
by the packages' own ``maybe_initialize_distributed``, and runs both
packages' DCN probe, network-path checks and gate on the same world, in
2- and 4-process worlds.  Names, verdicts, details and metrics must be
equal, latency aside.  The port's agent reports from that world then go
through the port's ``NodeReportProber`` with ``require_dcn_check``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from k8s_operator_libs_tpu.health import probes as jprobes  # noqa: E402
from k8s_operator_libs_tpu.health.slice_prober import (  # noqa: E402
    NodeReportProber as JaxReportProber,
)
from k8s_operator_libs_tpu.topology.slices import SliceInfo  # noqa: E402
from k8s_operator_libs_tpu.upgrade import UpgradeKeys  # noqa: E402
from k8s_operator_libs_tpu.upgrade.types import (  # noqa: E402
    NodeUpgradeState,
    UpgradeGroup,
)
from k8s_operator_libs_tpu_torch.health import agent as tagent  # noqa: E402
from k8s_operator_libs_tpu_torch.health import probes as tprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.health.slice_prober import (  # noqa: E402
    NodeReportProber as PortReportProber,
)
from tests.fixtures import make_node  # noqa: E402
from tests.test_multihost_agent import REPO_ROOT, _free_port  # noqa: E402

WORKER = os.path.join(REPO_ROOT, "tests", "torch_dcn_worker.py")
CPU = torch.device("cpu")
KEYS = UpgradeKeys()
WORLDS = [2, 4]
WORKER_TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(ref, port) -> None:
    """Equal apart from the latency."""
    assert (port.name, port.ok, port.detail, port.metrics) == (
        ref.name, ref.ok, ref.detail, ref.metrics
    )


# --- one process: no world ------------------------------------------------------


@pytest.mark.parametrize(
    "group, expected, needle",
    [
        ("", ["a", "b"], "no DCN group configured for this host"),
        ("a", ["a"], ">=2"),
        ("ring-a", ["ring-a", "ring-b"], "world never formed"),
    ],
)
def test_fail_closed_contracts_match_jax(cpu_devices, group, expected, needle):
    ref = jprobes.dcn_collective_probe(cpu_devices, group, expected)
    port = tprobes.dcn_collective_probe([CPU] * 8, group, expected)
    _same(ref, port)
    assert not port.ok and needle in port.detail
    if needle == "world never formed":
        assert port.metrics == {"processes": 1.0}


def test_raising_collective_fails_with_jax_prefix(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("connection reset by peer")

    monkeypatch.setattr(tprobes, "distributed_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "all_reduce", broken)
    port = tprobes.dcn_collective_probe([CPU], "ring-a", ["ring-a", "ring-b"])
    assert (port.name, port.ok, port.detail) == (
        "dcn_collective", False,
        "cross-slice psum failed: connection reset by peer",
    )
    assert port.metrics == {}


def test_run_host_probe_ends_in_the_collective(monkeypatch):
    """``dcn_group`` reaches the probe, after the battery and the
    reachability check, as in the JAX package."""
    seen = []

    def probe(devices, dcn_group="", expected_groups=None):
        seen.append((list(devices), dcn_group, list(expected_groups)))
        return tprobes.CheckResult("dcn_collective", True)

    monkeypatch.setattr(tprobes, "dcn_collective_probe", probe)
    checks = tprobes.run_host_probe(
        [CPU], matmul_n=64, hbm_mib=1, allreduce_elems=64,
        dcn_peers=["127.0.0.1:1"], dcn_group="ring-b",
        dcn_expected_groups=["ring-a", "ring-b"],
    )
    assert [c.name for c in checks][-2:] == [
        "dcn_reachability", "dcn_collective"
    ]
    assert seen == [([CPU], "ring-b", ["ring-a", "ring-b"])]


def test_no_world_without_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tagent.maybe_initialize_distributed(backend="gloo") is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tagent.maybe_initialize_distributed(backend="gloo") is False
    assert not torch.distributed.is_initialized()


# --- across processes ------------------------------------------------------------


def _run_world(n: int, store: str, live_peer: str) -> list[dict]:
    """Spawn ``n`` workers as one world; returns each rank's cases."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env.update(
            TPU_WORKER_HOSTNAMES=",".join(["127.0.0.1"] * n),
            TPU_WORKER_ID=str(rank),
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            OMP_NUM_THREADS="1",
            RANK=str(rank),
            WORLD_SIZE=str(n),
            TORCH_STORE=store,
            LIVE_PEER=live_peer,
        )
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, both worlds formed once."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(16)
    live_peer = f"127.0.0.1:{listener.getsockname()[1]}"
    try:
        return {
            n: _run_world(
                n, str(tmp_path_factory.mktemp(f"world{n}") / "store"),
                live_peer,
            )
            for n in WORLDS
        }
    finally:
        listener.close()


def _pairs(worlds, n, case):
    for rank in worlds[n]:
        ref, port = rank[case]
        yield ref, port


# The fused battery's timed figures, which no two runs share.
TIMED_METRICS = ("battery_compile_ms", "battery_execute_ms")


def _untimed(checks: list[dict]) -> list[dict]:
    return [
        dict(c, metrics={k: v for k, v in c["metrics"].items()
                         if k not in TIMED_METRICS})
        for c in checks
    ]


@pytest.mark.parametrize("n", WORLDS)
def test_worlds_formed(worlds, n):
    assert [r["world"] for r in worlds[n]] == [[n, n]] * n


@pytest.mark.parametrize("n", WORLDS)
def test_cross_process_collective_passes_with_jax_details(worlds, n):
    per_group = n  # n/2 hosts a group, 2 devices each
    for ref, port in _pairs(worlds, n, "dcn pass"):
        assert port == ref
        assert port["ok"]
        assert port["detail"] == (
            "cross-slice psum completed; contributions: "
            f"ring-a={per_group} ring-b={per_group}"
        )
        assert port["metrics"] == {
            "groups": 2.0, "participating": 2.0, "processes": float(n)
        }


@pytest.mark.parametrize("n", WORLDS)
def test_missing_group_fails_with_jax_details(worlds, n):
    for ref, port in _pairs(worlds, n, "dcn ring-c"):
        assert port == ref
        assert not port["ok"]
        assert port["detail"].startswith(
            "DCN collective missing contribution(s) from: ring-c; "
            "cross-slice psum completed; contributions: "
        )
        assert port["detail"].endswith(" ring-c=0")
        assert port["metrics"]["participating"] == 2.0


@pytest.mark.parametrize("n", WORLDS)
def test_raising_collective_in_a_world_matches_jax(worlds, n):
    for ref, port in _pairs(worlds, n, "dcn raises"):
        assert port == ref
        assert port["detail"] == "cross-slice psum failed: injected DCN fault"


@pytest.mark.parametrize("fault", ["network", "network, ring fault"])
@pytest.mark.parametrize("n", WORLDS)
def test_network_path_checks_in_a_world_match_jax(worlds, n, fault):
    for rank in worlds[n]:
        cases = rank[fault]
        for expected in (n, n + 1):
            ref, port = map(_untimed, cases[f"expect {expected}"])
            assert port == ref
            reach = port[0]
            assert reach["name"] == "dcn_reachability"
            assert reach["ok"] == (expected == n)
            assert port[1]["name"] == "ici_link_state"
            assert port[1]["ok"] == (fault == "network")
        ref, port = cases["gate"]
        assert port == ref
        assert port["passed"] == (fault == "network")
        if fault != "network":
            assert port["detail"] == (
                "ici_link_state: link 1->0 delivered 0.0, expected 1.0"
            )


def _group(node):
    return UpgradeGroup(
        id="slice:pool-dcn",
        members=[NodeUpgradeState(node=node)],
        slice_info=SliceInfo(
            slice_id="pool-dcn", accelerator="tpu-multihost-test",
            topology="2x1", expected_hosts=1, chips_per_host=2,
            dcn_group="ring-a",
        ),
    )


@pytest.mark.parametrize("case", ["pass", "ring-c"])
@pytest.mark.parametrize("n", WORLDS)
def test_agent_reports_from_a_world_through_the_gate(worlds, n, case):
    for rank, out in enumerate(worlds[n]):
        raw = out["reports"][case]
        node = make_node(f"host-{rank}", annotations={
            KEYS.health_report_annotation: raw
        })
        port_prober = PortReportProber(KEYS)
        port_prober.require_dcn_check = True
        ref_prober = JaxReportProber(KEYS)
        ref_prober.require_dcn_check = True
        port = port_prober.probe(_group(node))
        ref = ref_prober.probe(_group(node))
        assert (port.healthy, port.detail) == (ref.healthy, ref.detail)
        if case == "pass":
            assert port.healthy, port.detail
        else:
            assert not port.healthy
            assert port.detail.startswith(
                f"node host-{rank}: dcn_collective: DCN collective missing "
                "contribution(s) from: ring-c"
            )
        checks = {c["name"]: c["ok"] for c in json.loads(raw)["checks"]}
        assert checks["dcn_collective"] == (case == "pass")
        if case == "ring-c":
            # The sockets answer: only the collective sees the fault.
            assert checks["dcn_reachability"] is True
