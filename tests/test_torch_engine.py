"""The port's probers and agent driving the JAX package's upgrade engine.

The engine (``ClusterUpgradeStateManager`` on a ``FakeCluster``) is the
same code either way; only the prober behind its validation gate
changes.  A roll gated by the port's ``LocalDeviceProber`` must complete
and walk every node through the same distinct states as one gated by the
JAX package's, and the two ``NodeReportProber``s must give the same
verdict and detail for the reports the port's ``HealthAgent`` publishes.
A GPU node reaches the gate with no slice, so the port reads its
accelerator and device count from its labels; its verdicts are held to
the JAX package's on the TPU analogue, a slice of the same count and
floor.
"""

from __future__ import annotations

import time

import pytest

torch = pytest.importorskip("torch")

from k8s_operator_libs_tpu.api import DrainSpec, TPUUpgradePolicySpec  # noqa: E402
from k8s_operator_libs_tpu.health import (  # noqa: E402
    LocalDeviceProber as JaxLocalProber,
    NodeReportProber as JaxReportProber,
)
from k8s_operator_libs_tpu.health import fused as jfused  # noqa: E402
from k8s_operator_libs_tpu.k8s import FakeCluster  # noqa: E402
from k8s_operator_libs_tpu.topology.slices import SliceInfo  # noqa: E402
from k8s_operator_libs_tpu.upgrade import (  # noqa: E402
    ClusterUpgradeStateManager,
    UpgradeKeys,
    UpgradeState,
)
from k8s_operator_libs_tpu.upgrade.types import (  # noqa: E402
    NodeUpgradeState,
    UpgradeGroup,
)
from k8s_operator_libs_tpu_torch.health import (  # noqa: E402
    LocalDeviceProber as PortLocalProber,
    NodeReportProber as PortReportProber,
)
from k8s_operator_libs_tpu_torch.health import fused as tfused  # noqa: E402
from k8s_operator_libs_tpu_torch import hw  # noqa: E402
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent  # noqa: E402
from k8s_operator_libs_tpu_torch.health.probes import CheckResult  # noqa: E402
from k8s_operator_libs_tpu_torch.health.report import HealthReport  # noqa: E402
from k8s_operator_libs_tpu_torch.kernels import collectives  # noqa: E402
from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys as PortKeys  # noqa: E402
from tests.fixtures import (  # noqa: E402
    DRIVER_LABELS,
    NAMESPACE,
    ClusterFixture,
    make_node,
)

KEYS = UpgradeKeys()
CPU = torch.device("cpu")
SMALL = dict(matmul_n=128, hbm_mib=1, allreduce_elems=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; torch's default of one
    # intra-op thread per core oversubscribes the host and turns the
    # small CPU batteries here from milliseconds into seconds.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_caches():
    jfused.reset_battery_cache()
    tfused.reset_battery_cache()
    yield


def _collapse(states: list[str]) -> list[str]:
    out: list[str] = []
    for s in states:
        if not out or out[-1] != s:
            out.append(s)
    return out


def _roll(prober) -> dict[str, list[str]]:
    """Roll a 2-host slice and a plain node from h1 to h2 behind
    ``prober``; returns each node's sequence of distinct states."""
    cluster = FakeCluster()
    fx = ClusterFixture(cluster, KEYS)
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=2) + [fx.node(name="plain-0")]
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    fx.auto_recreate_driver_pods(ds, "h2")
    mgr = ClusterUpgradeStateManager(
        cluster, keys=KEYS, poll_interval_s=0.005, poll_timeout_s=2.0
    ).with_validation_enabled(prober)
    policy = TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        drain_spec=DrainSpec(enable=True, timeout_second=5),
    )
    seen: dict[str, list[str]] = {n.name: [] for n in nodes}
    for _ in range(80):
        mgr.apply_state(mgr.build_state(NAMESPACE, DRIVER_LABELS), policy)
        assert mgr.wait_for_async_work(30.0)
        for name, states in seen.items():
            node = cluster.get_node(name, cached=False)
            states.append(node.labels.get(KEYS.state_label, ""))
        if all(s[-1] == UpgradeState.DONE.value for s in seen.values()):
            break
    else:
        raise AssertionError(f"roll did not converge: {seen}")
    return {name: _collapse(states) for name, states in seen.items()}


def test_roll_gated_by_port_prober_walks_the_same_states(cpu_devices):
    port = _roll(PortLocalProber(devices=[CPU], **SMALL))
    ref = _roll(JaxLocalProber(devices=cpu_devices[:1], **SMALL))
    assert port == ref
    for states in port.values():
        assert UpgradeState.VALIDATION_REQUIRED.value in states
        assert states[-1] == UpgradeState.DONE.value


def _group(nodes, slice_info=None, ds=None):
    return UpgradeGroup(
        id=slice_info.slice_id if slice_info else nodes[0].name,
        members=[NodeUpgradeState(node=n, driver_daemon_set=ds) for n in nodes],
        slice_info=slice_info,
    )


@pytest.mark.parametrize("expected_devices", [0, 16])
def test_local_probers_agree(cpu_devices, expected_devices):
    group = _group([make_node("n0")])
    port = PortLocalProber(
        devices=[CPU], expected_devices=expected_devices, **SMALL
    ).probe(group)
    ref = JaxLocalProber(
        devices=cpu_devices[:1], expected_devices=expected_devices,
        **SMALL,
    ).probe(group)
    assert (port.healthy, port.detail) == (ref.healthy, ref.detail)
    assert port.healthy == (expected_devices == 0)
    assert set(port.telemetry["n0"]) == set(ref.telemetry["n0"])


class _DS:
    """Stands in for the driver DaemonSet the revision resolver reads."""


def _published(case: str):
    """A one-node group whose annotation the port's agent wrote, for
    ``case``; returns (group, report-prober kwargs)."""
    cluster = FakeCluster()
    cluster.create_node(make_node("host-0"))
    agent = HealthAgent(
        cluster, "host-0", PortKeys(),
        driver_revision="old" if case == "wrong_revision" else "rev-1",
        devices=[CPU, CPU] if case == "failed_check" else [CPU],
        **SMALL,
    )
    kwargs: dict = {}
    slice_info = None
    ds = None
    if case == "stale":
        report = agent.probe_once()
        report.timestamp = time.time() - 10_000.2
        agent.publish(report)
        kwargs["max_report_age_s"] = 60
    elif case == "malformed":
        cluster.patch_node_annotations(
            "host-0", {KEYS.health_report_annotation: "{bad"}
        )
    elif case == "failed_check":
        # A host whose ring drops traffic: member 0 keeps its own value.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(collectives, "ring_shift",
                       lambda shards: [s.clone() for s in shards])
            agent.run_once()
    elif case != "missing":
        agent.run_once()
    if case == "wrong_revision":
        ds = _DS()
        kwargs["revision_resolver"] = lambda _ds: "new"
    if case == "chip_count":
        # A 4-chip-per-host slice; the CPU agent sees one device.
        slice_info = SliceInfo(
            slice_id="pool-a", accelerator="tpu-v5p-slice",
            topology="2x2x1", expected_hosts=1,
        )
    node = cluster.get_node("host-0", cached=False)
    return _group([node], slice_info, ds), kwargs


@pytest.mark.parametrize(
    "case, healthy, needle",
    [
        ("healthy", True, "all 1 host report(s) healthy"),
        ("missing", False, "no health report from node host-0"),
        ("stale", False, "stale"),
        ("wrong_revision", False, "revision old, want new"),
        ("failed_check", False,
         "ici_ring: link 1->0 delivered 0.0, expected 1.0"),
        ("chip_count", False, "host enumerates 1 chips, expected 4"),
        ("malformed", False, "malformed health report"),
    ],
)
def test_report_probers_agree_on_agent_reports(case, healthy, needle):
    group, kwargs = _published(case)
    port = PortReportProber(PortKeys(), **kwargs).probe(group)
    ref = JaxReportProber(KEYS, **kwargs).probe(group)
    assert (port.healthy, port.detail) == (ref.healthy, ref.detail)
    assert port.telemetry == ref.telemetry
    assert port.healthy is healthy
    assert needle in port.detail


# --- GPU nodes: accelerator and device count from the node's labels --------

GFD = ("nvidia.com/gpu.product", "nvidia.com/gpu.count")
GKE = ("cloud.google.com/gke-accelerator",
       "cloud.google.com/gke-accelerator-count")


def _gpu_node(labels, visible, hbm_gbps=2900.0, busbw_gbps=180.0):
    """A node whose agent's report passed every check, with ``visible``
    GPUs, its HBM stream at ``hbm_gbps`` and its all-reduce at
    ``busbw_gbps``."""
    checks = [
        CheckResult("device_enumeration", True, 0.1,
                    f"{visible} device(s): NVIDIA H100 80GB HBM3",
                    {"devices": float(visible)}),
        CheckResult("hbm_bandwidth", True, 5.0,
                    f"{hbm_gbps:.1f} GB/s sustained over 1024 MiB x 64 "
                    "passes", {"gbps": hbm_gbps}),
        CheckResult("ici_allreduce", True, 0.05,
                    f"psum over {visible} devices exact",
                    {"devices": float(visible), "busbw_gbps": busbw_gbps}),
    ]
    report = HealthReport("gpu-0", "", checks, time.time(), visible)
    return make_node("gpu-0", labels,
                     {KEYS.health_report_annotation: report.to_json()})


def _labels(scheme, product, count):
    return {scheme[0]: product, scheme[1]: str(count)}


def _tpu_analogue(node, chips):
    """The same node in a TPU slice whose hosts hold ``chips`` chips."""
    return _group([node], SliceInfo(
        slice_id="pool-t", accelerator="tpu-v5p-slice", topology="2x2x2",
        expected_hosts=1, chips_per_host=chips,
    ))


@pytest.mark.parametrize(
    "scheme, product, visible, hbm, busbw, port_kw, ref_kw, needle",
    [
        # A GPU short of the label's count.
        (GFD, "NVIDIA-H100-80GB-HBM3", 7, 2900.0, 180.0, {}, {},
         "host enumerates 7 chips, expected 8"),
        (GKE, "nvidia-h100-80gb", 7, 2900.0, 180.0, {}, {},
         "host enumerates 7 chips, expected 8"),
        # HBM under the SXM profile's floor (half of 3350 GB/s).
        (GFD, "NVIDIA-H100-80GB-HBM3", 8, 800.0, 180.0,
         {"generation_floors": True}, {"min_hbm_gbps": 1675.0},
         "HBM bandwidth 800.0 GB/s below floor 1675.0"),
        (GKE, "nvidia-h100-mega-80gb", 8, 800.0, 180.0,
         {"hbm_floor_fraction": 0.5}, {"min_hbm_gbps": 1675.0},
         "HBM bandwidth 800.0 GB/s below floor 1675.0"),
        # Bus bandwidth under the SXM profile's floor (a quarter of 450).
        (GFD, "NVIDIA-H100-80GB-HBM3", 8, 2900.0, 20.0,
         {"generation_floors": True}, {"min_ici_busbw_gbps": 112.5},
         "ICI bus bandwidth 20.0 GB/s below floor 112.5"),
        (GFD, "NVIDIA-H100-80GB-HBM3", 8, 2900.0, 180.0,
         {"generation_floors": True},
         {"min_hbm_gbps": 1675.0, "min_ici_busbw_gbps": 112.5},
         "all 1 host report(s) healthy"),
    ],
)
def test_gpu_labels_gate_like_a_tpu_slice(scheme, product, visible, hbm,
                                          busbw, port_kw, ref_kw, needle):
    node = _gpu_node(_labels(scheme, product, 8), visible, hbm, busbw)
    port = PortReportProber(PortKeys(), **port_kw).probe(_group([node]))
    ref = JaxReportProber(KEYS, **ref_kw).probe(_tpu_analogue(node, 8))
    assert (port.healthy, port.detail) == (ref.healthy, ref.detail)
    assert needle in port.detail
    assert port.healthy == needle.startswith("all ")


def test_pcie_host_passes_its_profile_floor():
    """A PCIe card reaches the host's other GPUs over PCIe Gen5 (64 GB/s
    one way), so 20 GB/s of bus bandwidth clears its 16 GB/s floor; the
    same reading on an SXM board does not clear 112.5."""
    pcie = _gpu_node(_labels(GFD, "NVIDIA-H100-PCIe", 8), 8, 1500.0, 20.0)
    verdict = PortReportProber(PortKeys(), generation_floors=True).probe(
        _group([pcie])
    )
    assert verdict.healthy, verdict.detail
    sxm = _gpu_node(_labels(GFD, "NVIDIA-H100-80GB-HBM3", 8), 8, 2900.0,
                    20.0)
    verdict = PortReportProber(PortKeys(), generation_floors=True).probe(
        _group([sxm])
    )
    assert not verdict.healthy
    assert verdict.detail.endswith("below floor 112.5")


@pytest.mark.parametrize("labels", [{}, {"nvidia.com/gpu.count": "x"}])
def test_unlabelled_gpu_node_is_not_enforced(labels):
    """Without the labels the accelerator is unknown: no count and no
    floor, as the JAX package treats an unknown accelerator."""
    node = _gpu_node(labels, 7, 800.0, 20.0)
    port = PortReportProber(PortKeys(), generation_floors=True).probe(
        _group([node])
    )
    ref = JaxReportProber(KEYS, generation_floors=True).probe(_group([node]))
    assert (port.healthy, port.detail) == (ref.healthy, ref.detail)
    assert port.healthy


@pytest.mark.parametrize(
    "kind, name",
    [
        ("NVIDIA-H100-PCIe", "h100-pcie"),
        ("NVIDIA-H100-NVL", "h100-nvl"),
        ("NVIDIA-H100-80GB-HBM3", "h100-sxm"),
        ("NVIDIA H100 PCIe", "h100-pcie"),
        ("NVIDIA H100 NVL", "h100-nvl"),
        ("NVIDIA H100 80GB HBM3", "h100-sxm"),
        ("nvidia-h100-80gb", "h100-sxm"),
        ("nvidia-h100-mega-80gb", "h100-sxm"),
        ("nvidia_h100_nvl", "h100-nvl"),
    ],
)
def test_chip_spec_reads_gfd_and_gke_spellings(kind, name):
    assert hw.chip_spec(kind).name == name
