"""The port's report wire format and key builder against the JAX package.

A node's report must read the same whichever package published it:
``HealthReport.to_json`` is byte-identical for the same checks, each
package parses the other's JSON, the telemetry folds agree, and every
``UpgradeKeys`` property names the same key.
"""

from __future__ import annotations

import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")

from k8s_operator_libs_tpu.health import probes as jprobes  # noqa: E402
from k8s_operator_libs_tpu.health import report as jreport  # noqa: E402
from k8s_operator_libs_tpu.upgrade.util import UpgradeKeys as JKeys  # noqa: E402
from k8s_operator_libs_tpu_torch.health import probes as tprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.health import report as treport  # noqa: E402
from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys as TKeys  # noqa: E402

SMALL = dict(matmul_n=128, hbm_mib=1)
BATTERY = dict(fused=1.0, battery_cache_hit=0.0, battery_compile_ms=12.34567,
               battery_execute_ms=3.0001)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; torch's default of one
    # intra-op thread per core oversubscribes the host and turns the
    # small CPU batteries here from milliseconds into seconds.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _checks(label):
    """The check set ``label``: a list of (name, ok, latency_ms, detail,
    metrics); "cpu_battery" is a real run of the port's battery."""
    if label == "cpu_battery":
        return [
            (c.name, c.ok, c.latency_ms, c.detail, dict(c.metrics))
            for c in tprobes.run_host_probe(
                [torch.device("cpu")], fused=False, max_iters=64, **SMALL
            )
        ]
    return {
        "empty": [],
        "fused_with_floors": [
            ("device_enumeration", True, 0.0123456,
             "1 device(s): NVIDIA H100 80GB HBM3", {"devices": 1.0}),
            ("mxu_matmul", True, 8.0683, "exact over 8 chained matmuls",
             dict(BATTERY, n=4096.0, iters=8.0, floor_mxu_tflops=494.5)),
            ("hbm_bandwidth", True, 8.0683, "content exact",
             dict(BATTERY, mib=1024.0, iters=8.0, floor_hbm_gbps=1675.0)),
        ],
        "failing_unicode": [
            ("hbm_bandwidth", False, 1.5,
             "measured 1.0 GB/s — below floor “x” ✗",
             {"gbps": 1.0000049, "timing_inconclusive": 0.0}),
            ("ici_ring", False, 0.0, "2 devices: not ported yet",
             {"devices": 2.0}),
        ],
        "inconclusive": [
            ("mxu_matmul", True, 0.0, "throughput unmeasured",
             {"n": 4096.0, "iters": 9.0, "timing_inconclusive": 1.0,
              "tflops": 1e9}),
            ("hbm_bandwidth", True, 0.7, "2822.0 GB/s",
             {"gbps": 2822.0353208, "mib": 1024.0, "fused": 0.0,
              "battery_cache_hit": 0.0, "battery_execute_ms": 1628.3}),
        ],
    }[label]


LABELS = ["empty", "cpu_battery", "fused_with_floors", "failing_unicode",
          "inconclusive"]


def _reports(checks, **kw):
    fields = dict(node_name="gpu-node-0", driver_revision="rev-7",
                  timestamp=1760640000.123456, visible_devices=8,
                  slice_wide=False)
    fields.update(kw)
    return (
        jreport.HealthReport(
            checks=[jprobes.CheckResult(*c) for c in checks], **fields
        ),
        treport.HealthReport(
            checks=[tprobes.CheckResult(*c) for c in checks], **fields
        ),
    )


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("slice_wide", [False, True])
def test_to_json_is_byte_identical(label, slice_wide):
    j, t = _reports(_checks(label), slice_wide=slice_wide)
    assert t.to_json() == j.to_json()
    assert t.healthy == j.healthy


@pytest.mark.parametrize("label", LABELS)
def test_each_side_parses_the_other(label):
    j, t = _reports(_checks(label))
    from_port = jreport.HealthReport.from_json(t.to_json())
    from_jax = treport.HealthReport.from_json(j.to_json())
    assert from_port.to_json() == from_jax.to_json() == j.to_json()
    assert from_jax.healthy == from_port.healthy == j.healthy
    assert [c.name for c in from_jax.failed_checks()] == [
        c.name for c in from_port.failed_checks()
    ]


@pytest.mark.parametrize("label", LABELS)
def test_telemetry_folds_agree(label):
    j, t = _reports(_checks(label))
    for fn in ("measured_node_stats", "battery_telemetry",
               "fused_battery_telemetry"):
        assert getattr(treport, fn)(t.checks) == getattr(jreport, fn)(j.checks)


@pytest.mark.parametrize(
    "raw", ["", "not json", "[1,2]", "{bad", '{"checks": 5}',
            '{"ts": "soon"}', '{"checks": [1]}']
)
def test_malformed_reports_raise_value_error(raw):
    with pytest.raises(ValueError):
        treport.HealthReport.from_json(raw)


def test_health_checks_all_and_round_trip_fields():
    assert treport.HEALTH_CHECKS_ALL == jreport.HEALTH_CHECKS_ALL
    _, t = _reports(_checks("cpu_battery"), slice_wide=True)
    back = treport.HealthReport.from_json(t.to_json())
    assert (back.node_name, back.driver_revision, back.visible_devices,
            back.slice_wide) == ("gpu-node-0", "rev-7", 8, True)
    assert math.isclose(back.timestamp, 1760640000.123)
    assert json.loads(t.to_json())["checks"][1]["name"] == "mxu_matmul"


KEY_PAIRS = [
    ("libtpu", "tpu.google.com"),
    ("nvidia", "nvidia.com"),
    ("gpu-driver", "example.org"),
    ("", ""),
]


@pytest.mark.parametrize("driver, domain", KEY_PAIRS)
def test_upgrade_keys_match(driver, domain):
    props = sorted(
        name for name, v in vars(JKeys).items() if isinstance(v, property)
    )
    port_props = sorted(
        name for name, v in vars(TKeys).items() if isinstance(v, property)
    )
    assert port_props == props
    j = JKeys(driver_name=driver, domain=domain)
    t = TKeys(driver_name=driver, domain=domain)
    for name in props:
        assert getattr(t, name) == getattr(j, name), name


def test_upgrade_keys_defaults_match():
    assert (TKeys().driver_name, TKeys().domain) == (
        JKeys().driver_name, JKeys().domain
    )
    assert TKeys().health_report_annotation == JKeys().health_report_annotation
