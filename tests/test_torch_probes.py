"""The port's probe battery against the JAX package's, on the CPU.

The same battery runs through ``k8s_operator_libs_tpu.health`` on one
JAX CPU device and through ``k8s_operator_libs_tpu_torch.health`` on
``torch.device("cpu")``, where the port's kernels run their plain
versions.  The invariants are exact in both frameworks (chained 0.5
matmul, pass count of the stream), so check names, order, verdicts,
static metrics and the fused battery's detail strings must be identical,
and so must the details of injected faults.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from k8s_operator_libs_tpu.health import fused as jfused  # noqa: E402
from k8s_operator_libs_tpu.health import probes as jprobes  # noqa: E402
from k8s_operator_libs_tpu_torch import hw  # noqa: E402
from k8s_operator_libs_tpu_torch import kernels  # noqa: E402
from k8s_operator_libs_tpu_torch.fleet import profiles  # noqa: E402
from k8s_operator_libs_tpu_torch.health import fused as tfused  # noqa: E402
from k8s_operator_libs_tpu_torch.health import probes as tprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.kernels import collectives  # noqa: E402

CPU = torch.device("cpu")
SMALL = dict(matmul_n=128, hbm_mib=1, allreduce_elems=128)
# Caps the sustained-timing escalation: the figures are not compared,
# and under a loaded test host the estimator would escalate to its cap.
FAST = dict(max_iters=64)
STATIC = ("n", "mib", "devices", "fused", "battery_cache_hit")


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
    jfused.reset_battery_cache()
    tfused.reset_battery_cache()


@pytest.fixture
def jax_dev(cpu_devices):
    return cpu_devices[:1]


def _static(check, keys=STATIC):
    return {k: v for k, v in check.metrics.items() if k in keys}


def _shape(checks, details: bool, keys=STATIC):
    return [
        (c.name, c.ok, c.detail if details else None, _static(c, keys))
        for c in checks
    ]


# --- single probes ----------------------------------------------------------


@pytest.mark.parametrize("expected", [0, 1, 4])
def test_device_inventory_parity(jax_dev, expected):
    j = jprobes.device_inventory(jax_dev, expected)
    t = tprobes.device_inventory([CPU], expected)
    assert (t.name, t.ok, t.detail, t.metrics) == (
        j.name, j.ok, j.detail, j.metrics
    )


def test_matmul_probe_parity(jax_dev):
    j = jprobes.matmul_probe(jax_dev[0], n=128, **FAST)
    t = tprobes.matmul_probe(CPU, n=128, **FAST)
    assert (t.name, t.ok, t.metrics["n"]) == (j.name, j.ok, j.metrics["n"])
    assert t.ok and t.metrics["iters"] > 1
    assert ("tflops" in t.metrics) == ("tflops" in j.metrics)


def test_matmul_probe_rejects_non_pow2_identically():
    j = jprobes.matmul_probe(None, n=100)
    t = tprobes.matmul_probe(None, n=100)
    assert (t.name, t.ok, t.detail) == (j.name, j.ok, j.detail)


def test_hbm_bandwidth_probe_parity(jax_dev):
    j = jprobes.hbm_bandwidth_probe(jax_dev[0], mib=1, **FAST)
    t = tprobes.hbm_bandwidth_probe(CPU, mib=1, **FAST)
    assert (t.name, t.ok, t.metrics["mib"]) == (j.name, j.ok, j.metrics["mib"])
    assert t.ok and t.metrics["iters"] > 1 and t.metrics["gbps"] > 0


def test_single_device_ici_results_are_word_for_word(jax_dev):
    for jfn, tfn in (
        (jprobes.ici_allreduce_probe, tprobes.ici_allreduce_probe),
        (jprobes.ici_ring_probe, tprobes.ici_ring_probe),
        (jprobes.ici_ring_attention_probe, tprobes.ici_ring_attention_probe),
    ):
        j, t = jfn(jax_dev), tfn([CPU])
        assert (t.name, t.ok, t.detail, t.metrics) == (
            j.name, j.ok, j.detail, j.metrics
        )


# --- the battery ------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("skip_ici", [False, True])
@pytest.mark.parametrize("expected_devices", [0, 2])
def test_run_host_probe_parity(jax_dev, fused, skip_ici, expected_devices):
    kw = dict(**FAST, fused=fused, skip_ici=skip_ici,
              expected_devices=expected_devices)
    j = jprobes.run_host_probe(jax_dev, **SMALL, **kw)
    t = tprobes.run_host_probe([CPU], **SMALL, **kw)
    assert _shape(t, details=fused) == _shape(j, details=fused)
    assert all(c.ok for c in t[1:])
    assert tfused.battery_stats()["fallbacks"] == 0


def test_fused_battery_details_and_cache(jax_dev):
    keys = STATIC + ("iters",)
    for hit in (0.0, 1.0):
        j = jfused.run_fused_battery(jax_dev, **SMALL)
        t = tfused.run_fused_battery([CPU], **SMALL)
        assert _shape(t, True, keys) == _shape(j, True, keys)
        assert all(c.metrics["battery_cache_hit"] == hit for c in t)
    stats = tfused.battery_stats()
    assert (stats["compile_cache_misses"], stats["compile_cache_hits"]) == (1, 1)
    assert stats["cached_programs"] == 1.0


@pytest.mark.parametrize("nan_at", [None, 0, -1])
@pytest.mark.parametrize("center", [0.0, 0.5])
@pytest.mark.parametrize("n, offset", [(1, 0), (7, 1), (4097, 0),
                                       (1_000_003, 1)])
def test_stream_increment_verify_matches_jax(n, offset, center, nan_at):
    """The fused battery's last stream pass and its check against the JAX
    package's `x + 1` then `jnp.min`, `jnp.max` and `jnp.max(jnp.abs(x -
    c))` on the same seed-made input, exactly, NaN included."""
    host = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    if nan_at is not None:
        host[nan_at] = np.nan
    xj = jnp.asarray(host) + jnp.float32(1.0)
    want = np.array([jnp.min(xj), jnp.max(xj),
                     jnp.max(jnp.abs(xj - jnp.float32(center)))],
                    dtype=np.float32)
    x = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32),
                                         host]))[offset:]
    got = kernels.stream_increment_verify_(x, center)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert np.isnan(want).all() == (nan_at is not None)


@pytest.mark.parametrize("members", [1, 2, 3])
def test_battery_body_checks_the_stream_in_its_last_pass(monkeypatch,
                                                         members):
    """Each member's body runs HBM_CHAIN_ITERS - 1 plain passes, then one
    verifying pass (the check of x), and K2 once, on C."""
    calls = {"body": 0, "k1": 0, "k1_verify": 0, "k2": []}

    def counted(name, fn):
        def wrapper(*args, **kw):
            if name == "k2":
                calls[name].append(args[0].dtype)
            else:
                calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tfused, "_battery_body",
                        counted("body", tfused._battery_body))
    monkeypatch.setattr(tfused, "stream_increment_",
                        counted("k1", tfused.stream_increment_))
    monkeypatch.setattr(tfused, "stream_increment_verify_",
                        counted("k1_verify", tfused.stream_increment_verify_))
    monkeypatch.setattr(tfused, "verify_stats",
                        counted("k2", tfused.verify_stats))
    checks = tfused.run_fused_battery([CPU] * members, **SMALL)
    assert all(c.ok for c in checks)
    bodies = calls["body"]
    assert bodies == 2 * members  # the warm-up, then the run
    assert calls["k1_verify"] == bodies
    assert calls["k1"] == bodies * (tfused.HBM_CHAIN_ITERS - 1)
    assert calls["k2"] == [torch.bfloat16] * bodies


def test_fused_battery_rejects_non_pow2():
    with pytest.raises(ValueError):
        tfused.run_fused_battery([CPU], matmul_n=100)


def _seed_jax(kind):
    real = jfused._build_inputs

    def build(key, battery):
        a, b, x, ramp, ring = real(key, battery)
        if kind in ("mm_quarter", "mm_nan"):
            val = 0.25 if kind == "mm_quarter" else np.nan
            a = jax.device_put(a.at[0, 0].set(val), a.sharding)
        else:
            val = 3.0 if kind == "hbm_offset" else np.nan
            x = jax.device_put(x.at[5].add(jnp.float32(val)), x.sharding)
        return a, b, x, ramp, ring

    return build


def _seed_torch(kind):
    real = tfused._build_inputs

    def build(key, device, member):
        a, b, x, ramp, ring = real(key, device, member)
        if kind in ("mm_quarter", "mm_nan"):
            a[0, 0] = 0.25 if kind == "mm_quarter" else float("nan")
        else:
            x[5] += 3.0 if kind == "hbm_offset" else float("nan")
        return a, b, x, ramp, ring

    return build


@pytest.mark.parametrize(
    "kind", ["mm_quarter", "mm_nan", "hbm_offset", "hbm_nan"]
)
def test_fused_fault_details_match(jax_dev, monkeypatch, kind):
    monkeypatch.setattr(jfused, "_build_inputs", _seed_jax(kind))
    monkeypatch.setattr(tfused, "_build_inputs", _seed_torch(kind))
    j = jprobes.run_host_probe(jax_dev, fused=True, **SMALL)
    t = tprobes.run_host_probe([CPU], fused=True, **SMALL)
    assert [(c.name, c.ok, c.detail) for c in t] == [
        (c.name, c.ok, c.detail) for c in j
    ]
    failed = [c.name for c in t if not c.ok]
    assert failed == (["mxu_matmul"] if kind.startswith("mm") else
                      ["hbm_bandwidth"])
    assert tfused.battery_stats()["fallbacks"] == 0


def test_fused_fault_detail_text(monkeypatch):
    # The seeded quarter stays exact through the chain: row 0 of C is
    # 0.5 - 0.25/n after the first product and a fixed point after.
    monkeypatch.setattr(tfused, "_build_inputs", _seed_torch("mm_quarter"))
    t = tfused.run_fused_battery([CPU], **SMALL)
    assert t[0].detail == (
        "matmul result mismatch on device 0: max abs error 0.001953125 "
        "from expected 0.5 over 8 chained matmuls (n=128)"
    )


# --- fail closed -------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_multi_device_ici_fails_closed(monkeypatch, fused):
    # A host whose collectives cannot run (here: no peer access between
    # two of its GPUs) fails both ICI checks, naming the cause; the fused
    # battery falls back to the unfused probes, which fail as well.
    def no_peer_access(*args, **kw):
        raise RuntimeError("peer access 0->1 unavailable")

    monkeypatch.setattr(collectives, "all_reduce", no_peer_access)
    monkeypatch.setattr(collectives, "all_reduce_init", no_peer_access)
    monkeypatch.setattr(collectives, "ring_shift", no_peer_access)
    checks = tprobes.run_host_probe([CPU, CPU], fused=fused, **SMALL, **FAST)
    by_name = {c.name: c for c in checks}
    assert by_name["device_enumeration"].ok
    assert by_name["mxu_matmul"].ok and by_name["hbm_bandwidth"].ok
    assert by_name["mxu_matmul"].metrics["fused"] == 0.0
    assert tfused.battery_stats()["fallbacks"] == int(fused)
    assert (by_name["ici_allreduce"].ok, by_name["ici_allreduce"].detail) == (
        False, "all-reduce failed: peer access 0->1 unavailable"
    )
    assert (by_name["ici_ring"].ok, by_name["ici_ring"].detail) == (
        False, "ppermute failed: peer access 0->1 unavailable"
    )


def test_deep_and_dcn_collective_fail_closed():
    checks = tprobes.run_host_probe(
        [CPU, CPU], deep=True, dcn_expected_groups=["g1"],
        **SMALL,
    )
    names = [c.name for c in checks]
    assert names[-2:] == ["ici_ring_attention", "dcn_collective"]
    # The deep probe is ported: ring attention over both devices.
    deep, dcn = checks[-2:]
    assert deep.ok and deep.detail.startswith("seq 256 over 2 devices")
    # No DCN group for this host: the collective fails closed with the
    # JAX package's detail.
    assert (dcn.ok, dcn.detail) == (
        False, "no DCN group configured for this host (HEALTH_DCN_GROUP)"
    )
    # One device: deep is vacuous (as in the JAX package), DCN still
    # fails closed.
    single = tprobes.run_host_probe(
        [CPU], deep=True, dcn_expected_groups=["g1"], **SMALL
    )
    assert single[-2].ok and not single[-1].ok


def test_no_cuda_reports_failed_enumeration(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    checks = tprobes.run_host_probe(**SMALL)
    assert len(checks) == 1
    assert checks[0].name == "device_enumeration" and not checks[0].ok
    assert checks[0].detail.startswith("device enumeration failed: ")
    assert not tprobes.device_inventory().ok
    with pytest.raises(RuntimeError):
        tprobes.matmul_probe(n=128)


def test_fused_fault_falls_back_to_unfused(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(tfused, "_battery_body", broken)
    checks = tprobes.run_host_probe([CPU], fused=True, **SMALL, **FAST)
    assert all(c.ok for c in checks)
    assert checks[1].metrics["fused"] == 0.0
    assert tfused.battery_stats()["fallbacks"] == 1


def test_on_check_sees_every_check():
    seen = []
    checks = tprobes.run_host_probe([CPU], on_check=seen.append, **SMALL)
    assert seen == checks


# --- sustained timing ---------------------------------------------------------


class _ScriptClock:
    """perf_counter stand-in: each run() brackets its loop with two calls;
    this feeds a scripted elapsed time per run, in order."""

    def __init__(self, elapsed_seq):
        self.elapsed = list(elapsed_seq)
        self.now = 0.0
        self.pending = None

    def __call__(self):
        if self.pending is None:
            self.pending = self.elapsed.pop(0) if self.elapsed else 1.0
            return self.now
        self.now += self.pending
        self.pending = None
        return self.now


def _both_sustained(monkeypatch, jax_dev, script, **kw):
    """Run the JAX and the port estimator on the same clock script."""
    monkeypatch.setattr(jprobes, "_perf_counter", _ScriptClock(script))
    jx = jax.device_put(jnp.ones(()), jax_dev[0])
    j = jprobes._timed_sustained(lambda a: a + 1, (jx,), chain=True, **kw)
    monkeypatch.setattr(tprobes, "_perf_counter", _ScriptClock(script))
    t = tprobes._timed_sustained(
        lambda a: a + 1, (torch.ones(()),), chain=True, **kw
    )
    return j, t


def test_timed_sustained_escalates_past_jitter(monkeypatch, jax_dev):
    script = [0.001, 1.0] + [1.0, 0.5] * 3 + [1.0, 4.0] * 3
    j, t = _both_sustained(monkeypatch, jax_dev, script, min_time_s=1e-6)
    # k1 escalated 16→64, k2 256: slope = (4.0-1.0)/(256-64) s/iter.
    assert t[0] == pytest.approx(3.0 / 192 * 1e3) == j[0]
    assert t[2] == j[2] and float(t[1]) == float(j[1]) == 1 + t[2]


def test_timed_sustained_warm_run_resizes_k1(monkeypatch, jax_dev):
    script = [1.0, 0.016] + [1.0, 2.0] * 3
    j, t = _both_sustained(monkeypatch, jax_dev, script, min_time_s=1.0)
    assert t[0] == pytest.approx(1.0 / 1536 * 1e3) == j[0]
    assert t[2] == j[2] == 1 + 2 + 16 + 3 * (512 + 2048)


def test_timed_sustained_deterministic_never_escalates(monkeypatch):
    monkeypatch.setattr(
        tprobes, "_perf_counter", _ScriptClock([0.001, 1.0] + [1.0, 0.5] * 3)
    )
    with pytest.raises(tprobes.InconclusiveTiming) as err:
        tprobes._timed_sustained(
            lambda a: a + 1, (torch.ones(()),), min_time_s=1e-6,
            chain=True, deterministic=True,
        )
    # compile(1) + pilot(2) + warm(16) + 3×(16 + 64) applications.
    assert err.value.applied == 1 + 2 + 16 + 3 * 80


def test_inconclusive_timing_is_not_failure(monkeypatch):
    def fake(fn, args, **kw):
        out = fn(*args)
        raise tprobes.InconclusiveTiming("unstable timing (forced)", out, 1)

    monkeypatch.setattr(tprobes, "_timed_sustained", fake)
    res = tprobes.matmul_probe(CPU, n=64)
    assert res.ok and res.metrics.get("timing_inconclusive") == 1.0
    assert "tflops" not in res.metrics
    res = tprobes.hbm_bandwidth_probe(CPU, mib=1)
    assert res.ok and "gbps" not in res.metrics


def test_content_mismatch_is_attributed(monkeypatch):
    def wrong(fn, args, **kw):
        return 1.0, torch.full_like(args[0], 0.75), 7

    monkeypatch.setattr(tprobes, "_timed_sustained", wrong)
    res = tprobes.matmul_probe(CPU, n=4)
    assert not res.ok
    assert res.detail == "matmul result mismatch: expected 0.5, got [0.75, 0.75]"
    res = tprobes.hbm_bandwidth_probe(CPU, mib=1)
    assert not res.ok and "stream content mismatch: expected 7.0" in res.detail


def test_min_time_env_fallback(monkeypatch):
    monkeypatch.setenv("K8S_TPU_PROBE_MIN_TIME_S", "50ms")
    assert tprobes._min_time_from_env() == 0.05
    monkeypatch.setenv("K8S_TPU_PROBE_MIN_TIME_S", "0.2")
    assert tprobes._min_time_from_env() == 0.2


def test_dcn_reachability_parity():
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    try:
        peers = [f"127.0.0.1:{listener.getsockname()[1]}",
                 f"127.0.0.1:{dead_port}"]
        for sub in (peers[:1], peers):
            j = jprobes.dcn_reachability_probe(sub, timeout_s=0.5)
            t = tprobes.dcn_reachability_probe(sub, timeout_s=0.5)
            assert (t.ok, t.detail, t.metrics) == (j.ok, j.detail, j.metrics)
    finally:
        listener.close()


# --- the card's tables ---------------------------------------------------------


@pytest.mark.parametrize(
    "kind, name",
    [
        ("NVIDIA H100 80GB HBM3", "h100-sxm"),
        ("NVIDIA H100 PCIe", "h100-pcie"),
        ("NVIDIA H100 NVL", "h100-nvl"),
        ("nvidia-h100-80gb", "h100-sxm"),
        ("nvidia-h100-mega-80gb", "h100-sxm"),
        ("cpu", None),
        ("", None),
        ("TPU v5 lite", None),
        ("NVIDIA A100-SXM4-80GB", None),
    ],
)
def test_chip_spec_table(kind, name):
    spec = hw.chip_spec(kind)
    assert (spec.name if spec else None) == name
    assert (profiles.generation_of(kind) or None) == name


def test_spec_figures_and_floors():
    sxm = hw.chip_spec("NVIDIA H100 80GB HBM3")
    assert (sxm.bf16_tflops, sxm.hbm_gbps, sxm.hbm_gib) == (989.0, 3350.0, 80.0)
    assert hw.mfu(494.5, "NVIDIA H100 80GB HBM3") == 0.5
    assert hw.mfu(10.0, "cpu") is None
    assert hw.default_hbm_floor_gbps("NVIDIA H100 PCIe") == 1000.0
    assert hw.default_hbm_floor_gbps("cpu") == 0.0
    floors = tprobes.resolve_floors("NVIDIA H100 80GB HBM3")
    assert (floors.mxu_tflops, floors.hbm_gbps, floors.ici_busbw_gbps) == (
        494.5, 1675.0, 112.5
    )
    assert tprobes.resolve_floors("cpu") is None
    gens = profiles.known_generations()
    assert [g.name for g in gens] == ["h100-pcie", "h100-sxm", "h100-nvl"]
    # NVLink 4 one way on the SXM board; PCIe Gen5 x16 one way between
    # PCIe or NVL cards.
    assert [(g.chips_per_host, g.ici_gbps) for g in gens] == [
        (8, 64.0), (8, 450.0), (8, 64.0)
    ]
