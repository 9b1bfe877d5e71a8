"""The port's host collectives against the JAX package's, on the CPU.

The JAX side runs over the first n of the ``cpu_devices`` fixture's 8
devices (a ``shard_map`` over the ``ici`` mesh axis, as its probes do);
the port's over ``[torch.device("cpu")] * n``, where K4 ``peer_reduce``
runs its plain version inside the same reduce-scatter / all-gather and
ring algorithms that drive the card.  Both sum in index order, so
``all_reduce`` equals ``lax.psum`` bit for bit on any input; with a
divisor the port divides by IEEE division, where XLA on the CPU
multiplies by the divisor's reciprocal (exact for the powers of two, not
for n = 3), so that case is held against numpy's division of the psum.
The probes' invariants are exact in both frameworks (n(n+1)/2,
(n+1)/2, ring i-1), so verdicts, check names and details must agree,
apart from the timed figures of the unfused battery.
"""

from __future__ import annotations

import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from k8s_operator_libs_tpu.health import agent as jagent  # noqa: E402
from k8s_operator_libs_tpu.health import fused as jfused  # noqa: E402
from k8s_operator_libs_tpu.health import probes as jprobes  # noqa: E402
from k8s_operator_libs_tpu.health import slice_prober as jslice  # noqa: E402
from k8s_operator_libs_tpu_torch.health import agent as tagent  # noqa: E402
from k8s_operator_libs_tpu_torch.health import fused as tfused  # noqa: E402
from k8s_operator_libs_tpu_torch.health import probes as tprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.health import (  # noqa: E402
    slice_prober as tslice,
)
from k8s_operator_libs_tpu_torch.kernels import collectives  # noqa: E402
from k8s_operator_libs_tpu_torch.kernels import launch_counts  # noqa: E402

CPU = torch.device("cpu")
MEMBERS = [2, 3, 4, 8]
# The ramp's length per member: ragged against every n above (7·11·13),
# so the reduce-scatter's chunks are uneven.
ELEMS = 1001
SMALL = dict(matmul_n=64, hbm_mib=1, allreduce_elems=ELEMS)
# Caps the sustained-timing escalation: the figures are not compared.
FAST = dict(max_iters=64)
# The timed figures in the unfused battery's details.
TIMED = (
    (re.compile(r"\d+\.\d+ (TFLOPS|GB/s)"), r"# \1"),
    (re.compile(r"over \d+ (chained|rounds)"), r"over # \1"),
    (re.compile(r"x \d+ passes"), "x # passes"),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; one intra-op thread each
    # keeps the small CPU batteries here from oversubscribing the host.
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


def _untimed(detail: str) -> str:
    for pattern, repl in TIMED:
        detail = pattern.sub(repl, detail)
    return detail


def _shape(checks):
    return [
        (c.name, c.ok, _untimed(c.detail),
         {k: v for k, v in c.metrics.items()
          if k in ("devices", "n", "mib", "fused", "bad_links")})
        for c in checks
    ]


def _host(n: int, seed: int, elems: int = ELEMS) -> np.ndarray:
    """[n, elems] fp32 over many magnitudes, so that the order of the
    sums shows in the last bits."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1e3) ** rng.integers(-2, 3, (n, elems))
    return (rng.standard_normal((n, elems)) * scale).astype(np.float32)


def _jax_collective(devs, body, host):
    mesh = Mesh(np.asarray(devs), ("ici",))
    fn = jax.jit(
        jprobes.shard_map(body, mesh=mesh, in_specs=P("ici"),
                          out_specs=P("ici"))
    )
    return np.asarray(fn(jax.device_put(host, NamedSharding(mesh, P("ici")))))


def _members(host: np.ndarray) -> list:
    return [torch.from_numpy(row.copy()) for row in host]


def _bits(a: np.ndarray) -> np.ndarray:
    """The fp32 bit patterns, with every NaN as one pattern (a NaN's
    payload is not part of the contract)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    return np.where(np.isnan(a), np.int32(-1), a.view(np.int32))


# --- the collectives against lax.psum and lax.ppermute ---------------------


@pytest.mark.parametrize("n", MEMBERS)
def test_all_reduce_matches_psum_bit_for_bit(cpu_devices, n):
    host = _host(n, seed=n)
    host[n - 1, 17] = np.nan
    want = _jax_collective(
        cpu_devices[:n], lambda x: jax.lax.psum(x, "ici"), host
    )
    before = launch_counts()
    got = collectives.all_reduce(_members(host))
    assert launch_counts() == before  # the CPU takes the plain version
    assert len(got) == n
    for j in range(n):
        assert got[j].dtype == torch.float32 and got[j].shape == (ELEMS,)
        np.testing.assert_array_equal(_bits(got[j].numpy()), _bits(want[j]))
    # With a divisor: IEEE division of the same sum.
    divided = collectives.all_reduce(_members(host), divisor=float(n))
    for j in range(n):
        np.testing.assert_array_equal(
            _bits(divided[j].numpy()), _bits(want[j] / np.float32(n))
        )


@pytest.mark.parametrize("n", MEMBERS)
def test_ring_shift_matches_ppermute(cpu_devices, n):
    host = _host(n, seed=100 + n)
    perm = [(i, (i + 1) % n) for i in range(n)]
    want = _jax_collective(
        cpu_devices[:n], lambda x: jax.lax.ppermute(x, "ici", perm), host
    )
    got = collectives.ring_shift(_members(host))
    for j in range(n):
        np.testing.assert_array_equal(_bits(got[j].numpy()), _bits(want[j]))


# --- the probes ---------------------------------------------------------------


@pytest.mark.parametrize("n", MEMBERS)
def test_ici_allreduce_probe_parity(cpu_devices, n):
    j = jprobes.ici_allreduce_probe(
        cpu_devices[:n], per_device_elems=ELEMS, **FAST
    )
    t = tprobes.ici_allreduce_probe([CPU] * n, per_device_elems=ELEMS, **FAST)
    assert (t.name, t.ok, _untimed(t.detail)) == (
        j.name, j.ok, _untimed(j.detail)
    )
    assert t.ok and t.detail.startswith(f"psum over {n} devices exact; ")
    assert sorted(t.metrics) == sorted(j.metrics)
    assert t.metrics["devices"] == float(n) and t.metrics["iters"] > 1


@pytest.mark.parametrize("n", MEMBERS)
def test_ici_ring_probe_parity(cpu_devices, n):
    j = jprobes.ici_ring_probe(cpu_devices[:n])
    t = tprobes.ici_ring_probe([CPU] * n)
    assert (t.name, t.ok, t.detail, t.metrics) == (
        j.name, j.ok, j.detail, j.metrics
    )
    assert t.detail == (
        f"all {n} locally-received ring link(s) verified ({n}-device ring)"
    )


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", MEMBERS)
def test_run_host_probe_parity(cpu_devices, n, fused):
    j = jprobes.run_host_probe(cpu_devices[:n], fused=fused, **SMALL, **FAST)
    t = tprobes.run_host_probe([CPU] * n, fused=fused, **SMALL, **FAST)
    assert _shape(t) == _shape(j)
    assert [c.name for c in t] == [
        "device_enumeration", "mxu_matmul", "hbm_bandwidth",
        "ici_allreduce", "ici_ring",
    ]
    assert all(c.ok for c in t)
    assert all(c.metrics["fused"] == float(fused) for c in t[1:])
    assert tfused.battery_stats()["fallbacks"] == 0
    if fused:
        assert t[3].detail == (
            f"psum over {n} devices exact (4 rounds); fused battery "
            "(bus bandwidth unmeasured)"
        )


# --- injected faults -------------------------------------------------------------


def _dropped_ring(shards):
    """Every member keeps its own value: no traffic crossed a link."""
    return [s.clone() for s in shards]


def _dropped_sum(shards, divisor=1.0):
    """Every member keeps its own contribution, over the divisor."""
    return [s / divisor for s in shards]


def _zero_sum(shards, divisor=1.0):
    return [torch.zeros_like(s) for s in shards]


@pytest.mark.parametrize(
    "path", ["ring_probe", "fused_ring", "unfused_psum"]
)
@pytest.mark.parametrize("n", MEMBERS)
def test_dropped_traffic_fails_with_jax_details(cpu_devices, monkeypatch, n,
                                                path):
    if path == "unfused_psum":
        monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name: x)
        monkeypatch.setattr(collectives, "all_reduce", _dropped_sum)
    else:
        monkeypatch.setattr(jax.lax, "ppermute",
                            lambda x, axis_name, perm: x)
        monkeypatch.setattr(collectives, "ring_shift", _dropped_ring)
    if path == "ring_probe":
        j = [jprobes.ici_ring_probe(cpu_devices[:n])]
        t = [tprobes.ici_ring_probe([CPU] * n)]
    else:
        kw = dict(SMALL, **FAST, fused=path == "fused_ring")
        j = jprobes.run_host_probe(cpu_devices[:n], **kw)
        t = tprobes.run_host_probe([CPU] * n, **kw)
    assert _shape(t) == _shape(j)
    failed = [c for c in t if not c.ok]
    assert len(failed) == 1
    if path == "unfused_psum":
        assert failed[0].detail == (
            f"psum mismatch: expected {n * (n + 1) / 2}, got [1.0, {n}.0]"
        )
    else:
        assert failed[0].detail == (
            f"link {n - 1}->0 delivered 0.0, expected {float(n - 1)}"
        )
        assert failed[0].metrics["bad_links"] == float(n)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", MEMBERS)
def test_wrong_sum_fails_with_jax_details(cpu_devices, monkeypatch, n, fused):
    monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name: x * 0)
    monkeypatch.setattr(collectives, "all_reduce", _zero_sum)
    kw = dict(SMALL, **FAST, fused=fused)
    j = jprobes.run_host_probe(cpu_devices[:n], **kw)
    t = tprobes.run_host_probe([CPU] * n, **kw)
    assert _shape(t) == _shape(j)
    failed = [c for c in t if not c.ok]
    assert [c.name for c in failed] == ["ici_allreduce"]
    want = (
        f"psum mismatch on device 0: expected {(n + 1) / 2}, got 0.0"
        if fused else
        f"psum mismatch: expected {n * (n + 1) / 2}, got [0.0, 0.0]"
    )
    assert failed[0].detail == want


# --- allreduce_elems ------------------------------------------------------------


@pytest.mark.parametrize(
    "port, ref",
    [
        (tprobes.run_host_probe, jprobes.run_host_probe),
        (tfused.run_fused_battery, jfused.run_fused_battery),
        (tagent.HealthAgent, jagent.HealthAgent),
        (tslice.LocalDeviceProber, jslice.LocalDeviceProber),
        (tprobes.ici_allreduce_probe, jprobes.ici_allreduce_probe),
    ],
    ids=["run_host_probe", "run_fused_battery", "HealthAgent",
         "LocalDeviceProber", "ici_allreduce_probe"],
)
def test_allreduce_size_knob_matches_jax(port, ref):
    name = ("per_device_elems" if port is tprobes.ici_allreduce_probe
            else "allreduce_elems")
    got = inspect.signature(port).parameters[name].default
    assert got == inspect.signature(ref).parameters[name].default == 1 << 20


def test_allreduce_elems_reaches_the_battery_and_its_key(monkeypatch):
    k1 = tfused.battery_key([CPU] * 2, 64, 1, 8, False)
    k2 = tfused.battery_key([CPU] * 2, 64, 1, 16, False)
    assert k1 != k2 and (k1.allreduce_elems, k2.allreduce_elems) == (8, 16)
    for elems in (8, 16, 8):
        checks = tfused.run_fused_battery(
            [CPU] * 2, matmul_n=64, hbm_mib=1, allreduce_elems=elems
        )
        assert all(c.ok for c in checks)
    stats = tfused.battery_stats()
    assert (stats["compile_cache_misses"], stats["compile_cache_hits"]) == (
        2, 1
    )
    # The agent and the local prober hand the knob to the battery.
    seen = []
    real = tprobes.run_host_probe

    def spy(*args, **kw):
        seen.append(kw["allreduce_elems"])
        return real(*args, **kw)

    monkeypatch.setattr(tagent, "run_host_probe", spy)
    monkeypatch.setattr(tslice, "run_host_probe", spy)
    tagent.HealthAgent(
        object(), "node", devices=[CPU] * 2, matmul_n=64, hbm_mib=1,
        allreduce_elems=24,
    ).probe_once()
    tslice.LocalDeviceProber(
        [CPU] * 2, matmul_n=64, hbm_mib=1, allreduce_elems=40
    ).probe(type("G", (), {"nodes": [], "id": "g"})())
    assert seen == [24, 40]


# --- K4's plain version and the algorithms around it -----------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_peer_reduce_plain_is_index_order_and_ieee(k, off):
    host = _host(k, seed=k, elems=1000 + off)
    host[0, off + 5] = np.nan
    dst = torch.empty(997)
    got = collectives.peer_reduce(dst, _members(host), off=off, divisor=3.0)
    assert got is dst
    acc = host[0, off:off + 997].copy()
    for i in range(1, k):
        acc = acc + host[i, off:off + 997]
    want = acc / np.float32(3.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.isnan(got[5].item())


def test_peer_reduce_checks_its_inputs():
    src = torch.zeros(16)
    with pytest.raises(ValueError, match="1 to 8 sources"):
        collectives.peer_reduce(torch.empty(4), [src] * 9)
    with pytest.raises(ValueError, match="1 to 8 sources"):
        collectives.peer_reduce(torch.empty(4), [])
    with pytest.raises(ValueError, match="at least 14"):
        collectives.peer_reduce(torch.empty(4), [src], off=14)
    with pytest.raises(TypeError):
        collectives.peer_reduce(torch.empty(4), [src.double()])
    with pytest.raises(ValueError):
        collectives.peer_reduce(torch.empty(4), [torch.zeros(32)[::2]])
    with pytest.raises(ValueError):
        collectives.all_reduce([torch.zeros(4), torch.zeros(5)])
    with pytest.raises(ValueError):
        collectives.ring_shift([])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 10])
@pytest.mark.parametrize("elems", [1, 3, 8, 1001, 4096])
def test_chunks_tile_the_shard_on_16_byte_starts(n, elems):
    bounds = collectives._chunks(elems, n)
    assert len(bounds) == n and bounds[0][0] == 0 and bounds[-1][1] == elems
    for (a, b), (c, _) in zip(bounds, bounds[1:]):
        assert a <= b == c
    assert all(a % 4 == 0 or a == elems for a, _ in bounds)


@pytest.mark.parametrize("n", [1, 5, 8, 9])
def test_all_reduce_up_to_the_cap_and_ring_beyond_it(n):
    host = _host(n, seed=300 + n, elems=37)
    ring = collectives.ring_shift(_members(host))
    for j in range(n):
        np.testing.assert_array_equal(ring[j].numpy(), host[j - 1])
    if n > collectives.MAX_SOURCES:
        with pytest.raises(ValueError, match="at most 8 members"):
            collectives.all_reduce(_members(host))
        return
    got = collectives.all_reduce(_members(host), divisor=float(n))
    acc = host[0].copy()
    for i in range(1, n):
        acc = acc + host[i]
    for out in got:
        np.testing.assert_array_equal(
            _bits(out.numpy()), _bits(acc / np.float32(n))
        )


def test_collectives_leave_their_inputs_alone():
    host = _host(4, seed=7)
    shards = _members(host)
    collectives.all_reduce(shards, divisor=4.0)
    collectives.ring_shift(shards)
    for row, s in zip(host, shards):
        np.testing.assert_array_equal(s.numpy(), row)
