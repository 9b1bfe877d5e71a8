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
import itertools
import math
import re
from pathlib import Path

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


class _ScriptClock:
    """perf_counter stand-in, as in test_torch_probes: each timed run
    brackets its loop with two calls; this feeds the scripted elapsed
    times, one per run, in order and over again."""

    def __init__(self, elapsed_seq):
        self.elapsed = itertools.cycle(elapsed_seq)
        self.now = 0.0
        self.pending = None

    def __call__(self):
        if self.pending is None:
            self.pending = next(self.elapsed)
            return self.now
        self.now += self.pending
        self.pending = None
        return self.now


def _one_clock(monkeypatch):
    """Drive both packages' sustained estimators from one scripted,
    monotonic clock.  Each reads its own wall clock otherwise, and under
    load one side's runs can come out non-monotonic ("unstable timing")
    while the other's do not.  Here the pilot takes 1 s and the warm run
    4 s, then every k1-long run 1 s and every 4·k1-long run 4 s: each
    probe makes an even number of runs, so both sides see the same
    valid slopes and the same schedule."""
    clock = _ScriptClock([1.0, 4.0])
    monkeypatch.setattr(jprobes, "_perf_counter", clock)
    monkeypatch.setattr(tprobes, "_perf_counter", clock)


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
@pytest.mark.parametrize("into", ["new", "given", "in_place"])
def test_persistent_all_reduce_matches_psum_bit_for_bit(cpu_devices, n,
                                                         into):
    """Each call of ``all_reduce_init``'s function is a round of the
    shards' current values into the same outputs, in place included."""
    host = _host(n, seed=300 + n)
    host[0, 5] = np.nan
    shards = _members(host)
    out = {"new": None, "given": [torch.empty_like(s) for s in shards],
           "in_place": shards}[into]
    start = collectives.all_reduce_init(shards, divisor=float(n), out=out)
    if into == "in_place":
        shards = [s.clone() for s in shards]  # the round overwrites them
    want = _jax_collective(
        cpu_devices[:n], lambda x: jax.lax.psum(x, "ici"), host
    ) / np.float32(n)
    got = start()
    if out is not None:
        assert got == out
    for j in range(n):
        np.testing.assert_array_equal(_bits(got[j].numpy()), _bits(want[j]))
    if into != "in_place":
        for s in shards:  # new values reach the next round
            s.mul_(2.0)
        again = start()
        assert again is got
        for j in range(n):
            np.testing.assert_array_equal(_bits(again[j].numpy()),
                                          _bits(want[j] * np.float32(2)))


def test_persistent_all_reduce_checks_its_outputs():
    shards = [torch.zeros(4) for _ in range(3)]
    with pytest.raises(ValueError, match="3 members, 2 outputs"):
        collectives.all_reduce_init(shards, out=[torch.zeros(4)] * 2)
    with pytest.raises(ValueError, match="shape and device"):
        collectives.all_reduce_init(shards, out=[torch.zeros(5)] * 3)
    with pytest.raises(TypeError, match="want torch.float32"):
        collectives.all_reduce_init(
            shards, out=[torch.zeros(4, dtype=torch.int32)] * 3
        )
    with pytest.raises(ValueError, match="at most 8 members"):
        collectives.all_reduce_init([torch.zeros(4)] * 9)


@pytest.mark.parametrize("n, shape", [
    # The ramp (ragged against every n), the main path's one element a
    # member (the fused battery's and ici_ring_probe's ring), and 2-D.
    *(pytest.param(n, (ELEMS,), id=str(n)) for n in MEMBERS),
    *(pytest.param(n, (1,), id=f"{n}-one") for n in MEMBERS),
    *(pytest.param(n, (3, 67), id=f"{n}-3x67") for n in MEMBERS),
])
def test_ring_shift_matches_ppermute(cpu_devices, n, shape):
    host = _host(n, seed=100 + n, elems=math.prod(shape)).reshape(n, *shape)
    perm = [(i, (i + 1) % n) for i in range(n)]
    want = _jax_collective(
        cpu_devices[:n], lambda x: jax.lax.ppermute(x, "ici", perm), host
    )
    got = collectives.ring_shift(_members(host))
    for j in range(n):
        assert got[j].shape == shape
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
def test_run_host_probe_parity(cpu_devices, monkeypatch, n, fused):
    if not fused:
        _one_clock(monkeypatch)
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


def _persistent(fake):
    """``all_reduce_init`` whose rounds are ``fake``'s."""
    return lambda shards, divisor=1.0, out=None: (
        lambda: fake(list(shards), divisor)
    )


@pytest.mark.parametrize(
    "path", ["ring_probe", "fused_ring", "unfused_psum"]
)
@pytest.mark.parametrize("n", MEMBERS)
def test_dropped_traffic_fails_with_jax_details(cpu_devices, monkeypatch, n,
                                                path):
    if path == "unfused_psum":
        _one_clock(monkeypatch)
        monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name: x)
        monkeypatch.setattr(collectives, "all_reduce", _dropped_sum)
        monkeypatch.setattr(collectives, "all_reduce_init",
                            _persistent(_dropped_sum))
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
    if not fused:
        _one_clock(monkeypatch)
    monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name: x * 0)
    monkeypatch.setattr(collectives, "all_reduce", _zero_sum)
    monkeypatch.setattr(collectives, "all_reduce_init", _persistent(_zero_sum))
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


class _SeenOnCuda(torch.Tensor):
    """A CPU tensor whose device reads as ``cuda:0`` (``get_device``,
    ``device``, ``is_cpu``): a CPU/CUDA mix without a card."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.get_device:
            return 0
        if getattr(func, "__name__", None) == "__get__":
            attr = getattr(getattr(func, "__self__", None), "__name__", None)
            if attr == "device":
                return torch.device("cuda", 0)
            if attr == "is_cpu":
                return False
        return super().__torch_function__(func, types, args, kwargs or {})


def _on_cuda(t):
    return t.as_subclass(_SeenOnCuda)


# (dst, sources, offset, the error and today's message).
_REDUCE_FAULTS = {
    "dst-not-a-tensor": (lambda: 4.0, lambda: [torch.zeros(16)], 0,
                         TypeError, "peer_reduce: dst: want a tensor, got "
                         "float"),
    "dst-wrong-dtype": (lambda: torch.empty(4, dtype=torch.float64),
                        lambda: [torch.zeros(16)], 0, TypeError,
                        "peer_reduce: dst: want torch.float32, got "
                        "torch.float64"),
    "source-not-a-tensor": (lambda: torch.empty(4),
                            lambda: [torch.zeros(16), 3.0], 0, TypeError,
                            "peer_reduce: source 1: want a tensor, got "
                            "float"),
    "source-wrong-dtype": (lambda: torch.empty(4),
                           lambda: [torch.zeros(16, dtype=torch.float64)], 0,
                           TypeError, "peer_reduce: source 0: want "
                           "torch.float32, got torch.float64"),
    "source-non-contiguous": (lambda: torch.empty(4),
                              lambda: [torch.zeros(16), torch.zeros(32)[::2]],
                              0, ValueError,
                              "peer_reduce: source 1: must be contiguous"),
    "source-empty": (lambda: torch.empty(4), lambda: [torch.zeros(0)], 0,
                     ValueError, "peer_reduce: source 0: is empty"),
    "source-short-at-offset": (lambda: torch.empty(4),
                               lambda: [torch.zeros(18), torch.zeros(16)], 13,
                               ValueError, "peer_reduce: source 1 has 16 "
                               "elements, want at least 13 + 4"),
    "negative-offset": (lambda: torch.empty(4), lambda: [torch.zeros(16)], -1,
                        ValueError, "peer_reduce: negative offset -1"),
    "no-sources": (lambda: torch.empty(4), lambda: [], 0, ValueError,
                   "peer_reduce: want 1 to 8 sources, got 0"),
    "nine-sources": (lambda: torch.empty(4), lambda: [torch.zeros(16)] * 9, 0,
                     ValueError, "peer_reduce: want 1 to 8 sources, got 9"),
    "cuda-source-cpu-dst": (lambda: torch.empty(4),
                            lambda: [torch.zeros(16),
                                     _on_cuda(torch.zeros(16))],
                            0, ValueError, "peer_reduce: source 1 is on "
                            "cuda:0, dst on cpu"),
    "cpu-source-cuda-dst": (lambda: _on_cuda(torch.empty(4)),
                            lambda: [torch.zeros(16)], 0, ValueError,
                            "peer_reduce: source 0 is on cpu, dst on cuda:0"),
}


@pytest.mark.parametrize("fault", sorted(_REDUCE_FAULTS))
def test_peer_reduce_fast_check_and_fault_path_agree(monkeypatch, fault):
    """K4's wrapper checks in a few C-level passes and, when they fail,
    lets ``_check_reduce`` name the fault: the message is the fault
    path's own, and nothing reaches the plain version or the library."""
    make_dst, make_srcs, off, error, message = _REDUCE_FAULTS[fault]
    reached = []
    monkeypatch.setattr(collectives, "peer_reduce_plain",
                        lambda *a: reached.append(a))
    monkeypatch.setattr(collectives, "load_library",
                        lambda: reached.append("library"))
    with pytest.raises(error) as fast:
        collectives.peer_reduce(make_dst(), make_srcs(), off)
    with pytest.raises(error) as slow:
        collectives._check_reduce(make_dst(), make_srcs(), off)
    assert str(fast.value) == str(slow.value) == message
    assert reached == []


@pytest.mark.parametrize("k, off, divisor", [(1, 0, 1.0), (2, 3, 2.0),
                                             (5, 1, 3.0), (8, 12, 8.0)])
def test_peer_reduce_good_call_reaches_the_plain_version(monkeypatch, k, off,
                                                         divisor):
    host = _host(k, seed=40 + k, elems=16 + off)
    srcs = _members(host)
    seen = []
    real = collectives.peer_reduce_plain

    def plain(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(collectives, "peer_reduce_plain", plain)
    dst = torch.empty(16)
    assert collectives.peer_reduce(dst, iter(srcs), off, divisor) is dst
    assert len(seen) == 1 and seen[0][0] is dst and seen[0][2:] == (off,
                                                                   divisor)
    assert [s is t for s, t in zip(seen[0][1], srcs)] == [True] * k
    want = real(torch.empty(16), srcs, off, divisor)
    np.testing.assert_array_equal(_bits(dst.numpy()), _bits(want.numpy()))


def test_plan_kinds_match_the_cuda_source():
    """The plan kinds have one value on both sides of the binding."""
    src = (Path(collectives.__file__).parent / "csrc" /
           "collective_kernels.cu").read_text()
    kinds = dict(re.findall(r"\b(k\w+) = (\d+)",
                            re.search(r"enum Kind \{([^}]*)\}", src)[1]))
    assert kinds == {"kAllReduce": str(collectives.ALL_REDUCE),
                     "kAllGather": str(collectives.ALL_GATHER),
                     "kRingShift": str(collectives.RING_SHIFT)}


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


# --- K5's plain version, all_gather and the list-level autograd functions ------


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_peer_gather_plain_places_each_piece(k, dtype):
    rng = np.random.default_rng(k)
    lens = [int(x) for x in rng.integers(1, 50, k)]
    offsets, at = [], 3
    for n in lens:
        offsets.append(at)
        at += n + int(rng.integers(0, 4))
    pieces = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                               * 100).to(dtype) for n in lens]
    dst = torch.full((at + 2,), 7).to(dtype)
    want = dst.clone()
    got = collectives.peer_gather(dst, pieces, offsets)
    assert got is dst
    for p, off in zip(pieces, offsets):
        want[off:off + p.numel()] = p
    assert torch.equal(dst, want)


def test_peer_gather_checks_its_inputs():
    dst = torch.zeros(16)
    with pytest.raises(ValueError, match="1 to 8 pieces"):
        collectives.peer_gather(dst, [], [])
    with pytest.raises(ValueError, match="1 to 8 pieces"):
        collectives.peer_gather(dst, [torch.zeros(1)] * 9, list(range(9)))
    with pytest.raises(ValueError, match="overlap"):
        collectives.peer_gather(dst, [torch.zeros(4)] * 2, [0, 3])
    with pytest.raises(ValueError, match="overruns"):
        collectives.peer_gather(dst, [torch.zeros(4)], [13])
    with pytest.raises(TypeError):
        collectives.peer_gather(dst, [torch.zeros(4, dtype=torch.int32)], [0])
    with pytest.raises(ValueError, match="offsets"):
        collectives.peer_gather(dst, [torch.zeros(4)], [0, 4])


@pytest.mark.parametrize("offsets, fault", [
    ([8, 0, 4], None),  # out of order, disjoint
    ([0, 8, 4], None),
    ([8, 0, 2], "overlap"),  # out of order, overlapping
    ([4, 1, 9], "overlap"),
    ([12, 0, 4], "overruns"),
    ([8, -1, 4], "overruns"),
])
def test_peer_gather_checks_pieces_in_any_order(offsets, fault):
    """The checks hold for pieces in any order of their offsets: the
    quick pass over pieces in order, and the sort otherwise, agree with
    the fault each names."""
    pieces = [torch.full((4,), float(i + 1)) for i in range(3)]
    dst = torch.zeros(15)
    if fault:
        with pytest.raises(ValueError, match=fault):
            collectives.peer_gather(dst, pieces, offsets)
        return
    collectives.peer_gather(dst, pieces, offsets)
    for i, off in enumerate(offsets):
        assert dst[off:off + 4].tolist() == [float(i + 1)] * 4


@pytest.mark.parametrize("k,rows,width,gap", [(1, 3, 4, 0), (2, 5, 3, 1),
                                                (4, 8, 16, 0), (3, 2, 7, 5)])
def test_peer_gather_plain_interleaves_rows(k, rows, width, gap):
    """With rows > 1 each piece's rows land ``pitch`` elements apart,
    the rest of ``dst`` untouched."""
    rng = np.random.default_rng(rows * 10 + k)
    pitch = k * width + gap
    pieces = [torch.from_numpy(rng.standard_normal((rows, width))
                               .astype(np.float32)) for _ in range(k)]
    offsets = [i * width + gap for i in range(k)]
    dst = torch.full((rows * pitch,), 7.0)
    want = dst.clone().view(rows, pitch)
    for p, off in zip(pieces, offsets):
        want[:, off:off + width] = p
    collectives.peer_gather(dst, pieces, offsets, rows, pitch)
    assert torch.equal(dst, want.view(-1))


def test_peer_gather_checks_its_rows():
    dst = torch.zeros(4, 10)
    piece = torch.zeros(4, 3)
    collectives.peer_gather(dst, [piece, piece], [0, 5], 4, 10)
    with pytest.raises(ValueError, match="not 4 rows"):
        collectives.peer_gather(dst, [torch.zeros(10)], [0], 4, 10)
    with pytest.raises(ValueError, match="overrun the pitch"):
        collectives.peer_gather(dst, [piece], [8], 4, 10)
    with pytest.raises(ValueError, match="overlap"):
        collectives.peer_gather(dst, [piece, piece], [0, 2], 4, 10)
    with pytest.raises(ValueError, match="overruns dst"):
        collectives.peer_gather(dst, [piece], [0], 4, 13)
    with pytest.raises(ValueError, match="at least one row"):
        collectives.peer_gather(dst, [piece], [0], 0, 10)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dim", [0, 1, 2, -1])
def test_all_gather_of_three_dimensions_is_concatenation(n, dim):
    rng = np.random.default_rng(n + 7)
    host = rng.standard_normal((n, 2, 3, 5)).astype(np.float32)
    got = collectives.all_gather(_members(host), dim=dim)
    want = np.concatenate(list(host), axis=dim)
    for out in got:
        assert out.shape == want.shape and out.is_contiguous()
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))


@pytest.mark.parametrize("n", MEMBERS)
@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather_matches_jax_all_gather(cpu_devices, n, axis):
    host = _host(n, seed=200 + n, elems=3 * 7).reshape(n, 3, 7)
    want = _jax_collective(
        cpu_devices[:n],
        lambda x: jax.lax.all_gather(x, "ici", axis=axis + 1, tiled=True),
        host,
    )
    got = collectives.all_gather(_members(host), dim=axis)
    assert len(got) == n
    for j in range(n):
        assert got[j].shape == want[j].shape
        np.testing.assert_array_equal(_bits(got[j].numpy()), _bits(want[j]))


def test_all_gather_checks_its_members():
    with pytest.raises(ValueError, match="has shape"):
        collectives.all_gather([torch.zeros(2, 3), torch.zeros(3, 2)])
    with pytest.raises(TypeError, match="want a tensor"):
        collectives.all_gather([3, torch.zeros(2)])
    with pytest.raises(ValueError, match="at most 8 members"):
        collectives.all_gather([torch.zeros(2)] * 9)
    with pytest.raises(ValueError, match="no members"):
        collectives.all_gather([])
    out = collectives.all_gather([torch.ones(2, dtype=torch.int64)] * 3)
    assert out[0].dtype == torch.int64 and out[0].tolist() == [1] * 6


def _dense_and_members(n: int, seed: int):
    """A replicated input x [5, 6] and a weight split by columns across n
    members: the dense reference and the members' tensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    w = rng.standard_normal((6, 3 * n)).astype(np.float32)
    v = rng.standard_normal((3 * n, 4)).astype(np.float32)
    return x, w, v


@pytest.mark.parametrize("n", [2, 4])
def test_gather_and_copy_give_the_dense_gradients(n):
    """Column-parallel product, its output gathered, every member's copy
    of the loss summed: each member's gradients are those of one dense
    loss (Megatron's pairing)."""
    x, w, _ = _dense_and_members(n, n)
    xd = torch.tensor(x, requires_grad=True)
    wd = torch.tensor(w, requires_grad=True)
    ((xd @ wd) ** 2).sum().backward()
    xs = [torch.tensor(x, requires_grad=True) for _ in range(n)]
    ws = [torch.tensor(w[:, 3 * j:3 * j + 3], requires_grad=True)
          for j in range(n)]
    ys = collectives.gather_from_members(
        [a @ b for a, b in zip(collectives.copy_to_members(xs), ws)], -1
    )
    torch.autograd.backward([(y ** 2).sum() for y in ys])
    for y in ys:
        torch.testing.assert_close(y, (xd @ wd).detach())
    for j in range(n):
        torch.testing.assert_close(ws[j].grad, wd.grad[:, 3 * j:3 * j + 3])
        torch.testing.assert_close(xs[j].grad, xd.grad)


@pytest.mark.parametrize("n", [2, 4])
def test_row_parallel_reduce_gives_the_dense_gradients(n):
    """Column- then row-parallel product (an MLP split across n members),
    the partial outputs all-reduced: the members' gradients are the dense
    ones and every member's output is the dense output."""
    x, w, v = _dense_and_members(n, 10 + n)
    xd = torch.tensor(x, requires_grad=True)
    wd, vd = (torch.tensor(a, requires_grad=True) for a in (w, v))
    (torch.tanh(xd @ wd) @ vd).pow(2).sum().backward()
    xs = [torch.tensor(x, requires_grad=True) for _ in range(n)]
    ws = [torch.tensor(w[:, 3 * j:3 * j + 3], requires_grad=True)
          for j in range(n)]
    vs = [torch.tensor(v[3 * j:3 * j + 3], requires_grad=True)
          for j in range(n)]
    parts = [torch.tanh(a @ b) @ c
             for a, b, c in zip(collectives.copy_to_members(xs), ws, vs)]
    outs = collectives.reduce_from_members(parts)
    torch.autograd.backward([o.pow(2).sum() for o in outs])
    for o in outs:
        torch.testing.assert_close(o, torch.tanh(xd @ wd).detach() @ vd.detach())
    for j in range(n):
        torch.testing.assert_close(ws[j].grad, wd.grad[:, 3 * j:3 * j + 3])
        torch.testing.assert_close(vs[j].grad, vd.grad[3 * j:3 * j + 3])
        torch.testing.assert_close(xs[j].grad, xd.grad)


@pytest.mark.parametrize(
    "fn", ["copy_to_members", "reduce_from_members", "gather_from_members"]
)
def test_one_member_functions_are_the_identity(fn):
    x = torch.randn(3, 4, requires_grad=True)
    (y,) = getattr(collectives, fn)([x])
    assert y is x


@pytest.mark.parametrize("devices", [(0,) * 8, (0, 1, 0, 1), (3, 2, 1, 0),
                                     (0, 0, 1)])
def test_round_outputs_are_fresh_with_one_allocation_a_device(devices):
    """The CUDA rounds' outputs (made here from CPU shards, which only
    lend their dtype and device): new tensors, one allocation for the
    members that share a device."""
    shards = [torch.zeros(3, 5, dtype=torch.bfloat16) for _ in devices]
    outs, ptrs = collectives._outputs(shards, devices, (3, 5), 3 * 5 * 2)
    assert len(outs) == len(devices)
    assert ptrs == [o.data_ptr() for o in outs]
    bases = {}
    for out, d in zip(outs, devices):
        assert out.shape == (3, 5) and out.dtype == torch.bfloat16
        assert out.is_contiguous()
        bases.setdefault(d, set()).add(out.untyped_storage().data_ptr())
    assert all(len(b) == 1 for b in bases.values())
    assert len({p for b in bases.values() for p in b}) == len(bases)
    ptrs = [o.data_ptr() for o in outs]
    assert len(set(ptrs)) == len(ptrs)
    assert not any(o.data_ptr() == s.data_ptr()
                   for o in outs for s in shards)
