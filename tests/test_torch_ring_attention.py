"""The port's ring attention against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``k8s_operator_libs_tpu.workloads.ring_attention`` on JAX's 8 virtual CPU
devices and through ``k8s_operator_libs_tpu_torch.workloads.
ring_attention`` over ``[torch.device("cpu")] * n``, where the block
kernel K3 runs its plain version.

Tolerances:

- block step, plain K3 against JAX ``_block_attention``: 1e-5 absolute on
  num, m and l.  Both round q, k, p and v to bf16 at the same points and
  sum in fp32; only the order of the fp32 sums differs.
- fused ring step, ``block_attention_merge_plain`` against JAX
  ``_block_attention`` followed by ``_merge``: the same 1e-5 absolute on
  the accumulator's num, m and l.  The merge scales both sides by
  factors of at most 1 and adds them in the same order, so it keeps the
  block step's differences (and an ulp of ``exp``).
- ring against the JAX ring: 1e-5 absolute.  The two rings visit the same
  blocks with the same per-block maxima, so only fp32 summation order
  separates them (at most 3e-7 at these shapes on the CPU).
- ring against full attention: the JAX contract, 5e-2 absolute
  (``ring_attention.py:243``); the ring rounds p to bf16 against each
  block's own max, full attention against the row's global max, and the
  two reach at most 1.8e-3 here, so the test also holds them to 1e-2.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from k8s_operator_libs_tpu.health import probes as jprobes  # noqa: E402
from k8s_operator_libs_tpu.workloads import ring_attention as jra  # noqa: E402
from k8s_operator_libs_tpu_torch import layers  # noqa: E402
from k8s_operator_libs_tpu_torch.health import probes as tprobes  # noqa: E402
from k8s_operator_libs_tpu_torch.kernels import (  # noqa: E402
    block_attention,
    block_attention_merge_,
    block_attention_merge_plain,
    block_attention_plain,
    launch_counts,
)
from k8s_operator_libs_tpu_torch.workloads import (  # noqa: E402
    ring_attention as tra,
)
from k8s_operator_libs_tpu_torch.workloads.ring_attention import (  # noqa: E402
    ElasticRingSoak,
    full_attention_reference,
    make_ring_attention,
    ring_attention_soak,
)

CPU = torch.device("cpu")
BLOCK_ATOL = 1e-5
RING_VS_JAX_ATOL = 1e-5
CONTRACT_ATOL = 5e-2
REACHED_ATOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; torch's default of one
    # intra-op thread per core oversubscribes the host.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, batch, seq, heads, dim, kv_seq=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, seq, heads, dim)).astype(np.float32)
    kv_shape = (batch, kv_seq or seq, heads, dim)
    k, v = (rng.standard_normal(kv_shape).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _jax_ring(devices, causal, q, k, v):
    mesh = Mesh(np.asarray(devices), ("sp",))
    fn, shard = jra.make_ring_attention(mesh, "sp", causal=causal)
    return np.asarray(fn(*(shard(jnp.asarray(a)) for a in (q, k, v))))


def _torch_ring(n, causal, q, k, v):
    fn, shard = make_ring_attention([CPU] * n, causal=causal)
    out = fn(*(shard(t) for t in _torch(q, k, v)))
    return torch.cat(out, dim=1).numpy()


# --- the block step -------------------------------------------------------


@pytest.mark.parametrize(
    "q_offset, k_offset, causal",
    [
        (0, 0, True),  # on the diagonal
        (48, 0, True),  # wholly visible
        (0, 48, True),  # wholly masked: m 0, l 0, num 0
        (10, 3, True),  # ragged diagonal
        (0, 0, False),
    ],
)
def test_block_plain_matches_jax_block(q_offset, k_offset, causal):
    q, k, v = _qkv(0, 2, 40, 3, 16, kv_seq=24)
    sq, sk = q.shape[1], k.shape[1]
    if causal:
        mask = (q_offset + np.arange(sq))[:, None] >= (
            k_offset + np.arange(sk)
        )[None, :]
    else:
        mask = np.ones((sq, sk), bool)
    want = jra._block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)
    )
    got = block_attention_plain(*_torch(q, k, v), q_offset, k_offset, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_ATOL,
                                   rtol=0)
    if not mask.any():
        num, m, l = got
        assert not num.any() and not m.any() and not l.any()


def test_block_wrapper_takes_plain_version_on_cpu():
    q, k, v = _torch(*_qkv(1, 1, 16, 2, 8))
    before = launch_counts()
    for g, w in zip(block_attention(q, k, v, 0, 0, True),
                    block_attention_plain(q, k, v, 0, 0, True)):
        assert torch.equal(g, w)
    assert launch_counts() == before  # no kernel launch on the CPU


@pytest.mark.parametrize(
    "bad, exc",
    [
        (lambda q, k, v: (q.double(), k, v), TypeError),
        (lambda q, k, v: (q, k.bfloat16(), v), TypeError),
        (lambda q, k, v: (q.transpose(1, 2), k, v), ValueError),
        (lambda q, k, v: (q, k, v[:, :-1]), ValueError),
        (lambda q, k, v: (q[..., :4].contiguous(), k[..., :4].contiguous(),
                          v[..., :4].contiguous()), ValueError),
        (lambda q, k, v: (q[:, :0], k, v), ValueError),
        (lambda q, k, v: (q[0], k[0], v[0]), ValueError),
    ],
    ids=["f64", "bf16", "strided", "kv-shape", "head-dim-4", "empty",
         "3-d"],
)
def test_block_wrapper_rejects_bad_inputs(bad, exc):
    q, k, v = _torch(*_qkv(2, 1, 16, 2, 8))
    with pytest.raises(exc):
        block_attention(*bad(q, k, v))


# --- the fused ring step ---------------------------------------------------


def _accumulator(seed, batch, seq, heads, dim, first_step):
    """The ring's first-step accumulator (num 0, m NEG_INF, l 0) or a
    random running one (l > 0, m about a row max)."""
    shape = (batch, seq, heads)
    if first_step:
        return (np.zeros(shape + (dim,), np.float32),
                np.full(shape, jra.NEG_INF, np.float32),
                np.zeros(shape, np.float32))
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (dim,)).astype(np.float32),
            (rng.standard_normal(shape) + 1.0).astype(np.float32),
            rng.uniform(0.5, 20.0, shape).astype(np.float32))


@pytest.mark.parametrize("first_step", [True, False],
                         ids=["first-step", "running"])
@pytest.mark.parametrize("dim", [16, 32, 64])
@pytest.mark.parametrize(
    "q_offset, k_offset, causal",
    [
        (48, 0, True),  # before the diagonal: wholly visible
        (10, 10, True),  # on the diagonal
        (10, 30, True),  # after it: a ragged diagonal
        (0, 48, True),  # wholly masked
        (0, 0, False),
    ],
    ids=["before", "on", "after", "masked", "non-causal"],
)
def test_block_merge_plain_matches_jax_block_then_merge(
    q_offset, k_offset, causal, dim, first_step
):
    q, k, v = _qkv(3, 2, 40, 3, dim, kv_seq=24)
    acc = _accumulator(4, 2, 40, 3, dim, first_step)
    sq, sk = q.shape[1], k.shape[1]
    if causal:
        mask = (q_offset + np.arange(sq))[:, None] >= (
            k_offset + np.arange(sk)
        )[None, :]
    else:
        mask = np.ones((sq, sk), bool)
    block = jra._block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)
    )
    want = jra._merge(*(jnp.asarray(a) for a in acc), *block)
    tacc = _torch(*acc)
    got = block_attention_merge_plain(*tacc, *_torch(q, k, v), q_offset,
                                      k_offset, causal)
    for g, t in zip(got, tacc):
        assert g is t  # updated in place
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_ATOL,
                                   rtol=0)
    if first_step and not mask.any():
        num, m, l = got
        assert not num.any() and not m.any() and not l.any()


def test_merge_wrapper_takes_plain_version_on_cpu():
    q, k, v = _torch(*_qkv(5, 1, 16, 2, 8))
    acc = _torch(*_accumulator(6, 1, 16, 2, 8, False))
    want = [t.clone() for t in acc]
    before = launch_counts()
    block_attention_merge_plain(*want, q, k, v, 4, 2, True)
    got = block_attention_merge_(*acc, q, k, v, 4, 2, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts() == before  # no kernel launch on the CPU


@pytest.mark.parametrize(
    "bad, exc",
    [
        (lambda a, q, k, v: (a, (q.double(), k, v)), TypeError),
        (lambda a, q, k, v: (a, (q, k.bfloat16(), v)), TypeError),
        (lambda a, q, k, v: (a, (q.transpose(1, 2), k, v)), ValueError),
        (lambda a, q, k, v: (a, (q, k, v[:, :-1])), ValueError),
        (lambda a, q, k, v: (a, (q[0], k[0], v[0])), ValueError),
        (lambda a, q, k, v: ((a[0].double(), a[1], a[2]), (q, k, v)),
         TypeError),
        (lambda a, q, k, v: ((a[0], a[1][:, :-1].contiguous(), a[2]),
                             (q, k, v)), ValueError),
        (lambda a, q, k, v: ((a[0], a[1],
                             a[2].transpose(1, 2).contiguous()
                             .transpose(1, 2)), (q, k, v)), ValueError),
        (lambda a, q, k, v: ((a[0], a[1], a[2][:, :, None]), (q, k, v)),
         ValueError),
        (lambda a, q, k, v: ((a[0], None, a[2]), (q, k, v)), TypeError),
    ],
    ids=["f64", "bf16", "strided", "kv-shape", "3-d", "acc-f64",
         "acc-m-shape", "acc-l-strided", "acc-l-4-d", "acc-none"],
)
def test_merge_wrapper_rejects_bad_inputs(bad, exc):
    q, k, v = _torch(*_qkv(7, 1, 16, 2, 8))
    acc = _torch(*_accumulator(8, 1, 16, 2, 8, False))
    accs, qkv = bad(acc, q, k, v)
    with pytest.raises(exc):
        block_attention_merge_(*accs, *qkv)


# --- the ring ---------------------------------------------------------------


@pytest.mark.parametrize(
    "n, causal, seed, shape",
    [
        (8, True, 0, (2, 8 * 16, 2, 16)),
        (8, False, 1, (1, 8 * 8, 2, 8)),
        (4, True, 2, (1, 4 * 16, 2, 16)),
        (4, False, 3, (2, 4 * 16, 2, 16)),
    ],
)
def test_ring_matches_jax_ring_and_full_attention(
    cpu_devices, n, causal, seed, shape
):
    q, k, v = _qkv(seed, *shape)
    got = _torch_ring(n, causal, q, k, v)
    want = _jax_ring(cpu_devices[:n], causal, q, k, v)
    np.testing.assert_allclose(got, want, atol=RING_VS_JAX_ATOL, rtol=0)
    ref = np.asarray(jra.full_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal
    ))
    np.testing.assert_allclose(got, ref, atol=CONTRACT_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=REACHED_ATOL, rtol=0)
    # The port's own reference is the JAX one up to fp32 summation order.
    tref = full_attention_reference(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(tref.numpy(), ref, atol=BLOCK_ATOL, rtol=0)


def test_causality_no_leakage():
    """Changing a future key/value must not change earlier outputs:
    block-level causal masking across ring ranks is exact."""
    q, k, v = _qkv(2, 1, 4 * 8, 2, 8)
    out1 = _torch_ring(4, True, q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, -1] = 100.0
    v2[:, -1] = -100.0
    out2 = _torch_ring(4, True, q, k2, v2)
    np.testing.assert_array_equal(out1[:, :-1], out2[:, :-1])
    assert not np.array_equal(out1[:, -1], out2[:, -1])


def test_shard_cuts_along_the_sequence():
    fn, shard = make_ring_attention([CPU] * 4)
    x = torch.arange(2 * 8 * 3 * 8, dtype=torch.float32).reshape(2, 8, 3, 8)
    parts = shard(x)
    assert len(parts) == 4
    assert all(p.is_contiguous() and p.shape == (2, 2, 3, 8) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), x)
    with pytest.raises(ValueError):
        shard(x[:, :7])


def test_soak_keys_and_link_traffic(cpu_devices):
    kw = dict(seq_per_device=16, batch=1, heads=2, head_dim=8)
    got = ring_attention_soak([CPU] * 8, **kw)
    want = jra.ring_attention_soak(cpu_devices, **kw)
    assert set(got) == set(want)
    assert got["ok"], got
    assert got["max_err"] < REACHED_ATOL
    for key in ("devices", "global_seq", "moved_bytes"):
        assert got[key] == want[key]
    assert got["global_seq"] == 16 * 8
    assert got["moved_bytes"] == 2 * 7 * (16 * 2 * 8 * 4)
    assert got["link_gbps"] > 0 and got["latency_ms"] > 0


def test_soak_single_device_is_vacuous(cpu_devices):
    assert ring_attention_soak([CPU]) == jra.ring_attention_soak(
        cpu_devices[:1]
    )


# --- the soak's inputs, drawn once a shape ---------------------------------

SOAK_KW = dict(seq_per_device=16, batch=1, heads=2, head_dim=8)


def _ring_inputs(monkeypatch) -> list:
    """Spy on the ring: each call's q, k and v, whole along S, as numpy."""
    seen = []
    real = tra.ring_attention

    def spy(q, k, v, *a, **kw):
        seen.append([torch.cat(x, dim=1).numpy().copy() for x in (q, k, v)])
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tra, "ring_attention", spy)
    return seen


def _counted(fn):
    """``fn()``'s result and the layer counters it gave."""
    layers.take_layers()
    layers.record_layers(True)
    try:
        out = fn()
    finally:
        layers.record_layers(False)
    return out, layers.take_layers()[1]


@pytest.mark.parametrize("call", [1, 3])
def test_soak_inputs_are_the_probes_draw(monkeypatch, call):
    """The soak's q, k and v are a fresh seed-0 numpy draw of its shape,
    whether the soak draws them or finds them kept."""
    tra._soak_inputs.cache_clear()
    seen = _ring_inputs(monkeypatch)
    for _ in range(call):
        ring_attention_soak([CPU] * 8, **SOAK_KW)
    want = _qkv(0, 1, 16 * 8, 2, 8)
    # Two ring calls a soak: the checked one and the timed one.
    assert len(seen) == 2 * call
    for got in seen[-2:]:
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()


def test_soak_draws_once_a_shape():
    tra._soak_inputs.cache_clear()

    def soaks(seq_per_device):
        kw = dict(SOAK_KW, seq_per_device=seq_per_device)
        return [ring_attention_soak([CPU] * 4, **kw) for _ in range(2)]

    res, counters = _counted(lambda: soaks(16))
    assert all(r["ok"] for r in res), res
    assert counters["deep.input_draws"] == 1
    assert counters["deep.ring_steps"] == 2 * 2 * 4 * 4
    _, counters = _counted(lambda: soaks(16))
    assert "deep.input_draws" not in counters
    _, counters = _counted(lambda: soaks(32))
    assert counters["deep.input_draws"] == 1


def test_soak_leaves_its_kept_inputs_unchanged():
    ring_attention_soak([CPU] * 8, **SOAK_KW)
    kept = tra._soak_inputs((1, 16 * 8, 2, 8), False)
    before = kept.numpy().tobytes()
    for _ in range(2):
        ring_attention_soak([CPU] * 8, **SOAK_KW)
    assert tra._soak_inputs((1, 16 * 8, 2, 8), False) is kept
    assert not kept.is_pinned()
    assert kept.numpy().tobytes() == before


@pytest.mark.parametrize("kept", [False, True],
                         ids=["drawn", "kept"])
def test_soak_result_matches_jax_whether_drawn_or_kept(cpu_devices, kept):
    tra._soak_inputs.cache_clear()
    first = ring_attention_soak([CPU] * 8, **SOAK_KW)
    got = ring_attention_soak([CPU] * 8, **SOAK_KW) if kept else first
    want = jra.ring_attention_soak(cpu_devices, **SOAK_KW)
    assert set(got) == set(want)
    assert got["ok"], got
    for key in ("devices", "global_seq", "moved_bytes"):
        assert got[key] == want[key]
    # The same inputs through the same kernels: the same error, exactly.
    assert got["max_err"] == first["max_err"]
    assert abs(got["max_err"] - want["max_err"]) < RING_VS_JAX_ATOL


# --- the deep probe --------------------------------------------------------


def test_deep_probe_last_in_battery(cpu_devices):
    checks = tprobes.run_host_probe(
        [CPU] * 8, matmul_n=64, hbm_mib=1, deep=True, max_iters=64
    )
    names = [c.name for c in checks]
    assert names[-1] == "ici_ring_attention"
    deep = checks[-1]
    assert deep.ok, deep.detail
    want = jprobes.ici_ring_attention_probe(cpu_devices)
    assert want.ok
    assert deep.metrics["devices"] == want.metrics["devices"] == 8.0
    assert deep.metrics["global_seq"] == want.metrics["global_seq"] == 1024.0
    assert deep.detail.startswith("seq 1024 over 8 devices, max err ")
    assert float(deep.detail.rsplit(" ", 1)[1]) < REACHED_ATOL


def test_deep_probe_single_device_vacuous(cpu_devices):
    got = tprobes.ici_ring_attention_probe([CPU])
    want = jprobes.ici_ring_attention_probe(cpu_devices[:1])
    assert (got.name, got.ok, got.detail, got.metrics) == (
        want.name, want.ok, want.detail, want.metrics
    )


def test_deep_probe_fault_fails_the_check(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(tra, "ring_attention_soak", broken)
    res = tprobes.ici_ring_attention_probe([CPU] * 2)
    assert not res.ok
    assert res.detail == "ring attention failed: injected"


# --- elastic ring ---------------------------------------------------------


def test_elastic_ring_resize_numerics():
    """The ring re-forms around an excluded slice and the shrunk ring's
    attention still matches the full reference."""
    soak = ElasticRingSoak(
        [CPU] * 8, n_slices=4, seq_per_device=16, heads=2, head_dim=8
    )
    full = soak.run_round()
    assert full["ok"], full
    assert full["devices"] == 8 and full["global_seq"] == 16 * 8

    soak.exclude_slice(2)
    shrunk = soak.run_round()
    assert shrunk["ok"], shrunk
    assert shrunk["devices"] == 6 and shrunk["global_seq"] == 16 * 6

    soak.exclude_slice(2)  # idempotent replay
    assert soak.excluded == {2}
    soak.rejoin_slice(2)
    regrown = soak.run_round()
    assert regrown["ok"], regrown
    assert regrown["devices"] == 8
    for r in (full, shrunk, regrown):
        assert r["max_err"] < REACHED_ATOL


def test_elastic_ring_draws_fresh_inputs_every_round(monkeypatch):
    """The elastic soak keeps drawing from its own generator; it takes
    nothing from the deep probe's kept inputs."""
    seen = _ring_inputs(monkeypatch)
    soak = ElasticRingSoak(
        [CPU] * 4, n_slices=2, seq_per_device=16, heads=2, head_dim=8,
        seed=5,
    )
    _, counters = _counted(lambda: [soak.run_round() for _ in range(2)])
    assert "deep.input_draws" not in counters
    rng = np.random.default_rng(5)
    for got in seen:
        for g in got:
            w = rng.standard_normal((1, 16 * 4, 2, 8)).astype(np.float32)
            assert g.tobytes() == w.tobytes()
    assert seen[0][0].tobytes() != seen[1][0].tobytes()


def test_elastic_ring_rejects_bad_partitions():
    with pytest.raises(ValueError):
        ElasticRingSoak([CPU] * 8, n_slices=3)  # 8 % 3 != 0
    with pytest.raises(ValueError):
        ElasticRingSoak([CPU] * 8, n_slices=1)
    soak = ElasticRingSoak([CPU] * 8, n_slices=2, seq_per_device=8)
    soak.exclude_slice(0)
    with pytest.raises(ValueError):
        soak.exclude_slice(1)  # would empty the ring
    with pytest.raises(ValueError):
        soak.exclude_slice(5)
    # A slice of one device cannot ring on its own.
    lone = ElasticRingSoak([CPU] * 2, n_slices=2)
    with pytest.raises(ValueError):
        lone.exclude_slice(0)
