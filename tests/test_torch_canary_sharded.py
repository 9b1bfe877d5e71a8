"""The port's sharded canary and elastic runner against the JAX
package's, on the CPU.

The JAX side runs on the ``cpu_devices`` fixture's 8 virtual devices, the
port's over ``[torch.device("cpu")] * n``, where the collectives take the
kernels' plain versions.  Weights cross from JAX ``init_params(PRNGKey(0),
TINY)`` through numpy; batches are the same numpy integers.  Limits are
the canary's (``tests/test_torch_canary.py``): the first loss 1e-4
absolute (the forward pass alone, bf16 operands both sides, fp32 sums in
another order), later losses 1e-3 (Adam moves a parameter by about lr
whatever its gradient's size, so a near-zero gradient of the other sign
moves it by 2·lr), and each leaf's update ``p3 - p0`` after three steps:
at least 80 % of elements within 1e-5, 99 % within 1e-4, all within 6e-3.
Sharding changes the order of the sums (the row-parallel products' partial
sums, the dp mean of the gradients), on both sides alike.

Against the port's own one-device step the later losses are held to
2e-3: sharded and whole steps differ in every sum that crosses members,
and on these sizes the JAX package's own sharded and one-device steps
already differ by about 1e-3 after two updates (batch seeds 0-5), the
port's by up to about 1.7e-3; the first loss and the updates keep the
limits above.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from k8s_operator_libs_tpu.workloads import canary as jc  # noqa: E402
from k8s_operator_libs_tpu_torch.workloads import canary as tc  # noqa: E402

CPU = torch.device("cpu")
SIZES = dict(
    vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq_len=16,
    batch=8,
)
TINY_J = jc.CanaryConfig(**SIZES)
TINY = tc.CanaryConfig(**SIZES)
FIRST_LOSS_ATOL = 1e-4
LOSS_ATOL = 1e-3
# Sharded against whole steps (see the module docstring).
SPLIT_LOSS_ATOL = 2e-3
LR = 1e-3
UPDATE_TIGHT = ((1e-5, 0.80), (1e-4, 0.99))  # (atol, share of elements)
UPDATE_ATOL_3_STEPS = 3 * 2 * LR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; one intra-op thread each.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def host():
    """The JAX package's initial weights as numpy."""
    return jax.tree.map(
        np.asarray, jc.init_params(jax.random.PRNGKey(0), TINY_J)
    )


def _batches(seed: int, n: int, batch: int = TINY.batch) -> list:
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, TINY.vocab, (batch, TINY.seq_len + 1),
                     dtype=np.int32)
        for _ in range(n)
    ]


def _paths(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _paths(tree[key], prefix + (key,))
        else:
            yield prefix + (key,)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _zeros_state(host):
    return tc.AdamState(0, jax.tree.map(np.zeros_like, host),
                        jax.tree.map(np.zeros_like, host))


def _port_run(host, mesh, batches, cfg=TINY):
    """Three sharded steps in the port: (losses, params as numpy)."""
    st = tc.make_sharded_train_step(mesh, cfg)
    p = st.shard_params(host)
    o = st.shard_opt_state(p, _zeros_state(host))
    losses = []
    for b in batches:
        p, o, loss = st.step(p, o, st.shard_batch(b))
        losses.append(float(loss))
    return losses, st.unshard(p), p


def _jax_run(host, mesh, batches):
    step, opt, sp, sb, so = jc.make_sharded_train_step(mesh, TINY_J)
    p = sp(jax.tree.map(jnp.asarray, host))
    o = so(p, opt.init(jax.tree.map(jnp.asarray, host)))
    losses = []
    for b in batches:
        p, o, loss = step(p, o, sb(jnp.asarray(b)))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


def _hold_updates(host, got, want):
    for path in _paths(host):
        p0 = _at(host, path)
        w = _at(want, path) - p0
        diff = np.abs((_at(got, path) - p0) - w)
        assert np.median(np.abs(w)) > LR, path  # the updates are real
        for atol, share in UPDATE_TIGHT:
            assert (diff <= atol).mean() >= share, (path, atol)
        assert diff.max() <= UPDATE_ATOL_3_STEPS, path


def _hold_losses(got, want, atol=LOSS_ATOL):
    assert abs(got[0] - want[0]) <= FIRST_LOSS_ATOL, (got, want)
    for g, w in zip(got[1:], want[1:]):
        assert abs(g - w) <= atol, (got, want)


# --- the mesh and the specs ------------------------------------------------


@pytest.mark.parametrize("n, tp", [(8, 0), (8, 2), (8, 8), (4, 0), (6, 0),
                                   (2, 0), (1, 0)])
def test_make_mesh_matches_jax(cpu_devices, n, tp):
    want = jc.make_mesh(cpu_devices[:n], tp=tp)
    got = tc.make_mesh([CPU] * n, tp=tp)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert len(got.flat) == n and all(d == CPU for d in got.flat)


def test_make_mesh_rejects_what_jax_rejects(cpu_devices):
    with pytest.raises(ValueError):
        jc.make_mesh(cpu_devices[:6], tp=4)
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        tc.make_mesh([CPU] * 6, tp=4)


def test_mesh_keeps_member_order():
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = tc.make_mesh(devs)
    assert mesh.devices[1][2] == devs[6] and mesh.flat == devs


@pytest.mark.parametrize("make", ["make_mesh", "ElasticCanaryRunner",
                                  "CanaryRunner"])
def test_entry_points_default_to_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if make == "make_mesh":
            tc.make_mesh()
        elif make == "CanaryRunner":
            tc.CanaryRunner(TINY, mesh=None)
        else:
            tc.ElasticCanaryRunner(TINY, precompile=False)


def test_param_specs_have_jax_keys_and_split_axes():
    want = jc.param_specs(TINY_J)
    got = tc.param_specs(TINY)
    paths = list(_paths(got))
    assert paths == list(_paths(
        jax.tree.map(lambda s: 0, want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    ))
    assert len(paths) == 9
    for path in paths:
        assert tuple(_at(got, path)) == tuple(_at(want, path)), path


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_and_unshard_round_trip_exactly(host, tp):
    st = tc.make_sharded_train_step(tc.make_mesh([CPU] * 8, tp=tp), TINY)
    placed = st.shard_params(host)
    assert len(placed) == 8
    back = st.unshard(placed)
    for path in _paths(host):
        np.testing.assert_array_equal(_at(back, path), _at(host, path))
    # Member (i, j) holds heads [j·H/tp, (j+1)·H/tp) of q, of k and of v.
    w = TINY.d_model // tp
    qkv = host["layers"]["qkv"].reshape(2, 64, 3, 64)
    for m, tree in enumerate(placed):
        j = m % tp
        want = qkv[..., j * w:(j + 1) * w].reshape(2, 64, 3 * w)
        np.testing.assert_array_equal(tree["layers"]["qkv"].numpy(), want)
        assert tree["embed"].shape == (64, w) and tree["out"].shape == (64, w)
        assert tree["layers"]["mlp_out"].shape == (2, 128 // tp, 64)
    state = st.shard_opt_state(placed, _zeros_state(host))
    assert st.unshard(state).count == 0


@pytest.mark.parametrize(
    "field, value",
    [("n_heads", 6), ("d_ff", 130), ("vocab", 66), ("batch", 7)],
)
def test_sharded_step_rejects_sizes_that_do_not_divide(field, value):
    sizes = dict(SIZES, **{field: value})
    if field == "n_heads":
        sizes["d_model"] = 60
    with pytest.raises(ValueError, match=field):
        tc.make_sharded_train_step(tc.make_mesh([CPU] * 8), tc.CanaryConfig(
            **sizes))


# --- the sharded step ---------------------------------------------------------


@pytest.mark.parametrize("tp", [4, 2])
def test_sharded_step_matches_jax(cpu_devices, host, tp):
    batches = _batches(2, 3)
    want_losses, want = _jax_run(host, jc.make_mesh(cpu_devices, tp=tp),
                                 batches)
    got_losses, got, _ = _port_run(host, tc.make_mesh([CPU] * 8, tp=tp),
                                   batches)
    _hold_losses(got_losses, want_losses)
    _hold_updates(host, got, want)


@pytest.mark.parametrize("tp", [4, 2, 1])
def test_sharded_step_matches_the_one_device_step(host, tp):
    batches = _batches(3, 3)
    got_losses, got, _ = _port_run(host, tc.make_mesh([CPU] * 8, tp=tp),
                                   batches)
    step, opt = tc.make_train_step(TINY)
    p = tc.params_from_numpy(host, CPU)
    o = opt.init(p)
    want_losses = []
    for b in batches:
        p, o, loss = step(p, o, torch.from_numpy(b))
        want_losses.append(float(loss))
    _hold_losses(got_losses, want_losses, SPLIT_LOSS_ATOL)
    _hold_updates(host, got, tc.params_to_numpy(p))


@pytest.mark.parametrize("tp", [4, 2])
def test_replicated_leaves_stay_equal_on_every_member(host, tp):
    _, _, placed = _port_run(host, tc.make_mesh([CPU] * 8, tp=tp),
                             _batches(4, 3))
    for path in (("ln_f",), ("layers", "ln1"), ("layers", "ln2")):
        first = _at(placed[0], path)
        assert not torch.equal(first, torch.tensor(_at(host, path)))
        for tree in placed[1:]:
            assert torch.equal(_at(tree, path), first), path
    # Sharded leaves agree across dp replicas too: one mean gradient.
    for j in range(tp):
        for i in range(1, 8 // tp):
            for path in _paths(host):
                assert torch.equal(_at(placed[i * tp + j], path),
                                   _at(placed[j], path)), (path, i, j)


def test_remat_on_and_off_agree(host):
    mesh = tc.make_mesh([CPU] * 8)
    batches = _batches(5, 1)
    l1, p1, _ = _port_run(host, mesh, batches)
    l2, p2, _ = _port_run(host, mesh, batches,
                          tc.CanaryConfig(**SIZES, remat=False))
    assert l1 == l2
    for path in _paths(host):
        np.testing.assert_array_equal(_at(p1, path), _at(p2, path))


def test_sharded_step_leaves_its_arguments_unchanged(host):
    st = tc.make_sharded_train_step(tc.make_mesh([CPU] * 8), TINY)
    p = st.shard_params(host)
    o = st.shard_opt_state(p, _zeros_state(host))
    before = [tc.params_to_numpy(t) for t in p]
    st.step(p, o, st.shard_batch(_batches(6, 1)[0]))
    for tree, want in zip(p, before):
        for path in _paths(want):
            np.testing.assert_array_equal(_at(tree, path).numpy(),
                                          _at(want, path))
    assert all(s.count == 0 for s in o)


def test_runner_with_a_mesh_trains_like_the_one_device_runner():
    mesh = tc.make_mesh([CPU] * 8)
    sharded = tc.CanaryRunner(TINY, seed=7, mesh=mesh)
    single = tc.CanaryRunner(TINY, device=CPU, seed=7)
    assert sharded.param_count() == single.param_count()
    assert sharded.flops_per_step() == single.flops_per_step()
    for step in range(3):
        a, b = sharded.run_step(), single.run_step()
        assert abs(a - b) <= (FIRST_LOSS_ATOL if step == 0
                              else SPLIT_LOSS_ATOL)
    assert np.isfinite(sharded.losses).all()
    summary = sharded.perf_summary()
    assert summary["steps"] == 3 and summary["device"] == "cpu"


# --- the elastic runner -------------------------------------------------------


def _elastic_pair(cpu_devices, host, n_slices):
    jr = jc.ElasticCanaryRunner(TINY_J, cpu_devices, n_slices=n_slices,
                                precompile=False)
    jr._activate(frozenset(), jax.tree.map(jnp.asarray, host), None)
    tr = tc.ElasticCanaryRunner(TINY, [CPU] * 8, n_slices=n_slices,
                                precompile=False)
    tr._host_params = host
    tr._activate(frozenset(), host, None)
    return jr, tr


def _same_shape(jr, tr):
    assert tr.cfg.batch == jr.cfg.batch
    assert tr.active_device_count() == jr.active_device_count()
    assert tr.active_slices == jr.active_slices
    assert tr.mesh.shape == dict(jr.mesh.shape)


@pytest.mark.parametrize("n_slices, index", [(4, 1), (3, 2)],
                         ids=["physical", "logical"])
def test_elastic_runner_matches_jax_across_a_resize(cpu_devices, host,
                                                    n_slices, index):
    jr, tr = _elastic_pair(cpu_devices, host, n_slices)
    assert tr.physical == jr.physical == (n_slices == 4)
    _same_shape(jr, tr)
    got, want = [], []

    def steps(k):
        for _ in range(k):
            want.append(jr.run_step())
            got.append(tr.run_step())

    steps(2)
    before = tr._unshard(tr.params)
    tr.exclude_slice(index)
    jr.exclude_slice(index)
    # Checkpoint-free: the same values on the new placement.
    after = tr._unshard(tr.params)
    for path in _paths(host):
        np.testing.assert_array_equal(_at(after, path), _at(before, path))
    _same_shape(jr, tr)
    tr.exclude_slice(index)  # a replay: no second resize
    steps(2)
    tr.rejoin_slice(index)
    jr.rejoin_slice(index)
    tr.rejoin_slice(index)
    _same_shape(jr, tr)
    assert tr.cfg.batch == TINY.batch
    steps(2)
    _hold_losses(got, want)
    assert [e["direction"] for e in tr.resize_events] == ["down", "up"]
    assert [e["slice"] for e in tr.resize_events] == [index, index]


def test_elastic_bundle_batches_match_jax(cpu_devices):
    for n_slices in (2, 3, 4):
        jr = jc.ElasticCanaryRunner(TINY_J, cpu_devices, n_slices=n_slices,
                                    precompile=False)
        tr = tc.ElasticCanaryRunner(TINY, [CPU] * 8, n_slices=n_slices,
                                    precompile=False)
        assert tr.physical == jr.physical
        for i in range(n_slices):
            jb = jr._bundle_for(frozenset({i}))
            tb = tr._bundle_for(frozenset({i}))
            assert tb.cfg.batch == jb.cfg.batch, (n_slices, i)
            assert tb.mesh.shape == dict(jb.mesh.shape), (n_slices, i)


def test_precompile_leaves_the_runner_unchanged(host):
    tr = tc.ElasticCanaryRunner(TINY, [CPU] * 8, n_slices=2,
                                precompile=False)
    tr.run_step()
    params = tr._unshard(tr.params)
    state = tr._unshard(tr.opt_state)
    tr.precompile_exclusions()
    assert set(tr._bundles) == {frozenset(), frozenset({0}),
                                frozenset({1})}
    for path in _paths(params):
        np.testing.assert_array_equal(_at(tr._unshard(tr.params), path),
                                      _at(params, path))
        np.testing.assert_array_equal(_at(tr._unshard(tr.opt_state).mu,
                                          path), _at(state.mu, path))
    assert tr._unshard(tr.opt_state).count == 1
    assert tr.cfg.batch == TINY.batch and not tr.excluded


def test_elastic_resize_is_idempotent_and_bounded():
    tr = tc.ElasticCanaryRunner(TINY, [CPU] * 8, n_slices=2,
                                precompile=False)
    tr.exclude_slice(0)
    tr.exclude_slice(0)
    tr.rejoin_slice(1)  # not excluded: a no-op
    assert len(tr.resize_events) == 1 and tr.active_slices == 1
    assert tr.active_device_count() == 4 and tr.mesh.shape == {"dp": 2,
                                                                "tp": 2}
    with pytest.raises(ValueError, match="out of range"):
        tr.exclude_slice(5)
    with pytest.raises(ValueError, match="every slice"):
        tr.exclude_slice(1)
    with pytest.raises(ValueError, match="positive"):
        tc.ElasticCanaryRunner(TINY, [CPU] * 8, n_slices=0)
