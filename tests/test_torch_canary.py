"""The port's canary against the JAX package's, on the CPU.

Weights cross from JAX ``init_params(PRNGKey(0), TINY)`` to the port by
``params_from_numpy``; batches are the same numpy integers.  Both sides
round every matmul operand to bf16 and accumulate in fp32, so they differ
only where an fp32 sum taken in another order lands on the other side of
a bf16 rounding boundary: most values agree to the last fp32 bit, a few
by one bf16 step, which then propagates.  Tolerances, with what was
measured on this CPU:

- logits: 3e-2 absolute at |logits| < 4, median difference 0 (measured
  max 1.0e-2, median 0);
- loss: 1e-3 absolute (measured 6.8e-5);
- gradients: per leaf, 2e-2 of the leaf's largest JAX gradient (measured
  at most 0.5 %; both sides round gradients to bf16 at the casts);
- three Adam steps: losses 1e-3 absolute (measured 1.7e-4); each leaf's
  update ``p3 - p0`` against JAX's, with most elements far under lr
  (1e-3), which moves most elements by 2e-3 to 3e-3 in three steps: at
  least 80 % within 1e-5 and 99 % within 1e-4 (measured at least 85.6 %
  and 99.9 % overall), and every element within 2·lr a step, 6e-3
  (measured 2.0e-3).  Adam moves a parameter by about lr whatever its
  gradient's size, so where a near-zero gradient's sign differs the two
  updates differ by up to 2·lr a step.  An optimizer that never updates,
  or updates with the wrong sign, leaves almost no element within 1e-5;
- Adam alone on identical gradients: identical to ``optax.adam``;
- remat on against off: identical.
"""

from __future__ import annotations

import time

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
BENCH = dict(
    vocab=1024, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
    seq_len=512, batch=32,
)
LOGITS_ATOL = 3e-2
LOSS_ATOL = 1e-3
GRAD_RTOL_OF_MAX = 2e-2
LR = 1e-3
UPDATE_TIGHT = ((1e-5, 0.80), (1e-4, 0.99))  # (atol, share of elements)
UPDATE_ATOL_3_STEPS = 3 * 2 * LR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; torch's default of one
    # intra-op thread per core oversubscribes the host.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def crossed():
    """(JAX params, the same weights in the port, the numpy tree)."""
    jp = jc.init_params(jax.random.PRNGKey(0), TINY_J)
    host = jax.tree.map(np.asarray, jp)
    return jp, tc.params_from_numpy(host, CPU), host


def _batches(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, TINY.vocab, (TINY.batch, TINY.seq_len + 1),
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


def test_params_cross_both_ways(crossed):
    _, tp, host = crossed
    back = tc.params_to_numpy(tp)
    assert list(_paths(back)) == list(_paths(host))
    for path in _paths(host):
        got = _at(back, path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, _at(host, path))


def test_init_params_keeps_the_jax_tree(crossed):
    gen = torch.Generator().manual_seed(0)
    tp = tc.init_params(gen, TINY)
    _, _, host = crossed
    assert list(_paths(tc.params_to_numpy(tp))) == list(_paths(host))
    for path in _paths(host):
        assert tuple(_at(tp, path).shape) == _at(host, path).shape
    assert torch.equal(tp["layers"]["ln1"], torch.ones(2, 64))
    # Weights are N(0, 1/d_model), as in the JAX package.
    assert abs(float(tp["embed"].std()) - 64**-0.5) < 0.01


def test_logits_and_loss_match_jax(crossed):
    jp, tp, _ = crossed
    (batch,) = _batches(0, 1)
    want = np.asarray(jc.forward(jp, jnp.asarray(batch[:, :-1]), TINY_J))
    got = tc.forward(tp, torch.from_numpy(batch[:, :-1]), TINY)
    assert got.dtype == torch.float32 and got.shape == (8, 16, 64)
    diff = np.abs(got.detach().numpy() - want)
    assert diff.max() < LOGITS_ATOL
    assert np.median(diff) == 0.0
    jloss = float(jc.loss_fn(jp, jnp.asarray(batch), TINY_J))
    tloss = float(tc.loss_fn(tp, torch.from_numpy(batch), TINY))
    assert abs(tloss - jloss) < LOSS_ATOL


def test_gradients_match_jax_per_leaf(crossed):
    jp, tp, host = crossed
    (batch,) = _batches(1, 1)
    jgrads = jax.grad(jc.loss_fn)(jp, jnp.asarray(batch), TINY_J)
    leaves = [p.detach().requires_grad_(True) for p in tc._leaves(tp)]
    loss = tc.loss_fn(tc._unflatten(tp, leaves), torch.from_numpy(batch),
                      TINY)
    tgrads = tc._unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    for path in _paths(host):
        want = np.asarray(_at(jgrads, path))
        got = _at(tgrads, path).numpy()
        scale = np.abs(want).max()
        assert scale > 0, path
        assert np.abs(got - want).max() <= GRAD_RTOL_OF_MAX * scale, path


def test_three_adam_steps_match_jax(crossed):
    jp, tp, host = crossed
    jstep, jopt = jc.make_train_step(TINY_J)
    jstep = jax.jit(jstep)
    tstep, topt = tc.make_train_step(TINY)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for batch in _batches(2, 3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(batch))
        tp, tstate, tloss = tstep(tp, tstate, torch.from_numpy(batch))
        assert abs(float(tloss) - float(jloss)) < LOSS_ATOL
    assert tstate.count == 3
    assert TINY.learning_rate == TINY_J.learning_rate == LR
    jhost = jax.tree.map(np.asarray, jp)
    thost = tc.params_to_numpy(tp)
    for path in _paths(host):
        p0 = _at(host, path)
        want = _at(jhost, path) - p0
        diff = np.abs((_at(thost, path) - p0) - want)
        # The updates are real: most elements move by more than lr.
        assert np.median(np.abs(want)) > LR, path
        for atol, share in UPDATE_TIGHT:
            assert (diff <= atol).mean() >= share, (path, atol)
        assert diff.max() <= UPDATE_ATOL_3_STEPS, path


def test_adam_matches_optax_on_fixed_gradients():
    """The optimizer alone, on identical gradients: the same fp32
    operations in the same order as optax.adam."""
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32)}
    grads = [
        {"w": rng.standard_normal((5, 7)).astype(np.float32) * 10.0**-e}
        for e in range(4)
    ]
    opt = jc.optax.adam(1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jparams)
    tadam = tc.Adam(1e-3)
    tparams = tc.params_from_numpy(params, CPU)
    tstate = tadam.init(tparams)
    for g in grads:
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate)
        jparams = jc.optax.apply_updates(jparams, updates)
        tupdates, tstate = tadam.update(tc.params_from_numpy(g, CPU), tstate)
        tparams = tc.apply_updates(tparams, tupdates)
    np.testing.assert_array_equal(
        tparams["w"].numpy(), np.asarray(jparams["w"])
    )


def test_remat_on_and_off_agree(crossed):
    _, tp, _ = crossed
    no_remat = tc.CanaryConfig(**SIZES, remat=False)
    (batch,) = _batches(4, 1)
    with_step, opt = tc.make_train_step(TINY)
    without_step, _ = tc.make_train_step(no_remat)
    p1, _, l1 = with_step(tp, opt.init(tp), torch.from_numpy(batch))
    p2, _, l2 = without_step(tp, opt.init(tp), torch.from_numpy(batch))
    assert float(l1) == float(l2)
    for a, b in zip(tc._leaves(p1), tc._leaves(p2)):
        assert torch.equal(a, b)


def test_step_leaves_its_arguments_unchanged(crossed):
    _, tp, host = crossed
    step, opt = tc.make_train_step(TINY)
    state = opt.init(tp)
    (batch,) = _batches(5, 1)
    step(tp, state, torch.from_numpy(batch))
    for path in _paths(host):
        np.testing.assert_array_equal(_at(tp, path).numpy(), _at(host, path))
    assert state.count == 0


def _jax_runner_shell(cfg):
    """A JAX runner without its parameters materialised: its counting
    methods read only ``cfg`` and the parameters' shapes."""
    runner = object.__new__(jc.CanaryRunner)
    runner.cfg, runner.mesh = cfg, None
    runner.params = jax.eval_shape(
        lambda: jc.init_params(jax.random.PRNGKey(0), cfg)
    )
    return runner


@pytest.mark.parametrize("sizes", [SIZES, BENCH], ids=["tiny", "bench"])
def test_param_count_and_flops_equal_jax(sizes):
    jrunner = _jax_runner_shell(jc.CanaryConfig(**sizes))
    cfg = tc.CanaryConfig(**sizes)
    want_shapes = jax.tree.map(lambda s: s.shape, jrunner.params)
    assert tc.param_shapes(cfg) == want_shapes
    if sizes is SIZES:
        trunner = tc.CanaryRunner(cfg, device=CPU)
    else:
        # The bench model's 103 M parameters are not made on the CPU: the
        # runner counts meta tensors, which keep only their shapes.
        trunner = object.__new__(tc.CanaryRunner)
        trunner.cfg = cfg
        trunner.params = tc._tree_map(
            lambda s: torch.empty(s, device="meta"), tc.param_shapes(cfg)
        )
    assert trunner.param_count() == jrunner.param_count()
    assert trunner.flops_per_step() == jrunner.flops_per_step()
    if sizes is BENCH:
        assert trunner.param_count() == 102_777_856
        assert round(trunner.flops_per_step() / 1e12, 2) == 10.93


def test_runner_trains_on_the_jax_batches():
    runner = tc.CanaryRunner(TINY, device=CPU, seed=7)
    rng = np.random.default_rng(7)
    first = runner._make_batch()
    assert first.dtype == torch.int32 and first.device == CPU
    np.testing.assert_array_equal(
        first.numpy(),
        rng.integers(0, 64, (8, 17), dtype=np.int32),
    )
    before = float(tc.loss_fn(runner.params, first, TINY))
    for _ in range(5):
        runner.run_step()
    assert len(runner.losses) == 5 and np.isfinite(runner.losses).all()
    # The data are uniform tokens: training moves the logits toward
    # uniform, which lowers the loss on any batch, this one included.
    assert float(tc.loss_fn(runner.params, first, TINY)) < before
    summary = runner.perf_summary()
    assert summary["steps"] == 5 and summary["device"] == "cpu"
    assert summary["tokens_per_s"] > 0 and "mfu" not in summary


def test_gap_measurement():
    runner = tc.CanaryRunner(TINY, device=CPU)
    runner.run_step()
    runner.run_step()
    time.sleep(0.05)
    runner.run_step()
    assert runner.max_gap_seconds() >= 0.05
    last = runner.step_times[-1]
    # An open window counts the interval since the last completed step.
    assert runner.max_gap_seconds(until=last + 10.0) == pytest.approx(10.0)
    runner.reset_timing()
    assert runner.max_gap_seconds() == 0.0
    # No completed step at all: the whole window is the gap.
    start = runner.window_start
    assert runner.max_gap_seconds(until=start + 3.0) == pytest.approx(3.0)


def test_runner_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.CanaryRunner(TINY)
