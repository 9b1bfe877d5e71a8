"""The port's elastic-roll negotiation (``coordination/``) against the JAX
package's, on the CPU.

- The twelve tests of ``tests/test_elastic_coordination.py``, run against
  the port (``port_module``: their source with the package prefix
  rewritten, on the port's fixtures).
- Lockstep: each package's ``ElasticCanaryRunner`` answers its own
  engine's offers through its own ``WorkloadCoordinator`` over four
  slices: the JAX runner on the ``cpu_devices`` fixture's 8 virtual
  devices over one-host TPU slices, the port's over ``[cpu] * 8`` on the
  bench's own pool (``bench.ElasticPool``) of GFD-labelled nodes.  After
  every pass both fleets hold the same states, the port's resharded
  weights and Adam state equal the JAX runner's bit for bit, and both
  record the same negotiations, resizes and resize events.  Before each
  pass the JAX runner's weights and optimizer state cross into the
  port's through numpy, so each step's losses agree within
  ``LOSS_ATOL``, the limit of ``tests/test_torch_canary_sharded.py``:
  over 33 steps two free-running trajectories drift past it (1.2e-3
  within 33 steps here), as Adam moves a parameter by about lr whatever
  the size of its gradient.
- A GPU fleet: the bench's pool, four GPU Feature Discovery-labelled
  nodes in no slice, each its own group claiming one unit of the slice
  budget, accept and decline on the port.
- The port's bench stage, ``bench.elastic_roll`` at a small width,
  gives the counts of the JAX package's stage (``tools/bench_guard.py``
  ``measure_elastic``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from k8s_operator_libs_tpu import api as japi  # noqa: E402
from k8s_operator_libs_tpu import coordination as jcoord  # noqa: E402
from k8s_operator_libs_tpu import k8s as jk8s  # noqa: E402
from k8s_operator_libs_tpu import upgrade as jup  # noqa: E402
from k8s_operator_libs_tpu.workloads import canary as jc  # noqa: E402
from k8s_operator_libs_tpu_torch import bench  # noqa: E402
from k8s_operator_libs_tpu_torch import coordination as tcoord  # noqa: E402
from k8s_operator_libs_tpu_torch.workloads import canary as tc  # noqa: E402
from tests.test_torch_control_plane import (  # noqa: E402
    ENGINES,
    port_module,
    port_tests,
)

globals().update(port_tests(port_module("test_elastic_coordination.py")))

CPU = torch.device("cpu")
# The small canary of tests/test_torch_canary_sharded.py (the port's
# heads divide by tp).
SIZES = dict(
    vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq_len=16,
    batch=8,
)
LOSS_ATOL = 1e-3
N_SLICES = 4
SLICE_IDS = tuple(f"pool-{i}" for i in range(N_SLICES))
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Tier-1 runs six pytest workers at once; one intra-op thread each.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Passing:
    """The JAX side's prober: it passes every group (the stage measures
    the negotiation, not the gate)."""

    def probe(self, group):
        return jup.ProbeResult(True, "pass")


class _Roll:
    """The JAX package's engine and workload coordinator over a bumped
    fleet of ``SLICE_IDS``, TPU slices of one host each, under the JAX
    stage's policy: the JAX side of the lockstep, whose port side is the
    bench's own ``ElasticPool``."""

    def __init__(self, runtime, accept: bool) -> None:
        fixtures = ENGINES["jax"][3]
        self.cluster = jk8s.FakeCluster()
        self.keys = jup.UpgradeKeys()
        fx = fixtures.ClusterFixture(self.cluster, self.keys)
        ds = fx.daemon_set(hash_suffix="v1", revision=1)
        self.slice_nodes = {}
        for sid in SLICE_IDS:
            (node,) = fx.tpu_slice(sid, hosts=1)
            self.slice_nodes[sid] = node.name
            fx.driver_pod(node, ds, hash_suffix="v1")
        fx.bump_daemon_set_template(ds, "v2", revision=2)
        fx.auto_recreate_driver_pods(ds, "v2")
        self.mgr = jup.ClusterUpgradeStateManager(
            self.cluster, keys=self.keys, poll_interval_s=0.005,
            poll_timeout_s=2.0,
        )
        self.mgr.with_validation_enabled(_Passing())
        self.policy = japi.TPUUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=japi.IntOrString("25%"),
            unavailability_unit="slice",
            drain_spec=japi.DrainSpec(enable=True, timeout_second=5),
            elastic=japi.ElasticCoordinationSpec(
                enable=True, offer_timeout_second=60, rejoin_timeout_second=60
            ),
        )
        self.namespace = fixtures.NAMESPACE
        self.labels = fixtures.DRIVER_LABELS
        self.coordinator = jcoord.WorkloadCoordinator(
            self.cluster, self.keys, "canary",
            {sid: [n] for sid, n in self.slice_nodes.items()}, runtime,
            accept_policy=lambda sid: accept,
        )
        self.coordinator.register()

    def states(self) -> dict[str, str]:
        return {sid: self.cluster.get_node(n).labels.get(
            self.keys.state_label, "") for sid, n in self.slice_nodes.items()}

    def one_pass(self) -> None:
        state = self.mgr.build_state(self.namespace, self.labels,
                                     self.policy)
        self.mgr.apply_state(state, self.policy)
        assert self.mgr.wait_for_async_work(10.0)
        self.coordinator.poll_once()

    def done(self) -> bool:
        return all(s == "upgrade-done" for s in self.states().values())


def _runners(cpu_devices):
    """The JAX package's and the port's elastic runners over four
    slices, both from the JAX package's initial weights."""
    host = jax.tree.map(np.asarray, jc.init_params(
        jax.random.PRNGKey(0), jc.CanaryConfig(**SIZES)))
    jr = jc.ElasticCanaryRunner(jc.CanaryConfig(**SIZES), cpu_devices,
                                n_slices=N_SLICES, precompile=False)
    jr._activate(frozenset(), jax.tree.map(jnp.asarray, host), None)
    tr = tc.ElasticCanaryRunner(tc.CanaryConfig(**SIZES), [CPU] * 8,
                                n_slices=N_SLICES, precompile=False)
    tr._host_params = host
    tr._activate(frozenset(), host, None)
    return jr, tr


def _jax_state(jr):
    """The JAX runner's weights and Adam state on the host."""
    adam = jr.opt_state[0]
    return (jax.tree.map(np.asarray, jr.params), int(adam.count),
            jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu))


def _cross(jr, tr) -> None:
    """The JAX runner's weights and optimizer state into the port's
    runner, on its current placement."""
    params, count, mu, nu = _jax_state(jr)
    tr._activate(frozenset(tr.excluded), params, tc.AdamState(count, mu, nu))


def _assert_same_state(jr, tr) -> None:
    """The port runner's weights and Adam state, gathered from its
    placement, equal the JAX runner's bit for bit."""
    params, count, mu, nu = _jax_state(jr)
    opt = tr._unshard(tr.opt_state)
    assert opt.count == count
    for got, want in ((tr._unshard(tr.params), params), (opt.mu, mu),
                      (opt.nu, nu)):
        jax.tree.map(np.testing.assert_array_equal, got, want)


def _runtime(coord, runner):
    return coord.RunnerElasticRuntime(
        runner, {sid: i for i, sid in enumerate(SLICE_IDS)}
    )


@pytest.mark.parametrize("accept", [True, False], ids=["accept", "decline"])
def test_both_runners_roll_in_lockstep(cpu_devices, accept):
    """The JAX runner, engine and coordinator over one-host TPU slices;
    the port's over the bench's GFD pool; one canary step a pass.  Before
    each pass the JAX runner's weights and Adam state cross into the
    port's runner; after it (each runner having resized on its own) the
    port's gathered state equals the JAX runner's bit for bit, and both
    fleets hold the same states.  Both record the same negotiations,
    resizes and resize events, and each step's losses agree within
    ``LOSS_ATOL``."""
    jr, tr = _runners(cpu_devices)
    jroll = _Roll(_runtime(jcoord, jr), accept)
    pool = bench.ElasticPool(_runtime(tcoord, tr), accept)
    assert pool.slice_ids == list(SLICE_IDS)
    got, want = [], []
    for passes in range(1, 201):
        _cross(jr, tr)
        jroll.one_pass()
        pool.one_pass()
        assert pool.states() == jroll.states(), passes
        _assert_same_state(jr, tr)
        want.append(jr.run_step())
        got.append(tr.run_step())
        assert tr.mesh.shape == dict(jr.mesh.shape), passes
        assert tr.cfg.batch == jr.cfg.batch, passes
        if jroll.done():
            break
    assert pool.done()
    # The JAX stage's counts (one step a pass does not change them).
    assert passes == (34 if accept else 33)
    for name in ("elastic_negotiations", "elastic_resizes"):
        assert getattr(pool.mgr, name) == getattr(jroll.mgr, name)
    assert pool.mgr.elastic_negotiations == (
        {"accept": 4, "decline": 0, "timeout": 0} if accept
        else {"accept": 0, "decline": 4, "timeout": 0}
    )

    def events(runner):
        return [(e["direction"], e["slice"]) for e in runner.resize_events]

    assert events(tr) == events(jr)
    assert events(tr) == ([(d, i) for i in range(N_SLICES)
                           for d in ("down", "up")] if accept else [])
    assert not tr.excluded and not jr.excluded
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("accept", [True, False], ids=["accept", "decline"])
def test_a_gfd_pool_negotiates_node_by_node(accept):
    """The bench's pool, four GFD-labelled nodes in no slice: the engine
    makes each node its own group, reads the ``elastic-workload``
    annotation on it and claims one unit of the slice budget for it (25 %
    of four groups: one node out at a time); each node's name is the
    coordinator's slice id."""
    runtime = tcoord.RecordingRuntime()
    pool = bench.ElasticPool(runtime, accept)
    state = pool.mgr.build_state(bench.NAMESPACE, bench.DRIVER_LABELS,
                                 pool.policy)
    groups = {g.id: g for g in state.all_groups()}
    assert set(groups) == set(SLICE_IDS)
    assert {g.slice_info for g in groups.values()} == {None}
    assert all([n.name for n in g.nodes] == [g.id]
               for g in groups.values())
    offered: list[str] = []
    for _ in range(200):
        pool.one_pass()
        states = pool.states()
        out = [sid for sid, s in states.items()
               if s not in ("", "upgrade-required", "upgrade-done")]
        assert len(out) <= 1, states
        for sid in out:
            if sid not in offered:
                offered.append(sid)
        if pool.done():
            break
    assert pool.done()
    assert offered == list(SLICE_IDS)
    if accept:
        assert pool.mgr.elastic_negotiations == {
            "accept": 4, "decline": 0, "timeout": 0}
        assert pool.mgr.elastic_resizes == {"down": 4, "up": 4}
        assert runtime.calls == [f"{verb}:{sid}" for sid in SLICE_IDS
                                 for verb in ("exclude", "rejoin")]
    else:
        assert pool.mgr.elastic_negotiations == {
            "accept": 0, "decline": 4, "timeout": 0}
        assert pool.mgr.elastic_resizes == {"down": 0, "up": 0}
        assert runtime.calls == []
    for sid in SLICE_IDS:
        node = pool.cluster.get_node(sid)
        assert not node.spec.unschedulable
        assert node.annotations.get(
            bench.KEYS.elastic_excluded_annotation) != "true"
    assert pool.leftover_excluded() == 0


# The JAX package's elastic stage on its 8 virtual CPU devices, four
# one-host slices (tools/bench_guard.py measure_elastic; three steps a
# pass): (passes, canary steps, negotiations, resizes, runner resizes).
JAX_STAGE = {
    True: (34, 102, {"accept": 4, "decline": 0, "timeout": 0},
           {"down": 4, "up": 4}, 8),
    False: (33, 99, {"accept": 0, "decline": 4, "timeout": 0},
            {"down": 0, "up": 0}, 0),
}


@pytest.mark.parametrize("accept", [True, False], ids=["accept", "decline"])
def test_the_bench_stage_gives_the_jax_stage_counts(accept):
    r = bench.elastic_roll([CPU] * 8, accept, cfg=tc.CanaryConfig(**SIZES))
    passes, steps, negotiations, resizes, runner_resizes = JAX_STAGE[accept]
    assert r["converged"] and r["physical_partition"]
    assert (r["passes"], r["canary_steps"]) == (passes, steps)
    assert r["negotiations"] == negotiations
    assert r["resizes"] == resizes
    assert r["runner_resizes"] == runner_resizes
    assert r["leftover_excluded"] == 0
    assert (r["variant"], r["slices"], r["devices"]) == (
        "accept" if accept else "decline", 4, 8)
    # Eight members in four slices: dp 2 x tp 4, and dp 3 x tp 2 while a
    # slice is out (the accepting roll's steps only).
    assert r["meshes"] == ([(2, 4), (3, 2)] if accept else [(2, 4)])
    assert [(e["direction"], e["slice"]) for e in r["resize_events"]] == (
        [(d, i) for i in range(4) for d in ("down", "up")] if accept else [])
    # A gap is a pass's host time, a resize and a step at most.
    assert r["max_gap_s"] <= (r["slowest_step_s"] + r["slowest_resize_s"]
                              + r["slowest_pass_host_s"])
    # A gap of this width on the CPU stays far under the card's ceiling.
    assert r["downtime_s"] == 0.0
    # The plain versions count no launch.
    assert r["launches"] == {"peer_reduce": 0, "peer_gather": 0}
