"""The roll loop: a GPU operator pool rolls its driver, over and over,
under a training job.

Four GFD-labelled HGX H100 nodes on the port's ``FakeCluster`` run the
GPU operator's driver DaemonSet.  Each roll begins with a new driver
template (its revision drawn from the seed); the port's engine
(``ClusterUpgradeStateManager``) walks the nodes under the
configuration's policy, its validation gate asking the port's
``NodeReportProber`` for each node's report.  Each node's
``HealthAgent`` runs as the agent DaemonSet runs it: one battery when
the driver pod on its node comes back at a new revision, then one every
``probe_interval_s``; each publishes its report.  When every node is
``upgrade-done`` at the new revision the next roll begins at once.

The training job is the port's ``CanaryRunner`` on ``pool-0``, in a
closed loop, paused while ``pool-0`` is unschedulable; its pod is
evicted by the drain and comes back when the node does.  One card
stands in for every node's GPUs: ``pool-0``'s agent and the canary,
which share that node's GPUs, take one lock in turn; the other nodes'
agents take none.

The canary trains from weights and batches the benchmark makes from the
seed, on the card.  Set-up warms its step and puts its weights and Adam
state back; the window's first three steps, under the window's load,
are what the reference follows.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from harness import trace as tr
from harness.fleet import KEYS, NAMESPACE, Fleet
from harness.gate import revision_hash
from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    SliceHealthGateSpec,
    TPUUpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.health import fused
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
from k8s_operator_libs_tpu_torch.health.slice_prober import NodeReportProber
from k8s_operator_libs_tpu_torch.k8s import NotFoundError
from k8s_operator_libs_tpu_torch.keys import DRIVER_LABELS
from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager
from k8s_operator_libs_tpu_torch.workloads.canary import (
    CanaryConfig,
    CanaryRunner,
)
from reference import battery as ref_battery
from reference import canary as ref_canary
from reference import engine as ref_engine
from reference import verdict as ref_verdict

# A node between its cordon and its uncordon: what maxParallelUpgrades
# counts.
IN_FLIGHT_STATES = frozenset({
    "cordon-required", "wait-for-jobs-required", "pod-deletion-required",
    "drain-required", "pod-restart-required", "validation-required",
    "uncordon-required",
})
# A node from its cordon to the end of its drain.
DRAINING_STATES = frozenset({
    "cordon-required", "wait-for-jobs-required", "pod-deletion-required",
    "drain-required",
})
DONE = "upgrade-done"
CANARY_POD = "canary-0"


# -- the canary's weights and batches, made from the seed -------------------


def canary_leaf_shapes(c: dict) -> dict:
    L, D, V, Fd = c["n_layers"], c["d_model"], c["vocab"], c["d_ff"]
    return {"embed": (V, D), "qkv": (L, D, 3 * D), "proj": (L, D, D),
            "mlp_in": (L, D, Fd), "mlp_out": (L, Fd, D), "ln1": (L, D),
            "ln2": (L, D), "ln_f": (D,), "out": (D, V)}


def make_weights(c: dict, seed: int, device) -> dict:
    """Every matrix drawn normal in one call on the card, scaled by
    ``d_model ** -0.5``; the norms' gains ones."""
    shapes = canary_leaf_shapes(c)
    mats = [k for k in shapes if not k.startswith("ln")]
    sizes = [int(np.prod(shapes[k])) for k in mats]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= c["d_model"] ** -0.5
    out = {k: t.view(shapes[k]) for k, t in zip(mats, flat.split(sizes))}
    for k in shapes:
        if k.startswith("ln"):
            out[k] = torch.ones(shapes[k], device=device)
    return out


def nested(flat: dict) -> dict:
    """The canary's parameter tree from the flat leaves."""
    layer = ("qkv", "proj", "mlp_in", "mlp_out", "ln1", "ln2")
    return {"embed": flat["embed"], "layers": {k: flat[k] for k in layer},
            "ln_f": flat["ln_f"], "out": flat["out"]}


def flatten(tree: dict) -> dict:
    return {"embed": tree["embed"], **tree["layers"], "ln_f": tree["ln_f"],
            "out": tree["out"]}


class Feed:
    """Batches of ``batch × (seq_len + 1)`` tokens, uniform over the
    vocabulary, drawn on the card from the seed: every row differs."""

    def __init__(self, c: dict, seed: int, device) -> None:
        self.shape = (c["batch"], c["seq_len"] + 1)
        self.vocab = c["vocab"]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device

    def __call__(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device, dtype=torch.int32)


class MatmulPrecision(torch.overrides.TorchFunctionMode):
    """Notes, at each product the canary's step makes, the type the card
    computes it in: bf16 operands, fp32 ones under TF32, or fp32."""

    def __init__(self) -> None:
        super().__init__()
        self.seen: dict = defaultdict(int)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                    torch.mm, torch.bmm, torch.einsum):
            dts = {a.dtype for a in args if isinstance(a, torch.Tensor)}
            if torch.bfloat16 in dts or torch.float16 in dts:
                self.seen["bf16"] += 1
            elif torch.backends.cuda.matmul.allow_tf32:
                self.seen["tf32"] += 1
            else:
                self.seen["fp32"] += 1
        return func(*args, **(kwargs or {}))


def weight_seed(seed: int) -> int:
    return seed * 2 + 1


def feed_seed(seed: int) -> int:
    return seed * 2 + 2


def canary_runner(c: dict, seed: int, device):
    """The port's ``CanaryRunner`` on ``device``, training from weights and
    batches made from ``seed``; and the weights, as made."""
    weights = make_weights(c, weight_seed(seed), device)
    runner = CanaryRunner(
        CanaryConfig(vocab=c["vocab"], d_model=c["d_model"],
                     n_heads=c["n_heads"], n_layers=c["n_layers"],
                     d_ff=c["d_ff"], seq_len=c["seq_len"], batch=c["batch"],
                     learning_rate=c["learning_rate"]),
        device=device, seed=0)
    runner.params = nested(weights)
    runner.opt_state = runner.opt.init(runner.params)
    runner._make_batch = Feed(c, feed_seed(seed), device)
    return runner, weights


def warm_up(runner, steps: int) -> str:
    """``steps`` steps through the runner's own call and feed, so that
    nothing loads or compiles in the window; then its weights and Adam
    state back where they started (its feed runs on).  Returns the type
    the step's products are computed in."""
    start = runner.params
    precision = MatmulPrecision()
    with precision:
        runner.run_step()
    for _ in range(steps - 1):
        runner.run_step()
    runner.params = start
    runner.opt_state = runner.opt.init(start)
    runner.reset_timing()
    return max(precision.seen, key=precision.seen.get)


class FirstSteps:
    """Steps the runner through its own call, reading its first three:
    each step's loss, each leaf's first gradient as Adam holds it after
    step 1 (its first moment over ``1 - b1``), and each leaf's change
    from ``weights``, the state the steps start from, after step 3."""

    def __init__(self, runner, weights: dict, b1: float) -> None:
        self.runner, self.weights, self.b1 = runner, weights, b1
        self.losses: list = []
        self.grad: dict = {}
        self.change: dict = {}

    def step(self) -> None:
        self.runner.run_step()
        if len(self.losses) == 3:
            return
        self.losses.append(self.runner.losses[-1])
        if len(self.losses) == 1:
            mu = flatten(self.runner.opt_state.mu)
            self.grad = {k: float(v.norm() / (1 - self.b1))
                         for k, v in mu.items()}
        elif len(self.losses) == 3:
            now = flatten(self.runner.params)
            self.change = {k: float((now[k] - w).norm())
                           for k, w in self.weights.items()}
            self.weights = None


def reference_training(c: dict, seed: int, device, precision: str = "bf16",
                       skip: int = 0) -> dict:
    """The reference's three steps from the same weights and the batches
    the runner's feed draws after its first ``skip``."""
    weights = make_weights(c, weight_seed(seed), device)
    feed = Feed(c, feed_seed(seed), device)
    batches = [feed() for _ in range(skip + 3)][skip:]
    return ref_canary.train(weights, batches, c, precision)


class Loop:
    def __init__(self, run, cards: list) -> None:
        self.run = run
        self.cards = cards
        cfg = run.config
        self.rng = np.random.default_rng(run.seed)
        self.lock = threading.Lock()
        node_cfg = cfg["node"]
        self.gpus = int(node_cfg["gpus"])
        members = [cards[i % len(cards)] for i in range(self.gpus)]
        self.battery = node_cfg["battery"]
        self.probe_interval_s = float(cfg["agent"]["probe_interval_s"])
        pol = cfg["policy"]
        self.policy_cfg = pol

        # -- the pool --------------------------------------------------------
        self.fleet = Fleet(cfg["api"])
        self.revision = revision_hash(self.rng)
        self.fleet.driver_daemon_set(self.revision)
        self.nodes = [self.fleet.gpu_node(f"pool-{i}", node_cfg["node_labels"])
                      for i in range(int(cfg["nodes"]))]
        for node in self.nodes:
            self.fleet.driver_pod(node, self.revision)
        self.fleet.recreate_driver_pods()
        self.canary_node = self.nodes[int(cfg["canary_node"])].name
        self.fleet.workload_pod(self.canary_node, CANARY_POD)
        self.mgr = ClusterUpgradeStateManager(
            self.fleet.cluster, keys=KEYS, poll_interval_s=0.02,
            poll_timeout_s=5.0)
        prober_cfg = node_cfg["prober"]
        self.max_age_s = float(prober_cfg["max_report_age_s"])
        self.prober = NodeReportProber(
            KEYS, max_report_age_s=self.max_age_s,
            revision_resolver=(
                self.mgr.pod_manager.get_daemonset_controller_revision_hash),
            hbm_floor_fraction=prober_cfg["hbm_floor_fraction"],
            generation_floors=prober_cfg["generation_floors"],
        )
        self.verdicts: list = []
        real_probe = self.prober.probe

        def spy_probe(group):
            result = real_probe(group)
            required = self.prober._required_revision(group)
            for node in group.nodes:
                self.verdicts.append((
                    node.name, result.healthy, required,
                    node.annotations.get(KEYS.health_report_annotation)))
            return result

        self.prober.probe = spy_probe
        self.mgr.with_validation_enabled(self.prober)
        self.policy = TPUUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=int(pol["max_parallel_upgrades"]),
            max_unavailable=IntOrString(pol["max_unavailable"]),
            drain_spec=DrainSpec(enable=pol["drain"]["enable"],
                                 timeout_second=pol["drain"]["timeout_s"]),
            health_gate=SliceHealthGateSpec(
                enable=True, timeout_second=pol["health_gate_timeout_s"]),
        )
        b = self.battery
        self.agents = [
            HealthAgent(self.fleet.cluster, node.name, KEYS,
                        driver_revision=self.revision, devices=members,
                        matmul_n=b["matmul_n"], hbm_mib=b["hbm_mib"],
                        allreduce_elems=b["allreduce_elems"], fused=b["fused"])
            for node in self.nodes
        ]
        # node -> (the revision its agent last probed under, when it ended)
        self.probed: dict = {}

        # Every battery's rows: a spy on the fused read-back.
        self.rows: list = []
        real_run = fused._run

        def spy_run(key, inputs):
            rows = real_run(key, inputs)
            self.rows.append(rows)
            return rows

        run.patch(fused, "_run", spy_run)

        run.phase("pool")
        # -- each agent's first battery, at the driver on its node -----------
        revisions = self.fleet.driver_revisions()
        for agent in self.agents:
            self.run_agent(agent, revisions[agent.node_name])
        tr.synchronize(cards)
        run.phase("batteries")

        # -- the canary -------------------------------------------------------
        c = cfg["canary"]
        self.canary_cfg = c
        self.runner, weights = canary_runner(c, run.seed, cards[0])
        # The runner stamps its steps on time.monotonic; the run's clock is
        # time.perf_counter.
        self.mono_to_perf = time.perf_counter() - time.monotonic()
        run.phase("canary weights")
        self.warm_steps = int(run.traffic["canary_warm_steps"])
        self.canary_precision = warm_up(self.runner, self.warm_steps)
        self.first = FirstSteps(self.runner, weights, float(c["adam_b1"]))
        del weights
        tr.synchronize(cards)
        run.phase("canary")

        self._stop = threading.Event()
        self._canary_stop = threading.Event()
        self.samples_down: dict = defaultdict(int)
        self.samples_flight: dict = defaultdict(int)
        self.canary_out: dict = defaultdict(bool)
        self.roll = -1
        self.rolls: list = []
        self.errors: list = []
        self.transitions: list = []
        self.canary_failure: list = []
        self.threads = [threading.Thread(target=f, daemon=True) for f in
                        (self._agent_loop, self._sampler_loop,
                         self._canary_loop)]

    # -- the agents, the sampler and the canary -----------------------------

    def run_agent(self, agent, revision: str) -> None:
        """One battery and report of ``agent`` under ``revision``, the
        driver now on its node; on the canary's node, under the canary's
        lock."""
        shared = agent.node_name == self.canary_node
        with self.lock if shared else contextlib.nullcontext():
            agent.driver_revision = revision
            with self.run.span("battery"):
                report = agent.probe_once()
            with self.run.span("publish"):
                agent.publish(report)
        self.probed[agent.node_name] = (revision, time.perf_counter())

    def _states(self) -> dict:
        return {n.name: self.fleet.cluster.get_node(n.name, cached=False)
                for n in self.nodes}

    def _agent_loop(self) -> None:
        """Each agent probes when the driver pod on its node comes back at
        a new revision (the agent restarts with it) and again every
        ``probe_interval_s`` after its last battery."""
        poll = float(self.run.traffic["agent_poll_s"])
        while not self._stop.is_set():
            try:
                revisions = self.fleet.driver_revisions()
                for agent in self.agents:
                    rev = revisions.get(agent.node_name, "")
                    last, ended = self.probed[agent.node_name]
                    due = (rev != last or time.perf_counter() - ended
                           >= self.probe_interval_s)
                    if rev and due and not self._stop.is_set():
                        self.run_agent(agent, rev)
            except Exception as e:  # noqa: BLE001 — fails the run's check
                self.errors.append(f"agent loop: {type(e).__name__}: {e}")
                return
            time.sleep(poll)

    def _sampler_loop(self) -> None:
        while not self._stop.is_set():
            try:
                states = self._states()
            except Exception as e:  # noqa: BLE001 — fails the run's check
                self.errors.append(f"sampler: {type(e).__name__}: {e}")
                return
            r = self.roll
            down = sum(n.spec.unschedulable for n in states.values())
            flight = sum(n.labels.get(KEYS.state_label, "") in IN_FLIGHT_STATES
                         for n in states.values())
            self.samples_down[r] = max(self.samples_down[r], down)
            self.samples_flight[r] = max(self.samples_flight[r], flight)
            if states[self.canary_node].spec.unschedulable:
                self.canary_out[r] = True
            time.sleep(0.02)

    def _canary_disrupted(self) -> bool:
        try:
            return self.fleet.cluster.get_node(
                self.canary_node, cached=False).spec.unschedulable
        except NotFoundError:
            return True

    def _canary_pod(self) -> bool:
        """Whether the job's pod is on its node; the job's controller
        brings it back once the node is in service again.  The pod is
        listed before the node is read, so that a pod evicted between
        the two reads finds its node still draining."""
        cluster = self.fleet.cluster
        if cluster.list_pods("default", node_name=self.canary_node):
            return True
        node = cluster.get_node(self.canary_node, cached=False)
        if (node.spec.unschedulable
                or node.labels.get(KEYS.state_label, "") in DRAINING_STATES):
            return False
        self.fleet.workload_pod(self.canary_node, CANARY_POD)
        return True

    def _canary_loop(self) -> None:
        while not self._canary_stop.is_set():
            if self._canary_disrupted() or not self._canary_pod():
                time.sleep(0.01)
                continue
            with self.lock:
                try:
                    self.first.step()
                except Exception as e:  # noqa: BLE001 — fails the check
                    self.canary_failure.append(f"{type(e).__name__}: {e}")
                    return

    # -- the rolls ------------------------------------------------------------

    def _begin_roll(self) -> None:
        self.roll += 1
        self.revision = revision_hash(self.rng)
        self.fleet.bump(self.revision, self.roll + 2)
        self.rolls.append({"revision": self.revision,
                           "start": time.perf_counter(), "end": None})

    def _pass(self) -> dict:
        with self.run.span("engine_pass"):
            try:
                state = self.mgr.build_state(NAMESPACE, dict(DRIVER_LABELS))
            except NotFoundError:
                state = None
            if state is not None:
                self.mgr.apply_state(state, self.policy)
                self.mgr.wait_for_async_work(60.0)
        if state is None:
            # Cache lag on fresh objects: requeue, as a reconciler does.
            time.sleep(0.05)
        nodes = self._states()
        labels = {k: n.labels.get(KEYS.state_label, "") for k, n in nodes.items()}
        return labels

    def _roll_done(self, states: dict) -> bool:
        return all(s == DONE for s in states.values()) and all(
            self.fleet.driver_revision_on(n) == self.revision for n in states)

    def _close_roll(self, states: dict) -> None:
        roll = self.rolls[-1]
        roll["end"] = time.perf_counter()
        roll["final_states"] = dict(states)
        roll["final_revisions"] = {
            n: self.fleet.driver_revision_on(n) for n in states}

    def _advance(self, last: dict, deadline: float) -> bool:
        """One engine pass, each node's new state recorded; a roll that
        ends before ``deadline`` is followed by the next.  False when the
        pass failed."""
        try:
            states = self._pass()
        except Exception as e:  # noqa: BLE001 — fails the run's check
            self.errors.append(f"engine pass: {type(e).__name__}: {e}")
            return False
        t = time.perf_counter()
        for name, s in states.items():
            if last.get(name) != s:
                self.transitions.append((t, name, s, self.roll))
                last[name] = s
        if self._roll_done(states):
            self._close_roll(states)
            if time.perf_counter() < deadline:
                self._begin_roll()
        time.sleep(0.02)
        return True

    def window(self, deadline: float) -> None:
        run = self.run
        writes0 = self._writes()
        # Each node's state before the first bump, so that only a node that
        # reaches upgrade-done in the window is counted as done in it.
        last = {k: n.labels.get(KEYS.state_label, "")
                for k, n in self._states().items()}
        self._begin_roll()
        for t in self.threads:
            t.start()
        while time.perf_counter() < deadline:
            if not self._advance(last, deadline):
                break
        # The roll's pace closes as dispatched work does: the roll open at
        # the deadline, its template already bumped, is waited for with
        # everything else running as before, no new one is begun, and the
        # clock is read at its end.  All its nodes count, over all that time.
        limit = time.perf_counter() + float(run.traffic["finish_timeout_s"])
        while (self.rolls[-1]["end"] is None and not self.errors
               and time.perf_counter() < limit
               and self._advance(last, deadline)):
            pass
        self.pace_close = self.rolls[-1]["end"] or time.perf_counter()
        self._last = last
        run.facts["api_writes"] = self._writes() - writes0
        self._canary_stop.set()

    def _writes(self) -> int:
        mutating = ("patch", "create", "update", "delete", "evict", "set_")
        return int(sum(v for k, v in self.fleet.cluster.stats.items()
                       if str(k).startswith(mutating)))

    def finish(self) -> None:
        """Record the window's facts, then let the open roll end (outside
        the window) so that every roll is judged."""
        run = self.run
        w0, w1 = run.window
        run.facts["canary_steps"] = [t + self.mono_to_perf
                                     for t in self.runner.step_times]
        run.facts["tokens_per_step"] = (self.canary_cfg["batch"]
                                        * self.canary_cfg["seq_len"])
        close = self.pace_close
        run.facts["nodes_done"] = sum(
            1 for t, _, s, _ in self.transitions
            if s == DONE and w0 <= t <= close)
        run.facts["pace_s"] = close - w0
        run.facts["rolls"] = [
            {"start": r["start"], "end": r["end"],
             "canary_out": self.canary_out.get(i, False)}
            for i, r in enumerate(self.rolls)]
        run.facts["canary_matmul_precision"] = self.canary_precision
        run.facts["canary_cfg"] = self.canary_cfg
        limit = time.perf_counter() + float(run.traffic["finish_timeout_s"])
        while self.rolls and self.rolls[-1]["end"] is None:
            if time.perf_counter() > limit:
                break
            try:
                states = self._pass()
            except Exception as e:  # noqa: BLE001 — fails the run's check
                self.errors.append(f"engine pass: {type(e).__name__}: {e}")
                break
            self._last = states
            if self._roll_done(states):
                self._close_roll(states)
            time.sleep(0.02)
        self._stop.set()
        self._canary_stop.set()
        for t in self.threads:
            if t.ident is None:
                continue
            t.join(120.0)
            if t.is_alive():
                self.errors.append("a harness thread did not stop")
        self.mgr.wait_for_async_work(60.0)
        tr.synchronize(self.cards)

    def release(self) -> None:
        self.runner = None
        self.agents = None
        self.mgr = None

    # -- the comparison -------------------------------------------------------

    def compare(self) -> dict:
        dev = self.cards[0]
        ref = reference_training(self.canary_cfg, self.run.seed, dev,
                                 skip=self.warm_steps)
        f = self.first
        checks = training_checks(f.losses, f.grad, f.change, ref)
        b = self.battery
        want = ref_battery.expected_rows(self.gpus, b["matmul_n"],
                                         b["hbm_mib"], dev)
        row_gap = 0.0
        for rows in self.rows:
            gaps = [ref_battery.row_gap(r, w) for r, w in zip(rows, want)]
            if len(rows) != len(want) or not gaps:
                gaps = [float("inf")]
            row_gap = max(row_gap, *gaps)
        # The roll's gate is judged on a sound card; a wrong row anywhere
        # fails the run by row_gap, and every gate is then expected shut.
        failing = set() if row_gap == 0.0 else set(ref_battery.ENTRY_CHECK)
        mismatches = sum(
            ref_verdict.verdict(raw, required, self.gpus, False, failing,
                                self.max_age_s) != healthy
            for _, healthy, required, raw in self.verdicts)
        rolls = []
        for i, r in enumerate(self.rolls):
            rolls.append({**r, "max_unavailable_seen": self.samples_down[i],
                          "max_in_flight_seen": self.samples_flight[i]})
        faults = ref_engine.roll_faults(rolls, self.policy_cfg,
                                        len(self.nodes))
        errors = self.errors + self.canary_failure
        checks.update({
            "row_gap": row_gap,
            "verdict_mismatches": float(mismatches),
            "engine_faults": float(len(faults)),
            "run_errors": float(len(errors)),
        })
        bad_rolls = {int(f.split(":")[0].split()[1]) for f in faults}
        if self.rolls and self.rolls[-1]["end"] is None:
            faults.insert(0, f"roll {len(self.rolls) - 1} never ended: "
                          f"states {self._last}")
        return {"checks": checks, "attempted": len(self.rolls),
                "failed": len(bad_rolls) + (1 if errors else 0),
                "notes": [f"pace: {self.run.facts['nodes_done']} nodes in "
                          f"{self.run.facts['pace_s']:.3f} s, "
                          f"{len(self.rolls)} rolls"]
                + (errors + faults)[:5]}


def training_checks(losses: list, grad: dict, change: dict, ref: dict,
                    ) -> dict:
    """The training numbers compared: each of the three steps' loss as a
    share of the reference's, the first gradient's and the three steps'
    change by the worst leaf.  Leaves whose reference gradient is nought
    to rounding are left out of the change."""
    loss_gap = max((abs(a - b) / abs(b) for a, b in
                    zip(losses, ref["losses"])), default=float("inf"))
    if len(losses) != len(ref["losses"]) or loss_gap != loss_gap:
        loss_gap = float("inf")
    quiet = ref_canary.quiet_leaves(ref["first_grad"])
    return {
        "loss_gap": loss_gap,
        "grad_gap": ref_canary.worst_leaf_gap(grad, ref["first_grad"]),
        "change_gap": ref_canary.worst_leaf_gap(change, ref["change"], quiet),
    }
