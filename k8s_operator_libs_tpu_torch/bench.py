"""The port's end-to-end benchmark: a driver roll across an HGX H100 pool.

Run from the root of a checkout, on a machine with a CUDA card:

    python -m k8s_operator_libs_tpu_torch.bench

The headline of the JAX package's ``bench.py``, on the port's engine,
prober, agents and canary:

- **preflight**: :func:`hostenv.probe_cuda_init`.  When CUDA does not
  come up the bench prints its line with ``value`` 0.0 and ``error``
  set and exits non-zero; it never reruns on the CPU, which would hide
  the card's failure behind a number from another device;
- **battery**: ``run_host_probe`` at production size (n 4096 bf16, a
  1 GiB stream, 4 MiB all-reduce members) over one node's 8 members,
  unfused cold then warm (the TFLOPS, GB/s and bus bandwidth the floors
  gate on), then fused cold then warm (the warm-up cache's miss, then
  its hit);
- **canary**: ``CanaryRunner`` at the JAX bench's width (vocab 1024,
  d_model 1024, 16 heads, 8 layers, d_ff 4096, seq 512, batch 32) on the
  first card;
- **pool**: four HGX H100 nodes ``pool-0`` … ``pool-3`` on the port's
  ``FakeCluster`` (1 ms API latency, 50 ms read-cache lag), labelled as
  GPU Feature Discovery labels one (``nvidia.com/gpu.product``
  ``NVIDIA-H100-80GB-HBM3``, ``nvidia.com/gpu.count`` 8) and in no
  slice, so the engine makes each node its own upgrade group; a driver
  DaemonSet whose template is bumped;
- **gate**: each node's own ``HealthAgent`` over 8 members (the board's
  GPUs; ``cuda:0`` eight times on a one-card host) publishes its
  report, and ``NodeReportProber`` reads it with the H100 SXM profile's
  floors (``hbm_floor_fraction=0.5``, ``generation_floors=True``);
- **rolls**: sequential (``maxParallelUpgrades`` 1, the validation gate
  holding the slot) with the canary training on ``pool-0`` and paused
  while that node is cordoned; the attribution check (one node's missing
  report must fail that node's gate by name); then pipelined validation;
- **elastic rolls** (:func:`elastic_roll`): the bench-width canary sharded
  over the 8 members in four slices, one a node, answers the engine's
  exclusion offers through the workload coordinator (accept: dp 2 × tp
  4, dp 3 × tp 2 while a node is out), then declines them all;
- **federated roll** (:func:`federation_roll`): three member clusters of
  64 GFD-labelled nodes, one partitioned mid-roll for 20 coordinator
  ticks; host work only;
- **DCN roll** (``roll(..., dcn=True)``, the JAX bench's config 5):
  the pool as two rings (``pool-0``/``pool-1`` ``ring-a``, ``pool-2``/
  ``pool-3`` ``ring-b``, by ``nvidia.com/gpu-dcn-group``), two upgrades
  at a time under a 50 % budget with anti-affinity, the canary as
  ring-a's data-parallel pair (paused while either node is cordoned);
  the sampler records the most nodes of one ring out at once;
- **cross-ring collective** (:func:`dcn_collective_stage`): one worker
  process a ring (``python -m k8s_operator_libs_tpu_torch.bench
  --dcn-worker``, :func:`dcn_worker`) joins a 2-rank gloo world and runs
  its node's agent with the deep probe and the DCN checks over 8
  members of the card, publishing through ``RestClient`` to a
  ``KubeApiServer``; each report is read back and gated with
  ``require_dcn_check`` set.  The two ranks share one card, where NCCL
  refuses to run, so the world is gloo;
- **failure-injection roll** (:func:`failure_injection_roll`): one
  node's agent killed and its report withdrawn (the gate fails it by
  name within the 30 s timeout, a stuck event names it, it recovers
  when the agent returns), one node NotReady in flight (quarantined,
  rejoined), a workload pod stuck behind a finalizer (the eviction
  ladder clears it) and the engine killed and rebuilt mid-drain;
- **heterogeneous stage** (:func:`heterogeneous_roll`): three pools of
  two nodes (H100 PCIe, SXM, NVL by ``nvidia.com/gpu.product``) under a
  serial budget, the NVL pool behind a closed maintenance window: oldest
  generation first, nothing of the held pool moves while it is closed;
  host work only.

Headline: the canary's longest gap between steps during the sequential
roll, against the 120 s budget; when the roll did not complete, or
``pool-0`` is still out at the end, the open interval since its last
step counts.  ``vs_baseline`` is 120 / value, and 0.0 when the roll did
not complete.

One card stands in for the pool, so the canary and every node's agent
share it.  So that neither measures the other's contention, the
canary's steps and the agents' batteries take one lock in turn; the
part of the canary's longest gap spent waiting on it is recorded beside
the downtime (on a fleet each node has its own GPUs and nothing waits).

Output: one JSON line of at most 2 KB on stdout (:mod:`.bench_io`), the
full record in ``build/bench_torch/details.json``, progress on stderr.
The exit code is 0 only when the sequential roll completed with its
attribution check, the controller roll completed and every guard pin
held.

- **controller roll** (:func:`controller_roll`): the operator's own loop
  on a mixed pool of four GFD-labelled nodes (the port's
  ``UpgradeController`` owning both DaemonSets, its metrics served over
  HTTP, the status CLI's gather); admission PCIe, SXM, SXM, NVL;
- **guard stages** (:func:`guard_stages`): every stage of
  :mod:`.bench_guard` (cached, sharded, write hygiene, planner, packed
  admission, tracing, telemetry, multi-artifact, the fused battery and
  its async gate over the 8 members), the tracing stage's timed rolls
  each in a child, the 100,000-node stage last, in a child as well.
"""

from __future__ import annotations

import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from collections import Counter
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional, Sequence

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    ElasticCoordinationSpec,
    EvictionEscalationSpec,
    FederationCanarySpec,
    FederationClusterSpec,
    FederationSpec,
    IntOrString,
    SliceHealthGateSpec,
    SliceQuarantineSpec,
    TPUUpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.api.v1alpha1 import (
    MaintenanceWindowSpec,
    PoolSpec,
)
from k8s_operator_libs_tpu_torch.bench_fleet import (
    GPU_NAMESPACE,
    GPUS_PER_NODE,
    GpuFleet,
)
from k8s_operator_libs_tpu_torch import bench_guard
from k8s_operator_libs_tpu_torch.bench_io import emit
from k8s_operator_libs_tpu_torch.coordination import (
    RunnerElasticRuntime,
    WorkloadCoordinator,
)
from k8s_operator_libs_tpu_torch.controller import (
    ControllerConfig,
    UpgradeController,
)
from k8s_operator_libs_tpu_torch.driver import (
    AgentDaemonSetSpec,
    DriverDaemonSetSpec,
)
from k8s_operator_libs_tpu_torch.driver.daemonset import (
    TEMPLATE_HASH_ANNOTATION,
)
from k8s_operator_libs_tpu_torch.entry import members_of
from k8s_operator_libs_tpu_torch.federation import (
    ClusterRegistry,
    FederationCoordinator,
    FederationStateStore,
    ensure_federation_kind,
)
from k8s_operator_libs_tpu_torch.federation.coordinator import (
    PHASE_DONE,
    PHASE_PROMOTED,
)
from k8s_operator_libs_tpu_torch.health import NodeReportProber, run_host_probe
from k8s_operator_libs_tpu_torch.health.agent import (
    HealthAgent,
    csv_env,
    maybe_initialize_distributed,
)
from k8s_operator_libs_tpu_torch.health.fused import battery_stats
from k8s_operator_libs_tpu_torch.health.report import fused_battery_telemetry
from k8s_operator_libs_tpu_torch.fleet.profiles import GPU_PRODUCT_LABELS
from k8s_operator_libs_tpu_torch.hostenv import cpu_child_env, probe_cuda_init
from k8s_operator_libs_tpu_torch.keys import (
    CONTROLLER_NAME,
    DRIVER_LABELS,
    DRIVER_NAME_ENV,
    driver_keys,
    keys_from_env,
)
from k8s_operator_libs_tpu_torch.k8s import (
    FakeCluster,
    KubeApiServer,
    KubeConfig,
    NotFoundError,
    RestClient,
)
from k8s_operator_libs_tpu_torch.k8s.faults import FaultSchedule
from k8s_operator_libs_tpu_torch.k8s.leader import (
    LEASE_GROUP,
    LEASE_PLURAL,
    LEASE_VERSION,
    LeaderElector,
)
from k8s_operator_libs_tpu_torch.k8s.retry import (
    CircuitBreaker,
    ResilientClient,
    RetryPolicy,
)
from k8s_operator_libs_tpu_torch.kernels import (
    launch_counts,
    reset_launch_counts,
)
from k8s_operator_libs_tpu_torch.metrics import MetricsServer
from k8s_operator_libs_tpu_torch.status import gather
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    EventRecorder,
    ProbeResult,
)
from k8s_operator_libs_tpu_torch.upgrade.types import (
    NodeUpgradeState,
    UpgradeGroup,
)
from k8s_operator_libs_tpu_torch.workloads.canary import (
    CanaryConfig,
    CanaryRunner,
    ElasticCanaryRunner,
)

DOWNTIME_BUDGET_S = 120.0  # the north star: under 2 min of interruption
N_NODES = 4
# The DCN roll's rings (the JAX bench's config 5): pool-0 and pool-1 back
# one data-parallel job, pool-2 and pool-3 another.  Its canary is
# ring-a's pair: a step needs both nodes.
DCN_RINGS = ("ring-a", "ring-a", "ring-b", "ring-b")
DCN_CANARY_NODES = (0, 1)
# Per-roll watchdog.  The gate's timeout sits well below it, so a gate
# that never passes ends the roll as upgrade-failed inside the window.
ROLL_BUDGET_S = 240.0
VALIDATION_TIMEOUT_S = 90
PREFLIGHT_TIMEOUT_S = 120.0
METRIC_NAME = (
    "torch workload downtime during node-atomic driver rolling upgrade "
    "(4-node HGX H100 pool, real probe gate)"
)
DETAILS_PATH = (
    Path(__file__).resolve().parents[1] / "build" / "bench_torch"
    / "details.json"
)
# The NVIDIA GPU operator's keys ("nvidia.com/gpu-driver-upgrade-state").
KEYS = driver_keys()
NAMESPACE = GPU_NAMESPACE
# The JAX bench's canary (bench.py:1177-1180): 102,777,856 parameters.
BENCH_CANARY = CanaryConfig(
    vocab=1024, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
    seq_len=512, batch=32,
)


@dataclass(frozen=True)
class BatterySize:
    """The problem sizes of one agent battery."""

    matmul_n: int
    hbm_mib: int
    allreduce_elems: int


# The JAX bench's agent sizes: a node in flight probes with the 1 GiB
# production stream, long enough to average over a co-tenant; the
# background refresh keeps the stream and shrinks the matmul and the
# all-reduce.
IN_FLIGHT = BatterySize(1024, 1024, 1 << 16)
BACKGROUND = BatterySize(256, 1024, 1 << 12)
# A bounded sustained window: a 50 %-of-spec verdict needs no deep
# escalation, and a long battery would stall the canary on the shared
# card.
AGENT_MAX_ITERS = 256
# The states in which a node is in flight (queued nodes sit at
# upgrade-required and refresh in the background).
ACTIVE_STATES = frozenset({
    "cordon-required", "wait-for-jobs-required", "pod-deletion-required",
    "drain-required", "pod-restart-required", "validation-required",
})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _fleet(client: FakeCluster) -> GpuFleet:
    """The bench's fleet: GFD-labelled nodes and the GPU operator's
    driver DaemonSet, on the bench's keys and namespace."""
    return GpuFleet(client, KEYS, NAMESPACE)


def longest_gap(step_times: Sequence[float], window_start: float,
                until: Optional[float] = None) -> tuple[float, int]:
    """``(seconds, index)``: the longest interval between the window's
    start and the completed steps, each to the next, and the index of the
    step that closed it.  With ``until`` (the roll did not complete, or
    the workload is still disrupted) the open interval since the last
    step counts too, with index -1."""
    gap, index, last = 0.0, -1, window_start
    for i, t in enumerate(step_times):
        if t - last > gap:
            gap, index = t - last, i
        last = t
    if until is not None and until - last > gap:
        return until - last, -1
    return gap, index


class RollHarness:
    """One fresh cluster, engine and agent fleet for one roll.

    ``members``: the devices of one node's board, on which every node's
    agent runs its battery; ``device_lock``: taken around each battery
    (and by the canary around each step).  With ``dcn`` the nodes are
    two DCN rings (``pool-0``/``pool-1`` ``ring-a``, ``pool-2``/
    ``pool-3`` ``ring-b``, by ``KEYS.dcn_group_label``) and two nodes may
    be in flight, anti-affinity keeping them in different rings;
    ``event_recorder`` receives the engine's events."""

    def __init__(
        self,
        members: Sequence,
        pipeline: bool,
        device_lock: threading.Lock,
        sizes: tuple[BatterySize, BatterySize] = (IN_FLIGHT, BACKGROUND),
        dcn: bool = False,
        event_recorder: Optional[EventRecorder] = None,
    ) -> None:
        self.lock = device_lock
        self.in_flight_size, self.background_size = sizes
        self.dcn = dcn
        self.event_recorder = event_recorder
        self.cluster = FakeCluster(api_latency_s=0.001, cache_lag_s=0.05)
        self.fleet = _fleet(self.cluster)
        ds = self.fleet.driver_daemon_set("v1", 1)
        self.nodes = [
            self.fleet.gpu_node(
                f"pool-{i}",
                labels={KEYS.dcn_group_label: DCN_RINGS[i]} if dcn else None,
            )
            for i in range(N_NODES)
        ]
        for node in self.nodes:
            self.fleet.driver_pod(node, ds, "v1")
        self.fleet.bump_daemon_set_template(ds, "v2", 2)
        self.fleet.auto_recreate_driver_pods(ds, "v2")
        # The engine's liveness fence, flipped dark by crash_controller().
        self._alive = {"up": True}
        self.mgr = self._new_manager()
        self.prober = NodeReportProber(
            KEYS,
            revision_resolver=(
                self.mgr.pod_manager.get_daemonset_controller_revision_hash
            ),
            hbm_floor_fraction=0.5,
            generation_floors=True,
        )
        self.mgr.with_validation_enabled(self.prober)
        self._needs_adoption = False
        self.controller_kills = 0
        self.last_adopt_summary: dict = {}
        self.policy = TPUUpgradePolicySpec(
            auto_upgrade=True,
            # Two rings of two: two nodes in flight, of different rings;
            # the budget must allow two too, or the rings would roll one
            # node at a time and the anti-affinity would go untested.
            max_parallel_upgrades=2 if dcn else 1,
            **({"max_unavailable": IntOrString("50%")} if dcn else {}),
            drain_spec=DrainSpec(enable=True, timeout_second=30),
            health_gate=SliceHealthGateSpec(
                enable=True, timeout_second=VALIDATION_TIMEOUT_S
            ),
            pipeline_validation=pipeline,
            dcn_anti_affinity=True,
        )
        # Every node's own agent over the board's members.
        self.agents = [
            HealthAgent(self.cluster, node.name, KEYS, driver_revision="v2",
                        devices=list(members), max_iters=AGENT_MAX_ITERS)
            for node in self.nodes
        ]
        # Nodes whose agent has been killed: the agent loop skips them.
        self.dead_hosts: set[str] = set()
        # (node, in flight, seconds) of every battery run.
        self.batteries: list[tuple[str, bool, float]] = []
        self._stop = threading.Event()
        self.max_concurrent_unavailable = 0
        # Most nodes of one ring out at once (dcn): anti-affinity holds
        # it at 1.
        self.max_ring_unavailable = 0

    def _new_manager(self) -> ClusterUpgradeStateManager:
        mgr = ClusterUpgradeStateManager(
            self.cluster, keys=KEYS, event_recorder=self.event_recorder,
            poll_interval_s=0.02, poll_timeout_s=5.0,
        )
        mgr.fence = lambda a=self._alive: a["up"]
        return mgr

    # -- the engine's crash and rebuild --------------------------------------

    def crash_controller(self) -> None:
        """Kill the engine as a SIGKILL would: fence the old manager dark
        (its drain and eviction workers abandon their work), join them,
        then stand up a new manager on the same cluster and prober.
        :meth:`run` re-adopts the durable annotations on its next pass,
        so the eviction ladder resumes at its persisted rung.  The roll's
        quarantine and rejoin totals carry across."""
        self._alive["up"] = False
        self.mgr.wait_for_async_work(60.0)
        old = self.mgr
        self._alive = {"up": True}
        self.controller_kills += 1
        self.mgr = self._new_manager()
        self.mgr.with_validation_enabled(self.prober)
        self.mgr.recovery_probe_backoff_s = old.recovery_probe_backoff_s
        self.mgr.quarantines_total += old.quarantines_total
        self.mgr.rejoins_total += old.rejoins_total
        self._needs_adoption = True

    # -- the agents --------------------------------------------------------

    def run_agent(self, agent: HealthAgent, in_flight: bool) -> None:
        size = self.in_flight_size if in_flight else self.background_size
        agent.matmul_n = size.matmul_n
        agent.hbm_mib = size.hbm_mib
        agent.allreduce_elems = size.allreduce_elems
        with self.lock:
            if agent.node_name in self.dead_hosts:
                return
            t0 = time.monotonic()
            agent.run_once()
            self.batteries.append(
                (agent.node_name, in_flight, time.monotonic() - t0)
            )

    def kill_agent(self, name: str) -> None:
        """The agent of node ``name`` dies: it runs no battery from now
        on, and its report is withdrawn.  Under the device lock, so that a
        battery already under way publishes before the withdrawal."""
        with self.lock:
            self.dead_hosts.add(name)
            self.cluster.patch_node_annotations(
                name, {KEYS.health_report_annotation: None}
            )

    def sweep_agents_once(self) -> None:
        for agent in self.agents:
            self.run_agent(agent, in_flight=False)

    def _agent_loop(self) -> None:
        # A node in flight re-probes every cycle, as its own idle board
        # would; the others refresh in turn with the background battery.
        # A killed agent runs nothing.
        background = 0
        while not self._stop.is_set():
            states = self.node_states()
            in_flight = [a for a in self.agents
                         if states.get(a.node_name, "") in ACTIVE_STATES
                         and a.node_name not in self.dead_hosts]
            for agent in in_flight:
                if self._stop.is_set():
                    return
                self.run_agent(agent, in_flight=True)
            agent = self.agents[background % len(self.agents)]
            background += 1
            if (agent not in in_flight and not self._stop.is_set()
                    and agent.node_name not in self.dead_hosts):
                self.run_agent(agent, in_flight=False)
            time.sleep(0.05)

    # -- unavailability ----------------------------------------------------

    def node_disrupted(self, index: int) -> bool:
        try:
            return self.cluster.get_node(
                self.nodes[index].name, cached=False
            ).spec.unschedulable
        except NotFoundError:
            return True

    def _sampler_loop(self) -> None:
        while not self._stop.is_set():
            down = [self.node_disrupted(i) for i in range(N_NODES)]
            self.max_concurrent_unavailable = max(
                self.max_concurrent_unavailable, sum(down)
            )
            if self.dcn:
                per_ring = Counter(
                    ring for ring, out in zip(DCN_RINGS, down) if out
                )
                self.max_ring_unavailable = max(
                    self.max_ring_unavailable, *per_ring.values(), 0
                )
            time.sleep(0.02)

    def node_states(self) -> dict[str, str]:
        return {
            n.name: self.cluster.get_node(n.name, cached=False).labels.get(
                KEYS.state_label, ""
            )
            for n in self.nodes
        }

    # -- the attribution check ---------------------------------------------

    def attribution_check(self) -> dict:
        """Remove ``pool-1``'s report: the gate of its group must fail and
        name that node.  The report is restored afterwards."""
        victim = self.nodes[1].name
        self.cluster.patch_node_annotations(
            victim, {KEYS.health_report_annotation: None}
        )
        # The engine reads through the lagged cache: let the removal show.
        time.sleep(0.2)
        state = self.mgr.build_state(NAMESPACE, DRIVER_LABELS)
        group = next(g for g in state.all_groups()
                     if victim in (n.name for n in g.nodes))
        verdict = self.prober.probe(group)
        self.run_agent(self.agents[1], in_flight=False)
        return {"ok": (not verdict.healthy) and victim in verdict.detail,
                "victim": victim, "detail": verdict.detail}

    # -- the roll ------------------------------------------------------------

    def run(self, on_tick=None) -> dict:
        """One roll, to every node ``upgrade-done`` or ``ROLL_BUDGET_S``.
        ``on_tick(states, t)``, when given, runs after every pass with
        the nodes' states and the seconds since the roll began (the
        failure-injection roll injects its faults there)."""
        threads = [
            threading.Thread(target=self._agent_loop, daemon=True),
            threading.Thread(target=self._sampler_loop, daemon=True),
        ]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        ticks = 0
        done = False
        last: dict[str, str] = {}
        transitions: list[tuple[float, str, str]] = []
        try:
            while time.monotonic() - t0 < ROLL_BUDGET_S:
                ticks += 1
                try:
                    state = self.mgr.build_state(NAMESPACE, DRIVER_LABELS)
                except NotFoundError:
                    # Cache lag on fresh objects: requeue like a reconciler.
                    time.sleep(0.05)
                    continue
                if self._needs_adoption:
                    self.last_adopt_summary = self.mgr.adopt(
                        state, identity=f"bench-{self.controller_kills}",
                        term=self.controller_kills,
                    )
                    self._needs_adoption = False
                self.mgr.apply_state(state, self.policy)
                self.mgr.wait_for_async_work(60.0)
                states = self.node_states()
                for name, s in states.items():
                    if last.get(name) != s:
                        t_rel = time.monotonic() - t0
                        transitions.append((round(t_rel, 3), name, s))
                        gate = self.mgr.validation_manager.last_rejection
                        log(f"  t={t_rel:7.2f}s {name}: -> {s or '<none>'}"
                            + (f"  [gate: {gate}]" if gate else ""))
                        last[name] = s
                if on_tick is not None:
                    on_tick(states, time.monotonic() - t0)
                if all(s == "upgrade-done" for s in states.values()):
                    done = True
                    break
                time.sleep(0.02)
        finally:
            wall_s = time.monotonic() - t0
            self._stop.set()
            # A leaked agent would keep using the card after the roll.
            for t in threads:
                t.join(120.0)
                if t.is_alive():
                    raise RuntimeError(
                        "a harness thread did not stop; what follows would "
                        "measure its contention"
                    )
        result = {
            "complete": done,
            "wall_s": wall_s,
            "ticks": ticks,
            "max_concurrent_unavailable": self.max_concurrent_unavailable,
            **({"max_ring_unavailable": self.max_ring_unavailable}
               if self.dcn else {}),
            "node_windows_s": node_windows(transitions),
            "transitions": transitions,
            "batteries": len(self.batteries),
            "battery_s": sum(s for _, _, s in self.batteries),
        }
        if not done:
            result["final_states"] = self.node_states()
        return result


def node_windows(transitions) -> dict[str, Optional[float]]:
    """Each node's seconds in flight: from its first in-flight state to
    ``upgrade-done`` (None when it never got there)."""
    start: dict[str, float] = {}
    out: dict[str, Optional[float]] = {}
    for t, name, state in transitions:
        out.setdefault(name, None)
        if state in ACTIVE_STATES:
            start.setdefault(name, t)
        elif state == "upgrade-done" and name in start:
            out[name] = t - start[name]
    return out


def roll_with_canary(harness: RollHarness, canary: CanaryRunner,
                     canary_nodes: tuple[int, ...] = (0,)) -> dict:
    """Run ``harness``'s roll with ``canary`` training on the nodes
    ``canary_nodes`` (``pool-0`` alone: a one-node job; a ring's pair: a
    data-parallel job, whose step needs both), paused while any of them
    is cordoned; its steps take the harness's device lock.  Returns the
    roll's record with the downtime and the lock's share of it."""
    canary.reset_timing()
    waits: list[float] = []
    failure: list[str] = []
    stop = threading.Event()

    def disrupted() -> bool:
        return any(harness.node_disrupted(i) for i in canary_nodes)

    def canary_loop() -> None:
        while not stop.is_set():
            # A cordoned node cannot host the job: the step waits, and
            # that wait is the interruption a job sees.
            if disrupted():
                time.sleep(0.01)
                continue
            t0 = time.monotonic()
            with harness.lock:
                waited = time.monotonic() - t0
                try:
                    canary.run_step()
                except Exception as e:  # noqa: BLE001 — recorded below
                    failure.append(f"{type(e).__name__}: {e}")
                    return
            waits.append(waited)

    thread = threading.Thread(target=canary_loop, daemon=True)
    thread.start()
    try:
        result = harness.run()
    finally:
        stop.set()
        thread.join(120.0)
        if thread.is_alive():
            raise RuntimeError("the canary thread did not stop")
    end = time.monotonic()
    still_down = disrupted()
    downtime, closing = longest_gap(
        canary.step_times, canary.window_start,
        end if (still_down or not result["complete"] or failure) else None,
    )
    window = end - canary.window_start
    result.update(
        canary_nodes=[harness.nodes[i].name for i in canary_nodes],
        downtime_s=downtime,
        canary_steps=len(canary.step_times),
        canary_perf=canary.perf_summary(),
        canary_error=failure[0] if failure else None,
        lock={
            "reason": (
                "one card stands in for the pool: the canary and the four "
                "nodes' agents share it and take turns on one lock; on a "
                "fleet each node has its own GPUs"
            ),
            "wait_in_longest_gap_s": waits[closing] if closing >= 0 else 0.0,
            "wait_total_s": sum(waits),
            "wait_share": sum(waits) / window if window > 0 else 0.0,
        },
    )
    return result


def roll(
    members: Sequence,
    canary: CanaryRunner,
    device_lock: threading.Lock,
    pipeline: bool,
    attribution: bool,
    sizes: tuple[BatterySize, BatterySize] = (IN_FLIGHT, BACKGROUND),
    dcn: bool = False,
) -> dict:
    """A fresh pool, every agent's first report, the attribution check
    when asked, then the roll with the canary.  With ``dcn`` (the JAX
    bench's DCN roll, bench.py:1293-1309) the pool is two rings, two
    nodes roll at once, and the canary is ring-a's data-parallel pair
    (``DCN_CANARY_NODES``)."""
    harness = RollHarness(members, pipeline, device_lock, sizes, dcn=dcn)
    harness.sweep_agents_once()
    check = harness.attribution_check() if attribution else None
    if check is not None:
        log(f"attribution check: ok={check['ok']} ({check['detail']})")
    log(("dcn" if dcn else "pipelined" if pipeline else "sequential")
        + " roll:")
    result = roll_with_canary(harness, canary,
                              DCN_CANARY_NODES if dcn else (0,))
    result["attribution"] = check
    return result


# The controller roll's pool: each node's GPU Feature Discovery product,
# the names in the reverse of the profiles' order (PCIe, SXM, NVL) so
# that admission by generation and admission by name differ.
CONTROLLER_POOL = (
    ("pool-0", "NVIDIA-H100-NVL"),
    ("pool-1", "NVIDIA-H100-80GB-HBM3"),
    ("pool-2", "NVIDIA-H100-80GB-HBM3"),
    ("pool-3", "NVIDIA-H100-PCIe"),
)
CONTROLLER_MAX_PASSES = 80
_METRIC_LINE = re.compile(
    r'^tpu_operator_(fleet_nodes|nodes_by_state)\{(?:generation|state)="'
    r'([^"]*)"\} (\S+)$'
)


def _agent_env(cluster: FakeCluster, spec: AgentDaemonSetSpec) -> dict:
    """The env of the live agent DaemonSet's container."""
    ds = cluster.get_daemon_set(spec.namespace, spec.name)
    container = ds.spec.template.pod_spec["containers"][0]
    return {e["name"]: e.get("value") for e in container["env"]}


def _run_agent(cluster: FakeCluster, node: str, members: Sequence,
               size: BatterySize, env: dict) -> HealthAgent:
    """One report from ``node``'s agent, as its pod of the agent
    DaemonSet runs it: keys and revision from the DaemonSet's env."""
    agent = HealthAgent(
        cluster, node, keys_from_env(env), driver_revision=env["DRIVER_REVISION"],
        devices=list(members), matmul_n=size.matmul_n,
        hbm_mib=size.hbm_mib, allreduce_elems=size.allreduce_elems,
        max_iters=AGENT_MAX_ITERS,
    )
    agent.run_once()
    return agent


class ControllerRig:
    """A fresh ``FakeCluster`` holding :data:`CONTROLLER_POOL`, the driver
    and agent DaemonSet specs a controller owns, and the stand-ins for
    the DaemonSet controller (a ControllerRevision per driver template,
    the driver pods) and the agents: each node's ``HealthAgent`` over
    ``members`` at ``size``, with its keys and revision from the live
    agent DaemonSet's env."""

    def __init__(self, members: Sequence, size: BatterySize) -> None:
        self.cluster = FakeCluster()
        self.fleet = _fleet(self.cluster)
        self.nodes = [self.fleet.gpu_node(name, product)
                      for name, product in CONTROLLER_POOL]
        self.driver = DriverDaemonSetSpec(namespace=NAMESPACE, version="1")
        self.agent = AgentDaemonSetSpec(namespace=NAMESPACE)
        self.members, self.size = members, size
        self.batteries: list[float] = []

    def controller(self, **config) -> UpgradeController:
        """The port's ``UpgradeController`` on its default keys and
        selector, owning both DaemonSets (``generation_floors`` on, one
        upgrade at a time, drain on, the agents' gate), with ``config``
        besides."""
        controller = UpgradeController(self.cluster, ControllerConfig(
            namespace=NAMESPACE,
            policy=TPUUpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=1,
                drain_spec=DrainSpec(enable=True, timeout_second=30),
                health_gate=SliceHealthGateSpec(
                    enable=True, timeout_second=VALIDATION_TIMEOUT_S
                ),
            ),
            daemonset_spec=self.driver,
            agent_spec=self.agent,
            generation_floors=True,
            **config,
        ))
        controller.manager.provider.poll_interval_s = 0.01
        controller.manager.provider.poll_timeout_s = 5.0
        return controller

    def record_revision(self, revision: int) -> str:
        """The DaemonSet controller: a ControllerRevision of the driver
        DaemonSet's current template, named by its hash."""
        ds = self.cluster.get_daemon_set(NAMESPACE, self.driver.name)
        rev = ds.metadata.annotations[TEMPLATE_HASH_ANNOTATION][:10]
        self.fleet.bump_daemon_set_template(ds, rev, revision)
        return rev

    def node_states(self) -> dict[str, str]:
        return {n.name: self.cluster.get_node(n.name, cached=False).labels
                .get(KEYS.state_label, "") for n in self.nodes}

    def report(self, node: str) -> None:
        """One report from ``node``'s agent, its seconds recorded."""
        t0 = time.monotonic()
        _run_agent(self.cluster, node, self.members, self.size,
                   _agent_env(self.cluster, self.agent))
        self.batteries.append(time.monotonic() - t0)

    def stage(self, controller: UpgradeController) -> list[str]:
        """The roll's trigger, through ``controller``'s passes: both
        DaemonSets and the driver pods at the first revision, every
        agent's first report, then the driver spec's version bumped and
        the pods recreated at the second on deletion.  The two revisions'
        names."""
        controller.reconcile_once()          # creates both DaemonSets
        rev1 = self.record_revision(1)
        ds = self.cluster.get_daemon_set(NAMESPACE, self.driver.name)
        for node in self.nodes:
            self.fleet.driver_pod(node, ds, rev1)
        controller.reconcile_once()          # pins the agents to rev1
        for node in self.nodes:
            self.report(node.name)
        self.driver.version = "2"
        controller.reconcile_once()          # updates the driver's template
        rev2 = self.record_revision(2)
        self.fleet.auto_recreate_driver_pods(
            self.cluster.get_daemon_set(NAMESPACE, self.driver.name), rev2
        )
        return [rev1, rev2]


def controller_roll(members: Sequence, size: BatterySize = IN_FLIGHT) -> dict:
    """The port's ``UpgradeController``, on its default keys and
    selector, rolls :data:`CONTROLLER_POOL` on a ``FakeCluster``
    (:class:`ControllerRig`), one pass after another.

    Each node's agent reports once before the roll, then whenever its
    node waits at ``validation-required`` after a pass.  The roll bumps
    the driver spec's version.  After it, the controller's
    ``MetricsServer`` (a free loopback port) is scraped over HTTP and the
    status CLI's ``gather`` read."""
    rig = ControllerRig(members, size)
    cluster, nodes = rig.cluster, rig.nodes
    controller = rig.controller(interval_s=0.0)
    keys = controller.keys
    rev1, rev2 = rig.stage(controller)
    t0 = time.monotonic()
    passes = 0
    admitted: list[str] = []
    transitions: list[tuple[float, str, str]] = []
    last: dict[str, str] = {}

    def complete() -> bool:
        """Every node went through the roll and is done."""
        return (len(admitted) == len(nodes)
                and set(states.values()) == {"upgrade-done"})

    states = rig.node_states()
    while passes < CONTROLLER_MAX_PASSES and not complete():
        passes += 1
        controller.reconcile_once()
        controller.manager.wait_for_async_work(60.0)
        states = rig.node_states()
        for name, state in states.items():
            if last.get(name) != state:
                transitions.append((time.monotonic() - t0, name, state))
                last[name] = state
            if state in ACTIVE_STATES and name not in admitted:
                admitted.append(name)
        for name, state in states.items():
            if state == "validation-required":
                rig.report(name)
    wall_s = time.monotonic() - t0
    controller.reconcile_once()          # the metrics see the final states
    server = MetricsServer(controller.registry, port=0)
    server.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=10
        ) as resp:
            text = resp.read().decode()
    finally:
        server.stop()
    scraped: dict[str, dict[str, float]] = {
        "fleet_nodes": {}, "nodes_by_state": {}
    }
    for line in text.splitlines():
        m = _METRIC_LINE.match(line)
        if m:
            scraped[m.group(1)][m.group(2)] = float(m.group(3))
    status = gather(cluster, NAMESPACE, controller.config.driver_labels,
                    keys=keys)
    return {
        "complete": complete(),
        "final_states": states,
        "passes": passes,
        "wall_s": wall_s,
        "admitted": admitted,
        "transitions": transitions,
        "node_windows_s": node_windows(transitions),
        "revisions": [rev1, rev2],
        "agent_env": {k: v for k, v in _agent_env(cluster, rig.agent).items()
                      if k in (DRIVER_NAME_ENV, "DRIVER_REVISION")},
        "batteries": len(rig.batteries),
        "battery_s": sum(rig.batteries),
        "fleet_nodes": scraped["fleet_nodes"],
        "nodes_by_state": scraped["nodes_by_state"],
        "status_generations": status.get("fleet", {}).get("generations"),
        "keys": keys.state_label,
    }


# The controller's own modes (``UpgradeController.run_forever``), each
# rolling CONTROLLER_POOL with a resync far too long to help: a roll
# that completes was driven by watch events alone.
MODES_RESYNC_S = 120.0
MODES_DEBOUNCE_S = 0.02
MODES_SHARDS = 4
# A mode's roll, wall clock, before it counts as stalled.
MODES_DEADLINE_S = 60.0
# The failover mode's election, tests/test_leader.py's fast one: a 0.6 s
# term, the holder standing down 0.3 s after its last renewal, 0.03 s
# between rounds.
MODES_ELECTION = dict(lease_duration_s=0.6, renew_deadline_s=0.3,
                      retry_period_s=0.03)
# The failover mode's resync.  A leader-elected watch-mode controller
# opens its watch streams only once it leads, from a baseline taken when
# its pump thread next runs: the writes of the epoch's first pass can
# land before that baseline and wake nothing, and only the next resync
# moves the roll on (both packages' ``_watch_pump``; ROADMAP).
MODES_FAILOVER_RESYNC_S = 1.0
# An agent reports again while its node still waits at
# validation-required this long after its last report (its period).
AGENT_PERIOD_S = 1.0
# The controller's admission order of CONTROLLER_POOL: PCIe, both SXM,
# NVL (the profiles' order, then the name).
CONTROLLER_ORDER = ["pool-3", "pool-1", "pool-2", "pool-0"]


class RollWatch:
    """The agents and the observer of one event-driven roll, on a thread
    of its own.  A Node watch on the rig's cluster records each node's
    state changes in order and its cordons (``unschedulable`` set), and
    a node's agent reports when its node enters ``validation-required``,
    then each :data:`AGENT_PERIOD_S` it still waits there.  With
    ``controllers`` (leader-elected), every event and every 50 ms also
    samples the Lease's holder and how many of them believe they lead."""

    def __init__(self, rig: ControllerRig,
                 controllers: Sequence[UpgradeController] = ()) -> None:
        self.rig = rig
        self.controllers = list(controllers)
        self.admitted: list[str] = []
        self.transitions: list[tuple[float, str, str]] = []
        self.cordons: Counter = Counter()
        self.holders: list[tuple[float, str]] = []
        self.most_leading = 0
        self.first_done = threading.Event()
        self.done = threading.Event()
        self.done_at: Optional[float] = None
        self._states = rig.node_states()
        self._cordoned = {n.name: rig.cluster.get_node(
            n.name, cached=False).spec.unschedulable for n in rig.nodes}
        self._reported: dict[str, float] = {}
        self._stop = threading.Event()
        self._sub = rig.cluster.watch(["Node"])
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self.t0 = time.monotonic()
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(60.0)
        self._sub.close()

    def complete(self) -> bool:
        """Every node went through the roll and is done."""
        return (len(self.admitted) == len(self._states)
                and set(self._states.values()) == {"upgrade-done"})

    def _run(self) -> None:
        while not self._stop.is_set():
            ev = self._sub.get(timeout_s=0.05)
            if ev is not None and ev.object is not None:
                self._node(ev.object)
            self._sample_leaders()
            self._agents()

    def _node(self, node) -> None:
        name = node.name
        if name not in self._states:
            return
        state = node.labels.get(KEYS.state_label, "")
        if state != self._states[name]:
            self._states[name] = state
            self.transitions.append((time.monotonic() - self.t0, name, state))
            self._reported.pop(name, None)
            if state in ACTIVE_STATES and name not in self.admitted:
                self.admitted.append(name)
            if state == "upgrade-done":
                self.first_done.set()
            if self.complete() and not self.done.is_set():
                self.done_at = time.monotonic()
                self.done.set()
        if node.spec.unschedulable and not self._cordoned[name]:
            self.cordons[name] += 1
        self._cordoned[name] = node.spec.unschedulable

    def _agents(self) -> None:
        for name, state in self._states.items():
            if state == "validation-required" and (
                time.monotonic() - self._reported.get(name, -math.inf)
                >= AGENT_PERIOD_S
            ):
                self.rig.report(name)
                self._reported[name] = time.monotonic()

    def _sample_leaders(self) -> None:
        if not self.controllers:
            return
        self.most_leading = max(self.most_leading, sum(
            c.elector.is_leader() for c in self.controllers))
        try:
            lease = self.rig.cluster.get_custom_object(
                LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL, NAMESPACE,
                CONTROLLER_NAME)
        except NotFoundError:   # no replica has led yet
            return
        holder = lease["spec"].get("holderIdentity") or ""
        if holder and (not self.holders or self.holders[-1][1] != holder):
            self.holders.append((time.monotonic() - self.t0, holder))


def _count_passes(controller: UpgradeController) -> dict:
    """Counts ``controller``'s full and dirty passes (a dirty pass that
    falls back to a full one counts as both) and when the last ended."""
    count = {"full": 0, "dirty": 0, "last_end": time.monotonic()}
    for kind, name in (("full", "reconcile_once"),
                       ("dirty", "reconcile_dirty")):
        def counted(kind=kind, run=getattr(controller, name)):
            count[kind] += 1
            try:
                return run()
            finally:
                count["last_end"] = time.monotonic()

        setattr(controller, name, counted)
    return count


def _idle_tick(controller: UpgradeController, count: dict) -> int:
    """The pools one dirty tick walks once the roll is done and the
    controller has gone quiet (its dirty set empty, no pass for 0.2 s)."""
    sharded = controller._sharded
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and (
        sharded.queue.depth()
        or time.monotonic() - count["last_end"] < 0.2
    ):
        time.sleep(0.02)
    return sharded.tick(controller.config.policy).pools_walked


def _mode_roll(rig: ControllerRig, controllers: Sequence[UpgradeController],
               crash_leader: bool = False) -> dict:
    """``controllers``' ``run_forever`` loops roll the rig's staged pool.
    With two (leader-elected), the first leads before the second comes
    up; with ``crash_leader``, the leader stops without releasing its
    Lease once a node is done, and the standby must take over at the
    term's expiry."""
    elected = controllers[0].elector is not None
    watch = RollWatch(rig, controllers if elected else ())
    counts = [_count_passes(c) for c in controllers]
    threads = [threading.Thread(target=c.run_forever, daemon=True)
               for c in controllers]
    watch.start()
    deadline = watch.t0 + MODES_DEADLINE_S
    threads[0].start()
    for t in threads[1:]:
        while (not controllers[0].elector.is_leader()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        t.start()
    crashed = None
    if crash_leader and watch.first_done.wait(deadline - time.monotonic()):
        i = next((i for i, c in enumerate(controllers)
                  if c.elector.is_leader()), 0)
        crashed = (controllers[i].config.identity,
                   time.monotonic() - watch.t0)
        # A crash: no clean hand-over of the Lease.
        controllers[i].elector.release = lambda: None
        controllers[i].stop()
        threads[i].join(30.0)
    watch.done.wait(max(0.0, deadline - time.monotonic()))
    record = {
        "complete": watch.complete(),
        "wall_s": (watch.done_at or time.monotonic()) - watch.t0,
        "admitted": list(watch.admitted),
        "transitions": list(watch.transitions),
        "node_windows_s": node_windows(watch.transitions),
        "cordons": dict(watch.cordons),
    }
    if controllers[0]._sharded is not None and watch.complete():
        record["idle_tick_pools_walked"] = _idle_tick(controllers[0],
                                                      counts[0])
    for c in controllers:
        c.stop()
    for t in threads:
        t.join(30.0)
    watch.close()
    record["final_states"] = rig.node_states()
    record["passes"] = {c.config.identity or "controller":
                        {k: n[k] for k in ("full", "dirty")}
                        for c, n in zip(controllers, counts)}
    if elected:
        record["lease_holders"] = watch.holders
        record["most_leading_at_once"] = watch.most_leading
        record["crashed"] = crashed
    return record


def controller_modes(members: Sequence, size: BatterySize = IN_FLIGHT) -> dict:
    """The controller's own modes roll :data:`CONTROLLER_POOL`, each on a
    fresh :class:`ControllerRig` staged by a polling controller, every
    validation gated by the agents' batteries over ``members`` at
    ``size``:

    - ``dry_run``: a watch-mode controller's ``dry_run()`` plan, and the
      writes it made (0), before its roll (``watch``);
    - ``watch``: ``watch=True``, resync :data:`MODES_RESYNC_S`;
    - ``sharded``: also ``sharded=True`` over :data:`MODES_SHARDS`
      shards, then one idle dirty tick;
    - ``failover``: two leader-elected watch-mode controllers on
      :data:`MODES_ELECTION`, resync :data:`MODES_FAILOVER_RESYNC_S`;
      the leader crashes once a node is done.

    Each mode records its roll (``complete``, ``final_states``,
    ``admitted``, ``passes``, ``wall_s``) and its agents' batteries and
    seconds."""
    watched = dict(watch=True, interval_s=MODES_RESYNC_S,
                   watch_debounce_s=MODES_DEBOUNCE_S)
    modes: dict[str, dict] = {}
    fallbacks = battery_stats()["fallbacks"]

    def staged() -> ControllerRig:
        rig = ControllerRig(members, size)
        rig.stage(rig.controller(interval_s=0.0))
        return rig

    def batteries(rig: ControllerRig, record: dict) -> dict:
        record.update(batteries=len(rig.batteries),
                      battery_s=sum(rig.batteries))
        return record

    rig = staged()
    controller = rig.controller(**watched)
    writes = _writes(rig.cluster)
    plan = controller.dry_run()
    writes = _writes(rig.cluster) - writes
    nodes = {g.group_id: g.nodes for g in plan.groups}
    modes["dry_run"] = {
        "writes": writes,
        "plan_order": [n for wave in plan.waves for g in wave.group_ids
                       for n in nodes[g]],
        "plan_waves": len(plan.waves),
    }
    log("controller modes: watch")
    modes["watch"] = batteries(rig, _mode_roll(rig, [controller]))
    log("controller modes: sharded")
    rig = staged()
    modes["sharded"] = batteries(rig, _mode_roll(rig, [rig.controller(
        sharded=True, reconcile_shards=MODES_SHARDS, **watched)]))
    log("controller modes: failover")
    rig = staged()
    pair = []
    for identity in ("replica-a", "replica-b"):
        c = rig.controller(leader_elect=True, identity=identity,
                           publish_events=False, **dict(
                               watched, interval_s=MODES_FAILOVER_RESYNC_S))
        c.elector = LeaderElector(
            rig.cluster, identity=identity, namespace=NAMESPACE,
            name=c.config.lease_name, **MODES_ELECTION)
        pair.append(c)
    modes["failover"] = batteries(rig, _mode_roll(rig, pair,
                                                  crash_leader=True))
    modes["fallbacks"] = battery_stats()["fallbacks"] - fallbacks
    return modes


def controller_modes_pins(r: dict) -> dict[str, bool]:
    """Each pin of :func:`controller_modes`' record, by name: every roll
    complete and all done in :data:`CONTROLLER_ORDER`, each node cordoned
    once; the sharded roll on dirty passes and idle after; the standby
    completing the crashed leader's roll with one leader at a time; the
    dry run's plan in the order admitted, with no write; no fused
    battery fell back."""
    done = {name: "upgrade-done" for name, _ in CONTROLLER_POOL}
    pins = {}
    for mode in ("watch", "sharded", "failover"):
        m = r[mode]
        pins[f"{mode}_complete"] = (m["complete"]
                                    and m["final_states"] == done)
        pins[f"{mode}_order"] = m["admitted"] == CONTROLLER_ORDER
        pins[f"{mode}_cordoned_once"] = m["cordons"] == {
            name: 1 for name in done}
        pins[f"{mode}_passes"] = all(
            p["full"] > 0 for p in m["passes"].values())
    sharded = r["sharded"]
    pins["sharded_dirty_passes"] = all(
        p["dirty"] > 0 for p in sharded["passes"].values())
    pins["sharded_idle_walks_none"] = (
        sharded.get("idle_tick_pools_walked") == 0)
    failover = r["failover"]
    crashed = (failover["crashed"] or [None])[0]
    holders = [h for _, h in failover["lease_holders"]]
    pins["failover_crashed_leader"] = crashed == "replica-a"
    pins["failover_standby_took_over"] = holders == ["replica-a",
                                                     "replica-b"]
    pins["failover_one_leader"] = failover["most_leading_at_once"] == 1
    pins["dry_run_no_writes"] = r["dry_run"]["writes"] == 0
    pins["dry_run_order"] = (r["dry_run"]["plan_order"]
                             == r["watch"]["admitted"] == CONTROLLER_ORDER)
    pins["no_fused_fallback"] = r["fallbacks"] == 0
    return pins


# The elastic roll (the JAX package's tools/bench_guard.py:758-906): each
# of four GFD-labelled nodes is one slice of the elastic canary's members.
ELASTIC_N_SLICES = 4
ELASTIC_MAX_PASSES = 200
ELASTIC_WARMUP_STEPS = 4
ELASTIC_STEPS_PER_PASS = 3
# The JAX package's rule (bench_guard.py:134-141): a gap at the cadence of
# a step plus a resize is the job running, not an interruption, and
# downtime counts only a gap past the ceiling.  Its 0.5 s was set for a
# 32-wide canary stepping in about 5 ms on a CPU mesh.  At the bench
# width over 8 members of one NVIDIA H100 80GB HBM3 (700 W) the slowest
# step took up to 0.810 s and the slowest resize, 103 M parameters and
# two Adam states through numpy, up to 2.447 s (chip_smoke.py phases 10
# and 14, three runs): 3.257 s together.  The ceiling is about twice
# that, the spread of host-bound times across runs on the card.
ELASTIC_GAP_CEILING_S = 6.5


class PassingProber:
    """A validation prober whose every verdict passes: the elastic roll
    measures the negotiation, not the gate."""

    def probe(self, group) -> ProbeResult:
        return ProbeResult(True, "the elastic roll does not gate")


class ElasticPool:
    """The elastic roll's fleet: ``ELASTIC_N_SLICES`` GFD-labelled HGX
    nodes ``pool-0`` … in no slice (each node its own group) under a
    bumped driver DaemonSet, the JAX stage's engine and policy with a gate
    that passes, and a workload coordinator over ``runtime`` whose slice
    ids are the nodes' names, answering every offer with ``accept``."""

    def __init__(self, runtime, accept: bool) -> None:
        self.cluster = FakeCluster()
        fleet = _fleet(self.cluster)
        ds = fleet.driver_daemon_set("v1", 1)
        self.slice_ids = [f"pool-{i}" for i in range(ELASTIC_N_SLICES)]
        for sid in self.slice_ids:
            fleet.driver_pod(fleet.gpu_node(sid), ds, "v1")
        fleet.bump_daemon_set_template(ds, "v2", 2)
        fleet.auto_recreate_driver_pods(ds, "v2")
        self.mgr = ClusterUpgradeStateManager(
            self.cluster, keys=KEYS, poll_interval_s=0.005, poll_timeout_s=2.0
        )
        self.mgr.with_validation_enabled(PassingProber())
        self.policy = TPUUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("25%"),
            unavailability_unit="slice",
            drain_spec=DrainSpec(enable=True, timeout_second=5),
            elastic=ElasticCoordinationSpec(
                enable=True, offer_timeout_second=60, rejoin_timeout_second=60
            ),
        )
        self.coordinator = WorkloadCoordinator(
            self.cluster, KEYS, "bench-canary",
            {sid: [sid] for sid in self.slice_ids}, runtime,
            accept_policy=lambda sid: accept,
        )
        self.coordinator.register()

    def one_pass(self) -> None:
        """One engine pass, then one poll of the workload's coordinator."""
        self.mgr.apply_state(
            self.mgr.build_state(NAMESPACE, DRIVER_LABELS, self.policy),
            self.policy,
        )
        if not self.mgr.wait_for_async_work(10.0):
            raise RuntimeError("async upgrade work did not drain")
        self.coordinator.poll_once()

    def states(self) -> dict[str, str]:
        return {sid: self.cluster.get_node(sid).labels.get(KEYS.state_label, "")
                for sid in self.slice_ids}

    def done(self) -> bool:
        return all(s == "upgrade-done" for s in self.states().values())

    def leftover_excluded(self) -> int:
        return sum(
            self.cluster.get_node(sid).annotations.get(
                KEYS.elastic_excluded_annotation) == "true"
            for sid in self.slice_ids
        )


def elastic_roll(
    members: Sequence, accept: bool, cfg: CanaryConfig = BENCH_CANARY,
    steps_per_pass: int = ELASTIC_STEPS_PER_PASS,
) -> dict:
    """One roll of an :class:`ElasticPool` through the elastic
    negotiation, with an ``ElasticCanaryRunner`` over ``members`` (slice
    ``i``, node ``pool-i``, owns a contiguous block of them) answering the
    offers: ``accept`` excludes and rejoins every slice, otherwise every
    offer is declined and each node takes the drain path.  Each pass is
    one engine pass, one poll of the workload's coordinator, then
    ``steps_per_pass`` canary steps.

    Returns the JAX stage's record (``max_gap_s`` the canary's longest
    gap between steps, ``downtime_s`` 0.0 while it stays under
    ``ELASTIC_GAP_CEILING_S``) and, beside it, the passes, the wall, the
    parts any gap is made of (the slowest step, resize and pass's host
    time, resizes excluded), the (dp, tp) meshes the steps ran on and the
    kernels launched in the roll."""
    runner = ElasticCanaryRunner(cfg, devices=list(members),
                                 n_slices=ELASTIC_N_SLICES, seed=0)
    pool = ElasticPool(
        RunnerElasticRuntime(runner, {f"pool-{i}": i
                                      for i in range(ELASTIC_N_SLICES)}),
        accept,
    )
    for _ in range(ELASTIC_WARMUP_STEPS):  # set-up stays out of the window
        runner.run_step()
    runner.reset_timing()

    before = launch_counts()
    t0 = mark = time.monotonic()
    step_s: list[float] = []
    pass_host_s: list[float] = []
    meshes: set[tuple[int, int]] = set()
    converged = False
    passes = 0
    while passes < ELASTIC_MAX_PASSES and not converged:
        passes += 1
        resized = len(runner.resize_events)
        pool.one_pass()
        # From the last step of the pass before to this pass's first,
        # less the resizes: a gap is this, a resize and a step.
        pass_host_s.append(
            time.monotonic() - mark
            - sum(e["seconds"] for e in runner.resize_events[resized:])
        )
        for _ in range(steps_per_pass):
            s0 = time.monotonic()
            runner.run_step()
            step_s.append(runner.step_times[-1] - s0)
            meshes.add((runner.mesh.shape["dp"], runner.mesh.shape["tp"]))
        mark = runner.step_times[-1]
        converged = pool.done()
    wall_s = time.monotonic() - t0
    max_gap_s = runner.max_gap_seconds(until=time.monotonic())
    after = launch_counts()
    downtime_s = 0.0 if max_gap_s <= ELASTIC_GAP_CEILING_S else max_gap_s
    resize_s = [e["seconds"] for e in runner.resize_events]
    return {
        "variant": "accept" if accept else "decline",
        "slices": ELASTIC_N_SLICES,
        "devices": len(members),
        "physical_partition": runner.physical,
        "converged": converged,
        "downtime_s": downtime_s,
        "max_gap_s": max_gap_s,
        "median_step_s": runner.perf_summary().get("median_step_s", 0.0),
        "canary_steps": len(runner.step_times),
        "negotiations": dict(pool.mgr.elastic_negotiations),
        "resizes": dict(pool.mgr.elastic_resizes),
        "runner_resizes": len(runner.resize_events),
        "leftover_excluded": pool.leftover_excluded(),
        "gap_ceiling_s": ELASTIC_GAP_CEILING_S,
        "passes": passes,
        "steps_per_pass": steps_per_pass,
        "wall_s": wall_s,
        "slowest_step_s": max(step_s),
        "slowest_resize_s": max(resize_s, default=0.0),
        "slowest_pass_host_s": max(pass_host_s),
        "resize_events": runner.resize_events,
        "meshes": sorted(meshes),
        "launches": {k: after[k] - before[k]
                     for k in ("peer_reduce", "peer_gather")},
    }


# The federated roll (the JAX package's tools/bench_guard.py:2017-2210):
# three member clusters, one a region, cluster "b" partitioned mid-roll.
FED_N_CLUSTERS = 3
FED_NODES_PER_CLUSTER = 64
FED_PARTITION_TICKS = 20
FED_MAX_TICKS = 600
# The durable phase record's writes a roll may take (bench_guard.py:261).
FED_STORE_WRITE_CEILING = 8
_MUTATING = ("patch", "create", "update", "delete", "evict", "set_")


def _writes(cluster: FakeCluster) -> int:
    return int(sum(v for k, v in cluster.stats.items()
                   if str(k).startswith(_MUTATING)))


def federation_roll(
    n_clusters: int = FED_N_CLUSTERS,
    nodes_per_cluster: int = FED_NODES_PER_CLUSTER,
    partition_ticks: int = FED_PARTITION_TICKS,
) -> dict:
    """A federated roll over ``n_clusters`` member clusters of
    ``nodes_per_cluster`` GFD-labelled HGX H100 nodes each (in no slice,
    so each node is its own group), behind the JAX stage's resilient
    clients.  The canary region (``r1``) rolls first and promotes on a
    zero-length soak; then cluster ``b``, once mid-roll, loses its link
    (every call a server error) for ``partition_ticks`` coordinator ticks
    while the rest keeps rolling.  Returns the JAX stage's record.  No
    device work."""
    members = {}
    regions = {}
    for idx in range(n_clusters):
        name = chr(ord("a") + idx)
        regions[name] = f"r{idx + 1}"
        fake = FakeCluster()
        fleet = _fleet(fake)
        ds = fleet.driver_daemon_set("hash-1", 1)
        nodes = [fleet.gpu_node(f"{name}-s{i:02d}")
                 for i in range(nodes_per_cluster)]
        for node in nodes:
            fleet.driver_pod(node, ds, "hash-1")
        fleet.bump_daemon_set_template(ds, "hash-2", 2)
        fleet.auto_recreate_driver_pods(ds, "hash-2")
        client = ResilientClient(
            fake,
            retry_policy=RetryPolicy(max_attempts=2, base_backoff_s=0.0005,
                                     max_backoff_s=0.001, jitter=0.0),
            breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.0),
        )
        mgr = ClusterUpgradeStateManager(
            client, keys=KEYS, poll_interval_s=0.005, poll_timeout_s=2.0
        )
        members[name] = (fake, mgr, [n.name for n in nodes])

    policy = TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=16,
        max_unavailable=IntOrString("50%"),
        drain_spec=DrainSpec(enable=False),
        federation=FederationSpec(
            enable=True,
            clusters=[FederationClusterSpec(name=n, region=regions[n])
                      for n in members],
            canary=FederationCanarySpec(region="r1", soak_second=0),
            max_unavailable=IntOrString("50%"),
        ),
    )
    policy.validate()
    registry = ClusterRegistry(degraded_after=1, partitioned_after=2,
                               heal_probes=1)
    for name, (_, mgr, _) in members.items():
        registry.add(name, regions[name], mgr.client, manager=mgr)
    store_client = FakeCluster()
    ensure_federation_kind(store_client)
    store = FederationStateStore(store_client, NAMESPACE)
    coord = FederationCoordinator(
        registry, policy, NAMESPACE, DRIVER_LABELS, store,
        identity="bench-fed", term=1, async_wait_s=10.0,
    )

    def states(name: str) -> list[str]:
        fake, _, nodes = members[name]
        return [fake.get_node(n, cached=False).labels.get(KEYS.state_label,
                                                          "")
                for n in nodes]

    def cluster_done(name: str) -> bool:
        return set(states(name)) == {"upgrade-done"}

    target = members["b"][0]
    ticks = window_skips = 0
    window_writes = writes_before = partitioned_at = healed_at = -1
    b_started = False
    while ticks < FED_MAX_TICKS:
        summary = coord.tick()
        ticks += 1
        if partitioned_at < 0 and coord.phase in (PHASE_PROMOTED,
                                                  PHASE_DONE):
            # Cut the link once the other regions are really mid-roll.
            b_started = any(states("b"))
            if b_started and not cluster_done("b"):
                target.fault_schedule = FaultSchedule().server_error("")
                writes_before = _writes(target)
                partitioned_at = ticks
        elif partitioned_at > 0 and healed_at < 0:
            if "b" in (summary.get("skippedPartitioned") or []):
                window_skips += 1
            if ticks - partitioned_at >= partition_ticks:
                window_writes = _writes(target) - writes_before
                target.fault_schedule = None
                healed_at = ticks
        if coord.phase == PHASE_DONE and all(map(cluster_done, members)):
            break
    return {
        "stage": "federation",
        "clusters": n_clusters,
        "nodes_per_cluster": nodes_per_cluster,
        "nodes": n_clusters * nodes_per_cluster,
        "ticks": ticks,
        "converged": coord.phase == PHASE_DONE
        and all(map(cluster_done, members)),
        "partition_started": b_started and partitioned_at > 0,
        "partition_window_ticks": (healed_at - partitioned_at
                                   if healed_at > 0 else -1),
        "partition_window_skips": window_skips,
        "partition_window_writes": window_writes,
        "global_budget_violations": coord.global_ledger.violations,
        "global_budget_denials": coord.global_ledger.denials,
        "peak_global_unavailable": coord.global_ledger.peak_unavailable,
        "store_writes": store.writes,
        "partitions_detected": registry.stats.get("partitions", 0),
        "heals": registry.stats.get("heals", 0),
    }


# The failure-injection roll (the JAX package's bench.py:854-1053).  The
# gate's timeout is short, so the failed path lands well inside the
# roll's budget, and the stuck threshold sits under it, so the wait is
# evented before the engine gives up.
FAILINJ_VALIDATION_TIMEOUT_S = 30
FAILINJ_STUCK_THRESHOLD_S = 10
# Recovery probes are rate-limited after a rejection.
FAILINJ_RECOVERY_BACKOFF_S = 5.0
FAILINJ_QUARANTINE_DWELL_S = 1
FAILINJ_EVICT_TIMEOUT_S = 2
FAILINJ_DELETE_TIMEOUT_S = 2
# The engine stamps validation entry in whole seconds and fails the gate
# on the first pass once a whole second more than its timeout has passed
# since the stamp; the roll sees the failure at the end of a pass.  So a
# failure lands up to 1 s of stamp granularity plus about a pass after
# the timeout (30.26-30.94 s on the card, 30.62 and 31.25 s in the JAX
# bench's records); one a whole recovery backoff late is not "within" it.
FAILINJ_FAIL_SLACK_S = 2.0
STUCK_POD = "bench-stuck-finalizer"


def failure_injection_roll(
    members: Sequence,
    device_lock: threading.Lock,
    sizes: tuple[BatterySize, BatterySize] = (IN_FLIGHT, BACKGROUND),
    validation_timeout_s: int = FAILINJ_VALIDATION_TIMEOUT_S,
    stuck_threshold_s: int = FAILINJ_STUCK_THRESHOLD_S,
    recovery_backoff_s: float = FAILINJ_RECOVERY_BACKOFF_S,
    evict_timeout_s: int = FAILINJ_EVICT_TIMEOUT_S,
    delete_timeout_s: int = FAILINJ_DELETE_TIMEOUT_S,
) -> dict:
    """The failed path end to end, on the four-node pool, one node at a
    time, each fault on a whole node:

    - ``pool-1``'s agent is killed and its report withdrawn once the node
      leaves the queue: the gate rejects it by name, a stuck event names
      it before the engine gives up, and it goes ``upgrade-failed``
      within the validation timeout of its validation entry; then the
      agent returns (a fresh report) and the engine's gate-checked
      recovery brings it to ``upgrade-done``;
    - ``pool-2`` goes NotReady in flight: it is quarantined, comes back
      Ready, rejoins after the dwell and completes;
    - ``pool-3`` carries a workload pod stuck behind a finalizer, which
      the eviction ladder (evict, delete, force delete) must clear;
    - the engine is killed and rebuilt while ``pool-3`` is at
      ``drain-required``: the ticks until the rebuilt engine moves a
      node, and its ``adopt`` summary, are recorded.

    No canary runs.  Returns the JAX stage's record."""
    recorder = EventRecorder()
    harness = RollHarness(members, False, device_lock, sizes,
                          event_recorder=recorder)
    policy = harness.policy
    policy.health_gate = SliceHealthGateSpec(
        enable=True, timeout_second=validation_timeout_s
    )
    policy.stuck_threshold_second = stuck_threshold_s
    policy.slice_quarantine = SliceQuarantineSpec(
        enable=True, ready_dwell_second=FAILINJ_QUARANTINE_DWELL_S
    )
    policy.drain_spec.eviction_escalation = EvictionEscalationSpec(
        enable=True, evict_timeout_second=evict_timeout_s,
        delete_timeout_second=delete_timeout_s, allow_force_delete=True,
    )
    harness.mgr.recovery_probe_backoff_s = recovery_backoff_s
    stuck_pod = harness.fleet.workload_pod(harness.nodes[3], STUCK_POD)
    harness.cluster.set_pod_finalizers(
        stuck_pod.namespace, stuck_pod.name, ["bench/stuck"]
    )
    harness.sweep_agents_once()

    victim, q_victim, k_node = (harness.nodes[i].name for i in (1, 2, 3))
    stuck_in_gate = (f"Upgrade stuck: group {victim} has been in "
                     "'validation-required'")
    timeline: dict[str, float] = {}
    rejections: list[str] = []
    ctrl: dict = {"tick": 0, "kill_tick": None, "kill_states": None}

    def mark(key: str, t: float, msg: str) -> None:
        timeline[key] = t
        log(f"  t={t:7.2f}s fail-inject: {msg}")

    def on_tick(states: dict[str, str], t: float) -> None:
        ctrl["tick"] += 1
        # The engine is killed while pool-3's eviction ladder climbs.
        if ctrl["kill_tick"] is None:
            if states[k_node] == "drain-required":
                harness.crash_controller()
                ctrl["kill_tick"] = ctrl["tick"]
                ctrl["kill_states"] = dict(states)
                mark("t_controller_killed", t,
                     f"engine killed mid-drain of {k_node}; rebuilt")
        elif "t_controller_recovered" not in timeline:
            if states != ctrl["kill_states"]:
                ctrl["recovery_ticks"] = ctrl["tick"] - ctrl["kill_tick"]
                mark("t_controller_recovered", t,
                     f"rebuilt engine moved after {ctrl['recovery_ticks']} "
                     "tick(s)")
        # pool-2 goes NotReady in flight, then comes back.
        s2 = states[q_victim]
        if "t_node_down" not in timeline:
            if s2 in ACTIVE_STATES:
                harness.cluster.set_node_ready(q_victim, False)
                mark("t_node_down", t, f"{q_victim} NotReady (state {s2})")
        elif "t_quarantined" not in timeline:
            if s2 == "quarantined":
                harness.cluster.set_node_ready(q_victim, True)
                mark("t_quarantined", t, f"{q_victim} quarantined; Ready "
                     "again")
        elif "t_rejoined" not in timeline:
            if s2 and s2 != "quarantined":
                mark("t_rejoined", t, f"{q_victim} rejoined ({s2})")
        # pool-1's agent dies, the gate fails it, the agent returns.
        s1 = states[victim]
        rejection = harness.mgr.validation_manager.last_rejection.get(victim)
        if rejection and rejection not in rejections:
            rejections.append(rejection)
        if "t_stuck_event" not in timeline and any(
            e.message.startswith(stuck_in_gate) for e in list(recorder.events)
        ):
            mark("t_stuck_event", t, f"stuck event names {victim} in the "
                 "gate")
        if "t_agent_killed" not in timeline:
            if s1 in ACTIVE_STATES:
                harness.kill_agent(victim)
                mark("t_agent_killed", t, f"agent of {victim} killed "
                     f"(state {s1})")
        elif "t_validation_start" not in timeline:
            if s1 == "validation-required":
                timeline["t_validation_start"] = t
        elif "t_failed" not in timeline:
            if s1 == "upgrade-failed":
                timeline["t_failed"] = t
                harness.dead_hosts.discard(victim)
                harness.run_agent(harness.agents[1], in_flight=True)
                mark("t_agent_returned", t, f"agent of {victim} returned "
                     "(fresh report)")
        elif "t_recovered" not in timeline and s1 == "upgrade-done":
            mark("t_recovered", t, f"{victim} recovered")

    log("failure-injection roll:")
    result = harness.run(on_tick=on_tick)
    stuck_naming_victim = [
        e.message for e in recorder.events
        if e.message.startswith(stuck_in_gate)
    ]
    failed_within = (
        timeline["t_failed"] - timeline["t_validation_start"]
        if "t_failed" in timeline and "t_validation_start" in timeline
        else None
    )
    try:
        harness.cluster.get_pod(stuck_pod.namespace, stuck_pod.name)
        stuck_pod_cleared = False
    except NotFoundError:
        stuck_pod_cleared = True
    return {
        "complete": result["complete"],
        "wall_s": result["wall_s"],
        "victim": victim,
        "gate_rejections": rejections,
        "gate_named_victim": any(victim in r for r in rejections),
        "quarantine_victim": q_victim,
        "quarantines": harness.mgr.quarantines_total,
        "rejoins": harness.mgr.rejoins_total,
        "escalations": harness.mgr.escalation_stats.snapshot(),
        "stuck_pod_cleared": stuck_pod_cleared,
        "controller_kill": {
            "kills": harness.controller_kills,
            "kill_tick": ctrl["kill_tick"],
            "recovery_ticks": ctrl.get("recovery_ticks"),
            "adopted": harness.last_adopt_summary,
        },
        "validation_timeout_s": validation_timeout_s,
        "stuck_threshold_s": stuck_threshold_s,
        "fail_slack_s": FAILINJ_FAIL_SLACK_S,
        "timeline": timeline,
        "failed_within_s": failed_within,
        "recovered": "t_recovered" in timeline,
        "stuck_events_naming_victim": len(stuck_naming_victim),
        "stuck_event_sample": (
            stuck_naming_victim[0][:300] if stuck_naming_victim else None
        ),
        "batteries": len(harness.batteries),
        "transitions": result["transitions"],
        **({} if result["complete"]
           else {"final_states": result["final_states"]}),
    }


def failure_roll_pins(r: dict) -> dict[str, bool]:
    """Each pin of the failure-injection roll, by name: the record holds
    them all when every value is True."""
    kill = r["controller_kill"]
    timeline = r["timeline"]
    return {
        "complete": r["complete"],
        "gate_named_victim": r["gate_named_victim"],
        # Named in the gate before the engine gave up on it.
        "stuck_event_named_victim": r["stuck_events_naming_victim"] > 0
        and "t_stuck_event" in timeline and "t_failed" in timeline
        and timeline["t_stuck_event"] < timeline["t_failed"],
        "failed_within_timeout": r["failed_within_s"] is not None
        and r["failed_within_s"] <= r["validation_timeout_s"]
        + r["fail_slack_s"],
        "recovered": r["recovered"],
        "one_quarantine": r["quarantines"] == 1,
        "one_rejoin": r["rejoins"] == 1,
        "stuck_pod_cleared": r["stuck_pod_cleared"],
        "controller_recovered": kill["kills"] == 1
        and kill["recovery_ticks"] is not None,
    }


# The cross-ring collective (the JAX package's dcn_collective_stage,
# bench.py:362-467): one worker process a ring, each one GFD-labelled
# node's agent, in one gloo world.
DCN_WORKER_ARG = "--dcn-worker"
DCN_WORKER_TIMEOUT_S = 240.0
# The workers' battery (the agent's own sizes, small): the deep probe
# adds the ring attention over the members, its seq at the probe's
# default.
DCN_WORKER_SIZE = BatterySize(256, 64, 1 << 12)
# Env of a worker, besides the agent's own (NODE_NAME, DRIVER_REVISION,
# HEALTH_DEEP_PROBE, HEALTH_DCN_GROUP(S)) and torchrun's (MASTER_ADDR,
# MASTER_PORT, RANK, WORLD_SIZE).
APISERVER_ENV = "BENCH_APISERVER_HOST"
DCN_DEVICE_ENV = "BENCH_DCN_DEVICE"
DCN_SIZE_ENV = "BENCH_DCN_SIZE"
DCN_BACKEND_REASON = (
    "gloo: the two ranks share one card, and NCCL refuses two ranks on "
    "one GPU; on a fleet each ring's node has its own"
)


def dcn_worker() -> int:
    """One ring's node: join the world (gloo) from torchrun's env, run
    the node's ``HealthAgent`` (deep probe, the DCN checks) over
    ``GPUS_PER_NODE`` members of ``$BENCH_DCN_DEVICE``, publish the report
    through the API server at ``$BENCH_APISERVER_HOST``, and print one
    JSON line: the report's verdicts, the world's size and this process's
    kernel launches.  Without a card when asked for one it fails; it
    never goes on on the CPU."""
    import torch
    import torch.distributed as dist

    device = os.environ.get(DCN_DEVICE_ENV, "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        log("dcn worker: no CUDA device")
        return 3
    matmul_n, hbm_mib, allreduce_elems = (
        int(x) for x in os.environ[DCN_SIZE_ENV].split(",")
    )
    maybe_initialize_distributed(backend="gloo")
    agent = HealthAgent(
        RestClient(KubeConfig(host=os.environ[APISERVER_ENV]),
                   timeout_s=10.0),
        os.environ["NODE_NAME"], KEYS,
        driver_revision=os.environ.get("DRIVER_REVISION", ""),
        devices=members_of(GPUS_PER_NODE, device),
        matmul_n=matmul_n, hbm_mib=hbm_mib, allreduce_elems=allreduce_elems,
        deep=os.environ.get("HEALTH_DEEP_PROBE", "") == "1",
        dcn_group=os.environ.get("HEALTH_DCN_GROUP", ""),
        dcn_expected_groups=csv_env("HEALTH_DCN_GROUPS"),
        max_iters=AGENT_MAX_ITERS,
    )
    reset_launch_counts()
    report = agent.run_once()
    launches = launch_counts()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({
        "node": agent.node_name,
        "world_size": world,
        "visible_devices": report.visible_devices,
        "healthy": report.healthy,
        "checks": {c.name: c.ok for c in report.checks},
        "failed": [f"{c.name}: {c.detail}" for c in report.checks
                   if not c.ok],
        "launches": launches,
    }), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dcn_collective_stage(
    device: str = "cuda",
    size: BatterySize = DCN_WORKER_SIZE,
    timeout_s: float = DCN_WORKER_TIMEOUT_S,
    worker_cmd: Optional[Sequence[str]] = None,
) -> dict:
    """The cross-ring collective, for real: a ``FakeCluster`` holding one
    GFD-labelled node a ring (``ring-a``, ``ring-b``), served by a
    ``KubeApiServer``; one worker process a ring (:func:`dcn_worker`, or
    ``worker_cmd``) joins a 2-rank gloo world on a free loopback port
    and publishes its node's report.  Then each node's report, read back
    from the store, goes through a ``NodeReportProber`` with
    ``require_dcn_check`` set, as the engine sets it from
    ``health_gate.dcn_check``.  ``device`` "cpu" runs the workers with
    every card hidden.  A worker that fails, times out or prints no
    parseable line is recorded, never raised.  ``ok``: both rings'
    ``dcn_collective`` passed and both gates accepted."""
    rings = ["ring-a", "ring-b"]
    t0 = time.monotonic()
    store = FakeCluster()
    fleet = _fleet(store)
    nodes = [fleet.gpu_node(f"dcn-{ring}",
                            labels={KEYS.dcn_group_label: ring})
             for ring in rings]
    server = KubeApiServer(store)
    server.start()
    root = str(Path(__file__).resolve().parents[1])
    cmd = list(worker_cmd) if worker_cmd is not None else [
        sys.executable, "-m", "k8s_operator_libs_tpu_torch.bench",
        DCN_WORKER_ARG,
    ]
    port = _free_port()
    # The workers import the package from this checkout, installed or not.
    base = (cpu_child_env(prepend_pythonpath=root) if device == "cpu"
            else {**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (root, os.environ.get("PYTHONPATH")) if p)})
    verdicts: dict = {}
    procs = []
    try:
        for rank, (ring, node) in enumerate(zip(rings, nodes)):
            env = dict(base)
            env.update({
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "RANK": str(rank), "WORLD_SIZE": str(len(rings)),
                APISERVER_ENV: server.host, DCN_DEVICE_ENV: device,
                DCN_SIZE_ENV: f"{size.matmul_n},{size.hbm_mib},"
                              f"{size.allreduce_elems}",
                "NODE_NAME": node.name, "DRIVER_REVISION": "v2",
                "HEALTH_DEEP_PROBE": "1", "HEALTH_DCN_GROUP": ring,
                "HEALTH_DCN_GROUPS": ",".join(rings),
            })
            procs.append((ring, subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=root,
            )))
        deadline = time.monotonic() + timeout_s
        for ring, proc in procs:
            try:
                out, err = proc.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                verdicts[ring] = {"error": f"worker timed out after "
                                           f"{timeout_s:g} s"}
                continue
            if proc.returncode != 0:
                verdicts[ring] = {"error": f"worker rc={proc.returncode}: "
                                           f"{err[-300:]}"}
                continue
            try:
                rep = json.loads(out.strip().splitlines()[-1])
                verdicts[ring] = {
                    "dcn_collective": rep["checks"].get("dcn_collective"),
                    "healthy": rep["healthy"],
                    "failed": rep["failed"],
                    "world_size": rep["world_size"],
                    "launches": rep["launches"],
                }
            except (IndexError, ValueError, KeyError, TypeError,
                    AttributeError) as e:
                verdicts[ring] = {"error": f"unparseable worker report "
                                           f"({e!r}): {out[-200:]!r}"}
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        server.stop()
    prober = NodeReportProber(KEYS)
    prober.require_dcn_check = True
    gates = {}
    for ring, node in zip(rings, nodes):
        group = UpgradeGroup(id=node.name, members=[
            NodeUpgradeState(node=store.get_node(node.name, cached=False))
        ])
        verdict = prober.probe(group)
        gates[ring] = {"healthy": verdict.healthy, "detail": verdict.detail}
    ok = (all(v.get("dcn_collective") is True for v in verdicts.values())
          and len(verdicts) == len(rings)
          and all(g["healthy"] for g in gates.values()))
    return {
        "ok": ok,
        "device": device,
        "backend": DCN_BACKEND_REASON,
        "size": asdict(size),
        "rings": verdicts,
        "gates": gates,
        "wall_s": time.monotonic() - t0,
    }


# The heterogeneous stage (the JAX package's tools/bench_guard.py:909-
# 1057): three pools of two GFD-labelled nodes, one a generation, in the
# profiles' order PCIe, SXM, NVL, named in its reverse so that admission
# by generation and by name differ.  The NVL pool waits behind a
# maintenance window closed until the other two are done.
HET_POOLS = (
    ("h100-pcie", "NVIDIA-H100-PCIe", ("pool-4", "pool-5")),
    ("h100-sxm", "NVIDIA-H100-80GB-HBM3", ("pool-2", "pool-3")),
    ("h100-nvl", "NVIDIA-H100-NVL", ("pool-0", "pool-1")),
)
HET_HELD = "h100-nvl"
HET_MAX_TICKS = 400


def heterogeneous_roll() -> dict:
    """One policy rolls the three :data:`HET_POOLS` under a serial budget
    (one upgrade, one unit, unit ``slice``), each pool selected by its
    ``nvidia.com/gpu.product``.  The pins: admission is oldest generation
    first (PCIe, then SXM); the held pool makes no state transition and
    holds no cordon while its window is closed; once it opens the fleet
    converges.  Host work only; returns the JAX stage's record."""
    cluster = FakeCluster()
    fleet = _fleet(cluster)
    ds = fleet.driver_daemon_set("v1", 1)
    pools = {gen: [fleet.gpu_node(name, product) for name in names]
             for gen, product, names in HET_POOLS}
    for nodes in pools.values():
        for node in nodes:
            fleet.driver_pod(node, ds, "v1")
    fleet.bump_daemon_set_template(ds, "v2", 2)
    fleet.auto_recreate_driver_pods(ds, "v2")
    # A one-minute window half an hour away is closed now.
    closed_cron = f"{(time.gmtime().tm_min + 30) % 60} * * * *"
    policy = TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        max_unavailable=IntOrString(1),
        unavailability_unit="slice",
        pools=[
            PoolSpec(
                name=gen,
                node_selector={GPU_PRODUCT_LABELS[0]: product},
                maintenance_window=(MaintenanceWindowSpec(cron=closed_cron)
                                    if gen == HET_HELD else None),
            )
            for gen, product, _ in HET_POOLS
        ],
    )
    policy.validate()
    mgr = ClusterUpgradeStateManager(
        cluster, keys=KEYS, poll_interval_s=0.005, poll_timeout_s=2.0
    )
    held = {n.name for n in pools[HET_HELD]}
    held_transitions = 0
    patch = cluster.patch_node_labels

    def counting_patch(name, labels):
        nonlocal held_transitions
        if KEYS.state_label in labels and name in held:
            held_transitions += 1
        return patch(name, labels)

    cluster.patch_node_labels = counting_patch

    def pool_states(gen: str) -> set[str]:
        return {cluster.get_node(n.name, cached=False).labels.get(
            KEYS.state_label, "") for n in pools[gen]}

    settled = {"", "upgrade-required", "upgrade-done"}
    first_admit: dict[str, int] = {}
    transitions_while_closed = held_cordons_while_closed = 0
    window_opened = converged = False
    t0 = time.monotonic()
    for tick in range(HET_MAX_TICKS):
        mgr.apply_state(mgr.build_state(NAMESPACE, DRIVER_LABELS, policy),
                        policy)
        mgr.wait_for_async_work(30.0)
        states = {gen: pool_states(gen) for gen in pools}
        for gen, st in states.items():
            if st - settled and gen not in first_admit:
                first_admit[gen] = tick
        if not window_opened:
            transitions_while_closed = held_transitions
            held_cordons_while_closed += sum(
                cluster.get_node(name, cached=False).spec.unschedulable
                for name in held
            )
            if all(states[gen] == {"upgrade-done"}
                   for gen in pools if gen != HET_HELD):
                next(p for p in policy.pools
                     if p.name == HET_HELD).maintenance_window = (
                    MaintenanceWindowSpec(cron="* * * * *"))
                window_opened = True
        if all(st == {"upgrade-done"} for st in states.values()):
            converged = True
            break
    order = sorted(first_admit, key=first_admit.get)
    return {
        "stage": "heterogeneous",
        "pools": len(pools),
        "nodes": sum(len(ns) for ns in pools.values()),
        "converged": converged,
        "window_opened": window_opened,
        "ticks": tick + 1,
        "wall_s": time.monotonic() - t0,
        "first_admit_ticks": first_admit,
        "admission_order": order,
        "oldest_first": order[:2] == ["h100-pcie", "h100-sxm"],
        "held_transitions_while_closed": transitions_while_closed,
        "held_cordons_while_closed": held_cordons_while_closed,
    }


def guard_stages(members: Sequence) -> dict:
    """Every stage of :mod:`.bench_guard` in its order, the battery over
    ``members``, the 100,000-node stage last (in a child of its own).
    Each record carries its ``ok``, its ``failures`` and ``stage_s``."""
    out = {}
    for name, run in bench_guard.stages(members):
        log(f"guard: {name} starts")
        t0 = time.monotonic()
        record = run()
        record["failures"] = bench_guard.check(record)
        record["stage_s"] = time.monotonic() - t0
        log(f"guard: {name} ok={record['ok']} in {record['stage_s']:.3f} s"
            + (f": {record['failures']}" if record["failures"] else ""))
        out[name] = record
    return out


def battery_stage(members: Sequence) -> dict:
    """The production-size battery over ``members``: unfused cold and
    warm, then fused cold and warm."""
    out: dict = {"failures": {}}
    checks: list = []
    for fused in (False, True):
        for attempt in ("cold", "warm"):
            t0 = time.monotonic()
            checks = run_host_probe(members, fused=fused)
            label = f"{'fused' if fused else 'unfused'}_{attempt}"
            out[label + "_s"] = time.monotonic() - t0
            out["failures"].update(
                {f"{label}/{c.name}": c.detail for c in checks if not c.ok}
            )
            if not fused:
                out["metrics"] = {c.name: c.metrics for c in checks
                                  if c.metrics}
    # The fused warm run's telemetry: its cache hit and execute time.
    out["fused_telemetry"] = fused_battery_telemetry(checks)
    out["fused_stats"] = battery_stats()
    return out


def _num(x, nd: int):
    return round(float(x), nd) if isinstance(x, (int, float)) else None


def summarize(records: dict) -> dict:
    """The line's ``details``: the headline's context and each stage's
    pins, from the records :func:`main` gathers (``card``, ``battery``,
    ``sequential``, ``pipelined``, ``elastic``, ``federation``, ``dcn``,
    ``dcn_collective``, ``failure_injection``, ``heterogeneous``,
    ``controller``, ``guard``, ``preflight``)."""
    card, battery = records["card"], records["battery"]
    seq, pipe = records["sequential"], records["pipelined"]
    elastic, federation = records["elastic"], records["federation"]
    dcn, failinj = records["dcn"], records["failure_injection"]
    het, ctl = records["heterogeneous"], records["controller"]
    metrics = battery["metrics"]
    summary = {
        "complete": seq["complete"],
        "backend": "cuda",
        "device": card["kind"],
        "n_devices": card["count"],
        "downtime_budget_s": DOWNTIME_BUDGET_S,
        "upgrade_wall_s": _num(seq["wall_s"], 3),
        "node_windows_s": {k: _num(v, 3)
                           for k, v in seq["node_windows_s"].items()},
        "lock_wait_in_longest_gap_s": _num(
            seq["lock"]["wait_in_longest_gap_s"], 3),
        "lock_wait_share": _num(seq["lock"]["wait_share"], 4),
        "attribution_ok": seq["attribution"]["ok"],
        "attribution_victim": seq["attribution"]["victim"],
        "max_concurrent_unavailable": seq["max_concurrent_unavailable"],
        "pipelined_complete": pipe["complete"],
        "pipelined_wall_s": _num(pipe["wall_s"], 3),
        "pipelined_downtime_s": _num(pipe["downtime_s"], 3),
        "elastic_converged": elastic["accept"]["converged"],
        "elastic_max_gap_s": _num(elastic["accept"]["max_gap_s"], 3),
        "elastic_downtime_s": _num(elastic["accept"]["downtime_s"], 3),
        "elastic_decline_converged": elastic["decline"]["converged"],
        "federation_converged": federation["converged"],
        "dcn_complete": dcn["complete"],
        "dcn_ring_high_water": dcn["max_ring_unavailable"],
        "dcn_downtime_s": _num(dcn["downtime_s"], 3),
        "dcn_collective_ok": records["dcn_collective"]["ok"],
        "failinj_failed_within_s": _num(failinj["failed_within_s"], 3),
        "failinj_recovered": failinj["recovered"],
        "failinj_quarantines": failinj["quarantines"],
        "failinj_rejoins": failinj["rejoins"],
        "failinj_stuck_pod_cleared": failinj["stuck_pod_cleared"],
        "failinj_recovery_ticks":
            failinj["controller_kill"]["recovery_ticks"],
        "heterogeneous_converged": het["converged"],
        "heterogeneous_oldest_first": het["oldest_first"],
        "heterogeneous_held_transitions":
            het["held_transitions_while_closed"],
        "controller_complete": ctl["complete"],
        "controller_admitted": ctl["admitted"],
        "controller_fleet_nodes": ctl["fleet_nodes"],
        "controller_passes": ctl["passes"],
        "controller_wall_s": _num(ctl["wall_s"], 3),
        # Each guard stage: [ok, its headline number].
        "guard": {name: [r["ok"], float(f"{r[bench_guard.PINS[name][1]]:.4g}")]
                  for name, r in records["guard"].items()},
        "canary_steps": seq["canary_steps"],
        "canary_median_step_s": _num(
            seq["canary_perf"].get("median_step_s"), 4),
        "mxu_tflops": _num(metrics.get("mxu_matmul", {}).get("tflops"), 1),
        "hbm_gbps": _num(metrics.get("hbm_bandwidth", {}).get("gbps"), 1),
        "ici_busbw_gbps": _num(
            metrics.get("ici_allreduce", {}).get("busbw_gbps"), 1),
        "fused_warm_cache_hit":
            battery["fused_telemetry"].get("battery_cache_hit") == 1.0,
        "battery_failures": len(battery["failures"]),
        "preflight_s": _num(records["preflight"]["seconds"], 3),
    }
    if seq["canary_error"]:
        summary["error"] = f"canary: {seq['canary_error']}"
    return summary


def main() -> int:
    preflight = probe_cuda_init(PREFLIGHT_TIMEOUT_S)
    log(f"preflight: {preflight}")
    if not preflight["ok"]:
        emit(METRIC_NAME, 0.0, "s", 0.0, {
            "complete": False,
            "error": f"CUDA preflight failed: {preflight['error']}",
            "preflight_s": round(preflight["seconds"], 3),
        })
        return 2
    import torch

    members = members_of(GPUS_PER_NODE, "cuda")
    battery = battery_stage(members)
    log(f"battery: {battery}")
    canary = CanaryRunner(BENCH_CANARY, device=members[0])
    for _ in range(3):
        canary.run_step()  # warm-up
    lock = threading.Lock()
    seq = roll(members, canary, lock, pipeline=False, attribution=True)
    log(f"sequential roll: complete={seq['complete']} wall "
        f"{seq['wall_s']:.3f} s downtime {seq['downtime_s']:.3f} s")
    pipe = roll(members, canary, lock, pipeline=True, attribution=False)
    log(f"pipelined roll: complete={pipe['complete']} wall "
        f"{pipe['wall_s']:.3f} s downtime {pipe['downtime_s']:.3f} s")
    elastic = {}
    for accept in (True, False):
        r = elastic_roll(members, accept)
        elastic[r["variant"]] = r
        log(f"elastic roll ({r['variant']}): converged={r['converged']} "
            f"wall {r['wall_s']:.3f} s max gap {r['max_gap_s']:.3f} s "
            f"negotiations {r['negotiations']}")
    federation = federation_roll()
    log(f"federated roll: converged={federation['converged']} "
        f"{federation['ticks']} ticks")
    dcn = roll(members, canary, lock, pipeline=False, attribution=False,
               dcn=True)
    log(f"dcn roll: complete={dcn['complete']} wall {dcn['wall_s']:.3f} s "
        f"ring high-water {dcn['max_ring_unavailable']} pair downtime "
        f"{dcn['downtime_s']:.3f} s")
    collective = dcn_collective_stage()
    log(f"dcn collective: ok={collective['ok']} rings {collective['rings']} "
        f"gates {collective['gates']}")
    failinj = failure_injection_roll(members, lock)
    log(f"failure injection: pins {failure_roll_pins(failinj)} failed "
        f"within {failinj['failed_within_s']} s")
    het = heterogeneous_roll()
    log(f"heterogeneous roll: converged={het['converged']} order "
        f"{het['admission_order']}")
    ctl = controller_roll(members)
    log(f"controller roll: complete={ctl['complete']} admitted "
        f"{ctl['admitted']} in {ctl['wall_s']:.3f} s")
    guard = guard_stages(members)

    card = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    records = {
        "card": card, "battery": battery, "sequential": seq,
        "pipelined": pipe, "elastic": elastic, "federation": federation,
        "dcn": dcn, "dcn_collective": collective,
        "failure_injection": failinj, "heterogeneous": het,
        "controller": ctl, "guard": guard, "preflight": preflight,
    }
    details = {
        **{k: v for k, v in records.items() if k != "card"},
        "complete": seq["complete"],
        "device": card,
        "members": [str(m) for m in members],
        "canary": {"config": asdict(BENCH_CANARY),
                   "params": canary.param_count()},
        "agent_sizes": {"in_flight": asdict(IN_FLIGHT),
                        "background": asdict(BACKGROUND),
                        "max_iters": AGENT_MAX_ITERS},
        "downtime_budget_s": DOWNTIME_BUDGET_S,
        "validation_timeout_s": VALIDATION_TIMEOUT_S,
    }
    complete = seq["complete"]
    downtime = seq["downtime_s"]
    emit(
        METRIC_NAME,
        round(downtime, 3),
        "s",
        round(DOWNTIME_BUDGET_S / max(downtime, 1e-9), 2) if complete
        else 0.0,
        summarize(records),
        full_details=details,
        details_path=str(DETAILS_PATH),
    )
    guard_ok = all(r["ok"] for r in guard.values())
    return (0 if complete and seq["attribution"]["ok"] and ctl["complete"]
            and guard_ok else 1)


if __name__ == "__main__":
    if sys.argv[1:] == [DCN_WORKER_ARG]:
        sys.exit(dcn_worker())
    try:
        code = main()
    except Exception as e:  # noqa: BLE001 — the line must still land
        import traceback

        log(traceback.format_exc())
        emit(METRIC_NAME, 0.0, "s", 0.0, {
            "complete": False,
            "error": f"unhandled {type(e).__name__}: {e}"[:300],
        })
        code = 4
    sys.exit(code)
