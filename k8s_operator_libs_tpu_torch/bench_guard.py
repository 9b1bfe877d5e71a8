"""The port's regression guard: the JAX package's ``tools/bench_guard.py``
stages on the port's engine, over GPU Feature Discovery-labelled H100
fleets.

Run from the root of a checkout:

    python -m k8s_operator_libs_tpu_torch.bench_guard          # on the card
    python -m k8s_operator_libs_tpu_torch.bench_guard --cpu    # no card

Each stage is the reference stage's body, policy and pins, run on the
port's modules.  A GFD-labelled node has no slice, so the engine makes it
its own upgrade group and its own dirty-set pool: where the reference
builds ``slices`` slices of ``hosts`` hosts, a stage here builds
``slices * hosts`` GFD nodes of the same names, each its own pool (4096
pools at the sharded stage's size, 100,000 at the incremental stage's).
With ``tpu_slices=True`` a stage builds the reference stage's TPU-slice
fleet instead; the tests hold the port to the reference that way.  The
stages, in the order :func:`main` runs them and checks their pins:

1. ``cached_reconcile`` (:func:`measure`): 256 nodes through an
   ``Informer`` and a ``CachedKubeClient``; steady-state ticks cost at
   most :data:`API_PER_TICK_CEILING` API requests (true value 0);
2. ``sharded_reconcile`` (:func:`measure_sharded`): 4096 nodes, 200 idle
   ticks walk 0 pools at 0 requests, one delta walks exactly 1 pool;
3. ``write_hygiene`` (:func:`measure_write_hygiene`): a 256-node roll
   spends at most 2 node writes a transition, 50 idle sharded ticks at
   4096 nodes write nothing, a 50-event storm collapses at least 10:1;
4. ``planner`` (:func:`measure_planner`): a 4096-node plan over H100
   PCIe, SXM and NVL issues 0 writes; the digital twin's waves and
   node-to-wave assignment equal the analytic plan's;
5. ``packed_admission`` (:func:`measure_packed_admission`): always the
   reference's TPU-slice fleet (see :data:`PACKED_WHY`);
6. ``tracing`` (:func:`measure_tracing`): under 5 % p99 overhead (the
   median of five legs each, every leg in a child process of its own,
   so that every leg starts alike, which the reference's legs do not,
   a rep's two at once), one closed span tree whose
   buckets sum to the makespan, an idle traced fleet at 0 pools and 0
   writes, a trigger storm under the spool cap;
7. ``telemetry`` (:func:`measure_telemetry`): 256 nodes over the three
   H100 generations (TFLOPS and GB/s from ``hw.py``), exactly the one
   node at 0.75 of its generation's median confirmed; a roll writes as
   much with the plane attached as without;
8. ``multi_artifact`` (:func:`measure_multi_artifact`): the GPU
   operator's stack (driver, then the NIC driver, then the device
   plugin) shares one cordon and drain window a node and one budget
   charge a group;
9. ``probe_battery`` (:func:`measure_probe_battery`): the fused battery
   at production size over 8 members of the card, cold then warm, and
   the async gate for one node through ``ValidationManager`` and
   ``LocalDeviceProber``;
10. ``incremental_100k`` (:func:`measure_incremental`): 100,000 nodes,
    last, as the reference runs it (its heap would disturb the tracing
    stage's timing), and in a child process of its own, which imports
    no torch, so that its peak RSS pin reads the stage's own resident
    set (sampled: see :class:`_PeakRss`).

The count pins are the reference's.  The host-time ceilings are its
tripwires, unchanged; a time is the host's clock on the machine that
ran the stage.  The battery's two ceilings are the port's own, set from
the card's readings (see :data:`BATTERY_WARM_CEILING_S`).

:func:`main` prints each stage's record as one JSON line and exits 1 on
the first broken pin, naming it on stderr.  The port's bench and
``chip_smoke.py`` run the same stages through :func:`stages` and
:func:`check`.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    PlanningSpec,
    TPUUpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.api.v1alpha1 import (
    ArtifactDAGSpec,
    ArtifactEdgeSpec,
    ArtifactSpec,
)
from k8s_operator_libs_tpu_torch.bench_fleet import (
    DRIVER_LABELS,
    GFD_PRODUCTS,
    GPUS_PER_NODE,
    NAMESPACE,
    SXM,
    GpuFleet,
    make_node,
)
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    GPU_COUNT_LABELS,
    GPU_PRODUCT_LABELS,
)
from k8s_operator_libs_tpu_torch.hostenv import cpu_child_env
from k8s_operator_libs_tpu_torch.hw import chip_spec
from k8s_operator_libs_tpu_torch.k8s import FakeCluster
from k8s_operator_libs_tpu_torch.k8s.client import WatchEvent
from k8s_operator_libs_tpu_torch.k8s.informer import (
    CachedKubeClient,
    Informer,
)
from k8s_operator_libs_tpu_torch.k8s.objects import (
    ContainerStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
)
from k8s_operator_libs_tpu_torch.k8s.writeplan import WritePlan
from k8s_operator_libs_tpu_torch.obs.critical import analyze
from k8s_operator_libs_tpu_torch.obs.flightrec import FlightRecorder
from k8s_operator_libs_tpu_torch.obs.telemetry import (
    TelemetryPlane,
    format_ring,
    parse_ring,
)
from k8s_operator_libs_tpu_torch.obs.trace import KIND_ROLL
from k8s_operator_libs_tpu_torch.planning import plan_roll, run_twin
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    UpgradeKeys,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    GKE_TPU_ACCELERATOR_LABEL,
)
from k8s_operator_libs_tpu_torch.upgrade.sharded import (
    BudgetLedger,
    ShardedReconciler,
)

# -- the reference's sizes, pins and tripwires ------------------------------

N_SLICES = 16
HOSTS_PER_SLICE = 16
TICKS = 5
API_PER_TICK_CEILING = 0.5

SHARDED_N_SLICES = 256
SHARDED_HOSTS_PER_SLICE = 16
SHARDED_IDLE_TICKS = 200
SHARDED_IDLE_P99_CEILING_S = 0.05
SHARDED_ACTIVE_TICK_CEILING_S = 1.0

INC_N_SLICES = 6250
INC_HOSTS_PER_SLICE = 16  # 6250 x 16 = 100,000 nodes
INC_IDLE_TICKS = 50
INC_IDLE_P99_CEILING_S = 0.05
INC_ACTIVE_TICK_CEILING_S = 1.0
INC_SNAPSHOT_BUILD_CEILING_S = 0.5
INC_RSS_CEILING_MIB = 4096

WH_N_SLICES = 16
WH_HOSTS_PER_SLICE = 16
WH_WRITES_PER_TRANSITION_CEILING = 2.0
WH_IDLE_TICKS = 50
WH_EVENT_STORM = 50
WH_EVENT_COLLAPSE_FLOOR = 10.0

PLANNER_N_SLICES = 256
PLANNER_HOSTS_PER_SLICE = 16
PLAN_WALL_CEILING_S = 1.0
PLANNER_TWIN_N_SLICES = 12
PLANNER_TWIN_HOSTS = 4
# The reference's mix of TPU generations, one a slice in turn; a GFD
# fleet takes the three H100 products in turn instead.
PLANNER_TPU_GENERATIONS = (
    "tpu-v4-podslice", "tpu-v4-podslice", "tpu-v5-lite-podslice",
    "tpu-v6e-slice",
)

PACKED_N_SINGLES = 56
PACKED_N_QUADS = 50  # 56*1 + 50*4 = 256 nodes
PACKED_BUDGET_NODES = 5
PACKED_PARALLEL = 8
PACKED_TWIN_SINGLES = 4
PACKED_TWIN_QUADS = 4
PACKED_WHY = (
    "a GFD node is its own one-node group, so greedy and packed admission "
    "admit the same and the stage would pin nothing; it runs the "
    "reference's 56 one-host and 50 four-host TPU slices through the "
    "port's engine, whose topology/ keeps the reference's slice semantics"
)

TRACING_N_SLICES = 16
TRACING_HOSTS_PER_SLICE = 16
TRACING_OVERHEAD_CEILING_PCT = 5.0
TRACING_OVERHEAD_GRACE_S = 0.005
TRACING_TIMING_REPS = 5
TRACING_BUCKET_TOLERANCE_PCT = 1.0
TRACING_IDLE_TICKS = 25
TRACING_STORM_TRIGGERS = 100
TRACING_SPOOL_CAP_BYTES = 64 * 1024

TELEMETRY_N_NODES = 256
TELEMETRY_STRAGGLER_FRACTION = 0.75
TELEMETRY_ROLL_SLICES = 4
TELEMETRY_ROLL_HOSTS = 4
# The reference's generations and TFLOPS, for its TPU-slice fleet only.
TELEMETRY_TPU_GENERATIONS = (
    ("tpu-v4-podslice", "pool-v4", 240.0),
    ("tpu-v5-lite-podslice", "pool-v5e", 360.0),
    ("tpu-v6e-slice", "pool-v6e", 880.0),
)

MULTI_ART_N_SLICES = 64
MULTI_ART_HOSTS_PER_SLICE = 4
MULTI_ART_EXTRA_ARTIFACTS = 2  # NIC driver + device plugin ride the window
MULTI_ART_MAX_TICKS = 400
MULTI_ART_WRITE_VERBS = (
    "patch_node",
    "delete_pod",
    "evict_pod",
    "update_pod",
    "create_pod",
    "create_event",
    "update_daemon_set",
    "create_node",
    "delete_node",
)

# The battery at production size (``run_host_probe``'s defaults: n 4096
# bf16, a 1 GiB stream, 4 MiB all-reduce members) over one node's 8
# members; ``--cpu`` takes the reference guard's CPU sizes.
BATTERY_SIZES = dict(matmul_n=4096, hbm_mib=1024, allreduce_elems=1 << 20)
BATTERY_CPU_SIZES = dict(matmul_n=256, hbm_mib=4, allreduce_elems=1 << 14)
# The port's own ceilings (the reference's 1 s and 10 s were set for a
# CPU mesh), from the card's readings on an NVIDIA H100 80GB HBM3 at
# 700 W: the warm battery's wall through run_host_probe read
# 0.0599-0.0604 s (4x headroom), the async gate from the validation
# stamp to the healthy verdict 0.065-0.071 s (7x: a worker-thread
# handoff and 10 ms polls, on a host that may be busy).
BATTERY_WARM_CEILING_S = 0.24
VALIDATION_WALL_CEILING_S = 0.5

_WRITE_PREFIXES = ("patch", "create", "delete", "evict", "update", "post",
                   "put")


def _writes(cluster: FakeCluster) -> int:
    """The API write verbs ``cluster`` served, as the reference counts
    them."""
    return int(sum(v for k, v in cluster.stats.items()
                   if str(k).lower().startswith(_WRITE_PREFIXES)))


def _shape(tpu_slices: bool) -> str:
    return "tpu-slices" if tpu_slices else "gfd"


def _hosts(fx: GpuFleet, slice_id: str, hosts: int, tpu_slices: bool,
           state: Optional[UpgradeState] = None, product: str = SXM,
           accelerator: Optional[str] = None) -> list:
    """One TPU slice of ``hosts`` hosts (``tpu_slices``), else as many
    GFD-labelled nodes of the same names, each its own group."""
    if tpu_slices:
        kw = {"accelerator": accelerator} if accelerator else {}
        return fx.tpu_slice(slice_id, hosts=hosts, state=state, **kw)
    return fx.gpu_nodes(slice_id, hosts, state=state, product=product)


def _rolled_fleet(slices: int, hosts: int, name: str, tpu_slices: bool):
    """A rolled fleet, every node done and its driver pod at ``v1``
    (the state a controller sits in most of its life); ``name`` formats
    the slice index."""
    keys = UpgradeKeys()
    cluster = FakeCluster()
    fx = GpuFleet(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    for i in range(slices):
        for n in _hosts(fx, name.format(i), hosts, tpu_slices,
                        state=UpgradeState.DONE):
            fx.driver_pod(n, ds, hash_suffix="v1")
    return keys, cluster


def _rss_mib() -> Optional[float]:
    """This process's resident set now, MiB (``VmRSS``), or None without
    ``/proc``."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024
    except OSError:
        pass
    return None


class _PeakRss:
    """The peak of this process's resident set while the block runs,
    sampled every ``period_s`` on a thread.  Not ``ru_maxrss``: a child
    keeps its parent's resident set at the fork in it, and the kernel of
    the card's machine has no ``VmHWM``.  ``ru_maxrss`` (KiB on Linux)
    only where ``/proc`` is absent."""

    def __init__(self, period_s: float = 0.05) -> None:
        self.period_s = period_s
        self.peak_mib = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self) -> None:
        while True:
            rss = _rss_mib()
            if rss is None:
                return
            self.peak_mib = max(self.peak_mib, rss)
            if self._stop.wait(self.period_s):
                return

    def __enter__(self) -> "_PeakRss":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        rss = _rss_mib()
        self.peak_mib = (
            max(self.peak_mib, rss) if rss is not None
            else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)


def _policy(drain: bool = True) -> TPUUpgradePolicySpec:
    """The reference stages' policy: four at a time within 25 %."""
    return TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=4,
        max_unavailable=IntOrString("25%"),
        drain_spec=(DrainSpec(enable=True, timeout_second=5) if drain
                    else DrainSpec(enable=False)),
    )


def _seeded(cluster: FakeCluster, keys: UpgradeKeys, policy,
            **informer_kw):
    """An informer-backed manager and a ``ShardedReconciler`` seeded by
    one full resync.  Returns (informer, manager, reconciler, seconds of
    the informer's sync, seconds of the resync)."""
    informer = Informer(cluster, pod_namespace=NAMESPACE,
                        pod_match_labels=DRIVER_LABELS, **informer_kw)
    mgr = ClusterUpgradeStateManager(
        CachedKubeClient(cluster, informer=informer), keys=keys)
    t0 = time.monotonic()
    informer.sync()
    sync_s = time.monotonic() - t0
    sharded = ShardedReconciler(mgr, NAMESPACE, DRIVER_LABELS, shards=4)
    try:
        t0 = time.monotonic()
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        started = sharded.observe_full_state(state, policy, started=t0)
        mgr.apply_state(state, policy)
        sharded.complete_full_resync(started)
    except BaseException:
        sharded.shutdown()
        raise
    return informer, mgr, sharded, sync_s, time.monotonic() - t0


def _idle_ticks(sharded: ShardedReconciler, policy, ticks: int):
    """``ticks`` idle dirty ticks: (pools walked, p50 s, p99 s)."""
    walked = 0
    durations: list[float] = []
    for _ in range(ticks):
        report = sharded.tick(policy)
        walked += report.pools_walked
        durations.append(report.duration_s)
    durations.sort()
    return (walked, durations[len(durations) // 2],
            durations[int(len(durations) * 0.99)])


def _roll_to_done(mgr, cluster: FakeCluster, keys: UpgradeKeys, names,
                  policy, what: str, on_tick=None,
                  clock=time.monotonic) -> int:
    """Tick ``mgr`` until every node of ``names`` is done (120 s at
    most); ``on_tick(seconds)`` after each tick, read on ``clock``.
    Returns the ticks."""
    ticks = 0
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        t0 = clock()
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        mgr.apply_state(state, policy)
        if not mgr.wait_for_async_work(30.0):
            raise RuntimeError("async upgrade work did not drain")
        ticks += 1
        if on_tick is not None:
            on_tick(clock() - t0)
        if all(cluster.get_node(n, cached=False).labels.get(
                keys.state_label, "") == UpgradeState.DONE.value
               for n in names):
            return ticks
    raise RuntimeError(f"{what} did not converge inside 120 s")


# -- 1. cached reconcile -----------------------------------------------------


def measure(slices: int = N_SLICES, hosts: int = HOSTS_PER_SLICE,
            ticks: int = TICKS, tpu_slices: bool = False) -> dict:
    """Steady-state ticks of a rolled fleet through the cached client:
    the API requests a tick costs."""
    keys, cluster = _rolled_fleet(slices, hosts, "pool-{:02d}", tpu_slices)
    policy = _policy()
    informer = Informer(cluster)
    mgr = ClusterUpgradeStateManager(
        CachedKubeClient(cluster, informer=informer), keys=keys)
    sync_before = sum(cluster.stats.values())
    informer.sync()
    sync_requests = sum(cluster.stats.values()) - sync_before

    before = sum(cluster.stats.values())
    groups = 0
    for _ in range(ticks):
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        groups = len(state.all_groups())
        mgr.apply_state(state, policy)
        if not mgr.wait_for_async_work(10.0):
            raise RuntimeError("async upgrade work did not drain")
    total = sum(cluster.stats.values()) - before
    return {
        "stage": "cached_reconcile",
        "shape": _shape(tpu_slices),
        "nodes": slices * hosts,
        "groups": groups,
        "ticks": ticks,
        "sync_api_requests": sync_requests,
        "api_requests_total": total,
        "api_requests_per_tick": round(total / ticks, 3),
        "cache_hits": informer.stats["cache_hits"],
        "cache_misses": informer.stats["cache_misses"],
        "ceiling_per_tick": API_PER_TICK_CEILING,
    }


# -- 2. sharded dirty-set reconcile ------------------------------------------


def measure_sharded(slices: int = SHARDED_N_SLICES,
                    hosts: int = SHARDED_HOSTS_PER_SLICE,
                    idle_ticks: int = SHARDED_IDLE_TICKS,
                    tpu_slices: bool = False) -> dict:
    """Tick cost is O(changed): idle ticks walk no pool and send no
    request, and one node's delta walks its pool alone."""
    keys, cluster = _rolled_fleet(slices, hosts, "pool-{:03d}", tpu_slices)
    policy = _policy()
    _, _, sharded, _, seed_resync_s = _seeded(cluster, keys, policy)
    try:
        pools = len(sharded.router.pools())
        api_before = sum(cluster.stats.values())
        idle_walked, p50, p99 = _idle_ticks(sharded, policy, idle_ticks)
        idle_api = sum(cluster.stats.values()) - api_before

        node = cluster.get_node("pool-000-w0", cached=False)
        sharded.handle_event(WatchEvent("MODIFIED", "Node", node, 1))
        t0 = time.monotonic()
        report = sharded.tick(policy)
        active_tick_s = time.monotonic() - t0
        if not sharded.wait_idle(30.0):
            raise RuntimeError("sharded reconcile did not drain")
    finally:
        sharded.shutdown()
    return {
        "stage": "sharded_reconcile",
        "shape": _shape(tpu_slices),
        "nodes": slices * hosts,
        "pools": pools,
        "seed_resync_s": seed_resync_s,
        "idle_ticks": idle_ticks,
        "idle_pools_walked_total": idle_walked,
        "idle_api_requests_total": idle_api,
        "idle_p50_tick_s": p50,
        "idle_p99_tick_s": p99,
        "active_pools_walked": report.pools_walked,
        "active_tick_s": active_tick_s,
        "idle_p99_ceiling_s": SHARDED_IDLE_P99_CEILING_S,
        "active_tick_ceiling_s": SHARDED_ACTIVE_TICK_CEILING_S,
    }


# -- 3. write hygiene --------------------------------------------------------


def measure_write_hygiene(
    slices: int = WH_N_SLICES,
    hosts: int = WH_HOSTS_PER_SLICE,
    idle_slices: int = SHARDED_N_SLICES,
    idle_hosts: int = SHARDED_HOSTS_PER_SLICE,
    idle_ticks: int = WH_IDLE_TICKS,
    storm: int = WH_EVENT_STORM,
    tpu_slices: bool = False,
) -> dict:
    """The write plane's three pins: an active roll's node writes per
    state transition (coalescing), idle sharded ticks' writes
    (suppression), an identical-event storm's publishes (aggregation)."""
    # -- 1. active roll: writes per observed node state transition
    keys = UpgradeKeys()
    cluster = FakeCluster()
    fx = GpuFleet(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    nodes = []
    for i in range(slices):
        for n in _hosts(fx, f"pool-{i:02d}", hosts, tpu_slices):
            fx.driver_pod(n, ds, hash_suffix="v1")
            nodes.append(n.name)
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")
    policy = _policy()
    informer = Informer(cluster, pod_namespace=NAMESPACE,
                        pod_match_labels=DRIVER_LABELS)
    mgr = ClusterUpgradeStateManager(
        CachedKubeClient(cluster, informer=informer), keys=keys)
    informer.sync()

    def states() -> dict:
        return {name: cluster.get_node(name, cached=False).labels.get(
            keys.state_label, "") for name in nodes}

    transitions_total = node_writes_total = ticks_run = 0
    worst_ratio = 0.0
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        before_states = states()
        before_writes = int(cluster.stats.get("patch_node", 0))
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        mgr.apply_state(state, policy)
        if not mgr.wait_for_async_work(30.0):
            raise RuntimeError("async upgrade work did not drain")
        after_states = states()
        tick_writes = int(cluster.stats.get("patch_node", 0)) - before_writes
        tick_transitions = sum(1 for name in nodes
                               if after_states[name] != before_states[name])
        transitions_total += tick_transitions
        node_writes_total += tick_writes
        ticks_run += 1
        if tick_transitions:
            worst_ratio = max(worst_ratio, tick_writes / tick_transitions)
        if all(s == UpgradeState.DONE.value for s in after_states.values()):
            break
    else:
        raise RuntimeError("active roll did not converge inside 120 s")
    roll_ratio = node_writes_total / max(1, transitions_total)
    plan = getattr(mgr, "write_plan", None)
    counters = dict(plan.counters()) if plan is not None else {}

    # -- 2. sharded idle fleet: exactly zero writes per tick
    idle_keys, idle_cluster = _rolled_fleet(idle_slices, idle_hosts,
                                            "pool-{:03d}", tpu_slices)
    _, _, sharded, _, _ = _seeded(idle_cluster, idle_keys, policy)
    try:
        idle_pools = len(sharded.router.pools())
        writes_before = _writes(idle_cluster)
        for _ in range(idle_ticks):
            sharded.tick(policy)
        idle_writes = _writes(idle_cluster) - writes_before
        if not sharded.wait_idle(30.0):
            raise RuntimeError("sharded reconcile did not drain")
    finally:
        sharded.shutdown()

    # -- 3. identical-event storm collapses through the aggregator
    storm_cluster = FakeCluster()
    storm_plan = WritePlan(storm_cluster)
    event = {
        "type": "Warning",
        "reason": "UpgradeFailed",
        "message": "drain timed out",
        "involvedObject": {"kind": "Node", "name": "pool-00-w0"},
        "source": {"component": "tpu-upgrade-controller"},
    }
    for _ in range(storm):
        storm_plan.stage_event(NAMESPACE, dict(event))
        storm_plan.flush_events()
    storm_plan.flush_events(force=True)
    published = int(storm_cluster.stats.get("create_event", 0))
    return {
        "stage": "write_hygiene",
        "shape": _shape(tpu_slices),
        "nodes": slices * hosts,
        "roll_ticks": ticks_run,
        "roll_transitions": transitions_total,
        "roll_node_writes": node_writes_total,
        "roll_writes_per_transition": round(roll_ratio, 3),
        "roll_worst_tick_writes_per_transition": round(worst_ratio, 3),
        "writes_suppressed": int(counters.get("suppressed", 0)),
        "writes_coalesced_keys": int(counters.get("coalesced_keys", 0)),
        "conflict_replays": int(counters.get("conflict_replays", 0)),
        "idle_nodes": idle_slices * idle_hosts,
        "idle_pools": idle_pools,
        "idle_ticks": idle_ticks,
        "idle_writes_total": idle_writes,
        "event_storm": storm,
        "events_published": published,
        "event_collapse_ratio": round(storm / max(1, published), 1),
        "writes_per_transition_ceiling": WH_WRITES_PER_TRANSITION_CEILING,
        "event_collapse_floor": WH_EVENT_COLLAPSE_FLOOR,
    }


# -- 4. planner --------------------------------------------------------------


def measure_planner(
    slices: int = PLANNER_N_SLICES,
    hosts: int = PLANNER_HOSTS_PER_SLICE,
    twin_slices: int = PLANNER_TWIN_N_SLICES,
    twin_hosts: int = PLANNER_TWIN_HOSTS,
    tpu_slices: bool = False,
) -> dict:
    """A mixed-generation plan is fast and read-only, and the digital
    twin (the engine on a cloned cluster, virtual clock) rolls exactly
    the analytic plan's waves."""
    products = list(GFD_PRODUCTS.values())

    def mixed_fleet(n_slices: int, n_hosts: int):
        keys = UpgradeKeys()
        cluster = FakeCluster()
        fx = GpuFleet(cluster, keys)
        ds = fx.daemon_set(hash_suffix="v1", revision=1)
        for i in range(n_slices):
            for n in _hosts(
                fx, f"pool-{i:03d}", n_hosts, tpu_slices,
                state=UpgradeState.DONE,
                product=products[i % len(products)],
                accelerator=PLANNER_TPU_GENERATIONS[
                    i % len(PLANNER_TPU_GENERATIONS)],
            ):
                fx.driver_pod(n, ds, hash_suffix="v1")
        fx.bump_daemon_set_template(ds, "v2", revision=2)
        fx.auto_recreate_driver_pods(ds, "v2")
        return keys, cluster

    policy = TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=4,
        max_unavailable=IntOrString(4),
        drain_spec=DrainSpec(enable=False),
    )
    keys, cluster = mixed_fleet(slices, hosts)
    manager = ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0)
    state = manager.build_state(NAMESPACE, DRIVER_LABELS, policy)
    writes_before = _writes(cluster)
    t0 = time.perf_counter()
    plan = plan_roll(manager, state, policy)
    plan_wall_s = time.perf_counter() - t0
    plan_writes = _writes(cluster) - writes_before

    twin_keys, twin_cluster = mixed_fleet(twin_slices, twin_hosts)
    twin_policy = TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=2,
        max_unavailable=IntOrString(2),
        drain_spec=DrainSpec(enable=False),
    )
    twin_manager = ClusterUpgradeStateManager(
        twin_cluster, keys=twin_keys, poll_interval_s=0.005,
        poll_timeout_s=2.0)
    twin_state = twin_manager.build_state(NAMESPACE, DRIVER_LABELS,
                                          twin_policy)
    analytic = plan_roll(twin_manager, twin_state, twin_policy)
    twin = run_twin(twin_cluster, NAMESPACE, DRIVER_LABELS, twin_policy,
                    keys=twin_keys)
    return {
        "stage": "planner",
        "shape": _shape(tpu_slices),
        "nodes": slices * hosts,
        "pending_groups": plan.pending_groups,
        "plan_waves": plan.wave_count,
        "plan_wall_s": plan_wall_s,
        "plan_writes": plan_writes,
        "wall_ceiling_s": PLAN_WALL_CEILING_S,
        "twin_nodes": twin_slices * twin_hosts,
        "twin_converged": twin.converged,
        "analytic_waves": analytic.wave_count,
        "twin_waves": twin.wave_count,
        "node_wave_agrees": twin.node_wave == analytic.node_wave,
    }


# -- 5. packed admission -----------------------------------------------------


def measure_packed_admission(
    n_singles: int = PACKED_N_SINGLES,
    n_quads: int = PACKED_N_QUADS,
    twin_singles: int = PACKED_TWIN_SINGLES,
    twin_quads: int = PACKED_TWIN_QUADS,
) -> dict:
    """Plan-guided packing against greedy id-order admission under a
    node-unit budget of 5, analytic at 256 nodes and through the engine
    on a small fleet, always on the reference's TPU-slice fleet
    (:data:`PACKED_WHY`)."""

    def sized_fleet(singles: int, quads: int):
        keys = UpgradeKeys()
        cluster = FakeCluster()
        fx = GpuFleet(cluster, keys)
        ds = fx.daemon_set(hash_suffix="v1", revision=1)
        for i in range(singles):
            # "a-" < "b-": greedy id order tries every single first.
            for n in fx.tpu_slice(f"a-solo-{i:03d}", hosts=1,
                                  state=UpgradeState.DONE):
                fx.driver_pod(n, ds, hash_suffix="v1")
        for i in range(quads):
            for n in fx.tpu_slice(f"b-quad-{i:03d}", hosts=4,
                                  state=UpgradeState.DONE):
                fx.driver_pod(n, ds, hash_suffix="v1")
        fx.bump_daemon_set_template(ds, "v2", revision=2)
        fx.auto_recreate_driver_pods(ds, "v2")
        return keys, cluster

    def policy(mode: str) -> TPUUpgradePolicySpec:
        return TPUUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=PACKED_PARALLEL,
            max_unavailable=IntOrString(PACKED_BUDGET_NODES),
            unavailability_unit="node",
            drain_spec=DrainSpec(enable=False),
            planning=PlanningSpec(admission_mode=mode),
        )

    keys, cluster = sized_fleet(n_singles, n_quads)
    manager = ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0)
    state = manager.build_state(NAMESPACE, DRIVER_LABELS, policy("greedy"))
    writes_before = _writes(cluster)
    greedy_plan = plan_roll(manager, state, policy("greedy"))
    packed_plan = plan_roll(manager, state, policy("packed"))
    plan_writes = _writes(cluster) - writes_before

    twins = {}
    for mode in ("greedy", "packed"):
        twin_keys, twin_cluster = sized_fleet(twin_singles, twin_quads)
        twins[mode] = run_twin(twin_cluster, NAMESPACE, DRIVER_LABELS,
                               policy(mode), keys=twin_keys)
    sp_keys, sp_cluster = sized_fleet(twin_singles, twin_quads)
    sp_manager = ClusterUpgradeStateManager(
        sp_cluster, keys=sp_keys, poll_interval_s=0.005, poll_timeout_s=2.0)
    sp_state = sp_manager.build_state(NAMESPACE, DRIVER_LABELS,
                                      policy("packed"))
    small_plan = plan_roll(sp_manager, sp_state, policy("packed"))
    planned_waves = [sorted(w.group_ids) for w in small_plan.waves]
    engine_waves = [sorted(w) for w in twins["packed"].waves]
    greedy, packed = twins["greedy"], twins["packed"]
    return {
        "stage": "packed_admission",
        "shape": _shape(True),
        "why": PACKED_WHY,
        "nodes": n_singles + 4 * n_quads,
        "budget_nodes": PACKED_BUDGET_NODES,
        "greedy_waves": greedy_plan.wave_count,
        "packed_waves": packed_plan.wave_count,
        "greedy_duration_s": round(greedy_plan.projected_duration_s, 1),
        "packed_duration_s": round(packed_plan.projected_duration_s, 1),
        "plan_writes": plan_writes,
        "twin_nodes": twin_singles + 4 * twin_quads,
        "engine_greedy_converged": greedy.converged,
        "engine_packed_converged": packed.converged,
        "engine_greedy_waves": greedy.wave_count,
        "engine_packed_waves": packed.wave_count,
        "engine_greedy_duration_s": round(greedy.virtual_duration_s, 1),
        "engine_packed_duration_s": round(packed.virtual_duration_s, 1),
        "engine_packed_mode": packed.admission_mode,
        "engine_plan_wave_agrees": engine_waves == planned_waves,
        "packed_admitted": packed.admission.get("packed_admitted", 0),
        "greedy_idle_ticks": greedy.admission.get("budget_idle_ticks", 0),
        "packed_idle_ticks": packed.admission.get("budget_idle_ticks", 0),
    }


# -- 6. tracing --------------------------------------------------------------


def _p99(durations: list[float]) -> float:
    """The p99 of a roll's ticks; the first tick pays lazy imports and
    first touch."""
    samples = durations[1:] if len(durations) > 4 else durations
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]


def _median_leg(legs: list[dict]) -> dict:
    """The leg whose p99 tick is the median of ``legs``' (the lower of
    the two middle ones for an even count).  Not the least, as the
    reference takes within one process: across processes a leg's p99
    moves both ways (0.0574-0.0995 s over one run's five untraced legs
    on an H100 machine's host), so the least p99 is one leg's outlier."""
    return sorted(legs, key=lambda leg: _p99(leg["ticks"]))[
        (len(legs) - 1) // 2]


def _tracing_roll(enable_tracing: bool, slices: int, hosts: int,
                  tpu_slices: bool, clock=time.monotonic):
    """A fleet of ``slices * hosts`` nodes rolled to done with the
    recorder off or on, then two settling ticks; returns the manager and
    each tick's seconds on ``clock``."""
    # Drain off keeps the ticks CPU-bound (no async drain polls).
    policy = _policy(drain=False)
    keys = UpgradeKeys()
    cluster = FakeCluster()
    fx = GpuFleet(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    names = []
    for i in range(slices):
        for n in _hosts(fx, f"pool-{i:02d}", hosts, tpu_slices):
            fx.driver_pod(n, ds, hash_suffix="v1")
            names.append(n.name)
    fx.bump_daemon_set_template(ds, "v2", revision=2)
    fx.auto_recreate_driver_pods(ds, "v2")
    mgr = ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0,
        enable_tracing=enable_tracing)
    durations: list[float] = []
    _roll_to_done(mgr, cluster, keys, names, policy, "traced roll",
                  on_tick=durations.append, clock=clock)
    # Settling ticks: the closing maybe_end_roll runs on the apply pass
    # after the last async state flip lands.
    for _ in range(2):
        t0 = clock()
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        mgr.apply_state(state, policy)
        mgr.wait_for_async_work(10.0)
        durations.append(clock() - t0)
    return mgr, durations


def tracing_leg(enable_tracing: bool, slices: int = TRACING_N_SLICES,
                hosts: int = TRACING_HOSTS_PER_SLICE, storm: int = 0,
                tpu_slices: bool = False, cpu_ticks: bool = False) -> dict:
    """One leg of :func:`measure_tracing`: the active roll with the
    recorder off or on, each tick's seconds in ``ticks``: wall seconds,
    or with ``cpu_ticks`` the CPU seconds of the leg's process (every
    thread's, none spent waiting for a core).  A traced leg
    also reads its completed trace (the span tree, the critical-path
    buckets) and, given ``storm`` triggers, runs the black-box trigger
    storm against the spool cap with the trace as a snapshot."""
    # A one-node roll first, untimed: a process's first pass through
    # the engine's and the recorder's code pays one-time costs (5 ms in
    # one tick of a fresh process's traced roll, none in the next).
    _tracing_roll(enable_tracing, 1, 1, tpu_slices)
    # The heap before the leg parked in the permanent generation, so the
    # roll's collections scan what the roll allocates.
    gc.collect()
    gc.freeze()
    try:
        mgr, durations = _tracing_roll(
            enable_tracing, slices, hosts, tpu_slices,
            time.process_time if cpu_ticks else time.monotonic)
    finally:
        gc.unfreeze()
    out: dict = {"ticks": durations}
    if not enable_tracing:
        return out

    rec = mgr.trace_recorder
    completed = rec.last_completed() if rec is not None else None
    spans = completed.spans if completed is not None else []
    span_ids = {s.span_id for s in spans}
    roots = [s for s in spans if s.parent_id is None]
    makespan = completed.makespan if completed is not None else 0.0
    attribution = analyze(completed) if completed is not None else None
    bucket_sum = attribution.bucket_total() if attribution else 0.0
    out.update({
        "trace_completed": completed is not None,
        "trace_spans": len(spans),
        "trace_connected": (
            bool(spans) and len(roots) == 1 and roots[0].kind == KIND_ROLL
            and all(s.parent_id in span_ids for s in spans
                    if s.parent_id is not None)),
        "trace_open_spans": sum(1 for s in spans if s.open),
        "trace_drops": rec.drops if rec is not None else -1,
        "trace_groups": attribution.group_count if attribution else 0,
        "makespan_s": makespan,
        "bucket_sum_s": bucket_sum,
        "bucket_sum_error_pct": round(
            100.0 * abs(bucket_sum - makespan) / max(makespan, 1e-9)
            if completed is not None else 100.0, 4),
        "buckets": dict(attribution.buckets) if attribution else {},
    })
    if not storm:
        return out

    # -- black-box trigger storm stays under the spool byte cap
    spool_dir = tempfile.mkdtemp(prefix="bench-blackbox-")
    try:
        fr = FlightRecorder(spool_dir=spool_dir,
                            spool_cap_bytes=TRACING_SPOOL_CAP_BYTES,
                            throttle_s=0.0)
        if rec is not None:
            fr.snapshot_providers["trace"] = rec.export
        for i in range(storm):
            fr.note("delta", node=f"pool-{i % slices:02d}-w0", seq=i)
            fr.trigger("infeasible", tick=i, detail="bench trigger storm")
        out.update({
            "storm_dumps": sum(fr.dumps_total.values()),
            "spool_bytes": fr.spool_bytes(),
            "storm_spool_files": len(fr.spool_files()),
        })
    finally:
        shutil.rmtree(spool_dir, ignore_errors=True)
    return out


def measure_tracing(
    slices: int = TRACING_N_SLICES,
    hosts: int = TRACING_HOSTS_PER_SLICE,
    idle_slices: int = SHARDED_N_SLICES,
    idle_hosts: int = SHARDED_HOSTS_PER_SLICE,
    idle_ticks: int = TRACING_IDLE_TICKS,
    storm: int = TRACING_STORM_TRIGGERS,
    reps: int = TRACING_TIMING_REPS,
    tpu_slices: bool = False,
    cpu_ticks: bool = False,
) -> dict:
    """The recorder's cost on an active roll's p99 tick, the traced
    roll's span tree and attribution, an idle traced sharded fleet, and
    a black-box trigger storm against the spool cap.  The ticks are wall
    seconds; with ``cpu_ticks`` each leg's process CPU seconds
    (:func:`tracing_leg`), for a host whose other load takes the leg's
    cores for longer than the pin's grace."""
    # Repetitions, the median p99 of each leg (:func:`_median_leg`),
    # every leg (:func:`tracing_leg`) in a child interpreter of its own
    # so that every leg starts alike, and a rep's two legs at once so
    # that what else the host runs meanwhile slows both.  In one process the legs
    # do not start alike: the reference keeps the untraced leg's fleet
    # (in ``_``) through the traced leg, so its legs run beside none,
    # one or two earlier fleets, and on 256 one-node groups (45 full
    # collections in a 451-tick roll) the p99 tick is such a collection,
    # twice as long beside a fleet as alone; and a process's first roll
    # runs on a fresh heap, its ticks about a quarter shorter than those
    # of the rolls after it, so the least p99 of the leg that runs first
    # is that roll's.
    legs: dict[bool, list[dict]] = {False: [], True: []}
    for rep in range(reps):
        procs = {
            enable_tracing: _start_child(["--tracing-leg", json.dumps(dict(
                enable_tracing=enable_tracing, slices=slices, hosts=hosts,
                storm=storm if enable_tracing and rep == reps - 1 else 0,
                tpu_slices=tpu_slices, cpu_ticks=cpu_ticks))])
            for enable_tracing in (False, True)
        }
        try:
            for enable_tracing, proc in procs.items():
                legs[enable_tracing].append(_child_record(proc, 600.0))
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    ticks_off = _median_leg(legs[False])["ticks"]
    ticks_on = _median_leg(legs[True])["ticks"]
    p99_off, p99_on = _p99(ticks_off), _p99(ticks_on)
    overhead_pct = 100.0 * (p99_on - p99_off) / max(p99_off, 1e-9)
    traced = dict(legs[True][-1])
    del traced["ticks"]

    # -- idle sharded fleet with tracing on: still 0 pools, 0 writes
    policy = _policy(drain=False)
    idle_keys, idle_cluster = _rolled_fleet(idle_slices, idle_hosts,
                                            "pool-{:03d}", tpu_slices)
    informer, idle_mgr, sharded, _, _ = _seeded(idle_cluster, idle_keys,
                                                policy)
    try:
        idle_tracing_enabled = idle_mgr.trace_recorder is not None
        writes_before = _writes(idle_cluster)
        idle_walked = sum(sharded.tick(policy).pools_walked
                          for _ in range(idle_ticks))
        idle_writes = _writes(idle_cluster) - writes_before
        if not sharded.wait_idle(30.0):
            raise RuntimeError("sharded reconcile did not drain")
    finally:
        sharded.shutdown()

    return {
        "stage": "tracing",
        "shape": _shape(tpu_slices),
        "nodes": slices * hosts,
        "reps": reps,
        "leg_processes": 2 * reps,
        "tick_clock": "process cpu" if cpu_ticks else "wall",
        "roll_ticks_off": len(ticks_off),
        "roll_ticks_on": len(ticks_on),
        "p99_tick_off_s": p99_off,
        "p99_tick_on_s": p99_on,
        "leg_p99_off_s": [_p99(leg["ticks"]) for leg in legs[False]],
        "leg_p99_on_s": [_p99(leg["ticks"]) for leg in legs[True]],
        "mean_tick_off_s": sum(ticks_off) / len(ticks_off),
        "mean_tick_on_s": sum(ticks_on) / len(ticks_on),
        "overhead_pct": round(overhead_pct, 2),
        **traced,
        "idle_nodes": idle_slices * idle_hosts,
        "idle_ticks": idle_ticks,
        "idle_tracing_enabled": idle_tracing_enabled,
        "idle_pools_walked_total": idle_walked,
        "idle_writes_total": idle_writes,
        "storm_triggers": storm,
        "spool_cap_bytes": TRACING_SPOOL_CAP_BYTES,
        "overhead_ceiling_pct": TRACING_OVERHEAD_CEILING_PCT,
        "overhead_grace_s": TRACING_OVERHEAD_GRACE_S,
        "bucket_tolerance_pct": TRACING_BUCKET_TOLERANCE_PCT,
    }


# -- 7. telemetry ------------------------------------------------------------


def telemetry_generations(tpu_slices: bool = False) -> list:
    """(generation label value, pool, TFLOPS, GB/s) of the telemetry
    fleet's generations: the three H100 products with their data-sheet
    bf16 TFLOPS and HBM GB/s from ``hw.py``, or the reference's TPU
    generations and figures."""
    if tpu_slices:
        return [(gen, pool, tflops, tflops * 4.0)
                for gen, pool, tflops in TELEMETRY_TPU_GENERATIONS]
    return [(product, f"pool-{name}", chip_spec(product).bf16_tflops,
             chip_spec(product).hbm_gbps)
            for name, product in GFD_PRODUCTS.items()]


def measure_telemetry(
    n_nodes: int = TELEMETRY_N_NODES,
    roll_slices: int = TELEMETRY_ROLL_SLICES,
    roll_hosts: int = TELEMETRY_ROLL_HOSTS,
    tpu_slices: bool = False,
) -> dict:
    """Straggler verdicts on an adopted mixed-generation fleet (exactly
    the injected node confirmed), and write parity of a roll with and
    without the telemetry plane."""
    keys = UpgradeKeys()
    generations = telemetry_generations(tpu_slices)
    label = GKE_TPU_ACCELERATOR_LABEL if tpu_slices else GPU_PRODUCT_LABELS[0]

    # -- 1. verdict pins on an adopted mixed-generation fleet
    plane = TelemetryPlane()
    plane.annotation_key = keys.telemetry_history_annotation
    # Batteries already on the durable ring: one short of confirmation,
    # so the single battery after adoption decides.
    history = plane.confirm_batteries - 1

    def sample(stats: dict, scale: float) -> dict:
        out = {k: v * scale for k, v in stats.items()}
        out["battery_execute_ms"] = 40.0 / scale
        return out

    def jitter(node_idx: int, battery: int) -> float:
        # A deterministic +-0.8 % spread.
        return 1.0 + 0.004 * ((node_idx * 7 + battery * 3) % 5 - 2)

    fleet = []  # (name, generation, pool, baseline stats, straggler?)
    per_gen = -(-n_nodes // len(generations))
    for gen, pool, tflops, gbps in generations:
        stats = {"tflops": tflops, "gbps": gbps}
        for i in range(per_gen):
            if len(fleet) >= n_nodes:
                break
            fleet.append((f"{pool}-w{i:03d}", gen, pool, stats,
                          len(fleet) == 0))
    straggler_name = fleet[0][0]
    straggler_generation = fleet[0][1]

    adopted = 0
    pools = {}
    for j, (name, gen, pool, stats, slow) in enumerate(fleet):
        ring = []
        for battery in range(history):
            scale = jitter(j, battery)
            if slow:
                scale *= TELEMETRY_STRAGGLER_FRACTION
            ring.append((battery + 1, 1000.0 + battery, sample(stats, scale)))
        node = make_node(name, labels={label: gen}, annotations={
            keys.telemetry_history_annotation: format_ring(ring)})
        if plane.adopt_node(node):
            adopted += 1
        pools[name] = pool
    plane.seed_pools(pools)
    for j, (name, gen, pool, stats, slow) in enumerate(fleet):
        scale = jitter(j, history)
        if slow:
            scale *= TELEMETRY_STRAGGLER_FRACTION
        plane.ingest(name, sample(stats, scale), generation=gen, pool=pool)
    plane.recompute()
    status = plane.to_status()
    verdicts = status.get("stragglers") or []
    confirmed = sorted(v["node"] for v in verdicts)
    verdict = next((v for v in verdicts if v["node"] == straggler_name),
                   None)
    cohorts = (status.get("healthSummary") or {}).get("cohorts") or []

    # -- 2. write parity: the ring rides the combined patch
    policy = _policy(drain=False)
    roll_generation, _, roll_tflops, roll_gbps = (
        ("tpu-v5p-slice", "", 459.0, 1640.0) if tpu_slices
        else telemetry_generations()[1])
    leg_writes = {}
    rings_persisted = 0
    for enabled in (False, True):
        cluster = FakeCluster()
        fx = GpuFleet(cluster, keys)
        ds = fx.daemon_set(hash_suffix="v1", revision=1)
        names = []
        for i in range(roll_slices):
            for n in _hosts(fx, f"tel-{i:02d}", roll_hosts, tpu_slices):
                fx.driver_pod(n, ds, hash_suffix="v1")
                names.append(n.name)
        fx.bump_daemon_set_template(ds, "v2", revision=2)
        fx.auto_recreate_driver_pods(ds, "v2")
        mgr = ClusterUpgradeStateManager(
            cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0,
            enable_telemetry=enabled)
        if enabled:
            # One battery a node before the roll: every ring is dirty.
            for name in names:
                mgr.telemetry_plane.ingest(
                    name, {"tflops": roll_tflops, "gbps": roll_gbps},
                    generation=roll_generation)
        _roll_to_done(mgr, cluster, keys, names, policy,
                      "telemetry parity roll")
        leg_writes[enabled] = _writes(cluster)
        if enabled:
            rings_persisted = sum(
                1 for name in names
                if parse_ring(cluster.get_node(name, cached=False)
                              .annotations.get(
                                  keys.telemetry_history_annotation)))
    return {
        "stage": "telemetry",
        "shape": _shape(tpu_slices),
        "nodes": len(fleet),
        "generations": len(generations),
        "generation_tflops": {gen: tflops
                              for gen, _, tflops, _ in generations},
        "cohorts": len(cohorts),
        "adopted": adopted,
        "straggler": straggler_name,
        "straggler_generation": straggler_generation,
        "straggler_confirmed": verdict is not None,
        "straggler_z": verdict["z"] if verdict else 0.0,
        "straggler_score": verdict["score"] if verdict else -1.0,
        "straggler_streak": verdict["streak"] if verdict else 0,
        "confirmed": confirmed,
        "false_positives": len([n for n in confirmed
                                if n != straggler_name]),
        "fresh_batteries_to_confirm": 1,
        "drops": plane.drops,
        "roll_nodes": roll_slices * roll_hosts,
        "writes_without_telemetry": leg_writes.get(False, -1),
        "writes_with_telemetry": leg_writes.get(True, -1),
        "extra_writes": leg_writes.get(True, -1) - leg_writes.get(False, -1),
        "rings_persisted": rings_persisted,
    }


# -- 8. multi-artifact -------------------------------------------------------

# (artifact, DaemonSet name, pod name prefix, pod labels, versions v1 -> v2
# hash suffixes, target version) of each shape's stack.  The GPU
# operator's: the driver, then the NIC driver (the reference's OFED case,
# docs/automatic-ofed-upgrade.md), then the device plugin.
_STACKS = {
    "gfd": (("net", "mofed-driver", "mofed", {"app": "mofed-driver"},
             "24.07.0"),
            ("plugin", "nvidia-device-plugin", "plugin",
             {"app": "nvidia-device-plugin-daemonset"}, "0.16.2"),
            "550.90.07"),
    "tpu-slices": (("net", "tpu-net", "net", {"app": "tpu-network-driver"},
                    "1.4.0"),
                   ("plugin", "tpu-plugin", "plugin",
                    {"app": "tpu-device-plugin"}, "0.9.2"),
                   "2.18.0"),
}


def _multi_artifact_roll(multi: bool, slices: int, hosts: int,
                         tpu_slices: bool) -> dict:
    """One roll of a fresh fleet whose every node carries the stack's
    three pods, under the classic single-DaemonSet policy or the
    pinned-order three-artifact stack; the extra DaemonSets are bumped
    either way, so the two rolls' writes differ only by what the stack
    does."""
    net, plugin, driver_version = _STACKS[_shape(tpu_slices)]
    keys = UpgradeKeys()
    cluster = FakeCluster()
    fx = GpuFleet(cluster, keys)
    driver_ds = fx.daemon_set(hash_suffix="v1", revision=1)
    extra = [(fx.daemon_set(name=ds_name, hash_suffix=f"{prefix}-v1",
                            revision=1, labels=labels), prefix)
             for _, ds_name, prefix, labels, _ in (net, plugin)]
    nodes = []
    for i in range(slices):
        for n in _hosts(fx, f"pool-{i}", hosts, tpu_slices):
            nodes.append(n)
            fx.driver_pod(n, driver_ds, hash_suffix="v1")
            for ds, prefix in extra:
                fx.driver_pod(n, ds, hash_suffix=f"{prefix}-v1",
                              name=f"{prefix}-{n.name}")
    for ds, suffix in [(driver_ds, "v2")] + [(ds, f"{prefix}-v2")
                                             for ds, prefix in extra]:
        fx.bump_daemon_set_template(ds, suffix, revision=2)
        fx.auto_recreate_driver_pods(ds, suffix)
    groups = slices if tpu_slices else slices * hosts

    artifacts = None
    if multi:
        artifacts = ArtifactDAGSpec(
            items=[ArtifactSpec(name="driver",
                                match_labels=dict(DRIVER_LABELS),
                                target_version=driver_version)]
            + [ArtifactSpec(name=art, match_labels=dict(labels),
                            target_version=version)
               for art, _, _, labels, version in (net, plugin)],
            edges=[
                ArtifactEdgeSpec(before="driver", after="net",
                                 requires=f">={driver_version}",
                                 skew="pinned-order"),
                ArtifactEdgeSpec(before="net", after="plugin",
                                 skew="pinned-order"),
            ],
        )
    policy = TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        unavailability_unit="slice",
        artifacts=artifacts,
    )
    policy.validate()
    mgr = ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=5.0)

    # One BudgetLedger charge a group for the whole stack: count grants
    # to a group that holds none.
    ledger = BudgetLedger()
    ledger.configure(total_units=groups, max_parallel=0,
                     max_unavailable=groups, unit="slice")
    charges: dict[str, int] = {}
    orig_claim = ledger.try_claim

    def counting_claim(group_id, cost, **kw):
        held = ledger.holds(group_id)
        ok = orig_claim(group_id, cost, **kw)
        if ok and not held:
            charges[group_id] = charges.get(group_id, 0) + 1
        return ok

    ledger.try_claim = counting_claim
    mgr.budget_ledger = ledger

    cordons: dict[str, int] = {}
    orig_unsched = cluster.set_node_unschedulable

    def counting_unsched(name, unschedulable):
        if unschedulable:
            cordons[name] = cordons.get(name, 0) + 1
        return orig_unsched(name, unschedulable)

    cluster.set_node_unschedulable = counting_unsched

    # Drain-window entries: state-label writes into the drain state, on
    # both label write paths (plain and coalesced).
    drain_value = UpgradeState.DRAIN_REQUIRED.value
    drains: dict[str, int] = {}

    def watch_labels(name, labels):
        if (labels or {}).get(keys.state_label) == drain_value:
            drains[name] = drains.get(name, 0) + 1

    orig_patch_labels = cluster.patch_node_labels
    orig_patch_meta = cluster.patch_node_metadata

    def counting_patch_labels(name, patch):
        watch_labels(name, patch)
        return orig_patch_labels(name, patch)

    def counting_patch_meta(name, labels=None, annotations=None,
                            field_manager=None):
        watch_labels(name, labels)
        return orig_patch_meta(name, labels=labels, annotations=annotations,
                               field_manager=field_manager)

    cluster.patch_node_labels = counting_patch_labels
    cluster.patch_node_metadata = counting_patch_meta

    write_base = {v: cluster.stats.get(v, 0) for v in MULTI_ART_WRITE_VERBS}
    t0 = time.monotonic()
    converged = False
    for tick in range(MULTI_ART_MAX_TICKS):
        state = mgr.build_state(NAMESPACE, DRIVER_LABELS, policy)
        mgr.apply_state(state, policy)
        mgr.wait_for_async_work(60.0)
        states = {cluster.get_node(n.name, cached=False).labels.get(
            keys.state_label, "") for n in nodes}
        if states == {UpgradeState.DONE.value}:
            converged = True
            break
    return {
        "converged": converged,
        "ticks": tick + 1,
        "wall_s": time.monotonic() - t0,
        "nodes": len(nodes),
        "groups": groups,
        "cordons_per_node": sorted(set(cordons.values())) or [0],
        "nodes_cordoned": len(cordons),
        "drains_per_node": sorted(set(drains.values())) or [0],
        "nodes_drained": len(drains),
        "charges_per_group": sorted(set(charges.values())) or [0],
        "groups_charged": len(charges),
        "writes": {v: cluster.stats.get(v, 0) - write_base[v]
                   for v in MULTI_ART_WRITE_VERBS},
        "window_savings": mgr.artifact_window_savings,
        "skew_holds": dict(mgr.artifact_skew_holds),
    }


def measure_multi_artifact(slices: int = MULTI_ART_N_SLICES,
                           hosts: int = MULTI_ART_HOSTS_PER_SLICE,
                           tpu_slices: bool = False) -> dict:
    """The three-artifact stack shares one cordon and drain window a
    node and one budget charge a group, and writes exactly the extra
    artifacts' pod restarts more than the classic roll."""
    classic = _multi_artifact_roll(False, slices, hosts, tpu_slices)
    stack = _multi_artifact_roll(True, slices, hosts, tpu_slices)
    delta = {v: stack["writes"][v] - classic["writes"][v]
             for v in MULTI_ART_WRITE_VERBS}
    extra_restarts = stack["nodes"] * MULTI_ART_EXTRA_ARTIFACTS
    return {
        "stage": "multi_artifact",
        "shape": _shape(tpu_slices),
        "nodes": stack["nodes"],
        "groups": stack["groups"],
        "artifacts": 1 + MULTI_ART_EXTRA_ARTIFACTS,
        "stack": ["driver"] + [s[1] for s in _STACKS[_shape(tpu_slices)][:2]],
        "converged": classic["converged"] and stack["converged"],
        "classic_ticks": classic["ticks"],
        "stack_ticks": stack["ticks"],
        "classic_wall_s": classic["wall_s"],
        "stack_wall_s": stack["wall_s"],
        "cordons_per_node": stack["cordons_per_node"],
        "nodes_cordoned": stack["nodes_cordoned"],
        "drains_per_node": stack["drains_per_node"],
        "nodes_drained": stack["nodes_drained"],
        "charges_per_group": stack["charges_per_group"],
        "groups_charged": stack["groups_charged"],
        "write_delta": {k: v for k, v in delta.items() if v},
        "expected_extra_pod_restarts": extra_restarts,
        "extra_writes_clean": delta == {
            **{v: 0 for v in MULTI_ART_WRITE_VERBS},
            "delete_pod": extra_restarts,
            "create_pod": extra_restarts,
        },
        "window_savings": stack["window_savings"],
        "skew_holds": stack["skew_holds"],
    }


# -- 9. the fused battery and the async gate ---------------------------------


def measure_probe_battery(members: Optional[Sequence] = None,
                          sizes: Optional[dict] = None) -> dict:
    """The fused battery over ``members`` (8 members of the card by
    default) at ``sizes`` (production by default), cold then warm: the
    warm run must hit the warm-up cache.  Then the async gate's wall
    time, from the validation stamp to the healthy verdict, through
    ``ValidationManager`` and ``LocalDeviceProber`` for one GFD-labelled
    node (the stage builds no fleet, so it takes no ``tpu_slices``)."""
    from k8s_operator_libs_tpu_torch.entry import members_of
    from k8s_operator_libs_tpu_torch.health import fused
    from k8s_operator_libs_tpu_torch.health.probes import run_host_probe
    from k8s_operator_libs_tpu_torch.health.slice_prober import (
        LocalDeviceProber,
    )
    from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (
        NodeUpgradeStateProvider,
    )
    from k8s_operator_libs_tpu_torch.upgrade.types import (
        NodeUpgradeState,
        UpgradeGroup,
    )
    from k8s_operator_libs_tpu_torch.upgrade.validation_manager import (
        ValidationManager,
    )

    members = (list(members) if members is not None
               else members_of(GPUS_PER_NODE, "cuda"))
    sizes = dict(sizes or BATTERY_SIZES)
    fused.reset_battery_cache()
    t0 = time.monotonic()
    cold_checks = run_host_probe(members, fused=True, **sizes)
    cold_s = time.monotonic() - t0
    t0 = time.monotonic()
    warm_checks = run_host_probe(members, fused=True, **sizes)
    warm_s = time.monotonic() - t0
    stats = fused.battery_stats()
    warm_hit = any(c.metrics.get("battery_cache_hit") == 1.0
                   for c in warm_checks)

    keys = UpgradeKeys()
    cluster = FakeCluster()
    cluster.create_node(make_node("bench-val-0", labels={
        GPU_PRODUCT_LABELS[0]: SXM, GPU_COUNT_LABELS[0]: str(len(members))}))
    provider = NodeUpgradeStateProvider(cluster, keys, poll_interval_s=0.005,
                                        poll_timeout_s=5.0)
    vm = ValidationManager(
        cluster, provider, keys,
        prober=LocalDeviceProber(members, fused=True, **sizes),
        timeout_seconds=60,
    )
    gate_passed = False
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        fresh = cluster.get_node("bench-val-0", cached=False)
        group = UpgradeGroup(id="bench-val-0",
                             members=[NodeUpgradeState(node=fresh)])
        if vm.validate(group):
            gate_passed = True
            break
        time.sleep(0.01)
    vm.wait_idle(10.0)
    return {
        "stage": "probe_battery",
        "devices": len(members),
        "device": str(members[0]),
        "sizes": sizes,
        "cold_s": cold_s,
        "warm_s": warm_s,
        "warm_cache_hit": warm_hit,
        "compile_cache_hits": stats["compile_cache_hits"],
        "compile_cache_misses": stats["compile_cache_misses"],
        "fallbacks": stats["fallbacks"],
        "last_execute_ms": stats["last_execute_ms"],
        "checks_ok": (all(c.ok for c in cold_checks)
                      and all(c.ok for c in warm_checks)),
        "failed_checks": sorted({c.name for c in cold_checks + warm_checks
                                 if not c.ok}),
        "gate_passed": gate_passed,
        "validation_wall_s": vm.validation_wall_s.get("bench-val-0", -1.0),
        "warm_ceiling_s": BATTERY_WARM_CEILING_S,
        "validation_wall_ceiling_s": VALIDATION_WALL_CEILING_S,
    }


# -- 10. incremental O(delta) reconcile at 100,000 nodes ---------------------


def measure_incremental(slices: int = INC_N_SLICES,
                        hosts: int = INC_HOSTS_PER_SLICE,
                        idle_ticks: int = INC_IDLE_TICKS,
                        tpu_slices: bool = False) -> dict:
    """O(delta) reconcile through the materialized view and the
    copy-on-write snapshots: a clean resync audit, idle ticks at 0
    pools and 0 requests, one delta served from the view, a shallow
    reused snapshot and the process's peak RSS over the stage."""
    with _PeakRss() as rss:
        record = _incremental(slices, hosts, idle_ticks, tpu_slices)
    record["peak_rss_mib"] = rss.peak_mib
    return record


def _incremental(slices: int, hosts: int, idle_ticks: int,
                 tpu_slices: bool) -> dict:
    keys = UpgradeKeys()
    cluster = FakeCluster()
    fx = GpuFleet(cluster, keys)
    ds = fx.daemon_set(hash_suffix="v1", revision=1)
    selector = dict(ds.spec.selector.match_labels)
    owner = OwnerReference(name=ds.name, uid=ds.metadata.uid,
                           kind="DaemonSet")
    t0 = time.monotonic()
    for i in range(slices):
        for n in _hosts(fx, f"pool-{i:04d}", hosts, tpu_slices,
                        state=UpgradeState.DONE):
            # One pod a node, created directly, and the DaemonSet's
            # status settled in one write below (the fixture's
            # driver_pod rewrites the DaemonSet a pod).
            cluster.create_pod(Pod(
                metadata=ObjectMeta(
                    name=f"driver-{n.name}", namespace=ds.namespace,
                    labels={**selector, "controller-revision-hash": "v1"},
                    owner_references=[owner]),
                spec=PodSpec(node_name=n.name),
                status=PodStatus(
                    phase=PodPhase.RUNNING,
                    container_statuses=[ContainerStatus(ready=True,
                                                        restart_count=0)]),
            ))
    ds.status.desired_number_scheduled = slices * hosts
    cluster.update_daemon_set(ds)
    fleet_build_s = time.monotonic() - t0

    policy = _policy()
    # The seed resync at this scale outlasts the default freshness
    # bound; the stage pins tick cost, not staleness policy.
    informer, _, sharded, sync_s, seed_resync_s = _seeded(
        cluster, keys, policy, max_staleness_s=600.0)
    try:
        pools = len(sharded.router.pools())
        diff_mismatches = sharded.stats.get("matview_diff_mismatches", 0)

        # A store version bump invalidates the cached snapshot: the
        # rebuild must be shallow, and an untouched store must return
        # the identical object.
        node = cluster.get_node("pool-0000-w0", cached=False)
        informer.handle_event(WatchEvent("MODIFIED", "Node", node,
                                         node.metadata.resource_version))
        t0 = time.monotonic()
        snap1 = informer.snapshot()
        snapshot_build_s = time.monotonic() - t0
        snapshot_reused = informer.snapshot() is snap1
        snapshot_shared = bool(getattr(snap1, "shared", False))

        api_before = sum(cluster.stats.values())
        idle_walked, p50, p99 = _idle_ticks(sharded, policy, idle_ticks)
        idle_api = sum(cluster.stats.values()) - api_before

        # One watch delta, fed as the controller feeds it: the informer
        # (the view applies it) and the dirty-pool router.
        node = cluster.get_node(f"pool-{slices // 2:04d}-w{hosts // 2}",
                                cached=False)
        ev = WatchEvent("MODIFIED", "Node", node,
                        node.metadata.resource_version)
        t0 = time.monotonic()
        informer.handle_event(ev)
        delta_apply_s = time.monotonic() - t0
        sharded.handle_event(ev)
        hits_before = sharded.stats.get("matview_hits", 0)
        t0 = time.monotonic()
        report = sharded.tick(policy)
        active_tick_s = time.monotonic() - t0
        if not sharded.wait_idle(60.0):
            raise RuntimeError("incremental reconcile did not drain")
        matview_hits = sharded.stats.get("matview_hits", 0) - hits_before
        view_stats = (sharded.matview.snapshot_stats()
                      if sharded.matview is not None else {})
    finally:
        sharded.shutdown()
    return {
        "stage": "incremental_100k",
        "shape": _shape(tpu_slices),
        "nodes": slices * hosts,
        "pools": pools,
        "fleet_build_s": fleet_build_s,
        "sync_s": sync_s,
        "seed_resync_s": seed_resync_s,
        "resync_diff_mismatches": diff_mismatches,
        "snapshot_build_s": snapshot_build_s,
        "snapshot_reused": snapshot_reused,
        "snapshot_shared": snapshot_shared,
        "idle_ticks": idle_ticks,
        "idle_pools_walked_total": idle_walked,
        "idle_api_requests_total": idle_api,
        "idle_p50_tick_s": p50,
        "idle_p99_tick_s": p99,
        "delta_apply_s": delta_apply_s,
        "active_pools_walked": report.pools_walked,
        "active_tick_s": active_tick_s,
        "matview_hits": matview_hits,
        "matview_rows": view_stats.get("rows", 0),
        "matview_pools": view_stats.get("pools", 0),
        "matview_interned_strings": view_stats.get("interned_strings", 0),
        "idle_p99_ceiling_s": INC_IDLE_P99_CEILING_S,
        "active_tick_ceiling_s": INC_ACTIVE_TICK_CEILING_S,
        "snapshot_build_ceiling_s": INC_SNAPSHOT_BUILD_CEILING_S,
        "rss_ceiling_mib": INC_RSS_CEILING_MIB,
    }


# -- the pins ----------------------------------------------------------------


def _check_cached(r: dict) -> list[str]:
    if r["api_requests_per_tick"] > API_PER_TICK_CEILING:
        return [f"steady-state cached reconcile issued "
                f"{r['api_requests_per_tick']} API requests/tick at "
                f"{r['nodes']} nodes (ceiling {API_PER_TICK_CEILING}): a "
                "relist or per-node GET is back in the hot path"]
    return []


def _check_ticks(r: dict, idle_p99_ceiling_s: float,
                 active_tick_ceiling_s: float) -> list[str]:
    """The dirty-set pins shared by the sharded and incremental stages."""
    failures = []
    if r["idle_pools_walked_total"] != 0:
        failures.append(f"idle ticks walked {r['idle_pools_walked_total']} "
                        "pools (must be 0)")
    if r["idle_api_requests_total"] != 0:
        failures.append(f"idle ticks issued {r['idle_api_requests_total']} "
                        "API requests (must be 0)")
    if r["idle_p99_tick_s"] > idle_p99_ceiling_s:
        failures.append(f"idle p99 tick latency {r['idle_p99_tick_s']} s > "
                        f"ceiling {idle_p99_ceiling_s} s")
    if r["active_pools_walked"] != 1:
        failures.append(f"one delta walked {r['active_pools_walked']} "
                        "pools (must be exactly 1)")
    if r["active_tick_s"] > active_tick_ceiling_s:
        failures.append(f"active tick took {r['active_tick_s']} s > ceiling "
                        f"{active_tick_ceiling_s} s")
    return failures


def _check_sharded(r: dict) -> list[str]:
    return _check_ticks(r, SHARDED_IDLE_P99_CEILING_S,
                        SHARDED_ACTIVE_TICK_CEILING_S)


def _check_write_hygiene(r: dict) -> list[str]:
    failures = []
    if r["roll_writes_per_transition"] > WH_WRITES_PER_TRANSITION_CEILING:
        failures.append(
            f"active roll spent {r['roll_writes_per_transition']} node "
            f"writes per state transition (ceiling "
            f"{WH_WRITES_PER_TRANSITION_CEILING})")
    if r["idle_writes_total"] != 0:
        failures.append(
            f"{r['idle_ticks']} idle sharded ticks at {r['idle_nodes']} "
            f"nodes issued {r['idle_writes_total']} API writes (must be 0)")
    if r["event_collapse_ratio"] < WH_EVENT_COLLAPSE_FLOOR:
        failures.append(
            f"identical-event storm collapsed only "
            f"{r['event_collapse_ratio']}:1 (floor "
            f"{WH_EVENT_COLLAPSE_FLOOR}:1)")
    return failures


def _check_planner(r: dict) -> list[str]:
    failures = []
    if r["plan_wall_s"] > PLAN_WALL_CEILING_S:
        failures.append(f"{r['nodes']}-node plan took {r['plan_wall_s']} s "
                        f"(ceiling {PLAN_WALL_CEILING_S} s)")
    if r["plan_writes"] != 0:
        failures.append(f"planning issued {r['plan_writes']} API write "
                        "verb(s) (must be 0)")
    if not r["twin_converged"]:
        failures.append("digital twin did not converge to upgrade-done")
    if r["twin_waves"] != r["analytic_waves"]:
        failures.append(f"twin executed {r['twin_waves']} wave(s) but the "
                        f"analytic plan projected {r['analytic_waves']}")
    if not r["node_wave_agrees"]:
        failures.append("twin node->wave assignment diverged from the "
                        "analytic plan")
    return failures


def _check_packed(r: dict) -> list[str]:
    failures = []
    if r["packed_waves"] >= r["greedy_waves"]:
        failures.append(f"packed plan took {r['packed_waves']} wave(s) vs "
                        f"greedy {r['greedy_waves']} (must be fewer)")
    if r["packed_duration_s"] >= r["greedy_duration_s"]:
        failures.append(f"packed plan projects {r['packed_duration_s']} s "
                        f"vs greedy {r['greedy_duration_s']} s")
    if r["plan_writes"] != 0:
        failures.append(f"planning issued {r['plan_writes']} API write "
                        "verb(s) (must be 0)")
    if not r["engine_greedy_converged"]:
        failures.append("greedy engine roll did not converge")
    if not r["engine_packed_converged"]:
        failures.append("packed engine roll did not converge")
    if r["engine_packed_waves"] >= r["engine_greedy_waves"]:
        failures.append(f"engine rolled {r['engine_packed_waves']} packed "
                        f"wave(s) vs {r['engine_greedy_waves']} greedy")
    if r["engine_packed_mode"] != "packed":
        failures.append("engine admission never used the packed ordering")
    if not r["engine_plan_wave_agrees"]:
        failures.append("packed engine admission diverged from the "
                        "analytic packed plan's waves")
    if r["greedy_idle_ticks"] != 0 or r["packed_idle_ticks"] != 0:
        failures.append(f"budget idle ticks with admissible pending work: "
                        f"greedy {r['greedy_idle_ticks']}, packed "
                        f"{r['packed_idle_ticks']} (must be 0)")
    return failures


def _check_tracing(r: dict) -> list[str]:
    failures = []
    allowed = (r["p99_tick_off_s"] * (1.0 + TRACING_OVERHEAD_CEILING_PCT
                                      / 100.0) + TRACING_OVERHEAD_GRACE_S)
    if r["p99_tick_on_s"] > allowed:
        failures.append(f"tracing-on p99 tick {r['p99_tick_on_s']} s vs off "
                        f"{r['p99_tick_off_s']} s breaches the "
                        f"{TRACING_OVERHEAD_CEILING_PCT} % ceiling")
    if not r["trace_completed"]:
        failures.append("the traced roll never produced a completed trace")
    if not r["trace_connected"]:
        failures.append(f"completed trace is not one connected roll-rooted "
                        f"tree ({r['trace_spans']} spans)")
    if r["trace_open_spans"] != 0:
        failures.append(f"completed trace holds {r['trace_open_spans']} "
                        "open span(s)")
    if r["trace_drops"] != 0:
        failures.append(f"recorder dropped {r['trace_drops']} record(s)")
    if r["bucket_sum_error_pct"] > TRACING_BUCKET_TOLERANCE_PCT:
        failures.append(f"critical-path buckets sum to {r['bucket_sum_s']} s "
                        f"vs makespan {r['makespan_s']} s "
                        f"({r['bucket_sum_error_pct']} % error)")
    if not r["idle_tracing_enabled"]:
        failures.append("idle sharded manager was built without a trace "
                        "recorder")
    if r["idle_pools_walked_total"] != 0:
        failures.append(f"idle traced ticks walked "
                        f"{r['idle_pools_walked_total']} pools (must be 0)")
    if r["idle_writes_total"] != 0:
        failures.append(f"idle traced ticks issued {r['idle_writes_total']} "
                        "API writes (must be 0)")
    if r["storm_dumps"] == 0:
        failures.append("trigger storm produced zero black-box dumps")
    if r["spool_bytes"] > TRACING_SPOOL_CAP_BYTES:
        failures.append(f"black-box spool holds {r['spool_bytes']} bytes "
                        f"(cap {TRACING_SPOOL_CAP_BYTES})")
    return failures


def _check_telemetry(r: dict) -> list[str]:
    failures = []
    if r["adopted"] != r["nodes"]:
        failures.append(f"only {r['adopted']}/{r['nodes']} nodes re-seeded "
                        "their history ring on adoption")
    if not r["straggler_confirmed"]:
        failures.append(f"injected straggler {r['straggler']} was not "
                        "confirmed within one battery after adoption")
    if r["false_positives"] != 0:
        failures.append(f"{r['false_positives']} healthy node(s) flagged as "
                        f"stragglers ({r['confirmed']})")
    if r["drops"] != 0:
        failures.append(f"telemetry plane swallowed {r['drops']} error(s)")
    if r["extra_writes"] != 0:
        failures.append(f"telemetry-enabled roll issued {r['extra_writes']} "
                        "extra API write verb(s) (must be 0)")
    if r["rings_persisted"] != r["roll_nodes"]:
        failures.append(f"only {r['rings_persisted']}/{r['roll_nodes']} "
                        "nodes hold a history ring after the roll")
    return failures


def _check_multi_artifact(r: dict) -> list[str]:
    failures = []
    if not r["converged"]:
        failures.append(f"a roll did not converge (classic "
                        f"{r['classic_ticks']} ticks, stack "
                        f"{r['stack_ticks']} ticks)")
    if r["cordons_per_node"] != [1] or r["nodes_cordoned"] != r["nodes"]:
        failures.append(f"stack roll cordoned {r['nodes_cordoned']} node(s) "
                        f"{r['cordons_per_node']} time(s) each")
    if r["drains_per_node"] != [1] or r["nodes_drained"] != r["nodes"]:
        failures.append(f"stack roll entered the drain window "
                        f"{r['drains_per_node']} time(s) on "
                        f"{r['nodes_drained']} node(s)")
    if r["charges_per_group"] != [1] or r["groups_charged"] != r["groups"]:
        failures.append(f"stack roll charged {r['groups_charged']} group(s) "
                        f"{r['charges_per_group']} time(s) each")
    if not r["extra_writes_clean"]:
        failures.append(f"write delta vs the classic roll is "
                        f"{r['write_delta']} (must be exactly "
                        f"{r['expected_extra_pod_restarts']} pod deletes "
                        "and recreates)")
    if r["window_savings"] != r["nodes"] * MULTI_ART_EXTRA_ARTIFACTS:
        failures.append(f"shared-window savings {r['window_savings']} != "
                        f"nodes x extra artifacts ({r['nodes']} x "
                        f"{MULTI_ART_EXTRA_ARTIFACTS})")
    return failures


def _check_battery(r: dict) -> list[str]:
    failures = []
    if not r["checks_ok"]:
        failures.append(f"fused battery failed {r['failed_checks']}")
    if r["fallbacks"]:
        failures.append(f"fused battery fell back to unfused probes "
                        f"{r['fallbacks']} time(s)")
    if not r["warm_cache_hit"]:
        failures.append("second same-topology battery missed the warm-up "
                        "cache")
    if r["warm_s"] > BATTERY_WARM_CEILING_S:
        failures.append(f"warm fused battery took {r['warm_s']} s > ceiling "
                        f"{BATTERY_WARM_CEILING_S} s")
    if not r["gate_passed"]:
        failures.append("async validation gate never passed")
    elif r["validation_wall_s"] > VALIDATION_WALL_CEILING_S:
        failures.append(f"validation gate wall-clock "
                        f"{r['validation_wall_s']} s > ceiling "
                        f"{VALIDATION_WALL_CEILING_S} s")
    return failures


def _check_incremental(r: dict) -> list[str]:
    failures = []
    if r["resync_diff_mismatches"] != 0:
        failures.append(f"full-resync audit found "
                        f"{r['resync_diff_mismatches']} view-vs-build_state "
                        "mismatch(es) (must be 0)")
    failures += _check_ticks(r, INC_IDLE_P99_CEILING_S,
                             INC_ACTIVE_TICK_CEILING_S)
    if r["matview_hits"] < 1:
        failures.append("the dirty pool was rebuilt via build_state, not "
                        "served from the materialized view")
    if not r["snapshot_shared"]:
        failures.append("informer snapshot is no longer a COW view")
    if r["snapshot_build_s"] > INC_SNAPSHOT_BUILD_CEILING_S:
        failures.append(f"snapshot rebuild took {r['snapshot_build_s']} s > "
                        f"ceiling {INC_SNAPSHOT_BUILD_CEILING_S} s")
    if not r["snapshot_reused"]:
        failures.append("an unchanged store rebuilt its snapshot")
    if r["peak_rss_mib"] > INC_RSS_CEILING_MIB:
        failures.append(f"peak RSS {r['peak_rss_mib']} MiB > budget "
                        f"{INC_RSS_CEILING_MIB} MiB")
    return failures


# Stage name -> (its pin check, the key of its headline number).
PINS: dict[str, tuple[Callable[[dict], list[str]], str]] = {
    "cached_reconcile": (_check_cached, "api_requests_per_tick"),
    "sharded_reconcile": (_check_sharded, "idle_p99_tick_s"),
    "write_hygiene": (_check_write_hygiene, "roll_writes_per_transition"),
    "planner": (_check_planner, "plan_wall_s"),
    "packed_admission": (_check_packed, "packed_waves"),
    "tracing": (_check_tracing, "overhead_pct"),
    "telemetry": (_check_telemetry, "straggler_z"),
    "multi_artifact": (_check_multi_artifact, "window_savings"),
    "probe_battery": (_check_battery, "warm_s"),
    "incremental_100k": (_check_incremental, "active_tick_s"),
}


def check(record: dict) -> list[str]:
    """The broken pins of a stage's record, each named; sets the
    record's ``ok``."""
    failures = PINS[record["stage"]][0](record)
    record["ok"] = not failures
    return failures


def _start_child(args: Sequence[str]) -> subprocess.Popen:
    """This module run as ``args`` in a child interpreter with no CUDA
    device, its output piped."""
    root = str(Path(__file__).resolve().parents[1])
    cmd = [sys.executable, "-m", "k8s_operator_libs_tpu_torch.bench_guard",
           *args]
    return subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=cpu_child_env(prepend_pythonpath=root))


def _child_record(proc: subprocess.Popen, timeout_s: float) -> dict:
    """The last line ``proc`` prints, as JSON; a child that dies, prints
    nothing or outlives ``timeout_s`` raises (and is killed)."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = out.strip().splitlines()
    if proc.returncode not in (0, 1) or not lines:
        raise RuntimeError(f"{' '.join(proc.args[3:])} in a child: "
                           f"rc={proc.returncode} {err[-2000:]}")
    return json.loads(lines[-1])


def measure_in_child(stage: str, timeout_s: float = 1200.0) -> dict:
    """``stage``'s record, measured in a child interpreter of its own
    (no CUDA device), so that a peak-RSS pin reads the stage's own high
    water and not that of whatever the caller ran before it (the card's
    context, the batteries' host buffers).  The child is this module's
    ``--stage``; a child that dies or prints no record raises."""
    record = _child_record(_start_child(["--stage", stage]), timeout_s)
    record["process"] = "child"
    return record


def stages(members: Optional[Sequence] = None,
           battery_sizes: Optional[dict] = None,
           ) -> list[tuple[str, Callable[[], dict]]]:
    """(name, thunk) of every stage at the reference's sizes on GFD
    fleets, in the order :func:`main` runs them; the battery runs over
    ``members`` at ``battery_sizes``, the 100,000-node stage in a child
    (:func:`measure_in_child`)."""
    return [
        ("cached_reconcile", measure),
        ("sharded_reconcile", measure_sharded),
        ("write_hygiene", measure_write_hygiene),
        ("planner", measure_planner),
        ("packed_admission", measure_packed_admission),
        ("tracing", measure_tracing),
        ("telemetry", measure_telemetry),
        ("multi_artifact", measure_multi_artifact),
        ("probe_battery",
         lambda: measure_probe_battery(members, battery_sizes)),
        ("incremental_100k", lambda: measure_in_child("incremental_100k")),
    ]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the battery on 8 CPU members at the "
                             "reference guard's CPU sizes")
    parser.add_argument("--stage", choices=("incremental_100k",),
                        help="measure this stage alone, in this process")
    parser.add_argument("--tracing-leg", metavar="JSON",
                        help="run one leg of the tracing stage, given "
                             "tracing_leg's arguments, and print its ticks")
    args = parser.parse_args(argv)
    if args.tracing_leg:
        print(json.dumps(tracing_leg(**json.loads(args.tracing_leg))),
              flush=True)
        return 0
    if args.stage:
        record = measure_incremental()
        failures = check(record)
        print(json.dumps(record, sort_keys=True), flush=True)
        return 1 if failures else 0
    members = battery_sizes = None
    if args.cpu:
        from k8s_operator_libs_tpu_torch.entry import members_of

        members = members_of(GPUS_PER_NODE, "cpu")
        battery_sizes = BATTERY_CPU_SIZES
    for name, run in stages(members, battery_sizes):
        record = run()
        failures = check(record)
        print(json.dumps(record, sort_keys=True), flush=True)
        if failures:
            for f in failures:
                print(f"bench-guard FAIL ({name}): {f}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
