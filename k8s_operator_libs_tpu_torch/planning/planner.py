"""Deterministic, side-effect-free analytic roll planner.

Given one built cluster snapshot (``ClusterUpgradeState``) and one
``TPUUpgradePolicySpec``, :func:`plan_roll` emits a :class:`RollPlan`:
ordered upgrade waves respecting every admission rule the live engine
enforces — hierarchical fleet ∧ pool budgets, DCN anti-affinity,
oldest-generation-first ordering, maintenance-window open intervals,
and elastic offer timeouts — with per-wave projected durations derived
from measured per-phase clocks and a projected completion time.

The planner issues ZERO API write verbs (the dry-run path asserts this
through the write plane) and shares its admission predicates with the
live engine's helpers (`_pool_for_group`, `_unavailability_unit`, slot
math constants, `group_sort_key`), so a plan and the engine disagree
only where reality diverges from the snapshot — which is exactly what
the drift watchdog (:mod:`drift`) measures, and what the digital twin
(:mod:`twin`) validates ahead of time.

Wave semantics: a wave is one admission BATCH — the set of groups the
engine would admit together under the caps.  With uniform per-group
phase durations the engine's rolling admission degenerates to exactly
these batches (validated by the twin and the seeded fuzz cross-check);
with heterogeneous durations the waves are a conservative projection.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.artifacts.dag import artifact_dag_of
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    group_accelerator,
    group_dcn_group,
)
from k8s_operator_libs_tpu_torch.fleet.scheduler import (
    group_sort_key,
    packed_group_sort_key,
)
from k8s_operator_libs_tpu_torch.fleet.windows import (
    NEXT_OPEN_HORIZON_S,
    next_open,
    window_open,
)
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    IN_PROGRESS_STATES,
    TRUE_STRING,
    UpgradeState,
)

logger = get_logger(__name__)

# Default per-phase clocks (seconds), production-shaped: the fused probe
# battery's warm time is the validation clock (BENCH records < 1 s warm,
# docs/fused-probe-battery.md); cordon/uncordon are single label writes;
# drain covers the eviction ladder's polite rung; pod restart is the
# kubelet pull+start path.  Tests and the bench stage override these to
# the twin's measured clocks.
DEFAULT_CORDON_S = 1.0
DEFAULT_WAIT_FOR_JOBS_S = 0.0
DEFAULT_POD_DELETION_S = 2.0
DEFAULT_DRAIN_S = 30.0
DEFAULT_POD_RESTART_S = 20.0
DEFAULT_VALIDATION_S = 1.0
DEFAULT_UNCORDON_S = 1.0
DEFAULT_NEGOTIATE_S = 2.0
DEFAULT_REJOIN_S = 2.0

# Hard cap on simulated waves: a plan needing more than one wave per
# pending group (plus window jumps) indicates a modeling bug, not a
# bigger fleet.
_MAX_EXTRA_WAVES = 64


@dataclass
class PhaseClocks:
    """Measured per-phase durations the projection is built from."""

    cordon_s: float = DEFAULT_CORDON_S
    wait_for_jobs_s: float = DEFAULT_WAIT_FOR_JOBS_S
    pod_deletion_s: float = DEFAULT_POD_DELETION_S
    drain_s: float = DEFAULT_DRAIN_S
    pod_restart_s: float = DEFAULT_POD_RESTART_S
    validation_s: float = DEFAULT_VALIDATION_S
    uncordon_s: float = DEFAULT_UNCORDON_S
    negotiate_s: float = DEFAULT_NEGOTIATE_S
    rejoin_s: float = DEFAULT_REJOIN_S

    def to_dict(self) -> dict:
        return {
            "cordonSeconds": self.cordon_s,
            "waitForJobsSeconds": self.wait_for_jobs_s,
            "podDeletionSeconds": self.pod_deletion_s,
            "drainSeconds": self.drain_s,
            "podRestartSeconds": self.pod_restart_s,
            "validationSeconds": self.validation_s,
            "uncordonSeconds": self.uncordon_s,
            "negotiateSeconds": self.negotiate_s,
            "rejoinSeconds": self.rejoin_s,
        }


@dataclass
class PlanAssumptions:
    """What-if knobs shared by the planner and the twin.

    ``elastic_answer`` models the workload's response to exclusion
    offers (Tenplex negotiation makes roll duration workload-dependent):
    ``"accept"`` adds the negotiate+rejoin resize clocks, ``"decline"``
    adds one negotiate round before the classic drain path, and
    ``"timeout"`` charges the policy's full ``offerTimeoutSeconds``.
    """

    elastic_answer: str = "accept"  # accept | decline | timeout
    clocks: PhaseClocks = field(default_factory=PhaseClocks)
    # Measured per-pool clocks (pool name -> PhaseClocks, "" for the
    # pool-less bucket) overriding ``clocks`` for that pool's groups —
    # the drift watchdog feeds the EWMA tracker's estimates in here so
    # re-plans tighten as the roll progresses.
    pool_clocks: dict = field(default_factory=dict)
    # Wave-ordering override: "" inherits planning.admissionMode from
    # the policy; "greedy"/"packed" force one packer for what-ifs.
    admission_mode: str = ""
    # Group ids assumed preempted for the projection (what-if knob; the
    # live preemption annotation is honored regardless).
    preempted_groups: frozenset = frozenset()
    horizon_s: float = NEXT_OPEN_HORIZON_S


@dataclass
class PlannedGroup:
    """One group's place in the plan."""

    group_id: str
    pool: Optional[str]
    wave: int
    cost: int
    nodes: list[str]
    accelerator: str
    duration_s: float
    start_offset_s: float
    in_flight: bool = False

    def to_dict(self) -> dict:
        return {
            "group": self.group_id,
            "pool": self.pool,
            "wave": self.wave,
            "cost": self.cost,
            "nodes": list(self.nodes),
            "accelerator": self.accelerator,
            "durationSeconds": round(self.duration_s, 3),
            "startOffsetSeconds": round(self.start_offset_s, 3),
            "inFlight": self.in_flight,
        }


@dataclass
class PlanWave:
    """One admission batch."""

    index: int
    start_offset_s: float
    duration_s: float
    group_ids: list[str]
    pools: list[str]

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "startOffsetSeconds": round(self.start_offset_s, 3),
            "durationSeconds": round(self.duration_s, 3),
            "groups": list(self.group_ids),
            "pools": list(self.pools),
        }


@dataclass
class RollPlan:
    """The analytic projection of one roll from one snapshot."""

    created_epoch: float
    waves: list[PlanWave] = field(default_factory=list)
    groups: list[PlannedGroup] = field(default_factory=list)
    # node name -> wave index (the fuzz cross-check's unit of agreement)
    node_wave: dict[str, int] = field(default_factory=dict)
    # group id -> reason it is excluded from the projection
    held: dict[str, str] = field(default_factory=dict)
    # Plan-infeasibility reasons (window starvation, budget deadlock);
    # non-empty means the roll as planned never finishes.
    infeasible: list[str] = field(default_factory=list)
    total_nodes: int = 0
    pending_groups: int = 0
    projected_duration_s: float = 0.0
    projected_completion_epoch: float = 0.0
    unit: str = "slice"
    # Wave-ordering the projection was packed under (greedy | packed).
    admission_mode: str = "greedy"
    # Lazy group->wave index: packed admission asks wave_of once per
    # pending group per pass, which must stay O(1) amortized.
    _wave_index: Optional[dict] = field(
        default=None, repr=False, compare=False
    )

    @property
    def wave_count(self) -> int:
        return len(self.waves)

    def wave_of(self, group_id: str) -> Optional[int]:
        if self._wave_index is None or len(self._wave_index) != len(
            self.groups
        ):
            self._wave_index = {g.group_id: g.wave for g in self.groups}
        return self._wave_index.get(group_id)

    def to_dict(self) -> dict:
        return {
            "createdEpoch": int(self.created_epoch),
            "unit": self.unit,
            "admissionMode": self.admission_mode,
            "totalNodes": self.total_nodes,
            "pendingGroups": self.pending_groups,
            "waveCount": len(self.waves),
            "waves": [w.to_dict() for w in self.waves],
            "groups": [g.to_dict() for g in self.groups],
            "held": dict(self.held),
            "infeasible": list(self.infeasible),
            "projectedDurationSeconds": round(self.projected_duration_s, 3),
            "projectedCompletion": int(self.projected_completion_epoch),
        }

    def render(self) -> str:
        """Human-readable plan (the --dry-run output)."""
        lines = [
            f"RollPlan: {self.pending_groups} pending group(s) over "
            f"{len(self.waves)} wave(s), unit={self.unit}, "
            f"{self.total_nodes} managed nodes",
        ]
        for wave in self.waves:
            lines.append(
                f"  wave {wave.index}: t+{wave.start_offset_s:.0f}s "
                f"for {wave.duration_s:.0f}s — "
                f"{len(wave.group_ids)} group(s): "
                + ", ".join(wave.group_ids)
            )
        for gid, reason in sorted(self.held.items()):
            lines.append(f"  held {gid}: {reason}")
        if self.infeasible:
            for reason in self.infeasible:
                lines.append(f"  INFEASIBLE: {reason}")
        else:
            lines.append(
                f"  projected duration {self.projected_duration_s:.0f}s, "
                "completion "
                + _time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ",
                    _time.gmtime(self.projected_completion_epoch),
                )
            )
        return "\n".join(lines)


def _group_duration_s(
    group,
    policy,
    assumptions: PlanAssumptions,
    elastic_candidate: bool,
    pool_name: Optional[str] = None,
) -> float:
    """Projected wall-clock for one group's pass through the disruptive
    states, from the assumption clocks + the policy's enabled phases.
    Pools with measured EWMA clocks use those; the rest fall back to
    the assumption-level (static or twin-measured) clocks."""
    clocks = assumptions.pool_clocks.get(pool_name or "") or assumptions.clocks
    total = clocks.cordon_s + clocks.uncordon_s + clocks.pod_restart_s
    # Multi-artifact stacks step through their serialized levels inside
    # the ONE shared window: each extra level costs another pod-restart
    # clock, while cordon/drain/validation/uncordon stay amortized —
    # skew-pinned edges therefore serialize WITHIN a wave, they never
    # add waves.
    try:
        dag = artifact_dag_of(policy)
    except Exception:
        dag = None
    if dag is not None:
        total += (dag.serialized_steps() - 1) * clocks.pod_restart_s
    total += clocks.validation_s
    if policy.wait_for_completion is not None:
        total += clocks.wait_for_jobs_s
    drain_enabled = (
        policy.drain_spec is not None and policy.drain_spec.enable
    )
    if drain_enabled:
        total += clocks.drain_s
    else:
        total += clocks.pod_deletion_s
    if elastic_candidate:
        answer = assumptions.elastic_answer
        if answer == "accept":
            total += clocks.negotiate_s + clocks.rejoin_s
        elif answer == "decline":
            total += clocks.negotiate_s
        else:  # timeout: the offer ages out at the policy clock
            elastic = getattr(policy, "elastic", None)
            total += float(
                getattr(elastic, "offer_timeout_second", 0) or 0
            )
    return total


def _pool_caps(manager, state, policy, unit: str) -> dict:
    """name -> (max_unavailable_units, max_parallel) per policy pool,
    derived exactly like BudgetLedger.sync_from_state: the percentage
    scales against the pool's own unit population."""
    pools = manager._policy_pools(policy)
    if not pools:
        return {}
    pool_units: dict[str, int] = {}
    for group in state.all_groups():
        name = manager._pool_for_group(group, policy)
        if name is None:
            continue
        cost = 1 if unit == "slice" else group.size()
        pool_units[name] = pool_units.get(name, 0) + cost
    caps = {}
    for pool in pools:
        units_in_pool = pool_units.get(pool.name, 0)
        if pool.max_unavailable is not None:
            cap = pool.max_unavailable.scaled_value(
                units_in_pool, round_up=True
            )
        else:
            cap = units_in_pool
        caps[pool.name] = (cap, pool.max_parallel_upgrades or 0)
    return caps


def _group_requires_upgrade(manager, group, ds_hash_cache: dict) -> bool:
    """Would process_done_or_unknown_groups flag this group?  Same
    predicate as the engine's, with the per-DaemonSet revision-hash
    lookup cached so a 4096-node plan does not re-list
    ControllerRevisions per node."""
    for member in group.members:
        if manager._is_upgrade_requested(member.node):
            return True
        if member.is_orphaned_pod():
            continue
        ds = member.driver_daemon_set
        key = (ds.namespace, ds.name)
        ds_hash = ds_hash_cache.get(key)
        if ds_hash is None:
            try:
                ds_hash = (
                    manager.pod_manager
                    .get_daemonset_controller_revision_hash(ds)
                )
            except ValueError:
                continue
            ds_hash_cache[key] = ds_hash
        try:
            pod_hash = manager.pod_manager.get_pod_controller_revision_hash(
                member.driver_pod
            )
        except (ValueError, AttributeError):
            continue
        if pod_hash != ds_hash:
            return True
    return False


def _elastic_candidate(manager, policy, group) -> bool:
    elastic = getattr(policy, "elastic", None)
    if elastic is None or not elastic.enable:
        return False
    key = manager.keys.elastic_workload_annotation
    excluded_key = manager.keys.elastic_excluded_annotation
    return any(
        key in m.node.annotations
        and m.node.annotations.get(excluded_key) != TRUE_STRING
        for m in group.members
    )


def find_infeasibilities(
    manager,
    state,
    policy,
    now: Optional[float] = None,
    horizon_s: float = NEXT_OPEN_HORIZON_S,
) -> list[str]:
    """Cheap structural feasibility scan (no wave simulation): reasons
    this roll can provably never finish.  Used by the fleet-level stuck
    signal (upgrade/stuck.py) and the drift watchdog every pass, so it
    must stay O(groups)."""
    now = _time.time() if now is None else now
    reasons: list[str] = []
    unit = manager._unavailability_unit(policy)
    total_units = manager._total_units(state, unit)
    fleet_cap = total_units
    if policy.max_unavailable is not None:
        fleet_cap = policy.max_unavailable.scaled_value(
            total_units, round_up=True
        )
    caps = _pool_caps(manager, state, policy, unit)
    pools = {p.name: p for p in manager._policy_pools(policy)}

    # Pending cost per pool (UPGRADE_REQUIRED groups only: the cheap
    # scan runs on live snapshots where outdatedness is already
    # reflected in the state labels).
    pending: dict[Optional[str], list] = {}
    for group in state.groups_in(UpgradeState.UPGRADE_REQUIRED):
        pending.setdefault(
            manager._pool_for_group(group, policy), []
        ).append(group)

    for pool_name, groups in sorted(
        pending.items(), key=lambda kv: kv[0] or ""
    ):
        min_cost = min(
            1 if unit == "slice" else g.size() for g in groups
        )
        if min_cost > fleet_cap:
            reasons.append(
                f"budget-deadlock: fleet maxUnavailable admits "
                f"{fleet_cap} {unit}(s) but the smallest pending group "
                f"costs {min_cost}"
            )
        if pool_name is None:
            continue
        pool_cap = caps.get(pool_name, (None, 0))[0]
        if pool_cap is not None and min_cost > pool_cap:
            reasons.append(
                f"budget-deadlock: pool {pool_name} maxUnavailable "
                f"admits {pool_cap} {unit}(s) but its smallest pending "
                f"group costs {min_cost}"
            )
        pool = pools.get(pool_name)
        window = pool.maintenance_window if pool is not None else None
        if window is not None and window.cron:
            try:
                opens = next_open(window.cron, now, horizon_s)
            except ValueError:
                opens = now  # unparseable cron fails open at runtime
            if opens is None:
                reasons.append(
                    f"window-starvation: pool {pool_name} maintenance "
                    f"window {window.cron!r} never opens"
                )
    # Window-held groups were DROPPED from the live snapshot by
    # process_maintenance_windows (the hold is budget-free and
    # condition-only), so starvation for them must be read from the
    # manager's hold record: a pool whose window never opens again is
    # infeasible even with zero visible pending groups.
    held_info = getattr(manager, "window_held_info", None) or {}
    for pool_name, entries in sorted(held_info.items()):
        if pool_name is None or any(
            r.startswith(f"window-starvation: pool {pool_name} ")
            for r in reasons
        ):
            continue
        pool = pools.get(pool_name)
        window = pool.maintenance_window if pool is not None else None
        if window is None or not window.cron:
            continue
        try:
            opens = next_open(window.cron, now, horizon_s)
        except ValueError:
            continue  # unparseable cron fails open at runtime
        if opens is None:
            reasons.append(
                f"window-starvation: pool {pool_name} maintenance "
                f"window {window.cron!r} never opens "
                f"({len(entries)} group(s) held)"
            )
    # Elastic-decline storm: every negotiation so far was refused or
    # timed out, and slices keep re-entering negotiation — the roll is
    # burning offer timeouts without making exclusion progress.
    negotiations = getattr(manager, "elastic_negotiations", None)
    if negotiations and pending:
        refused = negotiations.get("decline", 0) + negotiations.get(
            "timeout", 0
        )
        if refused >= 5 and negotiations.get("accept", 0) == 0:
            reasons.append(
                f"elastic-decline-storm: {refused} exclusion offers "
                "declined or timed out with zero accepts; every slice "
                "is taking the full drain path"
            )
    return reasons


def plan_roll(
    manager,
    state,
    policy,
    now: Optional[float] = None,
    assumptions: Optional[PlanAssumptions] = None,
) -> RollPlan:
    """Emit the analytic :class:`RollPlan` for this snapshot + policy.

    Pure projection: reads the snapshot through the manager's helper
    predicates, never mutates it, and never stages a write."""
    now = _time.time() if now is None else now
    assumptions = assumptions or PlanAssumptions()
    plan = RollPlan(created_epoch=now)

    unit = manager._unavailability_unit(policy)
    plan.unit = unit
    total_units = manager._total_units(state, unit)
    plan.total_nodes = manager.get_total_managed_nodes(state)
    fleet_cap = total_units
    if policy.max_unavailable is not None:
        fleet_cap = policy.max_unavailable.scaled_value(
            total_units, round_up=True
        )
    fleet_parallel = policy.max_parallel_upgrades or 0
    caps = _pool_caps(manager, state, policy, unit)
    pools = {p.name: p for p in manager._policy_pools(policy)}
    window_key = manager.keys.window_wait_annotation
    skip_key = manager.keys.skip_label

    def _cost(group) -> int:
        return 1 if unit == "slice" else group.size()

    def _pool_window_cron(pool_name: Optional[str]) -> Optional[str]:
        pool = pools.get(pool_name) if pool_name else None
        window = pool.maintenance_window if pool is not None else None
        return window.cron if window is not None and window.cron else None

    def _window_open_at(pool_name: Optional[str], epoch: float) -> bool:
        cron = _pool_window_cron(pool_name)
        if cron is None:
            return True
        try:
            return window_open(cron, epoch)
        except ValueError:
            return True  # runtime fail-open, mirrored from the engine

    # -- classify every group -------------------------------------------
    ds_hash_cache: dict = {}
    pending: list = []  # (group, pool, cost, elastic, duration)
    in_flight: list = []
    for group in state.all_groups():
        eff = group.effective_state(manager.keys.state_label)
        pool_name = manager._pool_for_group(group, policy)
        if any(
            m.node.labels.get(skip_key) == TRUE_STRING
            for m in group.members
        ):
            plan.held[group.id] = "skip label set"
            continue
        if (
            group.id in assumptions.preempted_groups
            or manager._group_preempted(group)
        ):
            plan.held[group.id] = "preempted (holding budget-free)"
            continue
        if eff in (UpgradeState.FAILED, UpgradeState.QUARANTINED):
            plan.held[group.id] = f"in terminal/parked state {eff.value}"
            continue
        if (
            group.slice_info is not None
            and group.size() < group.slice_info.expected_hosts
        ):
            plan.held[group.id] = (
                f"incomplete slice ({group.size()}/"
                f"{group.slice_info.expected_hosts} hosts present)"
            )
            continue
        elastic = _elastic_candidate(manager, policy, group)
        duration = _group_duration_s(
            group, policy, assumptions, elastic, pool_name
        )
        if eff in IN_PROGRESS_STATES:
            in_flight.append(
                (group, pool_name, _cost(group), elastic, duration)
            )
        elif eff == UpgradeState.UPGRADE_REQUIRED:
            pending.append(
                (group, pool_name, _cost(group), elastic, duration)
            )
        elif eff in (UpgradeState.DONE, UpgradeState.UNKNOWN):
            if _group_requires_upgrade(manager, group, ds_hash_cache):
                pending.append(
                    (group, pool_name, _cost(group), elastic, duration)
                )

    admission_mode = assumptions.admission_mode or getattr(
        getattr(policy, "planning", None), "admission_mode", ""
    )
    plan.admission_mode = admission_mode or "greedy"
    if admission_mode == "packed":
        # First-fit-decreasing within each generation class: the wave
        # loop below is already first-fit (denied groups stay pending
        # while later ones fill the residual budget), so the decreasing
        # cost order is all packing adds — no gate is relaxed.
        pending.sort(
            key=lambda item: packed_group_sort_key(item[0], item[2])
        )
    else:
        pending.sort(key=lambda item: group_sort_key(item[0]))
    plan.pending_groups = len(pending) + len(in_flight)

    # -- simulate admission waves ---------------------------------------
    t = 0.0
    wave_index = 0
    max_waves = len(pending) + len(in_flight) + _MAX_EXTRA_WAVES
    while (pending or in_flight) and wave_index < max_waves:
        admitted: list = []
        used_budget = 0
        used_parallel = 0
        pool_used: dict[str, tuple[int, int]] = {}
        busy_dcn: set = set()

        # In-flight groups occupy the first wave unconditionally: their
        # unavailability is a fact, not an admission request (mirrors
        # the ledger's force re-charge semantics).
        for item in in_flight:
            group, pool_name, cost, _elastic, _duration = item
            admitted.append(item + (True,))
            if any(
                window_key in m.node.annotations for m in group.members
            ):
                continue  # window-held holds no budget
            used_budget += cost
            used_parallel += 1
            if pool_name is not None:
                pu, pp = pool_used.get(pool_name, (0, 0))
                pool_used[pool_name] = (pu + cost, pp + 1)
            dcn = group_dcn_group(group, manager.keys)
            if dcn:
                busy_dcn.add(dcn)
        in_flight = []

        still_pending: list = []
        for item in pending:
            group, pool_name, cost, elastic, _duration = item
            if not _window_open_at(pool_name, now + t):
                still_pending.append(item)
                continue
            if fleet_parallel and used_parallel + 1 > fleet_parallel:
                still_pending.append(item)
                continue
            if used_budget + cost > fleet_cap:
                still_pending.append(item)
                continue
            dcn = group_dcn_group(group, manager.keys)
            dcn_gate = getattr(policy, "dcn_anti_affinity", False)
            if dcn_gate and dcn and dcn in busy_dcn:
                still_pending.append(item)
                continue
            if pool_name is not None and pool_name in caps:
                pool_cap, pool_parallel = caps[pool_name]
                pu, pp = pool_used.get(pool_name, (0, 0))
                if pu + cost > pool_cap:
                    still_pending.append(item)
                    continue
                if pool_parallel and pp + 1 > pool_parallel:
                    still_pending.append(item)
                    continue
                pool_used[pool_name] = (pu + cost, pp + 1)
            admitted.append(item + (False,))
            used_budget += cost
            used_parallel += 1
            if dcn:
                busy_dcn.add(dcn)
        pending = still_pending

        if not admitted:
            # Nothing admitted this round.  Groups whose window IS open
            # are budget-deadlocked (the wave started with zero usage,
            # so if the caps deny them now they deny them forever);
            # groups behind a closed window wait for its next opening —
            # jump the virtual clock there, or report starvation when it
            # never comes.
            still: list = []
            for item in pending:
                group, pool_name, cost, _el, _dur = item
                if _window_open_at(pool_name, now + t):
                    where = (
                        f"pool {pool_name}" if pool_name else "fleet"
                    )
                    plan.infeasible.append(
                        f"budget-deadlock: {where} budget can never "
                        f"admit group {group.id} (cost {cost} {unit}(s))"
                    )
                    plan.held[group.id] = "budget-deadlocked"
                else:
                    still.append(item)
            pending = still
            if not pending:
                break
            jump_to: Optional[float] = None
            for item in pending:
                cron = _pool_window_cron(item[1])
                if cron is None:
                    continue
                try:
                    opens = next_open(
                        cron, now + t, assumptions.horizon_s
                    )
                except ValueError:
                    opens = now + t  # fail-open
                if opens is not None and (
                    jump_to is None or opens < jump_to
                ):
                    jump_to = opens
            if jump_to is not None and jump_to > now + t:
                t = jump_to - now
                continue
            if jump_to is None:
                for item in pending:
                    group, pool_name = item[0], item[1]
                    cron = _pool_window_cron(pool_name)
                    plan.infeasible.append(
                        f"window-starvation: pool {pool_name} "
                        f"maintenance window {cron!r} never opens for "
                        f"group {group.id}"
                    )
                    plan.held[group.id] = "window-starved"
            break

        start = t
        duration = max(item[4] for item in admitted)
        wave_groups = []
        wave_pools = []
        for group, pool_name, cost, _el, dur, was_in_flight in admitted:
            accelerator = group_accelerator(group)
            plan.groups.append(
                PlannedGroup(
                    group_id=group.id,
                    pool=pool_name,
                    wave=wave_index,
                    cost=cost,
                    nodes=[n.name for n in group.nodes],
                    accelerator=accelerator,
                    duration_s=dur,
                    start_offset_s=start,
                    in_flight=was_in_flight,
                )
            )
            for node in group.nodes:
                plan.node_wave[node.name] = wave_index
            wave_groups.append(group.id)
            if pool_name and pool_name not in wave_pools:
                wave_pools.append(pool_name)
        plan.waves.append(
            PlanWave(
                index=wave_index,
                start_offset_s=start,
                duration_s=duration,
                group_ids=wave_groups,
                pools=wave_pools,
            )
        )
        t += duration
        wave_index += 1

    plan.projected_duration_s = t
    plan.projected_completion_epoch = now + t
    # Merge the cheap structural reasons so a plan that IS simulable but
    # rides a decline storm still reports it.
    for reason in find_infeasibilities(
        manager, state, policy, now=now, horizon_s=assumptions.horizon_s
    ):
        if reason not in plan.infeasible:
            plan.infeasible.append(reason)
    return plan
