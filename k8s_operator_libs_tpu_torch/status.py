"""Read-only upgrade status summary: the operator's mid-roll view.

    python -m k8s_operator_libs_tpu_torch.status \
        --namespace gpu-operator --selector app=nvidia-driver-daemonset [--json]

Snapshots the cluster exactly the way the engine does (BuildState — no
writes) and prints per-slice state, host counts, availability, the
driver's current ControllerRevision, policy-CR conditions when present,
and recent Warning events.  This is the human/scripting face of the
same facts the controller acts on.  Counterpart of
``k8s_operator_libs_tpu.status``; its keys, selector and Lease default to
the port controller's.
"""

from __future__ import annotations

import argparse
import json as _json
from typing import Optional

from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.metrics import PREFIX
from k8s_operator_libs_tpu_torch.upgrade.consts import TRUE_STRING, UpgradeState
from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import node_ready
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
    BuildStateError,
    ClusterUpgradeStateManager,
)
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    group_accelerator,
    group_dcn_group,
)
from k8s_operator_libs_tpu_torch.keys import (
    CONTROLLER_NAME,
    DEFAULT_DRIVER_NAME,
    DRIVER_DAEMONSET_NAME,
    driver_keys,
)
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys


# Controller /metrics series → status keys for the shard-health section.
SHARDED_METRIC_KEYS = {
    "reconcile_shards": "shards",
    "reconcile_shard_busy": "busyShards",
    "reconcile_dirty_pools": "lastTickPools",
    "dirty_queue_depth": "queueDepth",
    "dirty_queue_in_flight": "queueInFlight",
    "dirty_queue_oldest_wait_seconds": "queueOldestWaitSeconds",
    "dirty_tick_duration_seconds": "lastTickSeconds",
    "dirty_events_routed_total": "eventsRouted",
    "dirty_events_coalesced_total": "eventsCoalesced",
    "dirty_pools_reconciled_total": "poolsReconciled",
    "dirty_shard_errors_total": "shardErrors",
    "dirty_shard_fenced_total": "shardFenced",
    "full_resyncs_total": "fullResyncs",
    "budget_unavailable_used": "budgetUsed",
    "budget_unavailable_cap": "budgetCap",
    "budget_parallel_used": "budgetParallel",
    "matview_hits_total": "viewHits",
    "matview_fallback_rebuilds_total": "viewFallbacks",
    "matview_diff_mismatches_total": "viewDiffMismatches",
    "matview_pools": "viewPools",
    "matview_rows": "viewRows",
    "matview_interned_strings": "viewInternedStrings",
    "matview_apply_latency_us": "viewApplyLatencyUs",
}


# Controller /metrics series → status keys for the elastic-coordination
# section (unlabeled series only; elastic_negotiations_total{outcome=...}
# and elastic_resizes_total{direction=...} are parsed label-aware below).
ELASTIC_METRIC_KEYS = {
    "elastic_excluded_slices": "excludedSlices",
    "elastic_resize_seconds": "lastResizeSeconds",
}


# Controller /metrics series → status keys for the probe-battery section
# (unlabeled series only; probe_battery_seconds{phase=...} and
# validation_wall_seconds{slice=...} are parsed label-aware below).
BATTERY_METRIC_KEYS = {
    "probe_battery_cache_hits_total": "cacheHits",
    "probe_battery_cache_misses_total": "cacheMisses",
    "probe_battery_fallbacks_total": "fallbacks",
    "probe_battery_cached_programs": "cachedPrograms",
}


# Controller /metrics series → status keys for the write-plane section
# (unlabeled series only; writeplan_writes_total{flow=...},
# writeplan_pending{kind=...}, flow_tokens{flow=...} and
# flow_throttled{flow=...} are parsed label-aware below).
WRITEPLANE_METRIC_KEYS = {
    "writes_suppressed_total": "suppressed",
    "writes_coalesced_total": "coalescedKeys",
    "writeplan_flushes_total": "flushes",
    "writeplan_fenced_drops_total": "fencedDrops",
    "writeplan_conflict_replays_total": "conflictReplays",
    "events_published_total": "eventsPublished",
    "events_aggregated_total": "eventsAggregated",
    "flow_throttle_waits_total": "throttleWaits",
    "flow_deferred_total": "deferred",
    "api_writes_per_tick": "apiWritesPerTick",
}


# Controller /metrics series → status keys for the plan section
# (unlabeled series only; fleet_roll_infeasible{reason=...} and
# fleet_window_invalid{pool=...} are parsed label-aware below).
PLAN_METRIC_KEYS = {
    "plan_waves": "waves",
    "plan_groups": "plannedGroups",
    "plan_completed_groups": "completedGroups",
    "plan_projected_completion_timestamp_seconds": "projectedCompletionEpoch",
    "plan_drift_seconds": "driftSeconds",
    "plan_replans_total": "replans",
    "budget_saturation": "budgetSaturation",
    "budget_idle_ticks_total": "budgetIdleTicks",
    "admission_packed_total": "packedAdmissions",
}

# Admission keys are published even with no active roll, so (like
# "replans") they must not by themselves make plan_health report a
# section.
_PLAN_ALWAYS_ON_KEYS = {
    "replans",
    "budgetSaturation",
    "budgetIdleTicks",
    "packedAdmissions",
    "admissionMode",
}


def _metrics_text(metrics_url: str, fetch=None) -> str:
    """Fetch the exposition text; ``fetch`` is injectable for tests."""
    if fetch is None:
        from urllib.request import urlopen

        with urlopen(metrics_url, timeout=5) as resp:
            return resp.read().decode()
    return fetch(metrics_url)


def sharded_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Shard health from the controller's /metrics exposition.

    The sharded reconciler lives inside the controller process; this
    read-only tool cannot see its queue directly, so it reads the same
    numbers the controller already exports.  Returns None when the
    family is absent (controller running the classic full-pass loop),
    an ``{"error": ...}`` dict when the endpoint is unreachable.
    ``fetch`` is injectable for tests."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        name = name.split("{")[0]
        if not name.startswith(PREFIX + "_"):
            continue
        key = SHARDED_METRIC_KEYS.get(name[len(PREFIX) + 1 :])
        if key is None:
            continue
        try:
            out[key] = float(value)
        except ValueError:
            continue
    return out or None


def battery_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Fused probe-battery + validation-gate health from /metrics.

    Returns None when the battery family is absent (controller never
    probed in-process — e.g. agents run the battery instead), an
    ``{"error": ...}`` dict when the endpoint is unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    out: dict = {}
    walls: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_"):
            continue
        short = name[len(PREFIX) + 1 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "probe_battery_seconds":
            if 'phase="compile"' in labels:
                out["compileSeconds"] = val
            elif 'phase="execute"' in labels:
                out["executeSeconds"] = val
        elif short == "validation_wall_seconds":
            gid = labels.split('slice="', 1)
            if len(gid) == 2:
                walls[gid[1].split('"', 1)[0]] = val
        else:
            key = BATTERY_METRIC_KEYS.get(short)
            if key is not None:
                out[key] = val
    if walls:
        out["validationWallSeconds"] = walls
    return out or None


def elastic_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Elastic-roll coordination health from the controller's /metrics.

    Returns None when the elastic family is absent (coordination never
    engaged — disabled in policy, or no registered workloads), an
    ``{"error": ...}`` dict when the endpoint is unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    out: dict = {}
    negotiations: dict[str, float] = {}
    resizes: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_"):
            continue
        short = name[len(PREFIX) + 1 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "elastic_negotiations_total":
            outcome = labels.split('outcome="', 1)
            if len(outcome) == 2:
                negotiations[outcome[1].split('"', 1)[0]] = val
        elif short == "elastic_resizes_total":
            direction = labels.split('direction="', 1)
            if len(direction) == 2:
                resizes[direction[1].split('"', 1)[0]] = val
        else:
            key = ELASTIC_METRIC_KEYS.get(short)
            if key is not None:
                out[key] = val
    if negotiations:
        out["negotiations"] = negotiations
    if resizes:
        out["resizes"] = resizes
    return out or None


def artifact_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Multi-artifact stack progress from the controller's /metrics.

    Returns None when the artifact family is absent (single-artifact
    policy — the classic path publishes no per-artifact series), an
    ``{"error": ...}`` dict when the endpoint is unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    out: dict = {}
    artifacts: dict[str, dict] = {}

    def _row(labels: str) -> Optional[dict]:
        name = labels.split('artifact="', 1)
        if len(name) != 2:
            return None
        return artifacts.setdefault(name[1].split('"', 1)[0], {})

    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_"):
            continue
        short = name[len(PREFIX) + 1 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "artifact_synced_nodes":
            row = _row(labels)
            if row is not None:
                row["synced"] = int(val)
        elif short == "artifact_nodes":
            row = _row(labels)
            if row is not None:
                row["nodes"] = int(val)
        elif short == "artifact_skew_holds_total":
            row = _row(labels)
            if row is not None:
                row["skewHolds"] = int(val)
        elif short == "artifact_gate_holds_total":
            row = _row(labels)
            if row is not None:
                row["gateHolds"] = int(val)
        elif short == "artifact_rollbacks_total":
            out["rollbacks"] = int(val)
        elif short == "artifact_shared_window_savings_total":
            out["sharedWindowSavings"] = int(val)
    if artifacts:
        out["artifacts"] = artifacts
    return out if artifacts else None


def write_plane_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Transactional write-plane health from the controller's /metrics.

    Shows per-flow writes and throttle state, pending queue depths, and
    the hygiene counters (suppressed / coalesced / aggregated).  Returns
    None when the write-plane family is absent (controller predates the
    write plane), an ``{"error": ...}`` dict when the endpoint is
    unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    out: dict = {}
    writes: dict[str, float] = {}
    pending: dict[str, float] = {}
    tokens: dict[str, float] = {}
    throttled: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_"):
            continue
        short = name[len(PREFIX) + 1 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "writeplan_writes_total":
            flow = labels.split('flow="', 1)
            if len(flow) == 2:
                writes[flow[1].split('"', 1)[0]] = val
        elif short == "writeplan_pending":
            kind = labels.split('kind="', 1)
            if len(kind) == 2:
                pending[kind[1].split('"', 1)[0]] = val
        elif short == "flow_tokens":
            flow = labels.split('flow="', 1)
            if len(flow) == 2:
                tokens[flow[1].split('"', 1)[0]] = val
        elif short == "flow_throttled":
            flow = labels.split('flow="', 1)
            if len(flow) == 2:
                throttled[flow[1].split('"', 1)[0]] = val
        else:
            key = WRITEPLANE_METRIC_KEYS.get(short)
            if key is not None:
                out[key] = val
    if writes:
        out["writes"] = writes
    if pending:
        out["pending"] = pending
    if tokens:
        out["flowTokens"] = tokens
    if throttled:
        out["flowThrottled"] = throttled
    # api_writes_per_tick alone predates the write plane — only report a
    # section when a write-plane-specific series was actually present.
    plane_only = set(out) - {"apiWritesPerTick"}
    return out if plane_only else None


def plan_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Predictive-planning health from the controller's /metrics: the
    anchored plan's projected waves, drift-adjusted ETA, and any
    structural infeasibility reasons the drift watchdog detected.

    Returns None when the plan family is absent (no active roll — the
    watchdog clears its gauges when the roll finishes), an
    ``{"error": ...}`` dict when the endpoint is unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    out: dict = {}
    infeasible: list[str] = []
    invalid_windows: list[str] = []
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_"):
            continue
        short = name[len(PREFIX) + 1 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "fleet_roll_infeasible":
            reason = labels.split('reason="', 1)
            if len(reason) == 2 and val:
                infeasible.append(reason[1].split('"', 1)[0])
        elif short == "admission_mode":
            mode = labels.split('mode="', 1)
            if len(mode) == 2 and val:
                out["admissionMode"] = mode[1].split('"', 1)[0]
        elif short == "fleet_window_invalid":
            pool = labels.split('pool="', 1)
            if len(pool) == 2 and val:
                invalid_windows.append(pool[1].split('"', 1)[0])
        else:
            key = PLAN_METRIC_KEYS.get(short)
            if key is not None:
                out[key] = val
    if infeasible:
        out["infeasible"] = sorted(infeasible)
    if invalid_windows:
        out["invalidWindows"] = sorted(invalid_windows)
    # plan_replans_total and the admission keys are published even with
    # no active roll — require a wave/ETA series before reporting a
    # section.
    return out if set(out) - _PLAN_ALWAYS_ON_KEYS else None


def telemetry_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Fleet health from the controller's /metrics: per-node health
    scores folded to a distribution, confirmed stragglers per
    (generation, pool) cohort, and the telemetry plane's own counters.

    Returns None when the family is absent (telemetry disabled or no
    batteries observed yet), an ``{"error": ...}`` dict when the
    endpoint is unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    scores: dict[str, float] = {}
    stragglers: list[dict] = []
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_"):
            continue
        short = name[len(PREFIX) + 1 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "node_health_score":
            node = labels.split('node="', 1)
            if len(node) == 2:
                scores[node[1].split('"', 1)[0]] = val
        elif short == "fleet_stragglers" and val:
            gen = labels.split('generation="', 1)
            pool = labels.split('pool="', 1)
            stragglers.append(
                {
                    "generation": (
                        gen[1].split('"', 1)[0] if len(gen) == 2 else ""
                    ),
                    "pool": (
                        pool[1].split('"', 1)[0] if len(pool) == 2 else ""
                    ),
                    "count": int(val),
                }
            )
        elif short == "telemetry_samples_total":
            out["samples"] = int(val)
        elif short == "telemetry_drops_total":
            out["drops"] = int(val)
    if scores:
        out["scoredNodes"] = len(scores)
        out["meanScore"] = round(sum(scores.values()) / len(scores), 1)
        worst = min(scores, key=scores.get)
        out["worstNode"] = worst
        out["worstScore"] = scores[worst]
    if stragglers:
        out["stragglers"] = sorted(
            stragglers, key=lambda s: (s["generation"], s["pool"])
        )
    return out if (scores or stragglers or out.get("samples")) else None


def federation_health(metrics_url: str, fetch=None) -> Optional[dict]:
    """Federated control plane from the controller's /metrics: the
    per-cluster health ladder, fail-static freeze depth, the canary
    gate, and the global budget counters.

    Returns None when the family is absent (federation disabled), an
    ``{"error": ...}`` dict when the endpoint is unreachable."""
    try:
        text = _metrics_text(metrics_url, fetch)
    except Exception as e:  # noqa: BLE001 — status must render regardless
        return {"error": f"metrics unreachable: {e}"}
    rung = {0: "Reachable", 1: "Degraded", 2: "Partitioned"}

    def _label(labels: str, key: str) -> str:
        part = labels.split(f'{key}="', 1)
        return part[1].split('"', 1)[0] if len(part) == 2 else ""

    clusters: dict[str, dict] = {}
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, _, value = line.rpartition(" ")
        labels = ""
        if "{" in name:
            name, _, labels = name.partition("{")
        if not name.startswith(PREFIX + "_federation_"):
            continue
        short = name[len(PREFIX) + 12 :]
        try:
            val = float(value)
        except ValueError:
            continue
        if short == "cluster_health":
            row = clusters.setdefault(_label(labels, "cluster"), {})
            row["region"] = _label(labels, "region")
            row["health"] = rung.get(int(val), "Partitioned")
        elif short == "cluster_done":
            clusters.setdefault(_label(labels, "cluster"), {})["done"] = (
                bool(val)
            )
        elif short == "frozen_groups" and val:
            clusters.setdefault(_label(labels, "cluster"), {})[
                "frozenGroups"
            ] = int(val)
        elif short == "phase" and val:
            out["phase"] = _label(labels, "phase")
        elif short == "canary_held":
            out["canaryHeld"] = bool(val)
        elif short == "soak_remaining_seconds" and val:
            out["soakRemainingSeconds"] = val
        elif short == "budget_unavailable_used":
            out["budgetUsed"] = int(val)
        elif short == "budget_unavailable_cap":
            out["budgetCap"] = int(val)
        elif short == "budget_parallel_used":
            out["budgetParallel"] = int(val)
        elif short == "budget_violations_total":
            out["budgetViolations"] = int(val)
        elif short == "partitions_total":
            out["partitions"] = int(val)
        elif short == "heals_total":
            out["heals"] = int(val)
    if clusters:
        out["clusters"] = {
            name: clusters[name] for name in sorted(clusters)
        }
    return out if (clusters or "phase" in out) else None


def gather(
    client: KubeClient,
    namespace: str,
    driver_labels: dict[str, str],
    keys: Optional[UpgradeKeys] = None,
    policy_ref: Optional[tuple[str, str]] = None,
    max_events: int = 10,
    lease_name: str = CONTROLLER_NAME,
    lease_namespace: Optional[str] = None,
    metrics_url: Optional[str] = None,
    metrics_fetch=None,
) -> dict:
    """Collect the status snapshot as a JSON-shaped dict (no writes)."""
    keys = keys or driver_keys()
    # Fetch + parse the policy FIRST: grouping can depend on it
    # (slice_atomic, topology overrides), and the controller passes its
    # policy into build_state — showing a different grouping here would
    # misrepresent what the engine acts on.
    policy = None
    policy_section: Optional[dict] = None
    if policy_ref is not None:
        from k8s_operator_libs_tpu_torch.api import TPUUpgradePolicySpec
        from k8s_operator_libs_tpu_torch.api.schema import (
            POLICY_GROUP,
            POLICY_PLURAL,
            POLICY_VERSION,
        )
        from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError

        try:
            cr = client.get_custom_object(
                POLICY_GROUP,
                POLICY_VERSION,
                POLICY_PLURAL,
                policy_ref[0],
                policy_ref[1],
            )
            cr_status = cr.get("status") or {}
            policy_section = {
                "spec": cr.get("spec") or {},
                "conditions": cr_status.get("conditions", []),
                # Lifetime counters the controller publishes (crash-safe:
                # re-seeded from annotations on leader adoption).
                "evictionEscalations": cr_status.get("evictionEscalations")
                or {},
                "rollbackAttempts": cr_status.get("rollbackAttempts") or {},
            }
            # Durable planning surface (written by the drift watchdog
            # each full pass; survives a controller restart).
            cr_plan = {
                key: cr_status[key]
                for key in (
                    "projectedCompletion",
                    "planDriftSeconds",
                    "planWaves",
                    "planCompletedGroups",
                    "planReplans",
                    "planInfeasible",
                    "admissionMode",
                    "budgetSaturation",
                    "planTraceId",
                )
                if key in cr_status
            }
            if cr_plan:
                policy_section["plan"] = cr_plan
            # Completed-roll makespan attribution (obs/critical.py),
            # durable on the CR so the CLI renders it after the fact.
            if cr_status.get("makespanBreakdown"):
                policy_section["makespanBreakdown"] = cr_status[
                    "makespanBreakdown"
                ]
            # Fleet health telemetry (obs/telemetry.py): cohort
            # baselines + confirmed stragglers as the controller last
            # published them.
            if cr_status.get("healthSummary"):
                policy_section["healthSummary"] = cr_status[
                    "healthSummary"
                ]
            if cr_status.get("stragglers"):
                policy_section["stragglers"] = cr_status["stragglers"]
            try:
                policy = TPUUpgradePolicySpec.from_dict(cr.get("spec") or {})
            except (ValueError, TypeError):
                policy = None
        except NotFoundError:
            policy_section = {"error": "policy CR not found"}
    mgr = ClusterUpgradeStateManager(client, keys=keys)
    try:
        state = mgr.build_state(namespace, driver_labels, policy)
    except BuildStateError as e:
        return {"error": f"snapshot incoherent: {e} (mid-rollout; retry)"}
    from k8s_operator_libs_tpu_torch.upgrade.durable import parse_int

    rung_key = keys.eviction_rung_annotation
    attempts_key = keys.rollback_attempts_annotation
    cycles_key = keys.quarantine_cycle_count_annotation
    # Nodes currently mid-escalation, per persisted ladder rung — read
    # from the durable annotations, so this is correct even while no
    # controller is running (or right after a leader handoff).
    escalations_in_flight: dict[str, int] = {}
    groups = []
    for group in sorted(state.all_groups(), key=lambda g: g.id):
        effective = group.effective_state(keys.state_label).value or "idle"
        member_states = {
            m.node.name: m.node.labels.get(keys.state_label, "")
            for m in group.members
        }
        unavailable = sum(
            1
            for m in group.members
            if m.node.spec.unschedulable or not node_ready(m.node)
        )
        for m in group.members:
            rung = m.node.annotations.get(rung_key, "")
            if rung:
                escalations_in_flight[rung] = (
                    escalations_in_flight.get(rung, 0) + 1
                )
        groups.append(
            {
                "group": group.id,
                "state": effective,
                "hosts": group.size(),
                "unavailable": unavailable,
                "rollbackAttempts": max(
                    (
                        parse_int(m.node.annotations.get(attempts_key))
                        for m in group.members
                    ),
                    default=0,
                ),
                "quarantineCycles": max(
                    (
                        parse_int(m.node.annotations.get(cycles_key))
                        for m in group.members
                    ),
                    default=0,
                ),
                "quarantined": effective == UpgradeState.QUARANTINED.value,
                "elasticExcluded": any(
                    m.node.annotations.get(keys.elastic_excluded_annotation)
                    == TRUE_STRING
                    for m in group.members
                ),
                "accelerator": group_accelerator(group),
                "topology": (
                    group.slice_info.topology if group.slice_info else ""
                ),
                "dcn_group": group_dcn_group(group, keys) or "",
                "members": member_states,
            }
        )
    # Heterogeneous-fleet view: hosts per generation (a GPU node's from
    # its GPU Feature Discovery label), currently
    # preempted hosts, and pools holding for a maintenance window —
    # read from the durable annotations the engine stamps, so the
    # section is correct even with no controller running.
    from k8s_operator_libs_tpu_torch.fleet.profiles import generation_of
    from k8s_operator_libs_tpu_torch.upgrade.consts import (
        NODE_PREEMPTION_ANNOTATION,
    )

    generations: dict[str, dict] = {}
    window_holds: dict[str, int] = {}
    window_key = keys.window_wait_annotation
    for group in state.all_groups():
        gen = generation_of(group_accelerator(group)) or "unknown"
        row = generations.setdefault(
            gen, {"nodes": 0, "groups": 0, "preempted": 0}
        )
        row["nodes"] += group.size()
        row["groups"] += 1
        row["preempted"] += sum(
            1
            for m in group.members
            if NODE_PREEMPTION_ANNOTATION in m.node.annotations
        )
        for m in group.members:
            pool = m.node.annotations.get(window_key, "")
            if pool:
                window_holds[pool] = window_holds.get(pool, 0) + 1
                break
    out = {
        "totalManagedNodes": mgr.get_total_managed_nodes(state),
        "totalManagedGroups": mgr.get_total_managed_groups(state),
        "upgradesInProgress": mgr.get_upgrades_in_progress(state),
        "upgradesDone": mgr.get_upgrades_done(state),
        "upgradesFailed": mgr.get_upgrades_failed(state),
        "upgradesPending": mgr.get_upgrades_pending(state),
        "slicesQuarantined": len(
            state.groups_in(UpgradeState.QUARANTINED)
        ),
        "evictionEscalationsInFlight": escalations_in_flight,
        "groups": groups,
    }
    if generations:
        fleet_section: dict = {"generations": generations}
        if window_holds:
            fleet_section["windowHolds"] = window_holds
        out["fleet"] = fleet_section
    if policy_section is not None:
        out["policy"] = policy_section
    # Control-plane health: when the client carries a circuit breaker
    # (RestClient / ResilientClient), surface open endpoints + retry
    # counters — the operator-facing view of degraded mode.
    breaker = getattr(client, "breaker", None)
    if breaker is not None and hasattr(breaker, "open_endpoints"):
        retry_stats = getattr(client, "retry_stats", None) or {}
        out["apiHealth"] = {
            "openCircuits": dict(breaker.open_endpoints()),
            "retries": int(retry_stats.get("retries", 0)),
            "breakerFastFails": int(
                retry_stats.get("breaker_fast_fail", 0)
            ),
        }
    # Who is driving: the election Lease names the active controller
    # replica (empty/absent = single-replica mode or between terms).
    try:
        from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError
        from k8s_operator_libs_tpu_torch.k8s.leader import (
            LEASE_GROUP,
            LEASE_PLURAL,
            LEASE_VERSION,
        )

        lease = client.get_custom_object(
            LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
            lease_namespace or namespace,
            lease_name,
        )
        spec = lease.get("spec") or {}
        out["leader"] = {
            "holder": spec.get("holderIdentity") or "",
            "renewTime": spec.get("renewTime") or "",
        }
    except NotFoundError:
        pass
    except Exception:  # noqa: BLE001 — read-only nicety, never fail status
        pass
    if metrics_url:
        sharded = sharded_health(metrics_url, fetch=metrics_fetch)
        if sharded is not None:
            out["shardedReconcile"] = sharded
        battery = battery_health(metrics_url, fetch=metrics_fetch)
        if battery is not None:
            out["probeBattery"] = battery
        elastic = elastic_health(metrics_url, fetch=metrics_fetch)
        if elastic is not None:
            out["elasticCoordination"] = elastic
        artifact = artifact_health(metrics_url, fetch=metrics_fetch)
        if artifact is not None:
            out["artifactStack"] = artifact
        plane = write_plane_health(metrics_url, fetch=metrics_fetch)
        if plane is not None:
            out["writePlane"] = plane
        plan = plan_health(metrics_url, fetch=metrics_fetch)
        if plan is not None:
            out["plan"] = plan
        health = telemetry_health(metrics_url, fetch=metrics_fetch)
        if health is not None:
            out["fleetHealth"] = health
        federation = federation_health(metrics_url, fetch=metrics_fetch)
        if federation is not None:
            out["federation"] = federation
    if hasattr(client, "list_events"):
        warnings = [
            e
            for e in client.list_events(namespace=namespace)
            if e.get("type") == "Warning"
        ]
        # Wire order is not time order on a real apiserver: sort by the
        # event timestamps (ISO strings sort correctly) before slicing.
        warnings.sort(
            key=lambda e: e.get("lastTimestamp")
            or e.get("firstTimestamp")
            or ""
        )
        out["recentWarnings"] = [
            {
                "object": (e.get("involvedObject") or {}).get("name", ""),
                "reason": e.get("reason", ""),
                "message": e.get("message", ""),
            }
            for e in warnings[-max_events:]
        ]
    return out


def render(status: dict) -> str:
    """Human-readable table of the gathered snapshot."""
    if "error" in status:
        return f"status unavailable: {status['error']}"
    lines = [
        f"nodes: {status['totalManagedNodes']} in {status['totalManagedGroups']} "
        f"group(s) | in-progress {status['upgradesInProgress']} "
        f"pending {status['upgradesPending']} done {status['upgradesDone']} "
        f"failed {status['upgradesFailed']} "
        f"quarantined {status.get('slicesQuarantined', 0)}",
        "",
        f"{'GROUP':32s} {'STATE':24s} {'HOSTS':>5s} {'UNAVAIL':>7s} "
        f"{'TOPOLOGY':10s} {'ELASTIC':8s} DCN",
    ]
    for g in status["groups"]:
        elastic_flag = "excluded" if g.get("elasticExcluded") else ""
        lines.append(
            f"{g['group'][:32]:32s} {g['state']:24s} {g['hosts']:>5d} "
            f"{g['unavailable']:>7d} {g['topology']:10s} "
            f"{elastic_flag:8s} {g['dcn_group']}"
        )
    esc = status.get("evictionEscalationsInFlight") or {}
    if esc:
        lines.append("")
        lines.append(
            "eviction ladders in flight (nodes at rung): "
            + ", ".join(f"{r}={n}" for r, n in sorted(esc.items()))
        )
    rollbacks = {
        g["group"]: g["rollbackAttempts"]
        for g in status["groups"]
        if g.get("rollbackAttempts")
    }
    if rollbacks:
        lines.append(
            "rollback attempts: "
            + ", ".join(f"{gid}={n}" for gid, n in sorted(rollbacks.items()))
        )
    cycles = {
        g["group"]: g["quarantineCycles"]
        for g in status["groups"]
        if g.get("quarantineCycles")
    }
    if cycles:
        lines.append(
            "quarantine cycles: "
            + ", ".join(f"{gid}={n}" for gid, n in sorted(cycles.items()))
        )
    fleet = status.get("fleet")
    if fleet is not None:
        lines.append("")
        lines.append("fleet by generation:")
        for gen, row in sorted((fleet.get("generations") or {}).items()):
            extra = (
                f", {int(row.get('preempted', 0))} preempted"
                if row.get("preempted")
                else ""
            )
            lines.append(
                f"  {gen:10s} {int(row['nodes']):>4d} host(s) in "
                f"{int(row['groups'])} group(s){extra}"
            )
        holds = fleet.get("windowHolds") or {}
        if holds:
            lines.append(
                "maintenance-window holds: "
                + ", ".join(
                    f"{pool}={int(n)} group(s)"
                    for pool, n in sorted(holds.items())
                )
            )
    leader = status.get("leader")
    if leader is not None:
        lines.append("")
        lines.append(
            f"leader: {leader['holder'] or '(none — between terms)'} "
            f"(renewed {leader['renewTime']})"
        )
    policy = status.get("policy")
    if policy is not None:
        lines.append("")
        if "error" in policy:
            lines.append(f"policy: {policy['error']}")
        else:
            for c in policy.get("conditions", []):
                lines.append(
                    f"condition {c.get('type', ''):12s} "
                    f"{c.get('status', ''):6s} {c.get('reason', '')}: "
                    f"{c.get('message', '')}"
                )
            lifetime = policy.get("evictionEscalations") or {}
            if lifetime:
                lines.append(
                    "escalations (lifetime): "
                    + ", ".join(
                        f"{r}={int(n)}" for r, n in sorted(lifetime.items())
                    )
                )
            rb = policy.get("rollbackAttempts") or {}
            if rb:
                lines.append(
                    "rollback attempts (lifetime): "
                    + ", ".join(
                        f"{gid}={int(n)}" for gid, n in sorted(rb.items())
                    )
                )
    sharded = status.get("shardedReconcile")
    if sharded is not None:
        lines.append("")
        if "error" in sharded:
            lines.append(f"sharded reconcile: {sharded['error']}")
        else:
            lines.append(
                f"sharded reconcile: {int(sharded.get('busyShards', 0))}/"
                f"{int(sharded.get('shards', 0))} shards busy | queue "
                f"{int(sharded.get('queueDepth', 0))} queued "
                f"{int(sharded.get('queueInFlight', 0))} in-flight "
                f"(oldest {sharded.get('queueOldestWaitSeconds', 0.0):.1f}s)"
                f" | budget {int(sharded.get('budgetUsed', 0))}/"
                f"{int(sharded.get('budgetCap', 0))}"
            )
            lines.append(
                f"  lifetime: "
                f"{int(sharded.get('poolsReconciled', 0))} pool passes, "
                f"{int(sharded.get('fullResyncs', 0))} full resyncs, "
                f"{int(sharded.get('eventsRouted', 0))} events routed "
                f"({int(sharded.get('eventsCoalesced', 0))} coalesced), "
                f"errors {int(sharded.get('shardErrors', 0))}, "
                f"fenced {int(sharded.get('shardFenced', 0))}"
            )
            if "viewPools" in sharded:
                lines.append(
                    f"  materialized view: "
                    f"{int(sharded.get('viewPools', 0))} pools "
                    f"{int(sharded.get('viewRows', 0))} rows | "
                    f"hits {int(sharded.get('viewHits', 0))} "
                    f"fallbacks {int(sharded.get('viewFallbacks', 0))} | "
                    f"diff mismatches "
                    f"{int(sharded.get('viewDiffMismatches', 0))} | "
                    f"interned {int(sharded.get('viewInternedStrings', 0))}"
                    f", apply "
                    f"{sharded.get('viewApplyLatencyUs', 0.0):.1f}us"
                )
    battery = status.get("probeBattery")
    if battery is not None:
        lines.append("")
        if "error" in battery:
            lines.append(f"probe battery: {battery['error']}")
        else:
            lines.append(
                f"probe battery: compile "
                f"{battery.get('compileSeconds', 0.0):.3f}s execute "
                f"{battery.get('executeSeconds', 0.0):.3f}s | cache "
                f"{int(battery.get('cacheHits', 0))} hit(s) "
                f"{int(battery.get('cacheMisses', 0))} miss(es) "
                f"({int(battery.get('cachedPrograms', 0))} cached), "
                f"fallbacks {int(battery.get('fallbacks', 0))}"
            )
            walls = battery.get("validationWallSeconds") or {}
            if walls:
                lines.append(
                    "  validation wall: "
                    + ", ".join(
                        f"{gid}={s:.1f}s" for gid, s in sorted(walls.items())
                    )
                )
    elastic = status.get("elasticCoordination")
    if elastic is not None:
        lines.append("")
        if "error" in elastic:
            lines.append(f"elastic coordination: {elastic['error']}")
        else:
            neg = elastic.get("negotiations") or {}
            res = elastic.get("resizes") or {}
            lines.append(
                f"elastic coordination: "
                f"{int(elastic.get('excludedSlices', 0))} slice(s) excluded"
                f" | negotiations accept {int(neg.get('accept', 0))} "
                f"decline {int(neg.get('decline', 0))} "
                f"timeout {int(neg.get('timeout', 0))}"
                f" | resizes down {int(res.get('down', 0))} "
                f"up {int(res.get('up', 0))} "
                f"(last {elastic.get('lastResizeSeconds', 0.0):.1f}s)"
            )
    artifact = status.get("artifactStack")
    if artifact is not None:
        lines.append("")
        if "error" in artifact:
            lines.append(f"artifact stack: {artifact['error']}")
        else:
            lines.append(
                f"artifact stack: "
                f"{int(artifact.get('sharedWindowSavings', 0))} shared-"
                f"window saving(s), "
                f"{int(artifact.get('rollbacks', 0))} rollback(s)"
            )
            for name, row in sorted(
                (artifact.get("artifacts") or {}).items()
            ):
                bits = [
                    f"  {name}: {int(row.get('synced', 0))}/"
                    f"{int(row.get('nodes', 0))} node(s) synced"
                ]
                if row.get("skewHolds"):
                    bits.append(f"{int(row['skewHolds'])} skew hold(s)")
                if row.get("gateHolds"):
                    bits.append(f"{int(row['gateHolds'])} gate hold(s)")
                lines.append(" | ".join(bits))
    plane = status.get("writePlane")
    if plane is not None:
        lines.append("")
        if "error" in plane:
            lines.append(f"write plane: {plane['error']}")
        else:
            writes = plane.get("writes") or {}
            pending = plane.get("pending") or {}
            tokens = plane.get("flowTokens") or {}
            throttled = plane.get("flowThrottled") or {}
            flow_bits = []
            for flow in ("mutating", "status"):
                state = "THROTTLED" if throttled.get(flow) else "ok"
                flow_bits.append(
                    f"{flow} {int(writes.get(flow, 0))} write(s) "
                    f"({tokens.get(flow, 0.0):.0f} tokens, {state})"
                )
            lines.append("write plane: " + " | ".join(flow_bits))
            lines.append(
                f"  queued: "
                + ", ".join(
                    f"{kind}={int(n)}" for kind, n in sorted(pending.items())
                )
                + f" | last tick {int(plane.get('apiWritesPerTick', 0))} "
                f"api write(s)"
            )
            lines.append(
                f"  hygiene: {int(plane.get('suppressed', 0))} suppressed, "
                f"{int(plane.get('coalescedKeys', 0))} coalesced key(s), "
                f"{int(plane.get('eventsAggregated', 0))} event(s) "
                f"aggregated into {int(plane.get('eventsPublished', 0))} "
                f"published"
            )
            lines.append(
                f"  safety: {int(plane.get('fencedDrops', 0))} fenced "
                f"drop(s), {int(plane.get('conflictReplays', 0))} conflict "
                f"replay(s), {int(plane.get('deferred', 0))} deferred, "
                f"{int(plane.get('throttleWaits', 0))} throttle wait(s)"
            )
    plan = status.get("plan")
    # The durable CR-status copy backs the section when the live metrics
    # endpoint was not consulted (or had no active roll).
    if plan is None:
        cr_plan = (status.get("policy") or {}).get("plan")
        if cr_plan:
            plan = {
                "waves": cr_plan.get("planWaves", 0),
                "completedGroups": cr_plan.get("planCompletedGroups", 0),
                "driftSeconds": cr_plan.get("planDriftSeconds", 0),
                "replans": cr_plan.get("planReplans", 0),
                "projectedCompletion": cr_plan.get(
                    "projectedCompletion", ""
                ),
                "infeasible": cr_plan.get("planInfeasible") or [],
            }
            if "admissionMode" in cr_plan:
                plan["admissionMode"] = cr_plan["admissionMode"]
            if "budgetSaturation" in cr_plan:
                plan["budgetSaturation"] = cr_plan["budgetSaturation"]
    if plan is not None:
        lines.append("")
        if "error" in plan:
            lines.append(f"plan: {plan['error']}")
        else:
            eta = plan.get("projectedCompletion", "")
            if not eta and plan.get("projectedCompletionEpoch"):
                import time as _time

                eta = _time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ",
                    _time.gmtime(plan["projectedCompletionEpoch"]),
                )
            drift = float(plan.get("driftSeconds", 0))
            lines.append(
                f"plan: {int(plan.get('completedGroups', 0))}/"
                f"{int(plan.get('plannedGroups', plan.get('waves', 0)))} "
                f"group(s) done over {int(plan.get('waves', 0))} wave(s)"
                f" | drift {drift:+.0f}s"
                f" | replans {int(plan.get('replans', 0))}"
                + (f" | ETA {eta}" if eta else "")
            )
            mode = plan.get("admissionMode")
            if mode:
                admission = f"  admission: {mode}"
                if "budgetSaturation" in plan:
                    admission += (
                        " | budget "
                        f"{float(plan['budgetSaturation']) * 100:.0f}%"
                        " saturated"
                    )
                if "budgetIdleTicks" in plan:
                    admission += (
                        f" | idle ticks {int(plan['budgetIdleTicks'])}"
                    )
                if "packedAdmissions" in plan:
                    admission += (
                        f" | packed {int(plan['packedAdmissions'])}"
                    )
                lines.append(admission)
            for reason in plan.get("infeasible") or []:
                lines.append(f"  INFEASIBLE: {reason}")
            invalid = plan.get("invalidWindows") or []
            if invalid:
                lines.append(
                    "  invalid maintenance-window cron (failing open): "
                    + ", ".join(invalid)
                )
            trace_id = plan.get("planTraceId") or (
                (status.get("policy") or {}).get("plan") or {}
            ).get("planTraceId")
            if trace_id:
                lines.append(f"  trace: {trace_id}")
    health = status.get("fleetHealth")
    cr_health = (status.get("policy") or {}).get("healthSummary")
    cr_stragglers = (status.get("policy") or {}).get("stragglers")
    # The durable CR-status copy backs the section when the live
    # metrics endpoint was not consulted.
    if health is None and (cr_health or cr_stragglers):
        health = {}
        if cr_health:
            health["scoredNodes"] = cr_health.get("scoredNodes", 0)
            health["meanScore"] = cr_health.get("meanScore", 0.0)
            health["cohorts"] = cr_health.get("cohorts") or []
        if cr_stragglers:
            health["confirmed"] = cr_stragglers
    if health is not None:
        lines.append("")
        if "error" in health:
            lines.append(f"fleet health: {health['error']}")
        else:
            head = (
                f"fleet health: {int(health.get('scoredNodes', 0))} "
                f"node(s) scored, mean {health.get('meanScore', 0.0):.1f}"
            )
            if health.get("worstNode"):
                head += (
                    f" (worst {health['worstNode']} at "
                    f"{health.get('worstScore', 0.0):.1f})"
                )
            if "samples" in health:
                head += (
                    f" | {int(health['samples'])} sample(s), "
                    f"{int(health.get('drops', 0))} drop(s)"
                )
            lines.append(head)
            # Per-generation cohort baselines (CR path only: the
            # metric surface carries medians per check, not cohorts).
            for cohort in health.get("cohorts") or []:
                stats = ", ".join(
                    f"{stat} {b.get('median', 0.0):g}±{b.get('mad', 0.0):g}"
                    for stat, b in sorted(
                        (cohort.get("baseline") or {}).items()
                    )
                )
                lines.append(
                    f"  {cohort.get('generation', '') or '?'}/"
                    f"{cohort.get('pool', '') or 'default'}: "
                    f"{int(cohort.get('nodes', 0))} node(s)"
                    + (f" | {stats}" if stats else "")
                )
            for s in health.get("stragglers") or []:
                lines.append(
                    f"  STRAGGLERS {s.get('generation', '') or '?'}/"
                    f"{s.get('pool', '') or 'default'}: "
                    f"{int(s.get('count', 0))}"
                )
            for v in health.get("confirmed") or []:
                lines.append(
                    f"  STRAGGLER {v.get('node', '')}: score "
                    f"{v.get('score', 0.0)}, z {v.get('z', 0.0)} on "
                    f"{v.get('worstStat', '')} over "
                    f"{int(v.get('streak', 0))} consecutive batteries"
                )
    federation = status.get("federation")
    if federation is not None:
        lines.append("")
        if "error" in federation:
            lines.append(f"federation: {federation['error']}")
        else:
            head = f"federation: phase {federation.get('phase', '?')}"
            if "budgetCap" in federation:
                head += (
                    f" | global budget "
                    f"{int(federation.get('budgetUsed', 0))}/"
                    f"{int(federation['budgetCap'])} unavailable, "
                    f"{int(federation.get('budgetParallel', 0))} "
                    "parallel"
                )
            if federation.get("budgetViolations"):
                head += (
                    f" | {int(federation['budgetViolations'])} "
                    "VIOLATION(S)"
                )
            if federation.get("partitions"):
                head += (
                    f" | {int(federation['partitions'])} partition(s), "
                    f"{int(federation.get('heals', 0))} heal(s)"
                )
            lines.append(head)
            for name, row in (federation.get("clusters") or {}).items():
                detail = row.get("health", "?")
                if row.get("done"):
                    detail += ", done"
                if row.get("frozenGroups"):
                    detail += (
                        f", {int(row['frozenGroups'])} frozen group(s)"
                    )
                lines.append(
                    f"  {name} ({row.get('region', '?')}): {detail}"
                )
            if federation.get("canaryHeld"):
                lines.append("  canary: HELD — promotion stopped")
            elif federation.get("soakRemainingSeconds"):
                lines.append(
                    f"  canary: soaking, "
                    f"{federation['soakRemainingSeconds']:.0f}s remaining"
                )
    breakdown = (status.get("policy") or {}).get("makespanBreakdown")
    if breakdown:
        from k8s_operator_libs_tpu_torch.obs.critical import render_breakdown

        lines.append("")
        lines.append("last roll (critical-path attribution):")
        for row in render_breakdown(breakdown).splitlines():
            lines.append(f"  {row}")
    api_health = status.get("apiHealth")
    if api_health is not None and api_health.get("openCircuits"):
        lines.append("")
        lines.append("api health: DEGRADED (circuit open)")
        for ep, err in sorted(api_health["openCircuits"].items()):
            lines.append(f"  {ep}: {err}")
    warnings = status.get("recentWarnings") or []
    if warnings:
        lines.append("")
        lines.append("recent warnings:")
        for w in warnings:
            lines.append(
                f"  {w['object']}: {w['reason']}: {w['message']}"
            )
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--namespace", default="kube-system")
    parser.add_argument(
        "--selector", default=f"app={DRIVER_DAEMONSET_NAME}"
    )
    parser.add_argument("--driver-name", default=DEFAULT_DRIVER_NAME)
    parser.add_argument("--policy-cr", default="", metavar="NAMESPACE/NAME")
    # Same flags (and defaults) as the controller, so a deployment that
    # customizes its election Lease still gets a leader section here.
    parser.add_argument("--lease-name", default=CONTROLLER_NAME)
    parser.add_argument(
        "--lease-namespace",
        default="",
        help="defaults to --namespace (the controller's behavior)",
    )
    parser.add_argument(
        "--metrics-url",
        default="",
        help="controller /metrics endpoint (e.g. http://HOST:9090/metrics);"
        " adds the sharded-reconcile, write-plane and plan health sections",
    )
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)
    from k8s_operator_libs_tpu_torch.controller import _parse_labels
    from k8s_operator_libs_tpu_torch.k8s import get_default_client

    policy_ref = None
    if args.policy_cr:
        ns, sep, name = args.policy_cr.partition("/")
        if not sep or not ns or not name:
            parser.error("--policy-cr must look like NAMESPACE/NAME")
        policy_ref = (ns, name)
    status = gather(
        get_default_client(),
        args.namespace,
        _parse_labels(args.selector),
        keys=driver_keys(args.driver_name),
        policy_ref=policy_ref,
        lease_name=args.lease_name,
        lease_namespace=args.lease_namespace or None,
        metrics_url=args.metrics_url or None,
    )
    print(_json.dumps(status, indent=2) if args.as_json else render(status))


if __name__ == "__main__":
    main()
