"""Observability: counters as methods (reference parity) + Prometheus text.

Counterpart of ``k8s_operator_libs_tpu.metrics``.  The metric names are
the reference's (``tpu_operator_*``): they are part of the wire contract,
as the check names are.

The reference deliberately exposes upgrade counters as *methods* on the
state manager, leaving export to consumers (SURVEY.md §5, reference
upgrade_state.go:1038-1120 — no prometheus dependency anywhere).  We keep
that contract and additionally ship the thin exporter consumers always
end up writing: a snapshot-based registry rendering Prometheus text
exposition format, served by a stdlib HTTP thread.  Gauges are slice-
granular as well as node-granular, plus the north-star timing metrics
(reconcile duration, per-slice upgrade wall-clock, probe latency).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState

logger = get_logger(__name__)

PREFIX = "tpu_operator"


class MetricsRegistry:
    """Thread-safe gauge/counter store rendering Prometheus text format."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> help text
        self._help: dict[str, str] = {}
        # name -> {label-tuple: value}
        self._values: dict[str, dict[tuple, float]] = defaultdict(dict)
        # name -> label key names
        self._label_keys: dict[str, tuple[str, ...]] = {}
        # name -> "counter" | "gauge" (drives the # TYPE line)
        self._kinds: dict[str, str] = {}
        # every describe() call in order — lets the registry self-lint
        # test catch a family registered twice
        self.described: list[str] = []

    def describe(
        self,
        name: str,
        help_text: str,
        *label_keys: str,
        kind: Optional[str] = None,
    ) -> None:
        """Register a family.  ``kind`` defaults by naming convention:
        families ending ``_total`` are counters, everything else a
        gauge — the registry self-lint pins that the convention and any
        explicit override agree."""
        with self._lock:
            self.described.append(name)
            self._help[name] = help_text
            self._label_keys[name] = tuple(label_keys)
            self._kinds[name] = kind or (
                "counter" if name.endswith("_total") else "gauge"
            )

    def kind(self, name: str) -> str:
        with self._lock:
            return self._kinds.get(name, "gauge")

    def _keys_for(self, name: str, labels: dict[str, str]) -> tuple:
        """Label keys for a metric; an undescribed metric adopts the keys
        of its first write (and keeps them), so render() never emits the
        same series with and without labels."""
        keys = self._label_keys.get(name)
        if keys is None:
            keys = tuple(sorted(labels))
            self._label_keys[name] = keys
        return keys

    def set(self, name: str, value: float, **labels: str) -> None:
        with self._lock:
            keys = self._keys_for(name, labels)
            self._values[name][tuple(labels.get(k, "") for k in keys)] = value

    def inc(self, name: str, delta: float = 1.0, **labels: str) -> None:
        with self._lock:
            keys = self._keys_for(name, labels)
            key = tuple(labels.get(k, "") for k in keys)
            self._values[name][key] = self._values[name].get(key, 0.0) + delta

    def clear(self, name: str) -> None:
        """Drop all series of a gauge (before re-publishing a snapshot, so
        removed slices/states don't linger)."""
        with self._lock:
            self._values[name] = {}

    def remove(self, name: str, **labels: str) -> None:
        """Drop one series of a gauge (e.g. a slice that is no longer
        stuck): the series disappears from render() instead of lingering
        at its last value."""
        with self._lock:
            keys = self._label_keys.get(name)
            if keys is None:
                return
            self._values[name].pop(
                tuple(labels.get(k, "") for k in keys), None
            )

    def render(self) -> str:
        with self._lock:
            lines: list[str] = []
            for name in sorted(self._values):
                full = f"{PREFIX}_{name}"
                if name in self._help:
                    lines.append(f"# HELP {full} {self._help[name]}")
                    kind = self._kinds.get(name, "gauge")
                    lines.append(f"# TYPE {full} {kind}")
                keys = self._label_keys.get(name, ())
                for label_vals, value in sorted(self._values[name].items()):
                    if keys:
                        rendered = ",".join(
                            f'{k}="{v}"' for k, v in zip(keys, label_vals)
                        )
                        lines.append(f"{full}{{{rendered}}} {value:g}")
                    else:
                        lines.append(f"{full} {value:g}")
            return "\n".join(lines) + "\n"


class UpgradeMetrics:
    """Publishes a state-manager snapshot into a registry each reconcile."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        r = self.registry
        r.describe(
            "nodes_by_state", "Managed nodes per upgrade state", "state"
        )
        r.describe(
            "slices_by_state", "Upgrade groups per effective state", "state"
        )
        r.describe("nodes_total", "Total managed nodes")
        r.describe("slices_total", "Total upgrade groups")
        r.describe("upgrades_in_progress", "Nodes in any in-progress state")
        r.describe("upgrades_done", "Nodes in upgrade-done")
        r.describe("upgrades_failed", "Nodes in upgrade-failed")
        r.describe("upgrades_pending", "Nodes in upgrade-required")
        r.describe(
            "reconcile_duration_seconds", "Last BuildState+ApplyState pass"
        )
        r.describe(
            "reconcile_total", "Reconcile passes since controller start"
        )
        r.describe(
            "slice_upgrade_seconds",
            "Wall-clock of each slice's last completed upgrade",
            "slice",
        )
        r.describe(
            "slice_stuck_seconds",
            "Dwell time of groups stuck in one in-progress state beyond "
            "the policy threshold (0 = not stuck)",
            "slice",
            "state",
        )
        r.describe(
            "slices_quarantined",
            "Groups currently parked in quarantined (mid-roll hardware "
            "loss; holds no unavailability budget)",
        )
        r.describe(
            "slice_quarantines_total",
            "Slice quarantine transitions since controller start",
        )
        r.describe(
            "slice_rejoins_total",
            "Slice rejoin-after-quarantine transitions since controller "
            "start",
        )
        r.describe(
            "eviction_escalations_total",
            "Eviction-ladder rung entries since controller start "
            "(re-seeded from persisted rung annotations on adoption)",
            "rung",
        )
        r.describe(
            "quarantine_cycle_demotions_total",
            "Slices demoted quarantined -> upgrade-failed after flapping "
            "across the configured number of dwell windows",
        )
        r.describe(
            "controller_adoptions_total",
            "Re-adoption passes run (one per leadership epoch / process "
            "start)",
        )
        r.describe(
            "controller_leader_term",
            "leaseTransitions number of the current leadership epoch",
        )
        r.describe(
            "api_circuit_open_endpoints",
            "API endpoints whose circuit breaker is currently open "
            "(>0 = reconcile degraded)",
        )
        r.describe(
            "api_request_retries_total",
            "Transient API failures retried by the client",
        )
        r.describe(
            "api_breaker_fast_fails_total",
            "API calls fast-failed because the endpoint circuit was open",
        )
        # Informer-backed cached reconcile surface (absent when the
        # manager reads through a raw client, i.e. polling mode).
        r.describe(
            "api_requests_per_tick",
            "API round trips issued during the last reconcile pass "
            "(all verbs; ~0 at steady state with a warm cache)",
        )
        r.describe(
            "api_writes_per_tick",
            "Mutating API round trips (patch/create/delete/evict/update) "
            "issued during the last reconcile pass — the write-path "
            "hygiene number the coalesced node patches drive down",
        )
        # Transactional write-plane surface (k8s/writeplan.py): absent
        # when the manager is an injected fake without a plan.
        r.describe(
            "writes_suppressed_total",
            "Writes skipped because the value already matched the cached "
            "object (no-op suppression, stage- and flush-time)",
        )
        r.describe(
            "writes_coalesced_total",
            "Extra key-groups folded into combined per-node metadata "
            "patches (round trips avoided by coalescing)",
        )
        r.describe(
            "writeplan_writes_total",
            "API writes issued by the write plane, by flow",
            "flow",
        )
        r.describe(
            "writeplan_flushes_total",
            "Write-plan flush batches executed",
        )
        r.describe(
            "writeplan_fenced_drops_total",
            "Queued write intents dropped whole at flush because the "
            "liveness or term fence said this process was deposed",
        )
        r.describe(
            "writeplan_conflict_replays_total",
            "409-conflicted patches replayed through quorum re-read + "
            "re-fence + re-dedupe (node and CR-status flows)",
        )
        r.describe(
            "writeplan_pending",
            "Write intents staged but not yet flushed, by kind",
            "kind",
        )
        r.describe(
            "events_published_total",
            "Cluster Events actually created by the write plane",
        )
        r.describe(
            "events_aggregated_total",
            "Event occurrences absorbed into count-carrying aggregates "
            "instead of separate Event objects (kubelet-style)",
        )
        r.describe(
            "flow_tokens",
            "Token-bucket level per APF flow",
            "flow",
        )
        r.describe(
            "flow_throttled",
            "1 when the flow's bucket is penalized below its base rate "
            "(429/Retry-After feedback), else 0",
            "flow",
        )
        r.describe(
            "flow_throttle_waits_total",
            "Times a mutating write waited on its bucket",
        )
        r.describe(
            "flow_deferred_total",
            "Status/event writes deferred to the next tick by a dry "
            "status bucket",
        )
        r.describe(
            "informer_cache_hits_total",
            "Hot-path reads served from the informer store",
        )
        r.describe(
            "informer_cache_misses_total",
            "Hot-path reads that fell through to the API (cold, stale, "
            "or absent object)",
        )
        r.describe(
            "informer_snapshot_age_seconds",
            "Seconds since the informer feed last heard from the "
            "apiserver (-1 = never synced)",
        )
        r.describe(
            "informer_lists_total",
            "Baseline LIST syncs the informer has performed",
        )
        r.describe(
            "informer_watch_reconnects_total",
            "Watch stream reconnects (resumed from the per-kind floor)",
        )
        r.describe(
            "informer_relists_total",
            "410-Gone invalidations that forced a full re-list",
        )
        # Sharded dirty-set reconcile surface (absent when the
        # controller runs the classic full-pass loop).
        r.describe(
            "reconcile_dirty_pools",
            "Pools walked by the last dirty tick (0 at steady state — "
            "the tick-cost-is-O(changed) evidence)",
        )
        r.describe(
            "reconcile_shard_busy",
            "Reconcile shards currently executing a pool pass",
        )
        r.describe(
            "reconcile_shards", "Configured reconcile shard count"
        )
        r.describe(
            "dirty_queue_depth", "Pools currently marked dirty (queued)"
        )
        r.describe(
            "dirty_queue_in_flight",
            "Pools claimed by a shard and not yet released",
        )
        r.describe(
            "dirty_queue_oldest_wait_seconds",
            "Age of the oldest still-queued dirty mark",
        )
        r.describe(
            "dirty_tick_duration_seconds",
            "Wall-clock of the last dirty tick (batch submit + wait)",
        )
        r.describe(
            "dirty_tick_max_queue_wait_seconds",
            "Longest time a pool in the last batch sat queued before a "
            "shard picked it up (queue latency)",
        )
        r.describe(
            "dirty_events_routed_total",
            "Watch deltas routed into the dirty set",
        )
        r.describe(
            "dirty_events_coalesced_total",
            "Routed deltas folded into an already-dirty pool entry",
        )
        r.describe(
            "dirty_pools_reconciled_total",
            "Pool-scoped reconcile passes completed by shards",
        )
        r.describe(
            "dirty_shard_errors_total",
            "Shard passes that crashed (pool requeued)",
        )
        r.describe(
            "dirty_shard_fenced_total",
            "Shard passes abandoned by the leadership fence",
        )
        r.describe(
            "dirty_pod_events_unrouted_total",
            "Pod deltas on nodes absent from the pool registry (covered "
            "by the node's own event or the next full resync)",
        )
        r.describe(
            "full_resyncs_total",
            "Periodic full-resync passes (safety net; re-seeds the pool "
            "registry and re-baselines the budget ledger)",
        )
        r.describe(
            "budget_unavailable_used",
            "Unavailability units currently charged in the shared "
            "maxUnavailable ledger (claims + external faults)",
        )
        r.describe(
            "budget_unavailable_cap",
            "Effective maxUnavailable cap the ledger enforces",
        )
        r.describe(
            "budget_parallel_used",
            "Groups currently holding an in-progress budget claim",
        )
        # Materialized-view surface (upgrade/matview.py): the O(delta)
        # incremental read path.  The view is an optimization, never an
        # authority — hits vs fallbacks show how often ticks avoided a
        # full scoped build, diff mismatches count every disagreement
        # the resync audit found (each one also triggered a fail-open
        # reseed).
        r.describe(
            "matview_hits_total",
            "Pool reconciles served from the materialized view "
            "(O(changed-objects) build, no informer re-scan)",
        )
        r.describe(
            "matview_fallback_rebuilds_total",
            "Pool reconciles that fell back to a full scoped "
            "build_state (view unseeded / stale / invalidated)",
        )
        r.describe(
            "matview_diff_mismatches_total",
            "View-vs-build_state disagreements found by the full-resync "
            "audit (each batch triggers a fail-open reseed)",
        )
        r.describe(
            "matview_pools",
            "Pools currently materialized in the view",
        )
        r.describe(
            "matview_rows",
            "Node rows currently materialized in the view",
        )
        r.describe(
            "matview_interned_strings",
            "Distinct strings in the view's intern pool (state labels, "
            "pool keys)",
        )
        r.describe(
            "matview_apply_latency_us",
            "Mean per-delta view apply latency in microseconds "
            "(runs under the informer lock; must stay O(1))",
        )
        # Multi-artifact stack surface (artifacts/ + the engine's
        # POD_RESTART_REQUIRED stepping; absent on single-artifact
        # policies, where the DAG of size 1 IS the classic path).
        r.describe(
            "artifact_synced_nodes",
            "Nodes whose pod for this artifact is at the target "
            "revision (vacuously synced nodes included)",
            "artifact",
        )
        r.describe(
            "artifact_nodes",
            "Nodes in groups currently stepping through this artifact",
            "artifact",
        )
        r.describe(
            "artifact_skew_holds_total",
            "Pod restarts withheld because a pinned-order edge put the "
            "artifact at a later level than the group's cursor",
            "artifact",
        )
        r.describe(
            "artifact_gate_holds_total",
            "Times an artifact's network-path gate held the stack at "
            "its edge (probe failed or errored; fail-closed)",
            "artifact",
        )
        r.describe(
            "artifact_rollbacks_total",
            "Multi-artifact rollbacks unwound in reverse topological "
            "order after a crash-looping artifact pod",
        )
        r.describe(
            "artifact_shared_window_savings_total",
            "Node cordon/drain windows avoided by rolling the whole "
            "stack inside one window (nodes x extra artifacts)",
        )
        # Fused probe-battery surface (health.fused; absent when the
        # controller never probed in-process, e.g. NodeReportProber-only
        # deployments where the agents run the battery instead).
        r.describe(
            "probe_battery_seconds",
            "Last fused-battery phase duration (compile is 0 on a "
            "topology-keyed cache hit)",
            "phase",
        )
        r.describe(
            "probe_battery_cache_hits_total",
            "Fused-battery dispatches served by the topology-keyed "
            "compile cache",
        )
        r.describe(
            "probe_battery_cache_misses_total",
            "Fused-battery compiles (first sight of a topology key)",
        )
        r.describe(
            "probe_battery_fallbacks_total",
            "Fused-battery failures that fell back to the unfused probes",
        )
        r.describe(
            "probe_battery_cached_programs",
            "Distinct topology keys currently held in the compile cache",
        )
        # Elastic roll coordination surface (absent on injected fakes
        # and on controllers with `elastic` disabled in policy).
        r.describe(
            "elastic_negotiations_total",
            "Exclusion-offer negotiations settled since controller start",
            "outcome",
        )
        r.describe(
            "elastic_resizes_total",
            "Workload mesh resizes completed (down = slice excluded, "
            "up = slice rejoined)",
            "direction",
        )
        r.describe(
            "elastic_resize_seconds",
            "Offer-to-resize-complete wall-clock of the last workload "
            "mesh resize (annotation epochs, 1s resolution)",
        )
        r.describe(
            "elastic_excluded_slices",
            "Slices currently excluded from their workload's mesh "
            "(rolling without budget charge)",
        )
        r.describe(
            "validation_wall_seconds",
            "Wall-clock of each slice's last passed validation gate "
            "(stamp -> healthy verdict, including async probe queueing)",
            "slice",
        )
        # Heterogeneous-fleet surface.
        r.describe(
            "preemptions_total",
            "Preempted in-flight slices observed, per generation "
            "(fast-path handling: no quarantine, budget released)",
            "generation",
        )
        r.describe(
            "fleet_nodes",
            "Managed nodes per device generation",
            "generation",
        )
        r.describe(
            "fleet_pool_window_open",
            "1 when the pool's maintenance window is open (or it has "
            "none), 0 while its groups hold in window-wait",
            "pool",
        )
        r.describe(
            "fleet_window_held_groups",
            "Groups currently holding in the budget-free window-wait "
            "condition",
        )
        r.describe(
            "fleet_window_invalid",
            "1 while the pool's maintenanceWindow cron fails to parse at "
            "runtime (the engine fails OPEN; see WindowCronInvalid events)",
            "pool",
        )
        # Predictive rollout-planning surface (planning/; absent until a
        # roll is active and the drift watchdog has anchored a plan).
        r.describe(
            "fleet_roll_infeasible",
            "1 per structural reason the active roll can provably never "
            "finish (window-starvation, budget-deadlock, "
            "elastic-decline-storm)",
            "reason",
        )
        r.describe(
            "plan_waves",
            "Upgrade waves in the anchored roll plan",
        )
        r.describe(
            "plan_groups",
            "Groups covered by the anchored roll plan",
        )
        r.describe(
            "plan_completed_groups",
            "Planned groups that have reached upgrade-done",
        )
        r.describe(
            "plan_projected_completion_timestamp_seconds",
            "Projected roll completion (unix epoch), drift-adjusted",
        )
        r.describe(
            "plan_drift_seconds",
            "Lateness of the next planned completion (positive = behind "
            "plan, negative = ahead)",
        )
        r.describe(
            "plan_infeasible",
            "Count of structural plan-infeasibility reasons currently "
            "detected (0 = the roll can finish)",
        )
        r.describe(
            "plan_replans_total",
            "Bounded re-plans triggered by drift over threshold",
        )
        # Plan-guided admission surface (planning.admissionMode).
        r.describe(
            "admission_mode",
            "1 for the admission ordering the engine used on its last "
            "pass: packed (plan-guided first-fit-decreasing) or greedy "
            "(generation/id order; also the fallback when no fresh plan "
            "is anchored)",
            "mode",
        )
        r.describe(
            "budget_saturation",
            "Fraction of the unavailability budget in use after the last "
            "admission pass (used / cap)",
        )
        r.describe(
            "budget_idle_ticks_total",
            "Admission passes that ended with idle budget despite an "
            "admissible group having been denied earlier in the same "
            "pass — structurally 0; any increase is an admission bug",
        )
        r.describe(
            "admission_packed_total",
            "Groups admitted under packed (plan-guided) ordering",
        )
        r.describe(
            "budget_wakeups_targeted_total",
            "Budget-release wakeups routed to the planned-next wave's "
            "pools only (vs blanket-waking every denied waiter)",
        )
        r.describe(
            "budget_wakeups_deferred_total",
            "Denied waiters re-queued (not woken) by a targeted "
            "budget-release wakeup; they re-enter on the next release "
            "or full resync",
        )
        # Fleet health telemetry surface (obs/telemetry; absent on
        # injected fake managers without the plane wired).
        r.describe(
            "node_health_score",
            "Per-node health score (100 = at fleet baseline; 12.5 points "
            "lost per robust-z of the worst below-baseline stat)",
            "node",
        )
        r.describe(
            "fleet_stragglers",
            "Nodes holding a confirmed straggler verdict (sustained "
            "below-baseline probe telemetry), per cohort",
            "generation",
            "pool",
        )
        r.describe(
            "probe_measured",
            "Fleet median of each measured probe statistic's latest "
            "per-node sample",
            "check",
            "stat",
        )
        r.describe(
            "telemetry_samples_total",
            "Probe-battery telemetry samples ingested into per-node "
            "histories",
        )
        r.describe(
            "telemetry_drops_total",
            "Telemetry-plane fail-open exceptions swallowed (capture, "
            "persistence, or adoption path)",
        )
        r.describe(
            "federation_cluster_health",
            "Member-cluster control-plane health ladder rung "
            "(0=Reachable, 1=Degraded, 2=Partitioned)",
            "cluster",
            "region",
        )
        r.describe(
            "federation_cluster_done",
            "1 when every group in the member cluster reached "
            "upgrade-done this federated roll",
            "cluster",
        )
        r.describe(
            "federation_frozen_groups",
            "Budget charges held fail-static for a partitioned member "
            "cluster (released only on heal-time re-adoption)",
            "cluster",
        )
        r.describe(
            "federation_probes_total",
            "Cross-cluster reachability probes issued by the registry",
        )
        r.describe(
            "federation_probe_failures_total",
            "Reachability probes that failed (hard or breaker-open)",
        )
        r.describe(
            "federation_partitions_total",
            "Member clusters stepped onto the Partitioned rung",
        )
        r.describe(
            "federation_heals_total",
            "Member clusters stepped back off the Partitioned rung",
        )
        r.describe(
            "federation_phase",
            "Federated roll phase (1 on the current phase's series)",
            "phase",
        )
        r.describe(
            "federation_canary_held",
            "1 while the canary gate holds promotion on a confirmed "
            "telemetry regression",
        )
        r.describe(
            "federation_canary_holds_total",
            "Canary promotion holds latched over the coordinator's "
            "lifetime",
        )
        r.describe(
            "federation_soak_remaining_seconds",
            "Seconds of clean canary soak still required before "
            "promotion",
        )
        r.describe(
            "federation_budget_unavailable_used",
            "Units currently charged against the global unavailability "
            "budget across all member clusters",
        )
        r.describe(
            "federation_budget_unavailable_cap",
            "Global unavailability budget cap in units",
        )
        r.describe(
            "federation_budget_parallel_used",
            "Groups concurrently in flight against the global parallel "
            "cap",
        )
        r.describe(
            "federation_budget_denials_total",
            "Admission attempts denied by the global budget hierarchy",
        )
        r.describe(
            "federation_budget_violations_total",
            "Non-forced grants observed above the global cap (must stay "
            "0)",
        )
        r.describe(
            "federation_store_writes_total",
            "Writes the durable federation state store issued (phase "
            "edges only, never per tick)",
        )
        # api_requests_per_tick baseline: total verb count at the end of
        # the previous observe() call.
        self._last_api_total: Optional[float] = None
        # api_writes_per_tick baseline, write verbs only.
        self._last_api_writes: Optional[float] = None

    def observe(self, manager, state, duration_s: float) -> None:
        r = self.registry
        r.clear("nodes_by_state")
        r.clear("slices_by_state")
        for st in UpgradeState:
            label = st.value or "unknown"
            r.set(
                "nodes_by_state", len(state.nodes_in(st)), state=label
            )
            r.set(
                "slices_by_state", len(state.groups_in(st)), state=label
            )
        r.set("nodes_total", manager.get_total_managed_nodes(state))
        r.set("slices_total", manager.get_total_managed_groups(state))
        r.set("upgrades_in_progress", manager.get_upgrades_in_progress(state))
        r.set("upgrades_done", manager.get_upgrades_done(state))
        r.set("upgrades_failed", manager.get_upgrades_failed(state))
        r.set("upgrades_pending", manager.get_upgrades_pending(state))
        r.set("reconcile_duration_seconds", duration_s)
        r.inc("reconcile_total")
        # Data-plane fault-tolerance surface (absent on injected fakes).
        r.set(
            "slices_quarantined",
            len(state.groups_in(UpgradeState.QUARANTINED)),
        )
        r.set(
            "slice_quarantines_total",
            getattr(manager, "quarantines_total", 0),
        )
        r.set("slice_rejoins_total", getattr(manager, "rejoins_total", 0))
        r.set(
            "quarantine_cycle_demotions_total",
            getattr(manager, "quarantine_cycle_demotions", 0),
        )
        # Multi-artifact stack surface (absent on injected fakes and a
        # no-op for single-artifact policies, whose progress dict stays
        # empty).  Per-artifact gauges republish as a snapshot so a
        # finished stack's series don't linger.
        progress = getattr(manager, "artifact_progress", None)
        if progress is not None:
            r.clear("artifact_synced_nodes")
            r.clear("artifact_nodes")
            for name, (synced, total) in sorted(progress.items()):
                r.set("artifact_synced_nodes", synced, artifact=name)
                r.set("artifact_nodes", total, artifact=name)
            for name, count in sorted(
                getattr(manager, "artifact_skew_holds", {}).items()
            ):
                r.set("artifact_skew_holds_total", count, artifact=name)
            for name, count in sorted(
                getattr(manager, "artifact_gate_holds", {}).items()
            ):
                r.set("artifact_gate_holds_total", count, artifact=name)
            r.set(
                "artifact_rollbacks_total",
                getattr(manager, "artifact_rollbacks_total", 0),
            )
            r.set(
                "artifact_shared_window_savings_total",
                getattr(manager, "artifact_window_savings", 0),
            )
        negotiations = getattr(manager, "elastic_negotiations", None)
        if negotiations is not None:
            for outcome, count in sorted(negotiations.items()):
                r.set("elastic_negotiations_total", count, outcome=outcome)
        resizes = getattr(manager, "elastic_resizes", None)
        if resizes is not None:
            for direction, count in sorted(resizes.items()):
                r.set("elastic_resizes_total", count, direction=direction)
            r.set(
                "elastic_resize_seconds",
                getattr(manager, "elastic_resize_seconds", 0.0),
            )
        excluded_check = getattr(manager, "_group_elastic_excluded", None)
        if excluded_check is not None:
            excluded = {
                group.id
                for groups in state.groups.values()
                for group in groups
                if excluded_check(group)
            }
            r.set("elastic_excluded_slices", len(excluded))
        esc_stats = getattr(manager, "escalation_stats", None)
        if esc_stats is not None and hasattr(esc_stats, "snapshot"):
            for rung, count in sorted(esc_stats.snapshot().items()):
                r.set("eviction_escalations_total", count, rung=rung)
        # Plan-guided admission surface (absent on injected fakes).
        astats = getattr(manager, "admission_stats", None)
        if astats is not None:
            cap = astats.get("last_budget_cap", 0)
            if cap:
                r.set(
                    "budget_saturation",
                    astats.get("last_budget_used", 0) / cap,
                )
            r.set(
                "budget_idle_ticks_total",
                astats.get("budget_idle_ticks", 0),
            )
            r.set(
                "admission_packed_total", astats.get("packed_admitted", 0)
            )
            mode = getattr(manager, "admission_mode", "greedy")
            r.clear("admission_mode")
            r.set("admission_mode", 1.0, mode=mode)
        # Client resilience surface (present on RestClient and
        # ResilientClient; absent on a bare FakeCluster).
        client = getattr(manager, "client", None)
        breaker = getattr(client, "breaker", None)
        if breaker is not None and hasattr(breaker, "open_endpoints"):
            r.set(
                "api_circuit_open_endpoints", len(breaker.open_endpoints())
            )
        retry_stats = getattr(client, "retry_stats", None)
        if retry_stats is not None:
            r.set(
                "api_request_retries_total", retry_stats.get("retries", 0)
            )
            r.set(
                "api_breaker_fast_fails_total",
                retry_stats.get("breaker_fast_fail", 0),
            )
        # Cached-reconcile surface.  ``client.stats`` counts actual API
        # round trips per verb (a CachedKubeClient delegates the attr to
        # its inner client), so the delta across observe() calls is the
        # API cost of the tick that just ran — the number the informer
        # exists to drive to ~0 at steady state.
        api_stats = getattr(client, "stats", None)
        if api_stats is not None and hasattr(api_stats, "values"):
            total = float(sum(api_stats.values()))
            if self._last_api_total is not None:
                r.set(
                    "api_requests_per_tick", total - self._last_api_total
                )
            self._last_api_total = total
            # Write verbs only.  Stats keys are "patch_node" style on the
            # fake cluster and "PATCH nodes" style on the REST client, so
            # a case-insensitive prefix match covers both.
            writes = float(
                sum(
                    v
                    for k, v in api_stats.items()
                    if str(k)
                    .lower()
                    .startswith(
                        (
                            "patch",
                            "create",
                            "delete",
                            "evict",
                            "update",
                            "post",
                            "put",
                        )
                    )
                )
            )
            if self._last_api_writes is not None:
                r.set("api_writes_per_tick", writes - self._last_api_writes)
            self._last_api_writes = writes
        # Transactional write-plane surface (k8s/writeplan.py).
        plan = getattr(manager, "write_plan", None)
        if plan is not None and hasattr(plan, "counters"):
            c = plan.counters()
            r.set("writes_suppressed_total", c.get("suppressed", 0))
            r.set("writes_coalesced_total", c.get("coalesced_keys", 0))
            r.set("writeplan_flushes_total", c.get("flushes", 0))
            r.set(
                "writeplan_writes_total",
                c.get("writes_mutating", 0),
                flow="mutating",
            )
            r.set(
                "writeplan_writes_total",
                c.get("writes_status", 0),
                flow="status",
            )
            r.set(
                "writeplan_fenced_drops_total",
                c.get("fenced_drops", 0)
                + c.get("fenced_drops_status", 0)
                + c.get("fenced_drops_events", 0),
            )
            r.set(
                "writeplan_conflict_replays_total",
                c.get("conflict_replays", 0)
                + c.get("status_conflict_replays", 0),
            )
            r.set("events_published_total", c.get("events_published", 0))
            r.set("events_aggregated_total", c.get("events_aggregated", 0))
            r.set(
                "flow_throttle_waits_total",
                c.get("throttle_waits_mutating", 0),
            )
            r.set("flow_deferred_total", c.get("deferred_status", 0))
            for kind, depth in sorted(plan.pending_depth().items()):
                r.set("writeplan_pending", depth, kind=kind)
            for flow, fs in sorted(plan.flows.state().items()):
                r.set("flow_tokens", fs.get("tokens", 0.0), flow=flow)
                r.set("flow_throttled", fs.get("throttled", 0.0), flow=flow)
        # Heterogeneous-fleet surface.
        preemptions = getattr(manager, "preemptions", None)
        if preemptions is not None:
            for gen, count in sorted(preemptions.items()):
                r.set("preemptions_total", count, generation=gen or "unknown")
        try:
            from k8s_operator_libs_tpu_torch.fleet.profiles import (
                generation_of,
                group_accelerator,
            )
        except Exception:  # noqa: BLE001 — keep metrics best-effort
            generation_of = None
        if generation_of is not None:
            gen_nodes: dict = {}
            for groups in state.groups.values():
                for group in groups:
                    gen = (
                        generation_of(group_accelerator(group))
                        or "unknown"
                    )
                    gen_nodes[gen] = gen_nodes.get(gen, 0) + group.size()
            r.clear("fleet_nodes")
            for gen, count in sorted(gen_nodes.items()):
                r.set("fleet_nodes", count, generation=gen)
        window_open = getattr(manager, "pool_window_open", None)
        if window_open is not None:
            r.clear("fleet_pool_window_open")
            for pool, is_open in sorted(window_open.items()):
                r.set(
                    "fleet_pool_window_open",
                    1 if is_open else 0,
                    pool=pool,
                )
        r.set(
            "fleet_window_held_groups",
            getattr(manager, "window_held_groups", 0),
        )
        cron_invalid = getattr(manager, "window_cron_invalid", None)
        if cron_invalid is not None:
            r.clear("fleet_window_invalid")
            for pool in sorted(cron_invalid):
                r.set("fleet_window_invalid", 1, pool=pool)
        # Fused-battery surface: import lazily so a controller built
        # without torch (pure NodeReportProber aggregation) still exports
        # everything else.
        try:
            from k8s_operator_libs_tpu_torch.health.fused import battery_stats
        except Exception:  # noqa: BLE001 — torch absent is fine
            battery_stats = None
        if battery_stats is not None:
            bstats = battery_stats()
            if bstats.get("compile_cache_hits") or bstats.get(
                "compile_cache_misses"
            ):
                r.set(
                    "probe_battery_seconds",
                    bstats.get("last_compile_ms", 0.0) / 1000.0,
                    phase="compile",
                )
                r.set(
                    "probe_battery_seconds",
                    bstats.get("last_execute_ms", 0.0) / 1000.0,
                    phase="execute",
                )
                r.set(
                    "probe_battery_cache_hits_total",
                    bstats.get("compile_cache_hits", 0),
                )
                r.set(
                    "probe_battery_cache_misses_total",
                    bstats.get("compile_cache_misses", 0),
                )
                r.set(
                    "probe_battery_fallbacks_total",
                    bstats.get("fallbacks", 0),
                )
                r.set(
                    "probe_battery_cached_programs",
                    bstats.get("cached_programs", 0),
                )
        vm = getattr(manager, "validation_manager", None)
        for gid, wall in getattr(vm, "validation_wall_s", {}).items():
            r.set("validation_wall_seconds", wall, slice=gid)
        informer = getattr(client, "informer", None)
        if informer is not None and hasattr(informer, "stats"):
            istats = informer.stats
            r.set("informer_cache_hits_total", istats.get("cache_hits", 0))
            r.set(
                "informer_cache_misses_total",
                istats.get("cache_misses", 0),
            )
            r.set("informer_lists_total", istats.get("lists", 0))
            r.set(
                "informer_watch_reconnects_total",
                istats.get("watch_reconnects", 0),
            )
            r.set("informer_relists_total", istats.get("relists_410", 0))
            age = informer.age_s()
            r.set(
                "informer_snapshot_age_seconds",
                age if age != float("inf") else -1.0,
            )

    def observe_plan(self, report) -> None:
        """Publish the drift watchdog's verdict (a planning.DriftReport).

        An inactive report clears the whole surface so a finished roll's
        ETA does not linger as a stale promise.
        """
        r = self.registry
        if report is None or not report.active:
            for name in (
                "plan_waves",
                "plan_groups",
                "plan_completed_groups",
                "plan_projected_completion_timestamp_seconds",
                "plan_drift_seconds",
                "plan_infeasible",
            ):
                r.clear(name)
            return
        r.set("plan_waves", report.wave_count)
        r.set("plan_groups", report.planned_groups)
        r.set("plan_completed_groups", report.completed_groups)
        r.set(
            "plan_projected_completion_timestamp_seconds",
            report.projected_completion_epoch,
        )
        r.set("plan_drift_seconds", report.drift_seconds)
        r.set("plan_infeasible", len(report.infeasible))
        r.set("plan_replans_total", report.replans)

    def observe_trace(self, manager, breakdown=None) -> None:
        """Publish the roll-tracing surface (obs/): recorder health
        (open spans, fail-open drops), flight-recorder activity (dumps
        per trigger reason, spool footprint), and — once a roll
        completes — its critical-path makespan buckets.  Everything here
        is getattr-guarded: injected fake managers without the obs
        wiring publish nothing."""
        r = self.registry
        rec = getattr(manager, "trace_recorder", None)
        if rec is not None:
            r.set("trace_spans_open", rec.open_span_count())
            r.set("trace_drops_total", rec.drops)
            r.set("trace_active", 1.0 if rec.active else 0.0)
        fr = getattr(manager, "flight_recorder", None)
        if fr is not None:
            for reason, count in sorted(fr.dumps_total.items()):
                r.set("flightrec_dumps_total", count, reason=reason)
            r.set("flightrec_throttled_total", fr.throttled_total)
            r.set("flightrec_note_drops_total", fr.note_drops)
            r.set("flightrec_spool_bytes", fr.spool_bytes())
        if breakdown:
            r.set(
                "roll_makespan_seconds",
                breakdown.get("makespanSeconds", 0.0),
            )
            for bucket, seconds in sorted(
                (breakdown.get("buckets") or {}).items()
            ):
                r.set(
                    "roll_makespan_bucket_seconds", seconds, bucket=bucket
                )

    def observe_telemetry(self, manager) -> None:
        """Publish the fleet-health telemetry surface (obs/telemetry):
        per-node health scores, confirmed stragglers per cohort, and the
        fleet median of each measured probe stat.  Gauges are cleared
        first so departed nodes and cohorts don't linger.  getattr-
        guarded: injected fake managers without the plane publish
        nothing."""
        plane = getattr(manager, "telemetry_plane", None)
        if plane is None:
            return
        r = self.registry
        view = plane.metrics_view()
        r.clear("node_health_score")
        for node, score in sorted(view["scores"].items()):
            r.set("node_health_score", score, node=node)
        r.clear("fleet_stragglers")
        for (generation, pool), count in sorted(
            view["stragglers"].items()
        ):
            r.set(
                "fleet_stragglers", count, generation=generation, pool=pool
            )
        r.clear("probe_measured")
        for (check, stat), value in sorted(view["measured"].items()):
            r.set("probe_measured", value, check=check, stat=stat)
        r.set("telemetry_samples_total", view["samples_total"])
        r.set("telemetry_drops_total", view["drops"])

    def observe_federation(self, coordinator) -> None:
        """Publish the federated control-plane surface (federation/):
        the per-cluster health ladder, fail-static freeze depth, the
        canary gate, and the global budget hierarchy's counters.
        Cleared-then-set for every labelled family so removed clusters
        and stale phases don't linger.  getattr-guarded like the other
        observe_* hooks: a bare manager publishes nothing."""
        registry = getattr(coordinator, "registry", None)
        if registry is None:
            return
        r = self.registry
        rung = {"Reachable": 0.0, "Degraded": 1.0, "Partitioned": 2.0}
        healths = registry.healths()
        done = getattr(coordinator, "_done", {})
        r.clear("federation_cluster_health")
        r.clear("federation_cluster_done")
        r.clear("federation_frozen_groups")
        for member in registry.members():
            health = healths[member.name].value
            r.set(
                "federation_cluster_health",
                rung.get(health, 2.0),
                cluster=member.name,
                region=member.region,
            )
            r.set(
                "federation_cluster_done",
                1.0 if done.get(member.name) else 0.0,
                cluster=member.name,
            )
            r.set(
                "federation_frozen_groups",
                len(member.frozen_groups),
                cluster=member.name,
            )
        stats = registry.stats
        r.set("federation_probes_total", stats.get("probes", 0))
        r.set(
            "federation_probe_failures_total",
            stats.get("probe_failures", 0),
        )
        r.set("federation_partitions_total", stats.get("partitions", 0))
        r.set("federation_heals_total", stats.get("heals", 0))
        r.clear("federation_phase")
        r.set("federation_phase", 1.0, phase=coordinator.phase)
        gate = getattr(coordinator, "gate", None)
        if gate is not None:
            verdict = gate.evaluate()
            r.set(
                "federation_canary_held",
                1.0 if gate.held is not None else 0.0,
            )
            r.set("federation_canary_holds_total", gate.holds_total)
            r.set(
                "federation_soak_remaining_seconds",
                round(verdict.soak_remaining_s, 3),
            )
        ledger = getattr(coordinator, "global_ledger", None)
        if ledger is not None:
            r.set(
                "federation_budget_unavailable_used",
                ledger.unavailable_used(),
            )
            r.set(
                "federation_budget_unavailable_cap",
                ledger.max_unavailable,
            )
            r.set(
                "federation_budget_parallel_used", ledger.parallel_used()
            )
            r.set("federation_budget_denials_total", ledger.denials)
            r.set(
                "federation_budget_violations_total", ledger.violations
            )
        store = getattr(coordinator, "store", None)
        if store is not None:
            r.set(
                "federation_store_writes_total",
                getattr(store, "writes", 0),
            )

    def observe_sharded(self, sharded, report=None) -> None:
        """Publish the sharded-reconcile surface.  Called with a
        TickReport after each dirty tick, and without one after a full
        resync (queue/ledger gauges still refresh there)."""
        r = self.registry
        r.set("reconcile_shards", sharded.shards)
        r.set("reconcile_shard_busy", sharded.busy_shards())
        r.set("dirty_queue_depth", sharded.queue.depth())
        r.set("dirty_queue_in_flight", sharded.queue.in_flight())
        r.set(
            "dirty_queue_oldest_wait_seconds",
            sharded.queue.oldest_wait_s(),
        )
        qstats = sharded.queue.stats
        r.set(
            "dirty_events_routed_total", qstats.get("events_routed", 0)
        )
        r.set(
            "dirty_events_coalesced_total",
            qstats.get("events_coalesced", 0),
        )
        r.set(
            "dirty_pod_events_unrouted_total",
            sharded.router.stats.get("pod_events_unrouted", 0),
        )
        sstats = sharded.stats
        r.set(
            "dirty_pools_reconciled_total",
            sstats.get("pools_reconciled", 0),
        )
        r.set("dirty_shard_errors_total", sstats.get("shard_errors", 0))
        r.set("dirty_shard_fenced_total", sstats.get("fenced", 0))
        r.set("full_resyncs_total", sstats.get("full_resyncs", 0))
        r.set(
            "budget_wakeups_targeted_total",
            sstats.get("budget_wakeups_targeted", 0),
        )
        r.set(
            "budget_wakeups_deferred_total",
            sstats.get("budget_wakeups_deferred", 0),
        )
        ledger = sharded.ledger
        r.set("budget_unavailable_used", ledger.unavailable_used())
        r.set("budget_unavailable_cap", ledger.max_unavailable)
        r.set("budget_parallel_used", ledger.parallel_used())
        view = getattr(sharded, "matview", None)
        if view is not None:
            r.set("matview_hits_total", sstats.get("matview_hits", 0))
            r.set(
                "matview_fallback_rebuilds_total",
                sstats.get("matview_fallbacks", 0),
            )
            r.set(
                "matview_diff_mismatches_total",
                view.stats.get("diff_mismatches", 0),
            )
            vstats = view.snapshot_stats()
            r.set("matview_pools", vstats["pools"])
            r.set("matview_rows", vstats["rows"])
            r.set(
                "matview_interned_strings", vstats["interned_strings"]
            )
            r.set(
                "matview_apply_latency_us",
                round(vstats["apply_avg_us"], 3),
            )
        if report is not None:
            r.set("reconcile_dirty_pools", report.pools_walked)
            r.set("dirty_tick_duration_seconds", report.duration_s)
            r.set(
                "dirty_tick_max_queue_wait_seconds",
                report.max_queue_wait_s,
            )


class SliceUpgradeTimer:
    """Tracks per-slice upgrade wall-clock: starts when a slice leaves
    done/unknown, stops when it returns to done — the north-star number."""

    # Snapshots a group must be absent from before its in-flight entry is
    # pruned: a mid-upgrade group can transiently vanish from ONE snapshot
    # (its driver pod recreated and briefly unscheduled), and pruning on
    # first miss would restart the clock and under-report the outage.
    PRUNE_AFTER_MISSES = 3

    def __init__(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self._started: dict[str, float] = {}
        self._misses: dict[str, int] = {}

    def observe_state(self, state) -> None:
        # Groups arrive pre-bucketed by effective state in state.groups.
        now = time.monotonic()
        seen: set[str] = set()
        for label, groups in state.groups.items():
            # upgrade-failed counts as in-flight: dwell time in failed IS
            # wall-clock the slice was disrupted, and a failed-then-
            # recovered upgrade should report its full outage.
            in_flight = label not in ("", UpgradeState.DONE.value)
            for group in groups:
                seen.add(group.id)
                if in_flight and group.id not in self._started:
                    self._started[group.id] = now
                elif not in_flight and group.id in self._started:
                    elapsed = now - self._started.pop(group.id)
                    self.registry.set(
                        "slice_upgrade_seconds", elapsed, slice=group.id
                    )
        # Prune groups that stay vanished from the snapshot (deleted node
        # pool, relabeled slice): a long-lived controller must not leak
        # entries, and a re-created slice id must not inherit a stale
        # start time.  Absence must persist PRUNE_AFTER_MISSES snapshots —
        # a transiently-invisible mid-upgrade group keeps its clock.
        for gid in set(self._started) - seen:
            self._misses[gid] = self._misses.get(gid, 0) + 1
            if self._misses[gid] >= self.PRUNE_AFTER_MISSES:
                del self._started[gid]
                del self._misses[gid]
        for gid in list(self._misses):
            if gid in seen or gid not in self._started:
                self._misses.pop(gid, None)


class MetricsServer:
    """Serve the registry at /metrics (plus a /healthz liveness probe)
    on a stdlib HTTP thread.  Binds loopback by default — exposing the
    scrape endpoint beyond the pod is an explicit deployment decision
    (``--metrics-bind-addr 0.0.0.0``), not a side effect."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        bind_addr: str = "127.0.0.1",
    ) -> None:
        registry_ref = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                path = self.path.rstrip("/")
                if path == "/healthz":
                    body = b"ok\n"
                    content_type = "text/plain"
                elif path in ("", "/metrics"):
                    body = registry_ref.render().encode()
                    content_type = "text/plain; version=0.0.4"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((bind_addr, port), Handler)
        self.bind_addr = bind_addr
        self.port = self._server.server_port
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def start(self) -> None:
        self._thread.start()
        logger.info(
            "metrics listening on %s:%d/metrics (liveness at /healthz)",
            self.bind_addr,
            self.port,
        )

    def stop(self) -> None:
        self._server.shutdown()
