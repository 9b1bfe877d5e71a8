"""The upgrade controller: reconcile loop + CLI.

Counterpart of ``k8s_operator_libs_tpu.controller`` for GPU nodes, the
same loop on the port's modules: it wires the NVIDIA driver DaemonSet
reconciler, the health-agent DaemonSet (its ``DRIVER_REVISION`` pinned to
the driver's ControllerRevision), the state manager, the health gate
(``NodeReportProber`` over the agents' reports) and metrics into one
loop, runnable as::

    python -m k8s_operator_libs_tpu_torch.controller \
        --namespace gpu-operator --selector app=nvidia-driver-daemonset \
        --policy-file policy.yaml --interval 30 --metrics-port 8081

Its keys default to the NVIDIA GPU operator's
(``nvidia.com/gpu-driver-upgrade-state``, :mod:`..keys`); the agents it
deploys read the same driver name from ``DRIVER_NAME``.

The policy YAML is the same camelCase shape a CRD would embed
(api.v1alpha1 round-trips it), e.g.::

    autoUpgrade: true
    maxParallelUpgrades: 1
    maxUnavailable: 25%
    drain: {enable: true, timeoutSeconds: 300}
    sliceAtomic: true
    healthGate: {enable: true, timeoutSeconds: 600}
"""

from __future__ import annotations

import argparse
import signal
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.api.v1alpha1 import (
    DriverUpgradePolicySpec,
    TPUUpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.driver.daemonset import (
    AgentDaemonSetSpec,
    DriverDaemonSetSpec,
    DriverSetReconciler,
)
from k8s_operator_libs_tpu_torch.health import NodeReportProber
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.retry import CircuitOpenError
from k8s_operator_libs_tpu_torch.keys import (
    CONTROLLER_NAME,
    DEFAULT_DRIVER_NAME,
    DRIVER_DAEMONSET_NAME,
    DRIVER_LABELS,
    driver_keys,
)
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState
from k8s_operator_libs_tpu_torch.metrics import (
    MetricsRegistry,
    MetricsServer,
    SliceUpgradeTimer,
    UpgradeMetrics,
)
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
    BuildStateError,
    ClusterUpgradeStateManager,
)
from k8s_operator_libs_tpu_torch.upgrade.util import (
    EVENT_TYPE_WARNING,
    EventRecorder,
    log_event,
)

logger = get_logger(__name__)


@dataclass
class ControllerConfig:
    namespace: str = "kube-system"
    driver_labels: dict[str, str] = field(
        default_factory=lambda: dict(DRIVER_LABELS)
    )
    driver_name: str = DEFAULT_DRIVER_NAME
    interval_s: float = 30.0
    policy: Optional[DriverUpgradePolicySpec] = None
    # When set, the controller also owns the driver DaemonSet.
    daemonset_spec: Optional[DriverDaemonSetSpec] = None
    # When set, the controller also owns the health-agent DaemonSet and
    # keeps its DRIVER_REVISION env pinned to the driver's current
    # ControllerRevision (agents restart and re-report on every driver
    # template change).
    agent_spec: Optional[AgentDaemonSetSpec] = None
    metrics_port: Optional[int] = None
    # Health-gate HBM floor as a fraction of the slice accelerator's
    # published spec bandwidth (hw.chip_spec).  0 disables the floor —
    # only for environments whose probe hosts are not the accelerator the
    # slice labels claim (CPU test rigs).
    hbm_floor_fraction: float = 0.5
    # Resolve HBM/ICI health-gate floors from the fleet GenerationProfile
    # registry (fleet.profiles) when no explicit floor is configured, so a
    # mixed v4/v5e/v6e fleet gates each pool at its own generation's spec.
    # Off by default: the fraction-based floor above stays the reference
    # wiring, and CPU test rigs carry accelerator labels whose published
    # ICI spec their fake reports can't meet.
    generation_floors: bool = False
    # (namespace, name) of a TPUUpgradePolicy CR to read the policy from
    # each pass instead of a static ``policy`` — the consumer-operator
    # pattern (reference SURVEY §1: "policy flows in from the consumer's
    # CRD").  The controller also writes upgrade counters back to the
    # CR's status subresource.
    policy_ref: Optional[tuple[str, str]] = None
    # Event-driven reconcile (controller-runtime informer semantics): a
    # watch on nodes/pods/daemonsets (+ the policy CR when policy_ref is
    # set) triggers a pass immediately instead of waiting out interval_s,
    # which becomes the periodic-resync fallback.  Mid-roll this makes
    # progress latency event-bound, not interval-bound.
    watch: bool = False
    # Coalesce bursts of watch events into one pass.
    watch_debounce_s: float = 0.1
    # Sharded dirty-set reconcile (requires watch): informer deltas feed
    # a per-pool dirty queue; event-driven passes rebuild and reconcile
    # ONLY the touched pools on parallel worker shards, with budget
    # arbitration through a shared maxUnavailable ledger.  interval_s
    # becomes the full-resync safety net.  Tick cost is O(changed)
    # instead of O(fleet).
    sharded: bool = False
    # Worker shards (parallel per-pool reconciles; each pool is still
    # serialized onto at most one shard at a time).
    reconcile_shards: int = 4
    # Scope the informer's Pod list+watch to the driver namespace+labels
    # (field-selector analogue) so non-driver pod volume cannot bloat
    # the store; out-of-scope pod queries (the drain path's per-node
    # all-namespace listing) pass through to the live API.
    informer_pod_scope: bool = True
    # Publish recorded transition/failure events to the cluster as
    # core/v1 Events (reference parity: every transition is an Event,
    # visible in `kubectl describe node`).
    publish_events: bool = True
    # HA: run leader election over a coordination.k8s.io/v1 Lease and
    # reconcile only while holding it — required whenever 2+ controller
    # replicas run (the consumer-operator pattern: controller-runtime
    # managers do the same before starting their reconcilers).
    leader_elect: bool = False
    lease_name: str = CONTROLLER_NAME
    # Defaults to ``namespace`` when None.
    lease_namespace: Optional[str] = None
    # Candidate identity; auto hostname_uuid when empty.
    identity: str = ""
    # Flight-recorder spool directory for black-box snapshots (obs/
    # flightrec.py).  None = <tmpdir>/tpu-upgrade-blackbox; "" disables
    # the on-disk spool (ring + triggers still run in memory).
    trace_spool_dir: Optional[str] = None
    # Address the metrics/healthz server binds.  Loopback by default:
    # exposing the scrape endpoint beyond the pod is a deployment
    # decision ("0.0.0.0"), not a side effect of enabling metrics.
    metrics_bind_addr: str = "127.0.0.1"


class UpgradeController:
    """Owns one driver's upgrade lifecycle end to end."""

    def __init__(self, client: KubeClient, config: ControllerConfig) -> None:
        self.client = client
        self.config = config
        self.keys = driver_keys(config.driver_name)
        self.events = EventRecorder()
        # Informer-backed cached reconcile (watch mode only): the watch
        # pump doubles as the informer's event feed, and the manager
        # reads through a CachedKubeClient so steady-state passes serve
        # nodes/pods/daemonsets/revisions from the cache instead of
        # re-listing.  Polling mode keeps the raw client: with no event
        # stream the cache would always be stale and every read would
        # fall through anyway.  self.client stays raw — leases, the
        # watch pump's own lists and the quorum fences must not be
        # cache-served.
        self.informer = None
        manager_client = client
        if config.watch:
            from k8s_operator_libs_tpu_torch.k8s.informer import (
                CachedKubeClient,
                Informer,
            )

            self.informer = Informer(
                client,
                pod_namespace=(
                    config.namespace if config.informer_pod_scope else ""
                ),
                pod_match_labels=(
                    config.driver_labels
                    if config.informer_pod_scope
                    else None
                ),
            )
            manager_client = CachedKubeClient(client, informer=self.informer)
        self.manager = ClusterUpgradeStateManager(
            manager_client, keys=self.keys, event_recorder=self.events
        )
        # Sharded dirty-set reconcile rides on the watch pump's event
        # stream; without a watch there are no deltas to route.
        self._sharded = None
        if config.sharded and config.watch:
            from k8s_operator_libs_tpu_torch.upgrade.sharded import (
                ShardedReconciler,
            )

            self._sharded = ShardedReconciler(
                self.manager,
                config.namespace,
                config.driver_labels,
                shards=config.reconcile_shards,
                # Same liveness fence as the manager's async workers —
                # reads self.elector at call time (set below).
                fence=lambda: (
                    self.elector is None or self.elector.is_leader()
                ),
                # Budget-release wakeups originate on shard threads, so
                # they must set the loop's wake event themselves (watch
                # events get theirs from the pump).
                wake=lambda: (
                    self._wake.set() if self._wake is not None else None
                ),
            )
        # Health gate: per-host probe-agent reports aggregated per
        # slice, pinned to the current driver revision.  The HBM floor is
        # derived per slice from the accelerator's published spec
        # (hw.chip_spec), so the silent-degradation mode the bandwidth
        # probe measures actually gates in the default wiring.
        self.manager.with_validation_enabled(
            NodeReportProber(
                self.keys,
                revision_resolver=(
                    self.manager.pod_manager
                    .get_daemonset_controller_revision_hash
                ),
                hbm_floor_fraction=config.hbm_floor_fraction,
                generation_floors=config.generation_floors,
            )
        )
        self.ds_reconciler = (
            DriverSetReconciler(client, config.daemonset_spec)
            if config.daemonset_spec is not None
            else None
        )
        self.agent_reconciler = (
            DriverSetReconciler(client, config.agent_spec)
            if config.agent_spec is not None
            else None
        )
        self.registry = MetricsRegistry()
        self.metrics = UpgradeMetrics(self.registry)
        self.slice_timer = SliceUpgradeTimer(self.registry)
        # Stuck-state dwell gauge flows into the same registry.
        self.manager.stuck_detector.registry = self.registry
        # Predictive rollout planning: the drift watchdog anchors the
        # active roll to its analytic RollPlan after every full pass and
        # republishes the ETA (CR status + metrics).  Planning is
        # read-only — it never issues a write verb.
        from k8s_operator_libs_tpu_torch.planning.clocks import PhaseClockTracker
        from k8s_operator_libs_tpu_torch.planning.drift import DriftWatchdog

        self.watchdog = DriftWatchdog(self.keys)
        # Per-pool EWMA phase clocks: every group-level transition the
        # provider stages is also reported here (read-only observer), and
        # the watchdog folds the measured clocks into each anchor/re-plan
        # so projections tighten as the roll progresses.
        self.clock_tracker = PhaseClockTracker()
        self.watchdog.clock_tracker = self.clock_tracker
        # Multicast registration: the trace recorder subscribed itself in
        # the manager's constructor, and the clock tracker joins it here
        # — each observer is exception-isolated by the provider.
        self.manager.provider.add_transition_observer(
            self.clock_tracker.observe_group_transition
        )
        # Black box: ring of recent facts + throttled redacted snapshots
        # on failure triggers (stuck, infeasible, quarantine, circuit-
        # open, crash-adoption).  Spool defaults under the system tmpdir;
        # trace_spool_dir="" keeps it memory-only.
        from k8s_operator_libs_tpu_torch.obs.flightrec import FlightRecorder

        spool_dir = config.trace_spool_dir
        if spool_dir is None:
            import os
            import tempfile

            spool_dir = os.path.join(
                tempfile.gettempdir(), "tpu-upgrade-blackbox"
            )
        self.flight_recorder = FlightRecorder(spool_dir=spool_dir or None)
        self.manager.set_flight_recorder(self.flight_recorder)
        self.flight_recorder.snapshot_providers["informer"] = (
            self._informer_snapshot
        )
        # One makespan breakdown publication per completed roll trace.
        self._published_breakdown_trace: Optional[str] = None
        self._last_breakdown: Optional[dict] = None
        # Plan-guided admission (planning.admissionMode: packed): the
        # engine's admission pass consults the watchdog's fresh plan to
        # ORDER chargeable groups — no budget/window/DCN gate is relaxed.
        self.manager.drift_watchdog = self.watchdog
        if self._sharded is not None:
            # Scoped dirty ticks between full resyncs feed the watchdog
            # as progress evidence (read-only observer).
            self._sharded.progress_observer = self.watchdog.note_tick
            # Budget-release wakeups target the planned-next wave first
            # (blanket wake when no fresh plan).
            self._sharded.plan_provider = self.watchdog.fresh_plan
        self.elector = None
        if config.leader_elect:
            from k8s_operator_libs_tpu_torch.k8s.leader import (
                LeaderElector,
                ensure_lease_kind,
            )

            # No-op on real clusters (coordination.k8s.io is built in);
            # required on the FakeCluster/KubeApiServer tiers, where an
            # unregistered kind would fail every election round.
            ensure_lease_kind(client)
            self.elector = LeaderElector(
                client,
                identity=config.identity or None,
                namespace=config.lease_namespace or config.namespace,
                name=config.lease_name,
            )
            # Crash-safety fence: every async worker (drain, eviction,
            # rollback) consults this before mutating, so a deposed
            # leader's in-flight workers abandon instead of racing the
            # successor.  Reads ``self.elector`` at call time — tests and
            # embedders may swap the elector after construction.
            self.manager.fence = (
                lambda: self.elector is None or self.elector.is_leader()
            )
            # Term fence on top: workers quorum-read the persisted
            # adoption stamp at entry/barriers and abandon if a HIGHER
            # term has stamped their nodes — closes the renew-deadline
            # window without waiting out any clock.  Built on the raw
            # client: the whole point is a quorum read.
            from k8s_operator_libs_tpu_torch.upgrade.durable import make_term_fence

            self.manager.term_fence = make_term_fence(
                client,
                self.keys,
                lambda: self.elector.term if self.elector is not None else 0,
            )
        self._stop = False
        # Re-adoption: the first reconcile pass of every leadership epoch
        # (and of a non-HA process lifetime) rebuilds in-memory progress
        # — escalation ladders, rollback attempts, probe backoffs — from
        # the durable annotation record instead of from zero.
        self._needs_adoption = True
        self._adoptions = 0
        # Policy-CR bookkeeping: the CR fetched this pass (reused for the
        # status write) and whether "missing" was already logged.
        self._policy_cr: Optional[dict] = None
        self._policy_cr_missing = False
        # Set while run_forever is in watch mode so stop() can interrupt
        # a long resync wait.
        self._wake: Optional[threading.Event] = None
        # Election bookkeeping (leader_elect mode).
        self._last_election_at: Optional[float] = None
        self._was_leader = False
        # Set in run_forever when watch + leader-elect are both on: the
        # watch pump streams only while this Event is set (leading).
        self._pump_gate: Optional[threading.Event] = None

    def reconcile_once(self) -> bool:
        """One full pass; returns False when the snapshot was incoherent
        (requeue and retry, reference reconcile-error semantics) or when
        the client's circuit breaker fast-failed the pass (degraded mode:
        the condition/metrics surface it, the loop keeps ticking, and the
        breaker's half-open probes heal the path)."""
        t0 = time.monotonic()
        try:
            if self.config.policy_ref is not None:
                self._refresh_policy_from_cr()
            if not self._still_leading():
                return False
            if self.ds_reconciler is not None:
                self.ds_reconciler.reconcile()
            if self.agent_reconciler is not None:
                self.config.agent_spec.driver_revision = (
                    self._current_driver_revision()
                )
                self.agent_reconciler.reconcile()
            # Stamp BEFORE the build: deltas that land while the (slow,
            # fleet-sized) snapshot is being assembled are not in it, so
            # the sharded layer must not treat them as covered by this
            # resync.  Only marks older than this instant may be cleared.
            resync_t0 = time.monotonic()
            try:
                state = self.manager.build_state(
                    self.config.namespace,
                    self.config.driver_labels,
                    self.config.policy,
                )
            except BuildStateError as e:
                logger.warning("build_state: %s (requeueing)", e)
                return False
            # Re-check right before the mutating phase: a pass that
            # outlived the renew deadline (apiserver latency, huge
            # snapshot) must not cordon/drain concurrently with a
            # successor that has already taken over.  is_leader() goes
            # False at the renew deadline, BEFORE anyone else's observed
            # term expires.
            if not self._still_leading():
                return False
            if self._needs_adoption:
                identity = (
                    self.elector.identity
                    if self.elector is not None
                    else (self.config.identity or "standalone")
                )
                term = self.elector.term if self.elector is not None else 0
                self.manager.adopt(
                    state,
                    identity=identity,
                    term=term,
                    policy=self.config.policy,
                )
                # Measured phase clocks ride the CR status: re-seed the
                # EWMA on adoption so a restart or leader handoff does
                # not reset estimates to the static defaults.  Loaded
                # values never overwrite live samples.
                if self._policy_cr is not None:
                    self.clock_tracker.load_status(
                        (self._policy_cr.get("status") or {}).get(
                            "phaseClocks"
                        )
                    )
                self._needs_adoption = False
                self._adoptions += 1
                self.registry.set(
                    "controller_adoptions_total", float(self._adoptions)
                )
                self.registry.set("controller_leader_term", float(term))
            resync_started = None
            if self._sharded is not None:
                # Anchor the sharded layer to ground truth: re-seed the
                # node→pool registry and re-baseline the budget ledger
                # from this full snapshot BEFORE acting on it.
                resync_started = self._sharded.observe_full_state(
                    state, self.config.policy, started=resync_t0
                )
            # Drift watchdog: full passes only (a scoped pass sees one
            # pool and cannot measure fleet progress).  Read-only —
            # plan_roll and find_infeasibilities never touch the API.
            # Runs BEFORE apply_state so the plan anchored from this
            # snapshot guides this pass's admission ordering (packed
            # mode); every observe input is bucket-fixed at build_state
            # time, so the verdict is identical either side of apply.
            if self.config.policy is not None:
                self.watchdog.configure(
                    getattr(self.config.policy, "planning", None)
                )
                # Refresh node→pool attribution for the phase-clock
                # tracker (full pass = whole-fleet scope), so measured
                # durations are charged to the right pool's EWMA.
                node_pools = {
                    m.node.name: (
                        self.manager._pool_for_group(
                            g, self.config.policy
                        )
                        or ""
                    )
                    for g in state.all_groups()
                    for m in g.members
                }
                self.clock_tracker.seed_pools(node_pools)
                # Same attribution feeds the span tree: group spans hang
                # under the right pool span.
                rec = getattr(self.manager, "trace_recorder", None)
                if rec is not None:
                    rec.seed_pools(node_pools)
                # ... and the telemetry plane, so health baselines fold
                # per (generation, pool) cohort instead of fleet-wide.
                plane = getattr(self.manager, "telemetry_plane", None)
                if plane is not None:
                    plane.seed_pools(node_pools)
                drift_report = self.watchdog.observe(
                    self.manager, state, self.config.policy
                )
            else:
                drift_report = None
            self.manager.apply_state(state, self.config.policy)
            if resync_started is not None:
                # Deltas queued before this pass began are covered by it.
                self._sharded.complete_full_resync(resync_started)
                self.metrics.observe_sharded(self._sharded)
        except CircuitOpenError as e:
            self._handle_circuit_open(e)
            return False
        self.metrics.observe_plan(drift_report)
        self.metrics.observe_trace(self.manager, self._trace_breakdown())
        self._observe_telemetry()
        if self.config.policy_ref is not None:
            self._update_cr_status(state)
        duration = time.monotonic() - t0
        self.metrics.observe(self.manager, state, duration)
        self.slice_timer.observe_state(state)
        self._flush_events(state)
        return True

    def reconcile_dirty(self) -> bool:
        """One event-driven dirty pass (sharded mode): reconcile ONLY
        the pools touched by watch deltas, on parallel worker shards —
        an idle tick takes 0 pools and builds 0 state.  Falls back to a
        full pass when the sharded layer is not yet seeded by a full
        resync or a new leadership epoch still needs re-adoption."""
        if (
            self._sharded is None
            or self._needs_adoption
            or not self._sharded.ready()
        ):
            return self.reconcile_once()
        try:
            if self.config.policy_ref is not None:
                self._refresh_policy_from_cr()
            if not self._still_leading():
                return False
            report = self._sharded.tick(self.config.policy)
        except CircuitOpenError as e:
            self._handle_circuit_open(e)
            return False
        self.metrics.observe_sharded(self._sharded, report)
        self._flush_events()
        return report.errors == 0 and report.fenced == 0

    def dry_run(self):
        """Build one read-only snapshot, return the analytic RollPlan,
        and PROVE the pass wrote nothing: every write verb the client
        observed and everything the transactional write plane issued
        must be zero (planning is read-only)."""
        from k8s_operator_libs_tpu_torch.planning.planner import plan_roll

        if self.config.policy_ref is not None:
            self._refresh_policy_from_cr()
        before = self._write_verb_count()
        state = self.manager.build_state(
            self.config.namespace,
            self.config.driver_labels,
            self.config.policy,
        )
        plan = plan_roll(self.manager, state, self.config.policy)
        writes = self._write_verb_count() - before
        if writes:
            raise RuntimeError(
                f"dry-run issued {writes} API write verb(s); planning "
                "must be read-only"
            )
        return plan

    def score_policy(self, candidate_path: str) -> str:
        """What-if scoring: run the digital twin under the CURRENT policy
        and under the candidate policy file, and report the makespan
        delta.  Same zero-write contract as --dry-run — both twins roll a
        cloned fleet; the live cluster sees only reads."""
        from k8s_operator_libs_tpu_torch.planning.twin import run_twin

        if self.config.policy_ref is not None:
            self._refresh_policy_from_cr()
        candidate = load_policy(candidate_path)
        before = self._write_verb_count()
        results = {}
        for label, policy in (
            ("current", self.config.policy),
            ("candidate", candidate),
        ):
            results[label] = run_twin(
                self.client,
                self.config.namespace,
                self.config.driver_labels,
                policy,
                keys=self.keys,
            )
        writes = self._write_verb_count() - before
        if writes:
            raise RuntimeError(
                f"what-if scoring issued {writes} API write verb(s) "
                "against the live cluster; scoring must be read-only"
            )
        cur, cand = results["current"], results["candidate"]
        delta = cand.virtual_duration_s - cur.virtual_duration_s
        lines = [
            f"what-if: {candidate_path}",
            (
                f"  current:   makespan {cur.virtual_duration_s:10.1f}s"
                f"  waves {cur.wave_count:3d}"
                f"  converged {cur.converged}"
            ),
            (
                f"  candidate: makespan {cand.virtual_duration_s:10.1f}s"
                f"  waves {cand.wave_count:3d}"
                f"  converged {cand.converged}"
            ),
            (
                f"  delta:     {delta:+10.1f}s"
                + (
                    "  (candidate faster)"
                    if delta < 0
                    else ("  (candidate slower)" if delta > 0 else "")
                )
            ),
        ]
        if cur.held or cand.held:
            lines.append(
                f"  held groups: current {sorted(cur.held)} "
                f"candidate {sorted(cand.held)}"
            )
        return "\n".join(lines)

    def _write_verb_count(self) -> float:
        """Write verbs observed so far: client per-verb stats (fake and
        REST clients both expose ``stats``) plus everything the write
        plane has flushed."""
        total = 0.0
        stats = getattr(
            getattr(self.manager, "client", None), "stats", None
        )
        if stats is not None and hasattr(stats, "items"):
            total += sum(
                v
                for k, v in stats.items()
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
        plan = self.write_plan
        if plan is not None and hasattr(plan, "counters"):
            c = plan.counters()
            total += c.get("writes_mutating", 0) + c.get(
                "writes_status", 0
            )
        return total

    def _open_circuit_count(self) -> int:
        breaker = getattr(self.client, "breaker", None)
        if breaker is None or not hasattr(breaker, "open_endpoints"):
            return 0
        return len(breaker.open_endpoints())

    @property
    def write_plan(self):
        """The manager's transactional write plane (None with injected
        fake managers): CR status and Events route through it so status
        churn rides the status flow — never the mutating one — and a
        deposed leader's queued writes drop at flush."""
        return getattr(self.manager, "write_plan", None)

    def _informer_snapshot(self):
        """Informer cache health for black-box snapshots (None when the
        controller runs without a watch)."""
        informer = self.informer
        if informer is None:
            return None
        age = informer.age_s()
        return {
            "age_seconds": age if age != float("inf") else None,
            "stats": dict(getattr(informer, "stats", {}) or {}),
        }

    def _trace_breakdown(self) -> Optional[dict]:
        """Critical-path makespan attribution for the most recently
        COMPLETED roll trace, computed once per trace id (the analysis
        walks the whole span tree) and cached for the CR status, the
        metrics surface and the status CLI."""
        rec = getattr(self.manager, "trace_recorder", None)
        if rec is None:
            return self._last_breakdown
        completed = rec.last_completed()
        if completed is None:
            return self._last_breakdown
        if completed.trace_id == self._published_breakdown_trace:
            return self._last_breakdown
        from k8s_operator_libs_tpu_torch.obs.critical import (
            analyze,
            expected_from_tracker,
            makespan_breakdown,
            phase_drift,
        )

        try:
            attribution = analyze(completed)
            expected = expected_from_tracker(self.clock_tracker)
            drift = phase_drift(attribution, expected)
            breakdown = makespan_breakdown(attribution, drift)
        except Exception:  # noqa: BLE001 — attribution is advisory
            logger.exception(
                "makespan attribution failed for trace %s",
                completed.trace_id,
            )
            self._published_breakdown_trace = completed.trace_id
            return self._last_breakdown
        self._published_breakdown_trace = completed.trace_id
        self._last_breakdown = breakdown
        logger.info(
            "roll %s complete: makespan %.1fs across %d group(s)",
            completed.trace_id,
            breakdown.get("makespanSeconds", 0.0),
            breakdown.get("groups", 0),
        )
        return breakdown

    def _observe_telemetry(self) -> None:
        """Fold this pass's probe telemetry into fleet baselines and
        publish the verdicts: metric families, straggler-aware phase
        clocks (the planner's ETA annotation), one NodeHealthDegraded
        Warning per FRESH confirmation (stamped with the active trace
        id), and a flight-recorder snapshot while the slow batteries
        are still in the evidence ring.  Observe-only: nothing here
        changes any node's upgrade state."""
        plane = getattr(self.manager, "telemetry_plane", None)
        if plane is None:
            return
        plane.recompute()
        self.metrics.observe_telemetry(self.manager)
        straggler_nodes = [
            s["node"]
            for s in plane.to_status().get("stragglers") or []
        ]
        self.clock_tracker.set_straggler_nodes(straggler_nodes)
        fresh = plane.new_confirmations()
        if not fresh:
            return
        suffix_fn = getattr(self.manager, "_trace_event_suffix", None)
        trace_suffix = suffix_fn() if suffix_fn is not None else ""
        for verdict in fresh:
            log_event(
                self.events,
                verdict["node"],
                EVENT_TYPE_WARNING,
                "NodeHealthDegraded",
                "Node confirmed as fleet straggler: worst stat "
                f"{verdict['worstStat']} at z={verdict['z']} vs its "
                f"({verdict['generation']}, {verdict['pool']}) cohort "
                f"baseline over {verdict['streak']} consecutive "
                f"batteries (health score {verdict['score']}); "
                "observe-only unless healthGate.quarantineStragglers"
                f"{trace_suffix}",
            )
        self.flight_recorder.trigger(
            "straggler",
            nodes=",".join(v["node"] for v in fresh),
            detail=f"{len(fresh)} fresh straggler confirmation(s)",
        )

    def _handle_circuit_open(self, exc: CircuitOpenError) -> None:
        """Degrade gracefully instead of crashing or wedging: log once
        per pass, publish the gauge, and best-effort surface a Degraded
        condition on the policy CR (an outage scoped to some endpoints
        still lets the status write land; a total one is swallowed and
        retried next pass)."""
        logger.warning(
            "reconcile degraded: %s (ticking on; half-open probes will "
            "close the circuit once the apiserver recovers)",
            exc,
        )
        self.metrics.registry.set(
            "api_circuit_open_endpoints",
            float(max(1, self._open_circuit_count())),
        )
        self.flight_recorder.trigger(
            "circuit_open",
            detail=str(exc),
            open_endpoints=self._open_circuit_count(),
        )
        self._flush_events()
        if self.config.policy_ref is None or self._policy_cr is None:
            return
        from k8s_operator_libs_tpu_torch.api.schema import (
            POLICY_GROUP,
            POLICY_PLURAL,
            POLICY_VERSION,
        )

        ns, name = self.config.policy_ref
        cr = self._policy_cr
        prev_status = dict(cr.get("status") or {})
        status = dict(prev_status)
        status["apiCircuitOpenEndpoints"] = max(
            1, self._open_circuit_count()
        )
        status["conditions"] = self._conditions(
            status, prev_status.get("conditions") or []
        )
        if status == prev_status:
            return
        cr["status"] = status
        try:
            plan = self.write_plan
            if plan is not None:
                plan.stage_cr_status(
                    POLICY_GROUP, POLICY_VERSION, POLICY_PLURAL, ns, cr
                )
                plan.flush_status()
            else:
                self.client.update_custom_object_status(
                    POLICY_GROUP, POLICY_VERSION, POLICY_PLURAL, ns, cr
                )
        except Exception as e:  # noqa: BLE001 — best-effort while degraded
            logger.debug("degraded status publication failed: %s", e)

    def _flush_events(self, state=None) -> None:
        """Drain recorded events to the log AND, when enabled, to the
        cluster as core/v1 Events (reference util.go:141-153 via
        client-go's EventRecorder — `kubectl describe node` shows them).
        Identical events within one pass aggregate into a count.
        Publication failures never fail the pass."""
        drained = self.events.drain()
        counts: dict[tuple[str, str, str, str], int] = {}
        for ev in drained:
            logger.info(
                "event %s %s %s: %s",
                ev.event_type,
                ev.object_name,
                ev.reason,
                ev.message,
            )
            key = (ev.object_name, ev.event_type, ev.reason, ev.message)
            counts[key] = counts.get(key, 0) + 1
        if not self.config.publish_events:
            return
        # involvedObject needs the node UID for `kubectl describe node`
        # to find the event (client-go's Search filters on it).
        node_uids: dict[str, str] = {}
        if state is not None:
            for group in state.all_groups():
                for n in group.nodes:
                    node_uids[n.name] = n.metadata.uid
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        plan = self.write_plan
        for (obj, etype, reason, message), count in counts.items():
            involved: dict = {"name": obj, "apiVersion": "v1"}
            if obj in node_uids:
                involved["kind"] = "Node"
                involved["uid"] = node_uids[obj]
            else:
                involved["kind"] = "Pod"  # restart-failure events name pods
            event = {
                "apiVersion": "v1",
                "kind": "Event",
                # A real apiserver requires a client-supplied
                # name (client-go EventRecorder does the same
                # object.timestamp scheme).
                "metadata": {"name": f"{obj}.{uuid.uuid4().hex[:12]}"},
                "involvedObject": involved,
                "type": etype,
                "reason": reason,
                "message": message,
                "count": count,
                "firstTimestamp": now,
                "lastTimestamp": now,
                "source": {"component": "tpu-upgrade-controller"},
            }
            if plan is not None:
                # Kubelet-style aggregation: identical events within the
                # window collapse into one count-carrying publication on
                # the status flow.
                plan.stage_event(self.config.namespace, event, count)
                continue
            try:
                self.client.create_event(self.config.namespace, event)
            except Exception as e:  # noqa: BLE001 — telemetry best-effort
                logger.debug("event publication failed: %s", e)
        if plan is not None:
            plan.flush_events()

    def _refresh_policy_from_cr(self) -> None:
        """Re-read the TPUUpgradePolicy CR: a policy edit takes effect on
        the next pass, like a consumer operator re-reading its CRD spec
        every reconcile.  A missing CR disables upgrades (policy None =
        no-op gate, reference upgrade_state.go:372); a malformed one
        keeps the last good policy (admission should have rejected it)."""
        from k8s_operator_libs_tpu_torch.api.schema import (
            POLICY_GROUP,
            POLICY_PLURAL,
            POLICY_VERSION,
        )
        from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError

        ns, name = self.config.policy_ref
        try:
            cr = self.client.get_custom_object(
                POLICY_GROUP, POLICY_VERSION, POLICY_PLURAL, ns, name
            )
        except NotFoundError:
            # Log on every transition into "missing" AND on the very
            # first pass: a typoed --policy-cr must not be a silent
            # permanent no-op.
            if not self._policy_cr_missing:
                logger.warning(
                    "policy CR %s/%s not found: upgrades paused "
                    "(create the TPUUpgradePolicy or fix --policy-cr)",
                    ns,
                    name,
                )
            self._policy_cr_missing = True
            self._policy_cr = None
            self.config.policy = None
            return
        self._policy_cr_missing = False
        self._policy_cr = cr
        try:
            policy = TPUUpgradePolicySpec.from_dict(cr.get("spec") or {})
            policy.validate()
            self.config.policy = policy
        except (ValueError, TypeError) as e:
            logger.warning(
                "policy CR %s/%s invalid (%s): keeping previous policy",
                ns,
                name,
                e,
            )

    def _update_cr_status(self, state) -> None:
        """Publish the method-counters (reference upgrade_state.go:
        1038-1120 exposes them for consumers to export) to the CR's
        status subresource, so `kubectl get tpuupgradepolicy -o yaml`
        shows progress.  Uses the CR fetched by _refresh_policy_from_cr
        this pass; lost-update conflicts are skipped — the next pass
        rewrites."""
        from k8s_operator_libs_tpu_torch.api.schema import (
            POLICY_GROUP,
            POLICY_PLURAL,
            POLICY_VERSION,
        )
        from k8s_operator_libs_tpu_torch.k8s.client import (
            ConflictError,
            NotFoundError,
        )

        ns, name = self.config.policy_ref
        cr = self._policy_cr
        if cr is None:
            return
        m = self.manager
        try:
            status = {
                "totalManagedNodes": m.get_total_managed_nodes(state),
                "totalManagedGroups": m.get_total_managed_groups(state),
                "upgradesInProgress": m.get_upgrades_in_progress(state),
                "upgradesDone": m.get_upgrades_done(state),
                "upgradesFailed": m.get_upgrades_failed(state),
                "upgradesPending": m.get_upgrades_pending(state),
                "currentUnavailableNodes": m.get_current_unavailable_nodes(
                    state
                ),
                "quarantinedSlices": len(
                    state.groups_in(UpgradeState.QUARANTINED)
                ),
                "apiCircuitOpenEndpoints": self._open_circuit_count(),
                # Escalation/rollback telemetry (crash-safe: seeded from
                # the durable annotation record on adoption, so these
                # survive controller restarts and leader handoffs).
                "evictionEscalations": {
                    rung: count
                    for rung, count in sorted(
                        m.escalation_stats.snapshot().items()
                    )
                    if count
                },
                "rollbackAttempts": dict(
                    sorted(
                        getattr(
                            m.validation_manager, "rollback_attempts", {}
                        ).items()
                    )
                ),
                "quarantineCycleDemotions": m.quarantine_cycle_demotions,
            }
            # Predictive-planning surface (drift watchdog; durable so the
            # status CLI can render the plan section from the CR alone).
            report = self.watchdog.last_report
            if report is not None and report.active:
                status["projectedCompletion"] = time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ",
                    time.gmtime(report.projected_completion_epoch),
                )
                status["planDriftSeconds"] = int(report.drift_seconds)
                status["planWaves"] = report.wave_count
                status["planCompletedGroups"] = report.completed_groups
                status["planReplans"] = report.replans
                if report.infeasible:
                    status["planInfeasible"] = list(report.infeasible)
            # Roll-tracing surface: the active trace id joins the plan
            # block (Events carry the same id, so operators can pivot
            # Events ↔ trace ↔ plan), and a completed roll publishes its
            # critical-path makespan attribution.
            rec = getattr(m, "trace_recorder", None)
            active_trace = (
                rec.active_trace_id() if rec is not None else None
            )
            if active_trace:
                status["planTraceId"] = active_trace
            breakdown = self._trace_breakdown()
            if breakdown:
                status["makespanBreakdown"] = breakdown
            # Measured per-pool phase clocks (EWMA): durable through the
            # write plane so a successor controller adopts them instead
            # of restarting from the static defaults.
            phase_clocks = self.clock_tracker.to_status()
            if phase_clocks:
                status["phaseClocks"] = phase_clocks
            # Fleet health telemetry: per-cohort baselines + any
            # confirmed stragglers (observe-only; quarantine routing is
            # the policy's healthGate.quarantineStragglers opt-in).
            plane = getattr(m, "telemetry_plane", None)
            if plane is not None:
                health = plane.to_status()
                if health.get("healthSummary"):
                    status["healthSummary"] = health["healthSummary"]
                if health.get("stragglers"):
                    status["stragglers"] = health["stragglers"]
            astats = self.manager.admission_stats
            if astats.get("last_budget_cap"):
                status["admissionMode"] = self.manager.admission_mode
                status["budgetSaturation"] = round(
                    astats.get("last_budget_used", 0)
                    / astats["last_budget_cap"],
                    3,
                )
            status["conditions"] = self._conditions(
                status, (cr.get("status") or {}).get("conditions") or []
            )
            if cr.get("status") == status:
                return  # no churn: don't bump resourceVersion every pass
            cr["status"] = status
            plan = self.write_plan
            if plan is not None:
                # Status flow: a dry bucket defers to the next pass
                # (which re-stages the freshest counters); a 409 replays
                # once onto a fresh read inside the plan.
                plan.stage_cr_status(
                    POLICY_GROUP, POLICY_VERSION, POLICY_PLURAL, ns, cr
                )
                plan.flush_status()
            else:
                self.client.update_custom_object_status(
                    POLICY_GROUP, POLICY_VERSION, POLICY_PLURAL, ns, cr
                )
        except (NotFoundError, ConflictError) as e:
            logger.debug("status update skipped: %s", e)

    @staticmethod
    def _conditions(status: dict, previous: list[dict]) -> list[dict]:
        """Standard operator status.conditions derived from the counters,
        with lastTransitionTime preserved while a condition's status is
        unchanged (k8s meta.v1 Condition semantics).

        Degraded is True on failed slices OR an open API circuit (the
        controller cannot currently drive the cluster); counters are read
        with defaults so a degraded pass can rebuild conditions from a
        partial previous status."""
        in_progress = status.get("upgradesInProgress", 0)
        pending = status.get("upgradesPending", 0)
        failed = status.get("upgradesFailed", 0)
        quarantined = status.get("quarantinedSlices", 0)
        open_circuits = status.get("apiCircuitOpenEndpoints", 0)
        in_flight = in_progress + pending
        if failed:
            degraded_reason = "SlicesFailed"
            degraded_msg = f"{failed} node(s) in upgrade-failed"
            if quarantined:
                degraded_msg += f"; {quarantined} slice(s) quarantined"
            if open_circuits:
                degraded_msg += (
                    f"; {open_circuits} API endpoint(s) circuit-open"
                )
        elif quarantined:
            degraded_reason = "SliceQuarantined"
            degraded_msg = (
                f"{quarantined} slice(s) quarantined after mid-roll "
                "hardware loss; each resumes once its hosts stay Ready "
                "past the dwell window"
            )
            if open_circuits:
                degraded_msg += (
                    f"; {open_circuits} API endpoint(s) circuit-open"
                )
        elif open_circuits:
            degraded_reason = "ApiCircuitOpen"
            degraded_msg = (
                f"{open_circuits} API endpoint(s) circuit-open after "
                "sustained apiserver failures; reconcile is degraded "
                "until the circuit closes"
            )
        else:
            degraded_reason = "AllHealthy"
            degraded_msg = f"{failed} node(s) in upgrade-failed"
        want = [
            (
                "Progressing",
                in_flight > 0,
                "UpgradesInFlight" if in_flight else "NoPendingUpgrades",
                f"{in_progress} in progress, "
                f"{pending} pending",
            ),
            (
                "Degraded",
                failed > 0 or quarantined > 0 or open_circuits > 0,
                degraded_reason,
                degraded_msg,
            ),
            (
                "Complete",
                in_flight == 0 and failed == 0 and quarantined == 0,
                (
                    "AllDone"
                    if in_flight == 0 and failed == 0 and quarantined == 0
                    else "Failures"
                    if failed
                    else "SlicesQuarantined"
                    if quarantined
                    else "InProgress"
                ),
                f"{status.get('upgradesDone', 0)}/"
                f"{status.get('totalManagedNodes', 0)} "
                "nodes at the current driver",
            ),
        ]
        prev_by_type = {c.get("type"): c for c in previous}
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        out = []
        for ctype, truthy, reason, message in want:
            cond_status = "True" if truthy else "False"
            prev = prev_by_type.get(ctype)
            last_transition = (
                prev["lastTransitionTime"]
                if prev is not None
                and prev.get("status") == cond_status
                and prev.get("lastTransitionTime")
                else now
            )
            out.append(
                {
                    "type": ctype,
                    "status": cond_status,
                    "reason": reason,
                    "message": message,
                    "lastTransitionTime": last_transition,
                }
            )
        return out

    def _current_driver_revision(self) -> str:
        """Current ControllerRevision hash of the (first) driver
        DaemonSet matching the selector, or "" when the DaemonSet is
        absent OR has no recorded revision yet (a just-created DS: the
        DS controller hasn't written its first ControllerRevision)."""
        daemon_sets = self.client.list_daemon_sets(
            namespace=self.config.namespace,
            match_labels=self.config.driver_labels,
        )
        if not daemon_sets:
            return ""
        try:
            return self.manager.pod_manager.get_daemonset_controller_revision_hash(
                daemon_sets[0]
            )
        except ValueError:
            return ""

    def stop(self, *_args) -> None:
        self._stop = True
        if self._sharded is not None:
            self._sharded.shutdown()
        if self._wake is not None:
            self._wake.set()  # interrupt a watch-mode resync wait

    def _still_leading(self) -> bool:
        """Mid-pass leadership guard; True when not in leader-elect mode.

        Runs a (retry-period-throttled) election round rather than only
        reading the deadline: a pass that takes longer than the renew
        deadline RENEWS here and proceeds — without this, every slow
        pass would abort at the guard, renew at the top of the loop, and
        abort again, livelocking a large cluster."""
        if self.elector is None or self._election_round():
            return True
        logger.warning(
            "leadership lost mid-pass (identity=%s); aborting reconcile",
            self.elector.identity,
        )
        return False

    def _election_round(self) -> bool:
        """Renew/acquire at the elector's retry cadence; between renewals
        trust ``is_leader()`` (itself bounded by the renew deadline, so a
        partitioned holder stands down before its term expires for
        anyone else).  Called at the top of every pass AND from inside
        the inter-pass waits — a 30 s reconcile interval must not starve
        a 10 s renew deadline."""
        e = self.elector
        now = time.monotonic()
        if (
            self._last_election_at is None
            or now - self._last_election_at >= e.retry_period_s
            # A HOLDER whose deadline decayed mid-wait renews at once
            # (the slow-pass guard).  A standby must NOT bypass the
            # throttle — `not is_leader()` is always true for it, and
            # _wait's 0.2 s chunks would turn the stated retry cadence
            # into ~5 Lease GETs per second per replica.
            or (self._was_leader and not e.is_leader())
        ):
            self._last_election_at = now
            leading = e.acquire_or_renew()
        else:
            leading = self._was_leader
        self.registry.set(
            "tpu_upgrade_controller_is_leader",
            1.0 if leading else 0.0,
            identity=e.identity,
        )
        if leading != self._was_leader:
            logger.info(
                "%s leadership (lease=%s identity=%s term=%d)",
                "gained" if leading else "lost",
                self.config.lease_name,
                e.identity,
                e.term,
            )
            if leading:
                # New leadership epoch: the next pass re-adopts in-flight
                # state from the durable record before acting on it.
                self._needs_adoption = True
        self._was_leader = leading
        if self._pump_gate is not None:
            if leading:
                self._pump_gate.set()
            else:
                self._pump_gate.clear()
        return leading

    def _wait(
        self,
        duration: float,
        wake: Optional[threading.Event] = None,
    ) -> bool:
        """Sleep up to ``duration``, chunked so ``stop()`` interrupts
        promptly, the leader keeps renewing its lease (a reconcile
        interval must never starve the renew deadline), and a leadership
        change in EITHER direction ends the wait early (the caller's
        loop re-evaluates).  Returns True iff ``wake`` fired (a watch
        event)."""
        deadline = time.monotonic() + duration
        e = self.elector
        was = self._was_leader
        while not self._stop:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            if wake is not None:
                chunk = (
                    remaining
                    if e is None
                    else min(remaining, e.retry_period_s)
                )
                if wake.wait(chunk):
                    return True
            else:
                time.sleep(min(remaining, 0.2))
            if e is not None:
                self._election_round()
                if self._was_leader != was:
                    return False
        return False

    def _watch_kinds(self) -> list[str]:
        # ControllerRevision rides along because the steady-state pass
        # resolves the driver DS's revision hash every tick — without
        # caching it, that one lookup would keep a per-tick LIST alive.
        kinds = ["Node", "Pod", "DaemonSet", "ControllerRevision"]
        if self.config.policy_ref is not None:
            from k8s_operator_libs_tpu_torch.api.schema import (
                POLICY_GROUP,
                POLICY_PLURAL,
                POLICY_VERSION,
            )

            ns, _ = self.config.policy_ref
            kinds.append(
                f"{POLICY_GROUP}/{POLICY_VERSION}/{ns}/{POLICY_PLURAL}"
            )
        return kinds

    def _watch_pump(self, wake: threading.Event) -> None:
        """Background thread: any watch event sets the wake flag; the
        stream is re-established on errors (apiserver restarts).

        Informer reconnect semantics (the client-go list-then-watch
        loop): each connect first takes a BASELINE — the cluster
        resourceVersion from a cheap one-item list — and watches from
        it; every event raises its own KIND's floor, and a reconnect
        resumes from the MINIMUM floor across kinds.  The per-kind
        minimum matters: on the wire tier each kind is an independent
        stream feeding one queue, so the highest rv seen globally may be
        ahead of an event still buffered in a slower stream — resuming
        from the max would skip it permanently, while resuming from the
        min replays at worst a few already-seen events (wakes are
        idempotent).  A 410 Gone (resume point compacted away) drops the
        baseline and forces an immediate wake — the pass it triggers
        re-snapshots the world, which is this controller's re-list.

        Under leader election the pump holds streams only while this
        replica leads (controller-runtime starts informers after winning
        the election): a standby discards every event anyway, and on a
        large pool the Pod watch is a heavy stream the apiserver should
        not carry twice."""
        from k8s_operator_libs_tpu_torch.k8s.client import ExpiredError

        resume_rv: Optional[int] = None
        floors: dict[str, int] = {}
        while not self._stop:
            gate = self._pump_gate
            if gate is not None and not gate.is_set():
                gate.wait(0.5)
                continue
            kinds = self._watch_kinds()
            try:
                if resume_rv is None:
                    # Baseline: the cluster RV "now" (shared across
                    # kinds — one etcd-style sequence), so the watch
                    # below misses nothing after this instant.  With an
                    # informer this is its LIST phase: sync() takes the
                    # same one-item baseline first, then snapshots every
                    # tracked kind, so the cache is coherent as of the
                    # rv the watch resumes from.
                    if self.informer is not None:
                        resume_rv = self.informer.sync()
                    else:
                        resume_rv = int(
                            self.client.list_page("Node", limit=1)[
                                "resourceVersion"
                            ]
                        )
                floors = {
                    (k.split("/")[-1] if "/" in k else k): resume_rv
                    for k in kinds
                }
                for ev in self.client.watch_events(
                    kinds, since_rv=resume_rv, bookmarks=True
                ):
                    if self._stop:
                        return
                    if self.informer is not None:
                        # Every yield feeds the cache: deltas apply,
                        # BOOKMARKs and None heartbeats refresh the
                        # staleness clock (a quiet-but-connected stream
                        # keeps cached reads valid).
                        self.informer.handle_event(ev)
                    if self._sharded is not None:
                        # ... and the dirty-set router: the delta marks
                        # exactly the pools it touches, which is what the
                        # next event-driven pass reconciles.
                        self._sharded.handle_event(ev)
                    if gate is not None and not gate.is_set():
                        # Lost leadership: drop the streams; keep the
                        # floors so regaining replays the standby gap.
                        # The informer is NOT invalidated — its age just
                        # grows unfed, so cached reads degrade to
                        # passthrough on their own.
                        resume_rv = min(floors.values())
                        break
                    if ev is not None:
                        if ev.rv and ev.kind in floors:
                            floors[ev.kind] = max(floors[ev.kind], ev.rv)
                        # BOOKMARKs advance resume points on quiet kinds
                        # (no reconcile-worthy change happened).
                        if ev.type != "BOOKMARK":
                            wake.set()
            except ExpiredError as e:
                logger.warning(
                    "watch resume point expired (%s); re-listing via an "
                    "immediate reconcile pass",
                    e,
                )
                resume_rv = None
                # Drop the floors too: they hold the rv that just
                # expired, and the generic reconnect handler below would
                # otherwise resurrect it after a transient baseline-list
                # failure, forcing a guaranteed second 410/re-list cycle.
                floors = {}
                if self.informer is not None:
                    # The cache may have missed compacted deltas: mark it
                    # unsynced so reads pass through until the relist
                    # (the next sync() above) rebuilds it.
                    self.informer.invalidate()
                wake.set()
            except Exception as e:  # noqa: BLE001 — reconnect, don't die
                logger.warning("watch stream broke (%s); reconnecting", e)
                if floors:
                    resume_rv = min(floors.values())
                if self.informer is not None:
                    self.informer.stats["watch_reconnects"] += 1
                time.sleep(1.0)

    def run_forever(self) -> None:
        server = None
        if self.config.metrics_port is not None:
            server = MetricsServer(
                self.registry,
                self.config.metrics_port,
                bind_addr=self.config.metrics_bind_addr,
            )
            server.start()
        wake: Optional[threading.Event] = None
        if self.config.watch:
            wake = threading.Event()
            self._wake = wake
            if self.elector is not None:
                self._pump_gate = threading.Event()
            threading.Thread(
                target=self._watch_pump, args=(wake,), daemon=True
            ).start()
        logger.info(
            "upgrade controller started: ns=%s selector=%s interval=%.0fs "
            "watch=%s",
            self.config.namespace,
            self.config.driver_labels,
            self.config.interval_s,
            self.config.watch,
        )
        # Sharded mode: event-driven wakes run DIRTY passes (only the
        # touched pools); the periodic FULL resync — the safety net that
        # catches missed deltas, re-baselines the budget ledger, and
        # runs stuck detection — is paced by wall clock, NOT by the wait
        # expiring quietly.  The wait below restarts after every pass,
        # so under sustained watch traffic (routine on a 10k-node fleet)
        # it would never expire and the full pass would starve; instead
        # a full pass is forced whenever one hasn't SUCCEEDED within
        # interval_s, regardless of wake activity.
        woken = False
        last_full = float("-inf")
        try:
            while not self._stop:
                if self.elector is not None and not self._election_round():
                    # Standby: never reconcile without the lease; retry
                    # at the election cadence (the wait ends early on
                    # gaining leadership).
                    self._wait(self.elector.retry_period_s)
                    continue
                if wake is not None:
                    # Clear BEFORE reconciling: an event that lands
                    # mid-pass must trigger another pass, not be lost.
                    wake.clear()
                try:
                    full_due = (
                        time.monotonic() - last_full
                        >= self.config.interval_s
                    )
                    if self._sharded is not None and woken and not full_due:
                        self.reconcile_dirty()
                    elif self.reconcile_once():
                        last_full = time.monotonic()
                except Exception:  # noqa: BLE001 — loop must survive
                    logger.exception("reconcile pass failed")
                # Event-driven: wake on the first change; otherwise the
                # interval is the (resync) cadence.  Losing leadership
                # ends the wait and the top of the loop goes standby.
                woken = self._wait(self.config.interval_s, wake)
                if woken and self.config.watch_debounce_s > 0:
                    time.sleep(self.config.watch_debounce_s)
        finally:
            if self.elector is not None:
                # Clean shutdown hands the lease over immediately instead
                # of making the successor wait out the term.
                self.elector.release()
            if server is not None:
                server.stop()


def _parse_labels(raw: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in raw.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def load_policy(path: Optional[str]) -> DriverUpgradePolicySpec:
    if not path:
        return TPUUpgradePolicySpec(auto_upgrade=True)
    import yaml

    from k8s_operator_libs_tpu_torch.api.schema import spec_schema, validate_object

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    # Reject malformed policy with apiserver-style messages — the same
    # schema the generated CRD advertises (config/crd/), so a file that
    # loads here would also be admitted as a TPUUpgradePolicy CR.
    errors = validate_object(data, spec_schema(TPUUpgradePolicySpec))
    if errors:
        raise ValueError(
            f"invalid policy {path}: " + "; ".join(errors)
        )
    policy = TPUUpgradePolicySpec.from_dict(data)
    policy.validate()
    return policy


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--namespace", default="kube-system")
    parser.add_argument(
        "--selector",
        default=f"app={DRIVER_DAEMONSET_NAME}",
        help="driver pod label selector, k=v[,k2=v2]",
    )
    parser.add_argument("--driver-name", default=DEFAULT_DRIVER_NAME)
    parser.add_argument("--interval", type=float, default=30.0)
    parser.add_argument("--policy-file", default="")
    parser.add_argument("--metrics-port", type=int, default=None)
    parser.add_argument(
        "--metrics-bind-addr",
        default="127.0.0.1",
        help="address the /metrics + /healthz server binds "
        "(loopback by default; use 0.0.0.0 to expose beyond the pod)",
    )
    parser.add_argument(
        "--manage-daemonset",
        action="store_true",
        help="also reconcile the NVIDIA driver DaemonSet",
    )
    parser.add_argument(
        "--manage-agent",
        action="store_true",
        help="also reconcile the health-probe-agent DaemonSet "
        "(DRIVER_REVISION follows the driver's ControllerRevision)",
    )
    parser.add_argument("--driver-image", default="")
    parser.add_argument("--driver-version", default="latest")
    parser.add_argument("--probe-interval", type=float, default=30.0)
    parser.add_argument(
        "--deep-probe",
        action="store_true",
        help="agents also run the ring-attention ICI soak",
    )
    parser.add_argument(
        "--policy-cr",
        default="",
        metavar="NAMESPACE/NAME",
        help="read the policy from a TPUUpgradePolicy CR each pass "
        "(requires config/crd/ installed) instead of --policy-file; "
        "upgrade counters are written back to the CR status",
    )
    parser.add_argument(
        "--watch",
        action="store_true",
        help="event-driven reconcile: watch nodes/pods/daemonsets (and "
        "the policy CR) and reconcile on change; --interval becomes the "
        "periodic-resync fallback",
    )
    parser.add_argument(
        "--sharded",
        action="store_true",
        help="sharded dirty-set reconcile (requires --watch): informer "
        "deltas feed a per-pool dirty queue; event-driven passes "
        "reconcile only the touched pools on parallel worker shards; "
        "--interval becomes the full-resync safety net",
    )
    parser.add_argument(
        "--shards",
        type=int,
        default=4,
        help="worker shards for --sharded (each pool is serialized onto "
        "at most one shard at a time)",
    )
    parser.add_argument(
        "--dry-run",
        action="store_true",
        help="build one read-only snapshot, print the analytic RollPlan "
        "(waves, per-wave durations, projected completion, holds, "
        "infeasibility) and exit without issuing a single API write verb",
    )
    parser.add_argument(
        "--score-policy",
        default="",
        metavar="FILE",
        help="what-if scoring: run the digital twin under the current "
        "policy and under FILE, print the makespan delta, and exit — "
        "zero API write verbs against the live cluster (same contract "
        "as --dry-run)",
    )
    parser.add_argument(
        "--leader-elect",
        action="store_true",
        help="run leader election over a coordination.k8s.io Lease and "
        "reconcile only while holding it (required with 2+ replicas)",
    )
    parser.add_argument(
        "--lease-name",
        default=CONTROLLER_NAME,
        help="Lease object name for --leader-elect",
    )
    parser.add_argument(
        "--lease-namespace",
        default="",
        help="Lease namespace (defaults to --namespace)",
    )
    args = parser.parse_args(argv)
    if args.policy_cr and args.policy_file:
        parser.error("--policy-cr and --policy-file are mutually exclusive")
    if args.sharded and not args.watch:
        parser.error("--sharded requires --watch (deltas feed the dirty set)")
    policy_ref = None
    if args.policy_cr:
        ns, sep, name = args.policy_cr.partition("/")
        if not sep or not ns or not name:
            parser.error("--policy-cr must look like NAMESPACE/NAME")
        policy_ref = (ns, name)

    from k8s_operator_libs_tpu_torch.k8s import get_default_client

    ds_spec = None
    if args.manage_daemonset:
        ds_spec = DriverDaemonSetSpec(
            namespace=args.namespace,
            driver_name=args.driver_name,
            version=args.driver_version,
            **({"image": args.driver_image} if args.driver_image else {}),
        )
    agent_spec = None
    if args.manage_agent:
        agent_spec = AgentDaemonSetSpec(
            namespace=args.namespace,
            driver_name=args.driver_name,
            version=args.driver_version,
            probe_interval_s=args.probe_interval,
            deep=args.deep_probe,
            **({"image": args.driver_image} if args.driver_image else {}),
        )
    controller = UpgradeController(
        get_default_client(),
        ControllerConfig(
            namespace=args.namespace,
            driver_labels=_parse_labels(args.selector),
            driver_name=args.driver_name,
            interval_s=args.interval,
            policy=(
                None if policy_ref else load_policy(args.policy_file)
            ),
            daemonset_spec=ds_spec,
            agent_spec=agent_spec,
            metrics_port=args.metrics_port,
            metrics_bind_addr=args.metrics_bind_addr,
            policy_ref=policy_ref,
            watch=args.watch,
            sharded=args.sharded,
            reconcile_shards=args.shards,
            leader_elect=args.leader_elect,
            lease_name=args.lease_name,
            lease_namespace=args.lease_namespace or None,
        ),
    )
    if args.dry_run:
        print(controller.dry_run().render())
        return
    if args.score_policy:
        print(controller.score_policy(args.score_policy))
        return
    signal.signal(signal.SIGTERM, controller.stop)
    signal.signal(signal.SIGINT, controller.stop)
    controller.run_forever()


if __name__ == "__main__":
    main()
