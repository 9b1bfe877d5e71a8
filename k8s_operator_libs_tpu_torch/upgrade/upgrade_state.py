"""The cluster upgrade state machine — slice-aware.

Capability parity with the reference's ``ClusterUpgradeStateManager``
(upgrade_state.go:55-1121): ``build_state`` snapshots the cluster
(DaemonSets → owned pods → nodes grouped by upgrade-state label),
``apply_state`` runs one stateless, idempotent pass that moves every unit
at most one state forward under ``maxParallelUpgrades``/``maxUnavailable``,
with the same nine per-state processors and the same slot math
(upgrade_state.go:1074-1102).

TPU redesign (SURVEY.md §7 step 2): the schedulable unit is an
:class:`UpgradeGroup` — every host of one ICI slice — which moves through
cordon → wait-for-jobs → pod-deletion → drain → pod-restart → validation →
uncordon **atomically**, because interrupting any host interrupts the
collective for the whole torus.  Non-TPU nodes form singleton groups, which
makes the group machinery degenerate to exactly the reference's per-node
semantics.  Slot accounting can run at slice or node granularity
(``TPUUpgradePolicySpec.unavailability_unit``), and a slice with any
cordoned/not-ready host counts as one unavailable slice — the torus is
down either way.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from k8s_operator_libs_tpu_torch.api.v1alpha1 import (
    DriverUpgradePolicySpec,
    TPUUpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.artifacts.dag import artifact_dag_of
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    generation_of,
    group_accelerator,
    group_dcn_group,
)
from k8s_operator_libs_tpu_torch.fleet.scheduler import (
    group_sort_key,
    packed_group_sort_key,
)
from k8s_operator_libs_tpu_torch.fleet.windows import window_open
from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError
from k8s_operator_libs_tpu_torch.k8s.drain import (
    ALL_RUNGS,
    EscalationStats,
    escalation_from_spec,
)
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.objects import DaemonSet, Node, Pod, deep_copy
from k8s_operator_libs_tpu_torch.k8s.writeplan import WritePlan
from k8s_operator_libs_tpu_torch.layers import count, spanned
from k8s_operator_libs_tpu_torch.topology.slices import slice_info_for_node
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    ELASTIC_RESPONSE_ACCEPT,
    ELASTIC_RESPONSE_DECLINE,
    IN_PROGRESS_STATES,
    NODE_PREEMPTION_ANNOTATION,
    QUARANTINABLE_STATES,
    TRUE_STRING,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade.cordon_manager import CordonManager
from k8s_operator_libs_tpu_torch.upgrade.durable import (
    AnnotationRungStore,
    format_adoption_stamp,
    monotonic_from_epoch,
    parse_epoch,
    parse_int,
)
from k8s_operator_libs_tpu_torch.upgrade.drain_manager import (
    DrainConfiguration,
    DrainManager,
)
from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (
    NodeUpgradeStateProvider,
    node_ready,
)
from k8s_operator_libs_tpu_torch.upgrade.pod_manager import (
    PodDeletionFilter,
    PodManager,
    PodManagerConfig,
)
from k8s_operator_libs_tpu_torch.upgrade.safe_driver_load_manager import (
    SafeDriverLoadManager,
)
from k8s_operator_libs_tpu_torch.upgrade.stuck import StuckStateDetector
from k8s_operator_libs_tpu_torch.upgrade.types import (
    ArtifactNodeState,
    ClusterUpgradeState,
    NodeUpgradeState,
    UpgradeGroup,
)
from k8s_operator_libs_tpu_torch.upgrade.util import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    EventRecorder,
    StringSet,
    UpgradeKeys,
    WorkerTracker,
    group_clock_start,
    log_event,
)
from k8s_operator_libs_tpu_torch.upgrade.validation_manager import (
    PodValidationProber,
    ProbeResult,
    SliceProber,
    ValidationManager,
)

logger = get_logger(__name__)

# Container restart count beyond which a not-ready driver pod is declared
# failing (upgrade_state.go:966-978).
DRIVER_POD_FAILING_RESTART_THRESHOLD = 10


class BuildStateError(RuntimeError):
    pass


class ClusterUpgradeStateManager:
    """State machine driver (reference upgrade_state.go:102-186)."""

    def __init__(
        self,
        client: KubeClient,
        keys: Optional[UpgradeKeys] = None,
        event_recorder: Optional[EventRecorder] = None,
        node_state_provider: Optional[NodeUpgradeStateProvider] = None,
        cordon_manager: Optional[CordonManager] = None,
        drain_manager: Optional[DrainManager] = None,
        pod_manager: Optional[PodManager] = None,
        validation_manager: Optional[ValidationManager] = None,
        safe_driver_load_manager: Optional[SafeDriverLoadManager] = None,
        poll_interval_s: float = 1.0,
        poll_timeout_s: float = 10.0,
        drain_poll_interval_s: Optional[float] = None,
        trace_recorder=None,
        enable_tracing: bool = True,
        telemetry_plane=None,
        enable_telemetry: bool = True,
    ) -> None:
        self.client = client
        self.keys = keys or UpgradeKeys()
        self.event_recorder = event_recorder
        self.provider = node_state_provider or NodeUpgradeStateProvider(
            client,
            self.keys,
            event_recorder,
            poll_interval_s=poll_interval_s,
            poll_timeout_s=poll_timeout_s,
        )
        # The transactional write plane every producer stages into
        # (k8s/writeplan.py): the provider owns it; the manager re-exports
        # it so the controller (CR status, Events), the durable rung
        # store, and metrics all share one plan — one coalesced patch per
        # node per tick, flow-scheduled status traffic, fence-at-flush.
        # Injected fake providers (tests) may not carry one; give them a
        # standalone plan so downstream wiring stays uniform.
        plan = getattr(self.provider, "plan", None)
        self.write_plan = plan if plan is not None else WritePlan(client)
        self.cordon_manager = cordon_manager or CordonManager(client)
        # Eviction/deletion polling is a distinct cadence from the
        # provider's cache-sync polls; it follows poll_interval_s by
        # default (fast tests stay fast) but is independently tunable so
        # sharpening cache-sync convergence doesn't hammer the Eviction
        # API.
        if drain_poll_interval_s is None:
            drain_poll_interval_s = poll_interval_s
        self.drain_manager = drain_manager or DrainManager(
            client, self.provider, self.keys, event_recorder,
            poll_interval_s=drain_poll_interval_s,
        )
        self.pod_manager = pod_manager or PodManager(
            client, self.provider, self.keys, None, event_recorder,
            poll_interval_s=drain_poll_interval_s,
        )
        self.validation_manager = validation_manager or ValidationManager(
            client, self.provider, self.keys, None, event_recorder
        )
        if getattr(self.validation_manager, "cordon_manager", None) is None:
            # For pipelined validation's re-cordon-on-timeout rollback.
            self.validation_manager.cordon_manager = self.cordon_manager
        self.safe_driver_load_manager = (
            safe_driver_load_manager
            or SafeDriverLoadManager(self.provider, self.keys)
        )
        # Stuck-state telemetry: Warning events + slice_stuck_seconds when
        # a group dwells in one in-progress state beyond the policy
        # threshold, carrying the sub-managers' progress-blocker reasons.
        self.stuck_detector = StuckStateDetector(self.keys, event_recorder)
        for owner, attr in (
            (self.validation_manager, "last_rejection"),
            (self.drain_manager, "last_error"),
        ):
            reasons = getattr(owner, attr, None)  # injected fakes may lack it
            if reasons is not None:
                self.stuck_detector.add_reason_source(reasons.get)
        # A FAILED group whose rollback eviction is still blocked (PDB,
        # API fault) carries an unresolved safety action: opt it into
        # stuck tracking so the wait stays visible in events + the
        # slice_stuck_seconds gauge until the eviction lands.
        pending = getattr(self.validation_manager, "pending_rollback", None)
        if pending is not None:
            self.stuck_detector.add_failed_reason_source(pending.get)
        # Slice quarantine bookkeeping (data-plane fault tolerance):
        # lifetime totals for metrics plus a per-group reason map the
        # stuck detector consumes — a group stalled behind a quarantine
        # must attribute the stall to the hardware loss, never count the
        # parked time as "stuck in <state>".
        self.quarantines_total = 0
        self.rejoins_total = 0
        # Slices demoted quarantined -> upgrade-failed after flapping
        # across the configured number of dwell windows (satellite cap).
        self.quarantine_cycle_demotions = 0
        self.quarantine_reasons: dict[str, str] = {}
        self.stuck_detector.add_reason_source(self.quarantine_reasons.get)
        # Elastic roll coordination lifetime counters (metrics.py reads
        # them off the manager the same way as quarantines_total).
        self.elastic_negotiations: dict[str, int] = {
            "accept": 0,
            "decline": 0,
            "timeout": 0,
        }
        self.elastic_resizes: dict[str, int] = {"down": 0, "up": 0}
        # Last observed workload resize duration (offer -> resize-complete
        # epoch delta), either direction.
        self.elastic_resize_seconds = 0.0
        # One shared per-rung eviction-escalation counter across every
        # DrainHelper owner (drains, workload-pod deletion, rollback
        # evictions), so a single metrics read covers all drain paths.
        self.escalation_stats = EscalationStats()
        for mgr in (
            self.drain_manager,
            self.pod_manager,
            self.validation_manager,
        ):
            if getattr(mgr, "escalation_stats", None) is None:
                try:
                    mgr.escalation_stats = self.escalation_stats
                except AttributeError:
                    pass  # injected fakes may refuse the attribute
        # Durable eviction-ladder store (crash safety): per-node rung +
        # entry epoch persisted as annotations, shared into every
        # DrainHelper owner the same way as escalation_stats so a fresh
        # leader resumes each ladder AT its committed rung, never rung 0.
        self.rung_store = AnnotationRungStore(
            client, self.keys, plan=self.write_plan
        )
        for mgr in (
            self.drain_manager,
            self.pod_manager,
            self.validation_manager,
        ):
            if getattr(mgr, "rung_store", None) is None:
                try:
                    mgr.rung_store = self.rung_store
                except AttributeError:
                    pass  # injected fakes may refuse the attribute
        # Leadership fence: the controller sets this to "is this process
        # still the live leader?" and the setter fans it out to every
        # async-worker owner, so a deposed leader's in-flight workers
        # abandon (FencedError) instead of mutating after handoff.
        self._fence = None
        # Term-comparison fence on top of liveness (ROADMAP follow-up):
        # workers compare the persisted adoption stamp's term against
        # their own before mutating, closing the deposed-leader window
        # between the last renew and the lease deadline.
        self._term_fence = None
        self._pod_deletion_enabled = False
        self._validation_enabled = False
        # Failed-group recovery probes are rate-limited: with a local
        # prober the full sustained battery (≥50 ms device probes + ICI
        # collectives) would otherwise run synchronously inside EVERY
        # reconcile pass for EVERY pod-synced failed group.  A rejection
        # is cached for this window before re-probing.
        self.recovery_probe_backoff_s = 30.0
        self._recovery_rejections: dict[str, float] = {}
        # The probe battery itself runs OFF the reconcile thread on the
        # drain-manager async-worker pattern: process_upgrade_failed_groups
        # schedules a worker per probe-eligible group (deduped by
        # _recovery_inflight) and consumes cached healthy verdicts on a
        # later pass, so the tick stays O(ms) regardless of prober type.
        # State transitions still happen only on the reconcile thread.
        self._recovery_tracker = WorkerTracker()
        self._recovery_inflight = StringSet()
        self._recovery_verdicts: dict[str, ProbeResult] = {}
        self._recovery_lock = threading.Lock()
        # When the client carries a circuit breaker (RestClient or
        # ResilientClient), an open circuit is a progress blocker every
        # group shares: surface it through stuck-state telemetry instead
        # of letting ticks fail silently.
        breaker = getattr(client, "breaker", None)
        if breaker is not None and hasattr(breaker, "describe_open"):
            self.stuck_detector.add_reason_source(
                lambda _gid: breaker.describe_open() or None
            )
        # Sharded reconcile (upgrade/sharded.py): when set, slot math is
        # arbitrated through this fleet-wide BudgetLedger instead of the
        # state-local arithmetic — scoped passes see one pool and would
        # otherwise jointly overspend maxUnavailable across shards.
        self.budget_ledger = None
        # Heterogeneous-fleet (fleet/) bookkeeping: preemption fast-path
        # counters per generation, plus maintenance-window visibility for
        # metrics/status (pool name -> window currently open?).
        self.preemptions: dict[str, int] = {}
        self.pool_window_open: dict[str, bool] = {}
        self.window_held_groups = 0
        # Window-held groups per pool, (group id, size, anchor node) —
        # the hold drops
        # them from the pass's snapshot, so the planner's feasibility
        # scan (find_infeasibilities) reads them from here instead: a
        # pool whose window never opens again must still be reported as
        # window-starved even though no pending group remains visible.
        self.window_held_info: dict[str, list[tuple[str, int, str]]] = {}
        # Runtime window-validation gap: pool name -> the unparseable
        # cron it is currently failing OPEN on (admission validates
        # crons, but a mid-run CR edit bypasses it).  Metrics publishes
        # fleet_window_invalid{pool} from this; the emitted set throttles
        # the WindowCronInvalid Warning to once per fail-open episode.
        self.window_cron_invalid: dict[str, str] = {}
        self._window_invalid_emitted: set[str] = set()
        # Plan-guided admission (planning.admissionMode: packed): the
        # controller wires its DriftWatchdog here; the admission pass
        # consults watchdog.fresh_plan() to pack waves and falls back to
        # greedy order whenever no fresh plan is anchored.
        self.drift_watchdog = None
        # Admission telemetry for metrics/status: lifetime counters
        # (packed_admitted, budget_idle_ticks) plus last-pass gauges
        # (last_budget_used / last_budget_cap -> budget_saturation).
        self.admission_stats: dict[str, int] = {}
        # Mode the last admission pass actually ran under ("greedy" or
        # "packed" — packed requires a fresh plan, so a stale anchor
        # reports greedy here even with admissionMode: packed).
        self.admission_mode = "greedy"
        # Multi-artifact stack bookkeeping (artifacts/), all observe-only
        # (metrics.py + status CLI read them off the manager the same way
        # as quarantines_total).  artifact_progress: artifact name ->
        # (synced member-pods, total member-pods) across the groups the
        # last pass touched.  artifact_skew_holds: lifetime count of
        # restart steps held back by a pinned-order edge, per artifact.
        # artifact_gate_holds: lifetime count of passes an artifact's
        # network-path gate answered not-passed.  Window savings: nodes x
        # (artifacts - 1) cordon/drain windows the shared window avoided,
        # accumulated when a multi-artifact group leaves POD_RESTART.
        self.artifact_progress: dict[str, tuple[int, int]] = {}
        self.artifact_skew_holds: dict[str, int] = {}
        self.artifact_gate_holds: dict[str, int] = {}
        self.artifact_window_savings = 0
        self.artifact_rollbacks_total = 0
        # Gate prober for network-path gated artifacts: duck-typed
        # `probe(group, artifact_name) -> .passed/.detail` (see
        # artifacts/gates.py).  None = gates pass vacuously (fake tier,
        # unit tests, clusters without a wired prober).
        self.artifact_gate_prober = None
        # Healthy gate verdicts cached per (group id, artifact) for the
        # life of the step — in-memory only, a restarted controller
        # re-probes (the safe direction).
        self._artifact_gate_ok: set[tuple[str, str]] = set()
        # (group id, artifact) pairs already warned about an ongoing
        # gate hold: one ArtifactGateHeld Warning per episode.
        self._artifact_gate_warned: set[tuple[str, str]] = set()
        # Roll tracing (obs/trace.py): every roll becomes a causal span
        # tree recorded at the engine's existing choke points.  Observe
        # -only and fail-open by contract — the recorder can never block
        # a transition; pass enable_tracing=False (bench OFF leg) to
        # remove even the hook overhead.
        self.trace_recorder = None
        if enable_tracing:
            # Deferred import: obs.trace needs upgrade.consts, so a
            # module-level import here would close an import cycle when
            # the obs package is imported first.
            from k8s_operator_libs_tpu_torch.obs.trace import TraceRecorder

            self.trace_recorder = trace_recorder or TraceRecorder()
        if self.trace_recorder is not None:
            rec = self.trace_recorder
            # Durable anchor annotation rides the state-label intents.
            rec.annotation_key = self.keys.trace_annotation
            add_observer = getattr(
                self.provider, "add_transition_observer", None
            )
            if add_observer is not None:  # injected fakes may lack it
                add_observer(rec.observe_group_transition)
            try:
                self.provider.transition_annotation_source = (
                    rec.annotation_source
                )
            except AttributeError:
                pass
            # Eviction-rung + validation-gate hooks flow to the helper
            # owners the same way as escalation_stats/rung_store.
            for mgr in (
                self.drain_manager,
                self.pod_manager,
                self.validation_manager,
            ):
                if getattr(mgr, "trace_recorder", None) is None:
                    try:
                        mgr.trace_recorder = rec
                    except AttributeError:
                        pass  # injected fakes may refuse the attribute
            try:
                # Stuck / RollInfeasible Warnings carry the trace id.
                self.stuck_detector.trace_suffix_source = (
                    self._trace_event_suffix
                )
            except AttributeError:
                pass
        # Fleet health telemetry plane (obs/telemetry.py): every probe
        # battery's measured stats land in a durable per-node ring that
        # rides the combined transition patch, folded into per-
        # (generation, pool) baselines and straggler verdicts.  Observe
        # -only and fail-open, same contract as the trace recorder;
        # pass enable_telemetry=False to remove even the hooks.
        self.telemetry_plane = None
        if enable_telemetry:
            # Deferred import, same cycle-avoidance as obs.trace above.
            from k8s_operator_libs_tpu_torch.obs.telemetry import TelemetryPlane

            self.telemetry_plane = telemetry_plane or TelemetryPlane()
        if self.telemetry_plane is not None:
            plane = self.telemetry_plane
            # Durable history ring rides the state-label intents,
            # multicast next to the trace anchor.
            plane.annotation_key = self.keys.telemetry_history_annotation
            add_source = getattr(
                self.provider, "add_transition_annotation_source", None
            )
            if add_source is not None:  # injected fakes may lack it
                add_source(plane.annotation_source)
            # Capture hook: every probe verdict's measured stats.
            if getattr(
                self.validation_manager, "telemetry_sink", None
            ) is None:
                try:
                    self.validation_manager.telemetry_sink = (
                        plane.observe_validation
                    )
                except AttributeError:
                    pass  # injected fakes may refuse the attribute
        # Flight recorder (obs/flightrec.py): wired by the controller
        # via set_flight_recorder(); None means "no black box".
        self.flight_recorder = None

    # -- observability wiring (obs/) -----------------------------------------

    def set_flight_recorder(self, recorder) -> None:
        """Wire the black box (obs/flightrec.py) into every feed and
        trigger point the manager owns: span-opening deltas, budget
        verdicts, stuck/quarantine/adoption triggers, and the snapshot
        providers (active span tree + ledger state)."""
        self.flight_recorder = recorder
        if recorder is None:
            return
        if self.trace_recorder is not None:
            self.trace_recorder.flight_recorder = recorder
            recorder.snapshot_providers["trace"] = self.trace_recorder.export
        if self.telemetry_plane is not None:
            recorder.snapshot_providers["telemetry"] = (
                self.telemetry_plane.export
            )
        recorder.snapshot_providers["ledger"] = self._ledger_snapshot_dict
        try:
            self.stuck_detector.flight_recorder = recorder
        except AttributeError:
            pass  # injected fakes may refuse the attribute
        ledger = self.budget_ledger
        if ledger is not None:
            try:
                ledger.trace_hook = self._note_budget
            except AttributeError:
                pass

    def _note_budget(self, verdict: str, group_id: str, **info) -> None:
        """BudgetLedger trace hook → flight-recorder ring (fail-open)."""
        recorder = self.flight_recorder
        if recorder is not None:
            recorder.note("budget", verdict=verdict, group=group_id, **info)

    def _ledger_snapshot_dict(self):
        """Ledger state for black-box snapshots (None when unsharded)."""
        ledger = self.budget_ledger
        if ledger is None:
            return None
        try:
            snap = ledger.snapshot()
            return {
                k: (sorted(v) if isinstance(v, (set, frozenset)) else v)
                for k, v in vars(snap).items()
            }
        except Exception as e:  # noqa: BLE001 — snapshots are advisory
            return {"error": str(e)}

    def _flightrec_trigger(self, trigger_reason: str, **context) -> None:
        # Parameter deliberately NOT named "reason": context may carry a
        # ``detail=<engine reason>`` keyword, and a same-named parameter
        # would collide at the call site — outside any fail-open guard.
        recorder = self.flight_recorder
        if recorder is None:
            return
        try:
            recorder.trigger(trigger_reason, **context)
        except Exception:  # noqa: BLE001 — black box is fail-open
            logger.debug("flight-recorder trigger failed", exc_info=True)

    def _trace_event_suffix(self) -> str:
        """``" (trace=<id>)"`` while a roll trace is active, else ``""``
        — appended to correlated Warning events so operators can join
        Events ↔ trace ↔ plan without guessing."""
        rec = self.trace_recorder
        trace_id = rec.active_trace_id() if rec is not None else None
        return f" (trace={trace_id})" if trace_id else ""

    # -- option builders (upgrade_state.go:153-186) --------------------------

    def with_pod_deletion_enabled(
        self, pod_deletion_filter: PodDeletionFilter
    ) -> "ClusterUpgradeStateManager":
        if pod_deletion_filter is None:
            logger.warning(
                "cannot enable PodDeletion state: filter is None"
            )
            return self
        self.pod_manager.pod_deletion_filter = pod_deletion_filter
        self._pod_deletion_enabled = True
        return self

    def with_validation_enabled(
        self, pod_selector_or_prober
    ) -> "ClusterUpgradeStateManager":
        """Enable the validation state with either a pod selector string
        (reference parity) or a SliceProber (TPU health gate)."""
        if not pod_selector_or_prober:
            logger.warning("cannot enable Validation state: empty selector")
            return self
        prober: SliceProber
        if isinstance(pod_selector_or_prober, str):
            prober = PodValidationProber(self.client, pod_selector_or_prober)
        else:
            prober = pod_selector_or_prober
        self.validation_manager.prober = prober
        self._validation_enabled = True
        return self

    def is_pod_deletion_enabled(self) -> bool:
        return self._pod_deletion_enabled

    def is_validation_enabled(self) -> bool:
        return self._validation_enabled

    # -- crash safety: fencing + re-adoption ---------------------------------

    @property
    def fence(self):
        """Leadership fence callable (True while this process may act)."""
        return self._fence

    @fence.setter
    def fence(self, fn) -> None:
        self._fence = fn
        # The write plane checks liveness at FLUSH time so a deposed
        # leader's queued plan is dropped whole, never partially applied.
        self.write_plan.fence = fn
        for mgr in (
            self.drain_manager,
            self.pod_manager,
            self.validation_manager,
        ):
            try:
                mgr.fence = fn
            except AttributeError:
                pass  # injected fakes may refuse the attribute

    @property
    def term_fence(self):
        """Term-comparison fence (``fence(nodes) -> bool``): False when a
        HIGHER-term leader's adoption stamp is already persisted on one
        of the nodes — the deposed-leader window the liveness fence
        cannot close (see durable.make_term_fence)."""
        return self._term_fence

    @term_fence.setter
    def term_fence(self, fn) -> None:
        self._term_fence = fn
        # Flush-time term check on a bounded sample of the staged nodes:
        # closes the deposed-leader window the liveness fence cannot.
        self.write_plan.term_fence = fn
        for mgr in (
            self.drain_manager,
            self.pod_manager,
            self.validation_manager,
        ):
            try:
                mgr.term_fence = fn
            except AttributeError:
                pass  # injected fakes may refuse the attribute

    def adopt(
        self,
        state: ClusterUpgradeState,
        identity: str = "",
        term: int = -1,
        policy=None,
    ) -> dict[str, int]:
        """Re-adoption pass: run ONCE when this process acquires the
        lease (or starts without HA), against a fresh snapshot.

        The label mailbox already carries the *state machine* position;
        this rebuilds the controller-process memory that the engine grew
        around it — from the durable record, not from zero:

        - escalation counters re-seeded from persisted per-node ladder
          rungs (a resumed force-delete ladder is visible in metrics);
        - rollback attempt counts / backoff anchors re-read from
          annotations (``validation_manager.adopt``), so FAILED groups
          whose eviction completeness is unknown are re-tracked as
          pending rollbacks instead of silently forgotten;
        - recovery-probe rejection clocks rebased from their persisted
          epochs, so a crash does not void the probe backoff window;
        - every in-flight node stamped ``<identity>@<term>`` so actions
          of a deposed leader's term are distinguishable from this one's.
        """
        summary = {
            "groups": 0,
            "rungs": 0,
            "rollbacks": 0,
            "probes": 0,
            "traces": 0,
            "telemetry": 0,
        }
        now_epoch = int(time.time())

        # (a0) Telemetry history: re-seed every node's measured-sample
        # ring from its durable annotation — baselines re-derive from
        # the rings alone, so a restarted controller scores the fleet
        # from the same longitudinal record the crashed one had (the
        # durable-clock idiom applied to health history).  ALL
        # nodes, not only in-flight ones: history is longitudinal.
        plane = self.telemetry_plane
        if plane is not None:
            for members in state.node_states.values():
                for nus in members:
                    if plane.adopt_node(nus.node):
                        summary["telemetry"] += 1

        # (a) Seed the shared escalation counters from persisted rungs:
        # one record per node, counting every rung up to the committed
        # one (the ladder climbed through them to get there).
        rung_key = self.keys.eviction_rung_annotation
        for members in state.node_states.values():
            for nus in members:
                persisted = nus.node.annotations.get(rung_key)
                if persisted in ALL_RUNGS:
                    for rung in ALL_RUNGS:
                        self.escalation_stats.record(rung)
                        if rung == persisted:
                            break
                    summary["rungs"] += 1

        # (b) Rollback attempt counts + retry backoff (validation layer).
        adopt_rollbacks = getattr(self.validation_manager, "adopt", None)
        if adopt_rollbacks is not None:  # injected fakes may lack it
            summary["rollbacks"] = adopt_rollbacks(state)

        # (c) Recovery-probe dedupe: a rejection inside the persisted
        # backoff window keeps the battery from re-running immediately
        # on the new leader's first pass.
        probe_key = self.keys.recovery_probe_since_annotation
        for group in state.groups_in(UpgradeState.FAILED):
            epochs = [
                e
                for e in (
                    parse_epoch(m.node.annotations.get(probe_key))
                    for m in group.members
                )
                if e is not None
            ]
            if epochs:
                with self._recovery_lock:
                    self._recovery_rejections[group.id] = monotonic_from_epoch(
                        max(epochs), now_epoch
                    )
                summary["probes"] += 1

        # (d) Fencing stamp on every in-flight node.  Best-effort: a
        # failed stamp degrades observability, never the adoption.
        stamp = format_adoption_stamp(identity or "unknown", term)
        adopt_key = self.keys.adopted_by_annotation
        trace_key = self.keys.trace_annotation
        recorder = self.trace_recorder
        for st in tuple(IN_PROGRESS_STATES) + (
            UpgradeState.FAILED,
            UpgradeState.QUARANTINED,
            # Serving hosts, but the rejoin-resize completion is still a
            # controller action that must be term-fenced.
            UpgradeState.REJOIN_RESIZE_REQUIRED,
            # Queued groups hold an open budget-wait span in the trace.
            UpgradeState.UPGRADE_REQUIRED,
        ):
            for group in state.groups_in(st):
                if st != UpgradeState.UPGRADE_REQUIRED:
                    summary["groups"] += 1
                # (e) Trace continuity: the persisted anchor re-opens the
                # group's in-flight spans under the new identity@term, so
                # the restarted controller CONTINUES the same trace id
                # instead of minting a fresh one mid-roll.
                if recorder is not None:
                    anchors = [
                        m.node.annotations.get(trace_key)
                        for m in group.members
                    ]
                    anchor = next((a for a in anchors if a), None)
                    if anchor is not None:
                        pool = None
                        if policy is not None:
                            try:
                                pool = self._pool_for_group(group, policy)
                            except Exception:  # noqa: BLE001 — pool
                                # attribution is advisory
                                pool = None
                        reopened = recorder.reopen_group(
                            [m.node for m in group.members],
                            anchor,
                            pool=pool,
                            adopted_by=stamp,
                            now_epoch=now_epoch,
                        )
                        if reopened:
                            summary["traces"] += 1
                if st == UpgradeState.UPGRADE_REQUIRED:
                    continue  # queued groups are not stamped/fenced
                stale = [
                    m.node
                    for m in group.members
                    if m.node.annotations.get(adopt_key) != stamp
                ]
                if stale:
                    try:
                        self.provider.change_nodes_upgrade_annotation(
                            stale, adopt_key, stamp
                        )
                    except Exception as e:  # noqa: BLE001 — best-effort
                        logger.warning(
                            "adoption stamp for group %s failed: %s",
                            group.id,
                            e,
                        )
        logger.info(
            "re-adoption (%s): %d in-flight group(s), %d persisted "
            "ladder rung(s), %d pending rollback(s), %d probe "
            "backoff(s), %d trace span(s) re-opened, %d telemetry "
            "ring(s) re-seeded",
            stamp,
            summary["groups"],
            summary["rungs"],
            summary["rollbacks"],
            summary["probes"],
            summary["traces"],
            summary["telemetry"],
        )
        if summary["groups"] or summary["traces"]:
            # Crash-adoption is a black-box trigger: capture what the
            # new leader inherited before it starts mutating.
            self._flightrec_trigger(
                "adoption",
                identity=stamp,
                groups=summary["groups"],
                traces=summary["traces"],
            )
        return summary

    # -- BuildState (upgrade_state.go:214-279) -------------------------------

    @spanned("engine.build_state", opens="_layer_pass")
    def build_state(
        self,
        namespace: str,
        driver_labels: dict[str, str],
        policy: Optional[DriverUpgradePolicySpec] = None,
        scope_nodes: Optional[set[str]] = None,
    ) -> ClusterUpgradeState:
        """Point-in-time snapshot: DaemonSets → owned pods → nodes, grouped
        by upgrade-state label and (new) by ICI slice.

        ``policy`` is optional (reference signature parity); pass it to
        honor ``TPUUpgradePolicySpec.slice_atomic=False`` (every node a
        singleton group) and ``topology.hosts_per_slice`` overrides.

        ``scope_nodes`` (sharded dirty-set reconcile) restricts the
        snapshot to the named nodes — one pool's scoped rebuild costs
        O(pool), not O(fleet).  The DaemonSet completeness guard is
        fleet-wide by definition and only applies to unscoped builds."""
        logger.info("building state")
        count("engine.passes")
        # Informer fast path: when the client exposes a fresh coherent
        # cache snapshot (CachedKubeClient), resolve daemonsets, pods,
        # AND every pod's node from the SAME in-memory view — one lock
        # hold, zero API round trips, no torn-read window between the
        # list calls below.  Otherwise (raw client, stale/unsynced
        # cache) the direct list + per-pod provider reads keep their
        # exact semantics.
        snapshot_fn = getattr(self.client, "coherent_snapshot", None)
        snapshot = None
        if callable(snapshot_fn):
            try:
                snapshot = snapshot_fn(node_names=scope_nodes)
            except TypeError:  # older/injected snapshot providers
                snapshot = snapshot_fn()
        # A shared (copy-on-write) snapshot lends out the informer
        # store's own objects: the engine mutates node/pod state in
        # place during a pass (provider read-your-writes), so every
        # object MATERIALIZED into the returned state must be privately
        # copied here.  Only driver daemonsets and the pods/nodes that
        # actually enter the state are copied — never the whole store.
        shared = bool(snapshot is not None and getattr(snapshot, "shared", False))
        if snapshot is not None:
            daemon_sets = {
                ds.metadata.uid: deep_copy(ds) if shared else ds
                for ds in snapshot.list_daemon_sets(
                    namespace, driver_labels
                )
            }
            pods = snapshot.list_pods(
                namespace=namespace, match_labels=driver_labels
            )
        else:
            daemon_sets = {
                ds.metadata.uid: ds
                for ds in self.client.list_daemon_sets(
                    namespace, driver_labels
                )
            }
            pods = self.client.list_pods(
                namespace=namespace, match_labels=driver_labels
            )
        if scope_nodes is not None:
            pods = [p for p in pods if p.spec.node_name in scope_nodes]

        filtered: list[tuple[Pod, Optional[DaemonSet]]] = []
        for ds in daemon_sets.values():
            ds_pods = [
                p
                for p in pods
                if not p.is_orphaned()
                and p.metadata.owner_references[0].uid == ds.metadata.uid
            ]
            if (
                scope_nodes is None
                and ds.status.desired_number_scheduled != len(ds_pods)
            ):
                # Guard (upgrade_state.go:243-246): a partially-scheduled
                # driver DaemonSet gives an incoherent snapshot.  A scoped
                # build sees a pool-sized subset by construction, so the
                # fleet-wide count cannot apply; the periodic full resync
                # keeps enforcing it.
                raise BuildStateError(
                    "driver DaemonSet should not have Unscheduled pods"
                )
            filtered.extend((p, ds) for p in ds_pods)
        filtered.extend((p, None) for p in pods if p.is_orphaned())

        state = ClusterUpgradeState()
        node_states_by_name: dict[str, NodeUpgradeState] = {}
        # COW materialization cache: a node referenced by two pods must
        # resolve to the SAME private copy (matching the eager-snapshot
        # behavior, where both lookups hit one copied object).
        node_copies: dict[str, Node] = {}
        for pod, ds in filtered:
            if not pod.spec.node_name:
                logger.info("driver pod %s has no node, skipping", pod.name)
                continue
            node = None
            if snapshot is not None:
                node = snapshot.get_node(pod.spec.node_name)
                if node is not None and shared:
                    copied = node_copies.get(node.name)
                    if copied is None:
                        copied = deep_copy(node)
                        node_copies[node.name] = copied
                    node = copied
                    pod = deep_copy(pod)
            else:
                try:
                    node = self.provider.get_node(pod.spec.node_name)
                except NotFoundError:
                    node = None
            if node is None:
                # Node deleted mid-roll (hardware repair, scale-down) with
                # its driver pod still Terminating: the pod is not part of
                # the cluster anymore.  Skipping it keeps the snapshot
                # membership-change-safe — the group rebuilds from the
                # surviving hosts, no orphaned labels, no double-counted
                # units.
                logger.warning(
                    "node %s for driver pod %s no longer exists, skipping",
                    pod.spec.node_name,
                    pod.name,
                )
                continue
            nus = NodeUpgradeState(node=node, driver_pod=pod, driver_daemon_set=ds)
            node_states_by_name[node.name] = nus
            label_state = node.labels.get(self.keys.state_label, "")
            state.node_states.setdefault(label_state, []).append(nus)

        self._attach_artifacts(
            node_states_by_name, namespace, policy, scope_nodes
        )
        self._build_groups(state, node_states_by_name, policy)
        return state

    def _attach_artifacts(
        self,
        node_states_by_name: dict[str, NodeUpgradeState],
        namespace: str,
        policy: Optional[DriverUpgradePolicySpec],
        scope_nodes: Optional[set[str]],
    ) -> None:
        """Resolve every NON-primary artifact's pods/DaemonSets onto the
        node states (multi-artifact policies only).

        The primary artifact — first in topological order — is the
        classic driver DaemonSet and already rides ``driver_pod`` /
        ``driver_daemon_set``: its matchLabels are the ``driver_labels``
        this build ran with.  Lookups go through ``self.client``, never
        the informer snapshot: the controller may scope its pod informer
        to the driver labels, and a scoped cache would silently miss the
        other artifacts' pods (CachedKubeClient falls through to the
        live client for uncovered queries).  A node with no pod for an
        artifact gets no entry — the engine treats it as vacuously
        synced, matching how the classic path treats a node its
        DaemonSet does not schedule onto."""
        dag = artifact_dag_of(policy)
        if dag is None:
            return
        primary = dag.primary()
        for name in dag.topo_order():
            if name == primary:
                continue
            art = dag.artifact(name)
            labels = dict(art.match_labels)
            dss = {
                ds.metadata.uid: ds
                for ds in self.client.list_daemon_sets(namespace, labels)
            }
            for pod in self.client.list_pods(
                namespace=namespace, match_labels=labels
            ):
                node_name = pod.spec.node_name
                if not node_name:
                    continue
                if scope_nodes is not None and node_name not in scope_nodes:
                    continue
                nus = node_states_by_name.get(node_name)
                if nus is None:
                    continue
                ds = None
                if not pod.is_orphaned():
                    ds = dss.get(pod.metadata.owner_references[0].uid)
                if nus.artifacts is None:
                    nus.artifacts = {}
                nus.artifacts[name] = ArtifactNodeState(pod=pod, daemon_set=ds)

    def _build_groups(
        self,
        state: ClusterUpgradeState,
        node_states_by_name: dict[str, NodeUpgradeState],
        policy: Optional[DriverUpgradePolicySpec] = None,
    ) -> None:
        """Bundle node states into slice groups; non-TPU nodes become
        singletons (degenerating to reference per-node semantics)."""
        slice_atomic = True
        hosts_override = 0
        if isinstance(policy, TPUUpgradePolicySpec):
            slice_atomic = policy.slice_atomic
            if policy.topology is not None:
                hosts_override = policy.topology.hosts_per_slice
        slice_members: dict[str, list[NodeUpgradeState]] = {}
        slice_infos: dict[str, object] = {}
        singletons: list[NodeUpgradeState] = []
        for nus in node_states_by_name.values():
            info = slice_info_for_node(nus.node, self.keys)
            if info is None or not slice_atomic:
                singletons.append(nus)
            else:
                if hosts_override > 0:
                    info.expected_hosts = hosts_override
                slice_members.setdefault(info.slice_id, []).append(nus)
                slice_infos.setdefault(info.slice_id, info)
        groups: list[UpgradeGroup] = []
        for slice_id, members in sorted(slice_members.items()):
            members.sort(key=lambda m: m.node.name)
            groups.append(
                UpgradeGroup(
                    id=slice_id,
                    members=members,
                    slice_info=slice_infos[slice_id],  # type: ignore[arg-type]
                )
            )
        groups.extend(
            UpgradeGroup(id=nus.node.name, members=[nus]) for nus in singletons
        )
        for group in groups:
            eff = group.effective_state(self.keys.state_label)
            state.groups.setdefault(eff.value, []).append(group)

    # -- ApplyState (upgrade_state.go:364-484) -------------------------------

    @spanned("engine.apply_state", joins="_layer_pass")
    def apply_state(
        self,
        current_state: Optional[ClusterUpgradeState],
        policy: Optional[DriverUpgradePolicySpec],
        scoped: bool = False,
    ) -> None:
        """One stateless, idempotent pass over the snapshot.

        ``scoped=True`` (sharded dirty-set reconcile) marks the snapshot
        as one pool's slice of the fleet: slot admission MUST go through
        ``self.budget_ledger`` (state-local math would overspend across
        shards), and fleet-cadence observers (the stuck detector, whose
        dwell tracking assumes it sees every group each pass) run only
        on full passes."""
        if current_state is None:
            raise ValueError("currentState should not be empty")
        if policy is None or not policy.auto_upgrade:
            logger.info("driver auto upgrade is disabled, skipping")
            return

        logger.info(
            "state counts: %s",
            {s.value or "unknown": len(current_state.nodes_in(s)) for s in UpgradeState},
        )

        # TPU health-gate knobs: validation timeout + gate disable + DCN.
        validation_active = self.is_validation_enabled()
        if isinstance(policy, TPUUpgradePolicySpec) and policy.health_gate is not None:
            if policy.health_gate.timeout_second:
                self.validation_manager.timeout_seconds = (
                    policy.health_gate.timeout_second
                )
            if not policy.health_gate.enable:
                validation_active = False
        # Set unconditionally (not only when a health gate is configured):
        # a leftover True from a previous policy must not keep rejecting
        # reports after the DCN gate is turned off.
        prober = getattr(self.validation_manager, "prober", None)
        if prober is not None and hasattr(prober, "require_dcn_check"):
            prober.require_dcn_check = bool(
                isinstance(policy, TPUUpgradePolicySpec)
                and policy.health_gate is not None
                and policy.health_gate.dcn_check
            )

        pipeline = (
            isinstance(policy, TPUUpgradePolicySpec)
            and policy.pipeline_validation
        )
        # Pipelined validation re-cordons a slice whose gate fails.
        self.validation_manager.recordon_on_timeout = pipeline
        if pipeline and self.budget_ledger is not None:
            # The pipelined gate released the group's ledger claim at
            # optimistic uncordon; a timeout takes the hosts back out of
            # service, so force the charge back on (past the caps if the
            # freed slot was already re-claimed — the unavailability is
            # a fact, not an admission request).
            _ledger = self.budget_ledger
            _unit = self._unavailability_unit(policy)

            def _recharge_on_recordon(group):
                _ledger.try_claim(
                    group.id,
                    1 if _unit == "slice" else group.size(),
                    force=True,
                )

            self.validation_manager.on_pipeline_recordon = (
                _recharge_on_recordon
            )
        else:
            self.validation_manager.on_pipeline_recordon = None

        # The pod manager's eviction-escalation ladder derives from the
        # drain spec (PodDeletionSpec carries no ladder knobs of its own).
        if hasattr(self.pod_manager, "escalation"):
            self.pod_manager.escalation = escalation_from_spec(
                getattr(policy.drain_spec, "eviction_escalation", None)
                if policy.drain_spec is not None
                else None
            )

        # Mixed pools in one CR need per-pool cap arbitration even on the
        # unsharded path: build a pass-local ledger from this snapshot so
        # admission goes through the same fleet ∧ pool claim the sharded
        # reconciler uses.  Restored to None at the end of the pass — the
        # next pass re-derives it from its own snapshot, so it needs no
        # cross-pass consistency.
        ephemeral_ledger = None
        if self.budget_ledger is None and self._policy_pools(policy):
            from k8s_operator_libs_tpu_torch.upgrade.sharded import BudgetLedger

            ephemeral_ledger = BudgetLedger()
            pool_of = {
                g.id: self._pool_for_group(g, policy)
                for g in current_state.all_groups()
            }
            ephemeral_ledger.pool_resolver = pool_of.get
            ephemeral_ledger.sync_from_state(self, current_state, policy)
            self.budget_ledger = ephemeral_ledger
        try:
            self._apply_state_processors(
                current_state, policy, scoped, validation_active, pipeline
            )
        finally:
            if ephemeral_ledger is not None:
                self.budget_ledger = None

    def _apply_state_processors(
        self,
        current_state: ClusterUpgradeState,
        policy: DriverUpgradePolicySpec,
        scoped: bool,
        validation_active: bool,
        pipeline: bool,
    ) -> None:
        # Preemption fast-path and maintenance-window gating run FIRST:
        # a preempted or window-held group must vanish from the snapshot
        # before ANY processor (quarantine included) can act on it — zero
        # transitions, zero budget held.
        self.process_preemption(current_state, policy)
        self.process_maintenance_windows(current_state, policy)

        # Slice quarantine runs BEFORE the slot math: a slice parked this
        # pass must already have released its unavailability budget when
        # upgrades_available is computed below, and a slice rejoining is
        # re-bucketed so the roll resumes in this same pass.
        self.process_quarantine(current_state, policy)

        unit = self._unavailability_unit(policy)
        ledger = self.budget_ledger
        in_progress_units = 0
        max_unavailable = 0
        if ledger is not None:
            # Sharded mode: the fleet-wide ledger (re-baselined every
            # full resync) is the single arbiter; the scoped state's
            # local totals are meaningless for admission.  Claims happen
            # inside process_upgrade_required_groups / quarantine rejoin.
            upgrades_available = 0
            logger.info(
                "budget ledger: %d/%d unavailable, %d claims (unit=%s)",
                ledger.unavailable_used(),
                ledger.max_unavailable,
                ledger.parallel_used(),
                ledger.unit,
            )
        else:
            total_units = self._total_units(current_state, unit)
            max_unavailable = total_units
            if policy.max_unavailable is not None:
                max_unavailable = policy.max_unavailable.scaled_value(
                    total_units, round_up=True
                )
            upgrades_available = self.get_upgrades_available_units(
                current_state, policy.max_parallel_upgrades, max_unavailable,
                unit, pipeline=pipeline,
            )
            in_progress_units = self._in_progress_units(current_state, unit)
            logger.info(
                "upgrades in progress: %d, available slots: %d (unit=%s, "
                "maxUnavailable=%d, total=%d)",
                in_progress_units,
                upgrades_available,
                unit,
                max_unavailable,
                total_units,
            )

        if ledger is not None and getattr(ledger, "trace_hook", None) is None:
            # Budget verdicts feed the flight-recorder ring (fail-open;
            # ephemeral ledgers are rebuilt per pass, so re-wire here).
            try:
                ledger.trace_hook = self._note_budget
            except AttributeError:
                pass
        self.process_done_or_unknown_groups(
            current_state, UpgradeState.UNKNOWN, policy
        )
        self.process_done_or_unknown_groups(
            current_state, UpgradeState.DONE, policy
        )
        if self.trace_recorder is not None:
            # Wave boundary: groups the coming admission pass charges
            # share one wave span per pool in the roll trace.
            self.trace_recorder.begin_admission_pass()
        self.process_upgrade_required_groups(
            current_state, upgrades_available, unit, policy
        )
        # Budget-saturation gauge inputs (metrics.py): how much of the
        # effective maxUnavailable cap the fleet holds after admission.
        astats = self.admission_stats
        if ledger is not None:
            astats["last_budget_used"] = ledger.unavailable_used()
            astats["last_budget_cap"] = ledger.max_unavailable
        else:
            astats["last_budget_used"] = min(
                max_unavailable,
                in_progress_units + astats.get("last_admitted_units", 0),
            )
            astats["last_budget_cap"] = max_unavailable
        # Elastic negotiation sits between admission and cordon: absorbed
        # resizes (and decline/timeout fallbacks) re-bucket into
        # cordon-required and proceed in this same pass.
        self.process_negotiation_groups(current_state, policy)
        self.process_cordon_required_groups(current_state)
        self.process_wait_for_jobs_required_groups(
            current_state, policy.wait_for_completion
        )
        drain_enabled = policy.drain_spec is not None and policy.drain_spec.enable
        self.process_pod_deletion_required_groups(
            current_state, policy.pod_deletion, drain_enabled
        )
        self.process_drain_groups(current_state, policy.drain_spec)
        self.process_pod_restart_groups(
            current_state, validation_active, pipeline=pipeline, policy=policy
        )
        self.process_upgrade_failed_groups(current_state, validation_active)
        self.process_validation_required_groups(current_state, validation_active)
        self.process_uncordon_required_groups(current_state)
        self.process_rejoin_resize_groups(current_state, policy)
        # Re-attempt rollback evictions that previously failed (PDB,
        # API fault) for groups still FAILED — idempotent, so pods on
        # gate-rejected hardware are evicted as soon as the blocker
        # clears rather than lingering until manual intervention.
        retry = getattr(
            self.validation_manager, "retry_pending_rollbacks", None
        )
        if retry is not None:  # injected fakes may lack it
            retry(current_state)
        if isinstance(policy, TPUUpgradePolicySpec):
            self.stuck_detector.threshold_s = float(
                policy.stuck_threshold_second
            )
        if not scoped:
            # Dwell tracking assumes a fleet-wide snapshot (a group
            # absent from the pass is treated as "moved on"); scoped
            # passes see one pool, so stuck detection runs at the full
            # -resync cadence instead.
            self.stuck_detector.observe(current_state)
            # Fleet-level "will this roll ever finish": window
            # starvation / budget deadlock / elastic-decline storms are
            # reported as plan infeasibility within one resync interval,
            # not discovered by waiting out a per-group dwell.
            self.stuck_detector.observe_fleet(
                current_state, policy, manager=self
            )
            if self.trace_recorder is not None:
                # Roll completion is only decidable fleet-wide: when
                # every traced group has reached a terminal state the
                # recorder closes the trace and hands the completed span
                # tree to obs/critical.py via last_completed().
                self.trace_recorder.maybe_end_roll()
        logger.info("state manager finished processing")

    # -- processors ----------------------------------------------------------

    @spanned("engine.done_or_unknown")
    def process_done_or_unknown_groups(
        self,
        state: ClusterUpgradeState,
        state_name: UpgradeState,
        policy: Optional[DriverUpgradePolicySpec] = None,
    ) -> None:
        """Decide upgrade-required vs done (upgrade_state.go:488-550).
        A slice requires upgrade if ANY host needs it — it moves whole.

        Multi-artifact stacks: an out-of-sync NON-primary artifact also
        requires the upgrade — the whole stack rides the one window, so
        a network-driver bump re-enters the same machine the libtpu bump
        uses (size-1 DAGs take the classic predicate untouched)."""
        dag = artifact_dag_of(policy)
        secondary = dag.topo_order()[1:] if dag is not None else []
        for group in state.groups_in(state_name):
            requires = False
            for member in group.members:
                synced, orphaned = self._pod_in_sync_with_ds(member)
                if (not synced and not orphaned) or self._is_upgrade_requested(
                    member.node
                ):
                    requires = True
                for name in secondary:
                    a_synced, a_orphaned = self._artifact_in_sync(member, name)
                    if not a_synced and not a_orphaned:
                        requires = True
            if self.safe_driver_load_manager.is_group_waiting_for_safe_driver_load(
                group
            ):
                logger.info(
                    "group %s is waiting for safe driver load, "
                    "initializing upgrade",
                    group.id,
                )
                requires = True
            if requires:
                # Track hosts that were already unschedulable so uncordon is
                # skipped for them at the end (upgrade_state.go:510-523).
                already_cordoned = [
                    m.node for m in group.members if m.node.spec.unschedulable
                ]
                if already_cordoned:
                    self.provider.change_nodes_upgrade_annotation(
                        already_cordoned,
                        self.keys.initial_state_annotation,
                        TRUE_STRING,
                    )
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.UPGRADE_REQUIRED
                )
                logger.info("group %s requires upgrade", group.id)
                continue
            if state_name == UpgradeState.UNKNOWN:
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.DONE
                )
                logger.info("group %s -> upgrade-done", group.id)

    def _in_flight_dcn_groups(self, state: ClusterUpgradeState) -> set[str]:
        """DCN (multi-slice) groups that currently have a slice in flight or
        unavailable.  Under dcn_anti_affinity, no second slice of the same
        group may start — taking both down would stall the whole
        data-parallel JobSet (BASELINE config 5)."""
        in_flight: set[str] = set()
        for group in state.all_groups():
            ring = group_dcn_group(group, self.keys)
            if ring is None:
                continue
            eff = group.effective_state(self.keys.state_label)
            if eff in IN_PROGRESS_STATES or self._group_unavailable(group):
                in_flight.add(ring)
        return in_flight

    @spanned("engine.upgrade_required")
    def process_upgrade_required_groups(
        self,
        state: ClusterUpgradeState,
        upgrades_available: int,
        unit: str,
        policy: Optional[DriverUpgradePolicySpec] = None,
    ) -> None:
        """Consume slots and move groups to cordon-required
        (upgrade_state.go:587-631), plus the TPU guards: never start an
        incomplete slice (a torus with missing hosts would be split by the
        upgrade itself) and never take two slices of one DCN group down
        simultaneously when dcn_anti_affinity is set."""
        dcn_anti_affinity = (
            isinstance(policy, TPUUpgradePolicySpec) and policy.dcn_anti_affinity
        )
        busy_dcn = self._in_flight_dcn_groups(state) if dcn_anti_affinity else set()
        # Generation-aware ordering (fleet/scheduler): budget slots drain
        # oldest-generation-first — the cheapest canary sees a new driver
        # before the flagship pools do.  Deterministic and label-derived,
        # so every controller incarnation computes the same order.
        #
        # Plan-guided packing (planning.admissionMode: packed): when the
        # drift watchdog holds a FRESH plan, reorder WITHIN each
        # generation class — the current planned wave's groups first,
        # then first-fit-decreasing by cost so smaller groups fill the
        # budget a denied head group would otherwise strand.  Every
        # admission gate below (skip, incomplete slice, DCN, window
        # holds upstream, fleet ∧ pool budgets) is unchanged, so packing
        # can only reorder candidates, never over-admit; with no fresh
        # plan the order degrades to exactly the greedy one.
        plan = None
        planning_spec = getattr(policy, "planning", None)
        if (
            planning_spec is not None
            and getattr(planning_spec, "admission_mode", "greedy") == "packed"
            and self.drift_watchdog is not None
        ):
            plan = self.drift_watchdog.fresh_plan()
        packed = plan is not None
        self.admission_mode = "packed" if packed else "greedy"
        if packed:
            unplanned_wave = 1 << 30

            def _admission_key(group) -> tuple:
                cost_ = 1 if unit == "slice" else group.size()
                key = packed_group_sort_key(group, cost_)
                wave = plan.wave_of(group.id)
                # generation rank | planned wave | -cost | group id
                return key[:3] + (
                    wave if wave is not None else unplanned_wave,
                ) + key[3:]

        else:
            _admission_key = group_sort_key
        stats = self.admission_stats
        stats["last_admitted_units"] = 0
        # Budget-gate denials this pass, re-probed after the loop: any
        # group the pass refused but could still afford is an idle-budget
        # tick (structurally 0 — the loop fills residual budget — so the
        # counter is a regression canary, not a steady-state signal).
        budget_denied: list = []
        for group in sorted(
            state.groups_in(UpgradeState.UPGRADE_REQUIRED), key=_admission_key
        ):
            requested = [
                m.node
                for m in group.members
                if self._is_upgrade_requested(m.node)
            ]
            if requested:
                # Clear the externally-set upgrade-requested annotation.
                self.provider.change_nodes_upgrade_annotation(
                    requested, self.keys.upgrade_requested_annotation, "null"
                )
            if any(
                m.node.labels.get(self.keys.skip_label) == TRUE_STRING
                for m in group.members
            ):
                logger.info("group %s is marked to skip upgrades", group.id)
                continue
            if (
                group.slice_info is not None
                and group.size() < group.slice_info.expected_hosts
            ):
                logger.warning(
                    "slice %s has %d/%d hosts visible; refusing to start an "
                    "upgrade on an incomplete slice",
                    group.id,
                    group.size(),
                    group.slice_info.expected_hosts,
                )
                continue
            ring = group_dcn_group(group, self.keys)
            if dcn_anti_affinity and ring is not None and ring in busy_dcn:
                logger.info(
                    "slice %s deferred: another slice of DCN group %s is in "
                    "flight (dcn_anti_affinity)",
                    group.id,
                    ring,
                )
                continue
            cost = 1 if unit == "slice" else group.size()
            already_cordoned = all(
                m.node.spec.unschedulable for m in group.members
            )
            ledger = self.budget_ledger
            if ledger is not None:
                # Sharded mode: admission is an atomic fleet-wide claim
                # — two shards each seeing "one slot free" in their own
                # scoped state cannot jointly overspend.  The
                # already-cordoned bypass becomes a forced claim: the
                # group is genuinely unavailable either way, and the
                # charge must stay visible to every other shard.
                dcn = ring if dcn_anti_affinity else None
                if not ledger.try_claim(
                    group.id, cost, dcn_group=dcn, force=already_cordoned
                ):
                    logger.info(
                        "upgrade limit reached (ledger), pausing group %s",
                        group.id,
                    )
                    budget_denied.append((group.id, cost, dcn))
                    continue
                if already_cordoned:
                    logger.info(
                        "group %s already cordoned, progressing", group.id
                    )
            elif upgrades_available < cost:
                # Already-cordoned groups bypass the slot limit
                # (upgrade_state.go:606-616).
                if already_cordoned:
                    logger.info(
                        "group %s already cordoned, progressing", group.id
                    )
                else:
                    logger.info(
                        "upgrade limit reached, pausing group %s", group.id
                    )
                    budget_denied.append((group.id, cost, None))
                    # Unsharded path has no ledger tap: feed the black
                    # box directly so denial history survives a crash.
                    self._note_budget(
                        "denied",
                        group.id,
                        cost=cost,
                        available=upgrades_available,
                    )
                    continue
            else:
                upgrades_available -= cost
                self._note_budget(
                    "granted",
                    group.id,
                    cost=cost,
                    available=upgrades_available,
                )
            # Elastic coordination: a registered workload is offered the
            # slice BEFORE any disruptive action.  The slot claim above is
            # kept through the negotiation — decline/timeout falls back to
            # cordon with exactly the pre-negotiation charge, and an
            # accepted resize releases it when the exclusion is absorbed.
            espec = self._elastic_spec(policy)
            target = UpgradeState.CORDON_REQUIRED
            if espec is not None and espec.enable:
                if self._group_elastic_excluded(group):
                    # Already excluded (quarantine-shrink): nothing to
                    # negotiate, and an excluded slice holds no budget.
                    if ledger is not None:
                        ledger.release(group.id)
                elif (
                    not already_cordoned
                    and self._group_elastic_registered(group)
                ):
                    target = UpgradeState.NEGOTIATE_REQUIRED
            self.provider.change_nodes_upgrade_state(group.nodes, target)
            stats["last_admitted_units"] += cost
            if packed:
                stats["packed_admitted"] = stats.get("packed_admitted", 0) + 1
            if ring is not None:
                busy_dcn.add(ring)
            if target is UpgradeState.NEGOTIATE_REQUIRED:
                self._move_group_bucket(state, group, target)
                logger.info("group %s negotiating elastic resize", group.id)
            else:
                logger.info("group %s waiting for cordon", group.id)

        # Idle-budget canary: re-probe every budget-gate denial against
        # the post-pass charge table.  Usage only grows within a pass,
        # so a denial that is affordable NOW was affordable when tried —
        # any hit means admission left chargeable pending work on the
        # table (e.g. an early-return regression in this loop).
        idle = False
        ledger = self.budget_ledger
        for gid, cost, dcn in budget_denied:
            if ledger is not None:
                if ledger.can_claim(gid, cost, dcn_group=dcn):
                    idle = True
                    break
            elif cost <= upgrades_available:
                idle = True
                break
        if idle:
            stats["budget_idle_ticks"] = stats.get("budget_idle_ticks", 0) + 1

    @spanned("engine.cordon_required")
    def process_cordon_required_groups(self, state: ClusterUpgradeState) -> None:
        """Cordon all hosts, then advance (upgrade_state.go:635-654)."""
        for group in state.groups_in(UpgradeState.CORDON_REQUIRED):
            self.cordon_manager.cordon_nodes(group.nodes)
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.WAIT_FOR_JOBS_REQUIRED
            )

    @spanned("engine.wait_for_jobs_required")
    def process_wait_for_jobs_required_groups(
        self, state: ClusterUpgradeState, wait_spec
    ) -> None:
        """(upgrade_state.go:658-693)"""
        groups = state.groups_in(UpgradeState.WAIT_FOR_JOBS_REQUIRED)
        if not groups:
            return
        if wait_spec is None or not wait_spec.pod_selector:
            next_state = (
                UpgradeState.POD_DELETION_REQUIRED
                if self.is_pod_deletion_enabled()
                else UpgradeState.DRAIN_REQUIRED
            )
            for group in groups:
                self.provider.change_nodes_upgrade_state(group.nodes, next_state)
            return
        self.pod_manager.schedule_check_on_pod_completion(
            PodManagerConfig(groups=groups, wait_for_completion_spec=wait_spec)
        )

    @spanned("engine.pod_deletion_required")
    def process_pod_deletion_required_groups(
        self, state: ClusterUpgradeState, deletion_spec, drain_enabled: bool
    ) -> None:
        """(upgrade_state.go:698-727)"""
        groups = state.groups_in(UpgradeState.POD_DELETION_REQUIRED)
        if not groups:
            return
        if not self.is_pod_deletion_enabled():
            for group in groups:
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.DRAIN_REQUIRED
                )
            return
        self.pod_manager.schedule_pod_eviction(
            PodManagerConfig(
                groups=groups,
                deletion_spec=deletion_spec,
                drain_enabled=drain_enabled,
            )
        )

    @spanned("engine.drain")
    def process_drain_groups(self, state: ClusterUpgradeState, drain_spec) -> None:
        """(upgrade_state.go:731-760)"""
        groups = state.groups_in(UpgradeState.DRAIN_REQUIRED)
        if not groups:
            return
        if drain_spec is None or not drain_spec.enable:
            logger.info("node drain is disabled by policy, skipping")
            for group in groups:
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.POD_RESTART_REQUIRED
                )
            return
        self.drain_manager.schedule_groups_drain(
            DrainConfiguration(spec=drain_spec, groups=groups)
        )

    @spanned("engine.pod_restart")
    def process_pod_restart_groups(
        self,
        state: ClusterUpgradeState,
        validation_active: Optional[bool] = None,
        pipeline: bool = False,
        policy: Optional[DriverUpgradePolicySpec] = None,
    ) -> None:
        """Restart outdated driver pods; advance fully-recovered groups
        (upgrade_state.go:764-831).

        With ``pipeline`` (TPUUpgradePolicySpec.pipeline_validation) a
        fully-synced group is uncordoned ON ENTRY to validation: the
        workload is readmitted while the health gate runs, so the slice
        stops counting against parallel/unavailability budgets and the
        next slice's drain overlaps this one's validation.

        Multi-artifact stacks (``policy.artifacts``, >1 item) step the
        group's artifacts through this SAME state — topological order,
        one restart step per pinned-order level, per-artifact gates —
        so the whole stack amortizes the one cordon/drain/uncordon
        window (and the one budget charge) the group already holds.
        Size-1 DAGs never enter that branch: the classic body below is
        the single-artifact path, unchanged."""
        if validation_active is None:
            validation_active = self.is_validation_enabled()
        dag = artifact_dag_of(policy)
        progress: dict[str, list[int]] = {}
        for group in state.groups_in(UpgradeState.POD_RESTART_REQUIRED):
            if dag is not None:
                self._process_multi_artifact_restart(
                    group, dag, validation_active, pipeline, progress
                )
                continue
            pods_to_restart: list[Pod] = []
            synced_members: list[NodeUpgradeState] = []
            for member in group.members:
                synced, orphaned = self._pod_in_sync_with_ds(member)
                if not synced or orphaned:
                    # Only restart pods not already terminating
                    # (upgrade_state.go:775-781).
                    if (
                        member.driver_pod is not None
                        and not member.driver_pod.is_terminating()
                    ):
                        pods_to_restart.append(member.driver_pod)
                else:
                    synced_members.append(member)
            if pods_to_restart:
                self.pod_manager.schedule_pods_restart(pods_to_restart)
            # A synced-but-crash-looping new driver fails the whole slice
            # (upgrade_state.go:811-825 lifted to the group).
            failing = [
                m
                for m in synced_members
                if m.driver_pod is not None
                and self._is_driver_pod_failing(m.driver_pod)
            ]
            if failing:
                logger.info(
                    "driver pod(s) failing with repeated restarts in group %s",
                    group.id,
                )
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.FAILED
                )
                continue
            if len(synced_members) != group.size():
                continue  # restarts pending; next pass re-checks
            self._advance_restart_synced_group(
                group,
                validation_active,
                pipeline,
                all(self._is_driver_pod_in_sync(m) for m in group.members),
            )
        if dag is not None:
            # Last-pass per-artifact progress gauge (metrics/status):
            # synced member-pods / total member-pods across the groups
            # currently inside their restart window.
            self.artifact_progress = {
                name: (row[0], row[1]) for name, row in progress.items()
            }

    def _advance_restart_synced_group(
        self,
        group: UpgradeGroup,
        validation_active: bool,
        pipeline: bool,
        all_ready: bool,
    ) -> None:
        """Shared tail of the pod-restart processor: every pod carries
        the new template, so release held driver loads in one batch
        (safe-load protocol, upgrade_state.go:783) and — once every pod
        is also Running+Ready — hand the group to validation/uncordon."""
        self.safe_driver_load_manager.unblock_group_loading(group)
        if not all_ready:
            return
        if validation_active:
            if pipeline:
                # Optimistic uncordon: readmit the workload now;
                # hosts that started cordoned stay cordoned.
                key = self.keys.initial_state_annotation
                self.cordon_manager.uncordon_nodes(
                    [
                        m.node
                        for m in group.members
                        if key not in m.node.annotations
                    ]
                )
                if self.budget_ledger is not None:
                    # Hosts are schedulable while the gate runs:
                    # free the fleet-wide charge so the next
                    # slice's upgrade overlaps this validation
                    # (the local-slot path does the same via
                    # _group_validating_schedulable).  A timeout
                    # re-charges through on_pipeline_recordon.
                    self.budget_ledger.release(group.id)
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.VALIDATION_REQUIRED
            )
        else:
            self._update_group_to_uncordon_or_done(group)

    def _process_multi_artifact_restart(
        self,
        group: UpgradeGroup,
        dag,
        validation_active: bool,
        pipeline: bool,
        progress: dict[str, list[int]],
    ) -> None:
        """Step one group's artifact stack inside its held window.

        The group sits in POD_RESTART_REQUIRED across however many
        passes the stack needs; its cordon/drain already happened ONCE
        and its single BudgetLedger charge stays held — this method
        performs only pod restarts and in-memory gate probes, so every
        additional artifact costs exactly its own DaemonSet's pod
        restarts in API writes and nothing else.

        Stepping: the cursor is the earliest (topological) restart step
        with any unsynced-or-ungated artifact; only cursor-step
        artifacts restart this pass, later pinned-order steps hold
        (counted per artifact in ``artifact_skew_holds``).  A synced
        artifact whose pod crash-loops fails the group, unwinding in
        REVERSE topological order (events per step, then the classic
        POD_RESTART_REQUIRED -> FAILED edge).  Crash resume is free:
        the cursor derives from observed pod revision hashes, so a
        fresh controller lands on the exact in-flight step with zero
        extra durable writes."""
        levels = dag.levels()
        order = dag.topo_order()
        primary = order[0]

        def sync_of(member: NodeUpgradeState, name: str) -> tuple[bool, bool]:
            if name == primary:
                return self._pod_in_sync_with_ds(member)
            return self._artifact_in_sync(member, name)

        def pod_of(member: NodeUpgradeState, name: str) -> Optional[Pod]:
            if name == primary:
                return member.driver_pod
            art = member.artifact_state(name)
            return art.pod if art is not None else None

        restartable: dict[str, list[Pod]] = {}
        synced_count: dict[str, int] = {}
        failing: dict[str, list[str]] = {}
        for name in order:
            pods: list[Pod] = []
            synced_n = 0
            crash: list[str] = []
            for member in group.members:
                synced, orphaned = sync_of(member, name)
                pod = pod_of(member, name)
                if not synced or orphaned:
                    if pod is not None and not pod.is_terminating():
                        pods.append(pod)
                else:
                    synced_n += 1
                    if pod is not None and self._is_driver_pod_failing(pod):
                        crash.append(member.node.name)
            restartable[name] = pods
            synced_count[name] = synced_n
            failing[name] = crash
            row = progress.setdefault(name, [0, 0])
            row[0] += synced_n
            row[1] += group.size()

        anchor = group.node_names[0] if group.node_names else group.id
        crashed = [n for n in order if failing[n]]
        if crashed:
            # Rollback: unwind every artifact whose step had been
            # reached, newest first (reverse topological order), then
            # take the classic crash-loop edge to FAILED — one group
            # transition, exactly the existing state machine.
            first = crashed[0]
            reached = [n for n in order if levels[n] <= levels[first]]
            unwind = [n for n in dag.rollback_order() if n in reached]
            logger.info(
                "artifact %s crash-looping in group %s; unwinding %s",
                first,
                group.id,
                unwind,
            )
            self.artifact_rollbacks_total += 1
            log_event(
                self.event_recorder,
                anchor,
                EVENT_TYPE_WARNING,
                "ArtifactRollback",
                f"group {group.id}: artifact {first!r} crash-looping "
                "after restart (nodes: "
                f"{', '.join(failing[first])}); unwinding in reverse "
                f"topological order: {', '.join(unwind)}",
            )
            for i, name in enumerate(unwind):
                log_event(
                    self.event_recorder,
                    anchor,
                    EVENT_TYPE_NORMAL,
                    "ArtifactRollbackStep",
                    f"group {group.id}: unwind {i + 1}/{len(unwind)}: "
                    f"artifact {name!r} (step {levels[name]})",
                )
            self._drop_artifact_gate_state(group.id)
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.FAILED
            )
            return

        def artifact_ready(name: str) -> bool:
            return synced_count[name] == group.size() and (
                self._artifact_gate_passed(group, dag.artifact(name), name)
            )

        incomplete = [n for n in order if not artifact_ready(n)]
        tr = self.trace_recorder
        if incomplete:
            cursor = min(levels[n] for n in incomplete)
            for name in order:
                pods = restartable[name]
                if not pods:
                    if tr is not None and levels[name] < cursor:
                        tr.artifact_step(group, name, done=True)
                    continue
                if levels[name] > cursor:
                    # Pinned-order skew hold: an earlier step is not
                    # complete, so this artifact's outdated pods stay
                    # on the old version inside the same window.
                    self.artifact_skew_holds[name] = (
                        self.artifact_skew_holds.get(name, 0) + 1
                    )
                    logger.info(
                        "artifact %s of group %s held at step %d "
                        "(cursor at step %d)",
                        name,
                        group.id,
                        levels[name],
                        cursor,
                    )
                    continue
                if tr is not None:
                    tr.artifact_step(group, name)
                self.pod_manager.schedule_pods_restart(pods)
            return
        # The whole stack is synced and gated: close the artifact spans,
        # drop per-group gate state, count the windows the shared pass
        # avoided (k-artifact stack, one window instead of k), and take
        # the classic advance path.
        if tr is not None:
            for name in order:
                tr.artifact_step(group, name, done=True)
        self._drop_artifact_gate_state(group.id)
        all_ready = all(
            self._is_driver_pod_in_sync(m) for m in group.members
        ) and all(
            self._artifact_pod_ready(m, name)
            for m in group.members
            for name in order[1:]
        )
        if all_ready:
            self.artifact_window_savings += group.size() * (dag.size() - 1)
        self._advance_restart_synced_group(
            group, validation_active, pipeline, all_ready
        )

    @spanned("engine.upgrade_failed")
    def process_upgrade_failed_groups(
        self,
        state: ClusterUpgradeState,
        validation_active: Optional[bool] = None,
    ) -> None:
        """Auto-recover failed groups whose driver pods are all back in sync
        (upgrade_state.go:835-877) — AND whose health gate passes.

        The reference's recovery predicate is pod-sync alone because its
        validation IS a pod-Ready check; here the gate is stronger (slice
        re-formation, ICI collectives), so recovering on pod sync alone
        would silently bless a slice the gate explicitly rejected (e.g.
        after a validation timeout — with pipelined validation that would
        re-admit the workload onto unvalidated hardware).

        The probe battery is the one piece of device work this state
        machine triggers, and it used to run synchronously here — a
        sustained-collective prober would hold the reconcile tick for its
        whole runtime.  It now runs on an async worker (drain-manager
        pattern): this pass schedules the probe and moves on; a later
        pass consumes the cached healthy verdict and performs the state
        transition on the reconcile thread."""
        if validation_active is None:
            validation_active = self.is_validation_enabled()
        failed_ids = set()
        for group in state.groups_in(UpgradeState.FAILED):
            failed_ids.add(group.id)
            if not all(self._is_driver_pod_in_sync(m) for m in group.members):
                continue
            if validation_active and self.validation_manager.prober is not None:
                with self._recovery_lock:
                    verdict = self._recovery_verdicts.pop(group.id, None)
                if verdict is None:
                    self._maybe_schedule_recovery_probe(group)
                    continue
                # Healthy verdict cached by the worker: the transition
                # below runs here, on the reconcile thread.
                with self._recovery_lock:
                    self._recovery_rejections.pop(group.id, None)
            self._update_group_to_uncordon_or_done(group)
        # Groups that left FAILED (recovered, deleted, or relabeled) must
        # not pin a stale rejection — or a stale healthy verdict —
        # against a future failure.
        with self._recovery_lock:
            for gid in list(self._recovery_rejections):
                if gid not in failed_ids:
                    del self._recovery_rejections[gid]
            for gid in list(self._recovery_verdicts):
                if gid not in failed_ids:
                    del self._recovery_verdicts[gid]

    def _maybe_schedule_recovery_probe(self, group: UpgradeGroup) -> None:
        """Spawn the health-gate probe for a pod-synced FAILED group on a
        worker thread, unless one is already in flight or a recent
        rejection is still inside the backoff window."""
        if not self._recovery_inflight.try_add(group.id):
            return  # probe already running for this group
        with self._recovery_lock:
            last = self._recovery_rejections.get(group.id)
        if (
            last is not None
            and time.monotonic() - last < self.recovery_probe_backoff_s
        ):
            # Recently rejected; don't re-run the battery yet.
            self._recovery_inflight.remove(group.id)
            return
        prober = self.validation_manager.prober

        def _probe() -> None:
            try:
                try:
                    result = prober.probe(group)
                except Exception as e:  # noqa: BLE001 — verdict, not crash
                    result = ProbeResult(
                        False, f"recovery probe raised: {type(e).__name__}: {e}"
                    )
                with self._recovery_lock:
                    if result.healthy:
                        self._recovery_verdicts[group.id] = result
                        self._recovery_rejections.pop(group.id, None)
                    else:
                        self._recovery_rejections[group.id] = time.monotonic()
                # Persist the rejection epoch (crash safety): a restarted
                # leader rebases it in adopt() and honors the remaining
                # backoff instead of immediately re-running the battery.
                probe_key = self.keys.recovery_probe_since_annotation
                try:
                    if result.healthy:
                        stamped = [
                            m.node
                            for m in group.members
                            if probe_key in m.node.annotations
                        ]
                        if stamped:
                            self.provider.change_nodes_upgrade_annotation(
                                stamped, probe_key, "null"
                            )
                    else:
                        self.provider.change_nodes_upgrade_annotation(
                            group.nodes, probe_key, str(int(time.time()))
                        )
                except Exception as e:  # noqa: BLE001 — best-effort clock
                    logger.debug(
                        "probe backoff stamp for %s failed: %s", group.id, e
                    )
                if not result.healthy:
                    logger.info(
                        "failed group %s stays failed: health gate "
                        "rejects recovery: %s (next probe in %.0fs)",
                        group.id,
                        result.detail,
                        self.recovery_probe_backoff_s,
                    )
            finally:
                self._recovery_inflight.remove(group.id)

        try:
            self._recovery_tracker.spawn(
                _probe, name=f"recovery-probe-{group.id}"
            )
        except Exception:
            # A failed spawn must not strand the in-flight claim (the
            # same leak shape as the rollback-spawn fix in
            # validation_manager._schedule_rollback_eviction).
            self._recovery_inflight.remove(group.id)
            raise

    @spanned("engine.validation_required")
    def process_validation_required_groups(
        self, state: ClusterUpgradeState, validation_active: Optional[bool] = None
    ) -> None:
        """(upgrade_state.go:880-911)"""
        if validation_active is None:
            validation_active = self.is_validation_enabled()
        for group in state.groups_in(UpgradeState.VALIDATION_REQUIRED):
            # Driver may have restarted after reaching validation: make sure
            # it isn't re-blocked on safe load (upgrade_state.go:886-893).
            self.safe_driver_load_manager.unblock_group_loading(group)
            if validation_active and not self.validation_manager.validate(group):
                logger.info("validation not complete for group %s", group.id)
                continue
            self._update_group_to_uncordon_or_done(group)

    @spanned("engine.uncordon_required")
    def process_uncordon_required_groups(
        self, state: ClusterUpgradeState
    ) -> None:
        """Uncordon and finish (upgrade_state.go:915-934).  Hosts that were
        unschedulable before the upgrade stay cordoned
        (upgrade_state.go:1003-1028)."""
        for group in list(state.groups_in(UpgradeState.UNCORDON_REQUIRED)):
            keep_cordoned_key = self.keys.initial_state_annotation
            to_uncordon = [
                m.node
                for m in group.members
                if keep_cordoned_key not in m.node.annotations
            ]
            annotated = [
                m.node
                for m in group.members
                if keep_cordoned_key in m.node.annotations
            ]
            self.cordon_manager.uncordon_nodes(to_uncordon)
            # An excluded-by-resize slice is not done yet: the workload
            # must resize back over it first, so it routes through
            # rejoin-resize (the rejoin offer is posted there).
            next_state = (
                UpgradeState.REJOIN_RESIZE_REQUIRED
                if self._group_elastic_excluded(group)
                else UpgradeState.DONE
            )
            self.provider.change_nodes_upgrade_state(group.nodes, next_state)
            if annotated:
                self.provider.change_nodes_upgrade_annotation(
                    annotated, keep_cordoned_key, "null"
                )
            if self.budget_ledger is not None:
                # Hosts are schedulable again: free the fleet-wide
                # unavailability charge and parallel slot.
                self.budget_ledger.release(group.id)
            if next_state is UpgradeState.REJOIN_RESIZE_REQUIRED:
                self._move_group_bucket(state, group, next_state)
                logger.info(
                    "group %s uncordoned; awaiting rejoin-resize", group.id
                )

    # -- elastic roll coordination (workload-negotiated mesh reshaping) ------

    @staticmethod
    def _elastic_spec(policy):
        if isinstance(policy, TPUUpgradePolicySpec):
            return policy.elastic
        return None

    def _group_elastic_registered(self, group: UpgradeGroup) -> bool:
        """An elastic workload has registered on this slice's nodes."""
        key = self.keys.elastic_workload_annotation
        return any(m.node.annotations.get(key) for m in group.members)

    def _group_elastic_excluded(self, group: UpgradeGroup) -> bool:
        """The workload has resized away from this slice: it holds no
        maxUnavailable budget (mirroring quarantine) and must pass
        through rejoin-resize before DONE."""
        key = self.keys.elastic_excluded_annotation
        return any(
            m.node.annotations.get(key) == TRUE_STRING
            for m in group.members
        )

    def _group_annotation_value(self, group: UpgradeGroup, key: str) -> str:
        for member in group.members:
            value = member.node.annotations.get(key, "")
            if value:
                return value
        return ""

    def _clear_elastic_negotiation(self, group: UpgradeGroup) -> None:
        """Retire the offer/response/resize-complete trio (guarded per
        key, so the common path writes nothing).  The exclusion marker is
        NOT cleared here — it must survive until rejoin-resize."""
        for key in (
            self.keys.elastic_offer_annotation,
            self.keys.elastic_response_annotation,
            self.keys.elastic_resize_complete_annotation,
        ):
            carriers = [
                m.node for m in group.members if key in m.node.annotations
            ]
            if carriers:
                self.provider.change_nodes_upgrade_annotation(
                    carriers, key, "null"
                )

    def _absorb_negotiation_response(
        self, group: UpgradeGroup, offer_start: Optional[int]
    ) -> bool:
        """Absorb an accepted + completed down-resize: stamp the exclusion
        marker, release the budget claim, count it.  Shared between the
        negotiation processor and the quarantine scan (quarantine-shrink).
        Returns True when the exclusion was absorbed."""
        response = self._group_annotation_value(
            group, self.keys.elastic_response_annotation
        )
        if response != ELASTIC_RESPONSE_ACCEPT:
            return False
        complete_epoch = parse_epoch(
            self._group_annotation_value(
                group, self.keys.elastic_resize_complete_annotation
            )
        )
        if complete_epoch is None:
            return False
        if self.term_fence is not None and not self.term_fence(group.nodes):
            # A deposed leader must not complete a resize: the successor
            # owns the exclusion/budget bookkeeping.
            logger.warning(
                "term fence: not absorbing resize for group %s", group.id
            )
            return False
        self.provider.change_nodes_upgrade_annotation(
            group.nodes, self.keys.elastic_excluded_annotation, TRUE_STRING
        )
        self._clear_elastic_negotiation(group)
        if self.trace_recorder is not None:
            self.trace_recorder.end_wait(group, "negotiate")
        self.elastic_negotiations["accept"] += 1
        self.elastic_resizes["down"] += 1
        if offer_start is not None:
            self.elastic_resize_seconds = float(
                max(0, complete_epoch - offer_start)
            )
        for node in group.nodes:
            log_event(
                self.event_recorder,
                node.name,
                EVENT_TYPE_NORMAL,
                "ElasticResizeComplete",
                "Workload resized away from the slice; excluded from the "
                "mesh (holds no unavailability budget) until rejoin-resize",
            )
        if self.budget_ledger is not None:
            # The workload keeps stepping without this slice: it is not
            # "unavailable" in the maxUnavailable sense, so the admission
            # claim is freed for the rest of the fleet.
            self.budget_ledger.release(group.id)
        return True

    @spanned("engine.negotiation")
    def process_negotiation_groups(
        self,
        state: ClusterUpgradeState,
        policy: Optional[DriverUpgradePolicySpec],
    ) -> None:
        """Drive negotiate-required groups: post the exclusion offer
        (stamp-if-absent — a restarted controller resumes the same offer
        clock, never double-offers), then absorb the workload's response.

        Accept + resize-complete: exclusion absorbed, budget released,
        on to cordon.  Decline or offer timeout: the elastic markers are
        retired and the group falls back to cordon-required with its
        admission-time budget claim intact — the exact pre-coordination
        drain path."""
        groups = list(state.groups_in(UpgradeState.NEGOTIATE_REQUIRED))
        if not groups:
            return
        spec = self._elastic_spec(policy)
        timeout_s = int(spec.offer_timeout_second) if spec is not None else 0
        offer_key = self.keys.elastic_offer_annotation
        now = int(time.time())
        for group in groups:
            if self._group_elastic_excluded(group):
                # Already excluded (the resize was absorbed while
                # quarantined): nothing left to negotiate.
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.CORDON_REQUIRED
                )
                self._move_group_bucket(
                    state, group, UpgradeState.CORDON_REQUIRED
                )
                if self.budget_ledger is not None:
                    self.budget_ledger.release(group.id)
                continue
            start = group_clock_start(self.provider, group, offer_key, now)
            if self.trace_recorder is not None:
                # Idempotent: a restarted controller resuming the same
                # offer clock re-opens the same negotiation wait span.
                self.trace_recorder.begin_wait(group, "negotiate")
            if start is None:
                # Offer freshly posted this pass; the workload answers on
                # a later one.
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_NORMAL,
                        "ElasticOfferPosted",
                        "Exclusion offer posted to the registered elastic "
                        f"workload (timeout {timeout_s}s, then drain "
                        "fallback)",
                    )
                continue
            if self._absorb_negotiation_response(group, start):
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.CORDON_REQUIRED
                )
                self._move_group_bucket(
                    state, group, UpgradeState.CORDON_REQUIRED
                )
                logger.info(
                    "group %s excluded by resize; proceeding to cordon",
                    group.id,
                )
                continue
            response = self._group_annotation_value(
                group, self.keys.elastic_response_annotation
            )
            declined = response == ELASTIC_RESPONSE_DECLINE
            timed_out = not declined and now - start >= timeout_s
            if not declined and not timed_out:
                continue  # offer open; workload still deciding/resizing
            outcome = "decline" if declined else "timeout"
            self.elastic_negotiations[outcome] += 1
            for node in group.nodes:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_WARNING,
                    "ElasticDeclined" if declined else "ElasticOfferTimeout",
                    (
                        "Workload declined the exclusion offer"
                        if declined
                        else f"Exclusion offer unanswered for {timeout_s}s"
                    )
                    + "; falling back to the drain path",
                )
            # Retire the negotiation markers BEFORE the state flip so the
            # fallback slice is annotation-identical to a pre-coordination
            # roll (same downstream events, same budget charge).
            self._clear_elastic_negotiation(group)
            if self.trace_recorder is not None:
                self.trace_recorder.end_wait(group, "negotiate")
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.CORDON_REQUIRED
            )
            self._move_group_bucket(state, group, UpgradeState.CORDON_REQUIRED)
            logger.info(
                "group %s elastic %s; falling back to drain roll",
                group.id,
                outcome,
            )

    @spanned("engine.rejoin_resize")
    def process_rejoin_resize_groups(
        self,
        state: ClusterUpgradeState,
        policy: Optional[DriverUpgradePolicySpec],
    ) -> None:
        """Drive rejoin-resize-required groups: post the rejoin offer
        (stamp-if-absent, same crash-safe clock as the exclusion offer)
        and finish to DONE once the workload resized back over the slice
        — or on rejoin timeout (the workload may rejoin later on its own
        schedule; the roll must not hang on it)."""
        groups = list(state.groups_in(UpgradeState.REJOIN_RESIZE_REQUIRED))
        if not groups:
            return
        spec = self._elastic_spec(policy)
        timeout_s = (
            int(spec.rejoin_timeout_second) if spec is not None else 0
        )
        offer_key = self.keys.elastic_rejoin_offer_annotation
        complete_key = self.keys.elastic_rejoin_complete_annotation
        now = int(time.time())
        for group in groups:
            start = group_clock_start(self.provider, group, offer_key, now)
            if start is None:
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_NORMAL,
                        "ElasticRejoinOffered",
                        "Slice upgraded and uncordoned; rejoin-resize "
                        "offered to the workload",
                    )
                continue
            complete_epoch = parse_epoch(
                self._group_annotation_value(group, complete_key)
            )
            timed_out = complete_epoch is None and now - start >= timeout_s
            if complete_epoch is None and not timed_out:
                continue  # workload still resizing back up
            if (
                self.term_fence is not None
                and not self.term_fence(group.nodes)
            ):
                logger.warning(
                    "term fence: not completing rejoin for group %s",
                    group.id,
                )
                continue
            if complete_epoch is not None:
                self.elastic_resizes["up"] += 1
                self.elastic_resize_seconds = float(
                    max(0, complete_epoch - start)
                )
            for node in group.nodes:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_NORMAL
                    if complete_epoch is not None
                    else EVENT_TYPE_WARNING,
                    "ElasticRejoinComplete"
                    if complete_epoch is not None
                    else "ElasticRejoinTimeout",
                    "Workload resized back over the slice"
                    if complete_epoch is not None
                    else f"Rejoin-resize unanswered for {timeout_s}s; "
                    "completing the roll without it",
                )
            # Retire every elastic marker including the exclusion: the
            # slice is DONE and back in the budget-accounting population.
            for key in (
                self.keys.elastic_excluded_annotation,
                offer_key,
                complete_key,
            ):
                carriers = [
                    m.node
                    for m in group.members
                    if key in m.node.annotations
                ]
                if carriers:
                    self.provider.change_nodes_upgrade_annotation(
                        carriers, key, "null"
                    )
            self.provider.change_nodes_upgrade_state(
                group.nodes, UpgradeState.DONE
            )
            self._move_group_bucket(state, group, UpgradeState.DONE)
            logger.info("group %s rejoin-resize finished -> done", group.id)

    # -- heterogeneous fleets (fleet/): pools, windows, preemption -----------

    @staticmethod
    def _policy_pools(policy) -> list:
        if isinstance(policy, TPUUpgradePolicySpec):
            return list(policy.pools or [])
        return []

    def _pool_for_group(self, group: UpgradeGroup, policy) -> Optional[str]:
        """The policy pool this group belongs to: first pool (in CR list
        order) whose node_selector fully matches the group's first
        member's labels.  Slice members share node-pool labels by
        construction, so one member decides for the group; first-match
        order makes membership deterministic when selectors overlap."""
        pools = self._policy_pools(policy)
        if not pools or not group.members:
            return None
        labels = group.members[0].node.labels
        for pool in pools:
            selector = pool.node_selector
            if selector and all(
                labels.get(k) == v for k, v in selector.items()
            ):
                return pool.name
        return None

    def _group_preempted(self, group: UpgradeGroup) -> bool:
        """Any member carries the platform preemption signal."""
        return any(
            NODE_PREEMPTION_ANNOTATION in m.node.annotations
            for m in group.members
        )

    def _group_window_held(self, group: UpgradeGroup) -> bool:
        """The group is holding in the window-wait condition."""
        key = self.keys.window_wait_annotation
        return any(key in m.node.annotations for m in group.members)

    def _group_budget_exempt(self, group: UpgradeGroup) -> bool:
        """Preempted and window-held groups hold no budget — the hook
        BudgetLedger.sync_from_state consults so a full resync does not
        silently re-charge what the fast paths released."""
        return self._group_preempted(group) or self._group_window_held(group)

    def _remove_group_from_snapshot(
        self, state: ClusterUpgradeState, group: UpgradeGroup
    ) -> None:
        """Drop a group from every snapshot bucket so the REST of this
        pass makes zero decisions about it — no processor sees it, no
        counter counts it.  Labels are untouched: this is a pass-local
        hold, not a state transition."""
        for groups in state.groups.values():
            if group in groups:
                groups.remove(group)
        for members in state.node_states.values():
            for member in group.members:
                if member in members:
                    members.remove(member)

    @spanned("engine.preemption")
    def process_preemption(
        self,
        state: ClusterUpgradeState,
        policy: Optional[DriverUpgradePolicySpec],
    ) -> None:
        """Preemption fast-path: a reclaimed spot/preemptible node is NOT
        a hardware failure.

        While any member carries the platform preemption signal the
        whole group is dropped from this pass's snapshot — it skips
        quarantine entirely (no prior-state park, no flap-cycle count),
        makes zero transitions, and holds no budget.  The first
        observation releases the group's ledger claim and counts
        ``preemptions_total{generation}`` exactly once, recorded
        durably in the preempted-since annotation so a controller
        restart neither double-counts nor double-releases.

        On return (signal cleared) the stamp is retired and an in-flight
        group force-reclaims its budget and continues in this same pass
        — no hysteresis dwell: the node did not flap, it was taken and
        given back by the platform."""
        since_key = self.keys.preempted_since_annotation
        unit = self._unavailability_unit(policy) if policy else "node"
        for group in list(state.all_groups()):
            stamped = [
                m.node
                for m in group.members
                if since_key in m.node.annotations
            ]
            if self._group_preempted(group):
                if not stamped:
                    gen = (
                        generation_of(group_accelerator(group))
                        or "unknown"
                    )
                    self.preemptions[gen] = self.preemptions.get(gen, 0) + 1
                    with self.provider.batched():
                        self.provider.change_nodes_upgrade_annotation(
                            group.nodes, since_key, str(int(time.time()))
                        )
                    if self.budget_ledger is not None:
                        self.budget_ledger.release(group.id)
                    for node in group.nodes:
                        log_event(
                            self.event_recorder,
                            node.name,
                            EVENT_TYPE_NORMAL,
                            "NodePreempted",
                            "Slice preempted by the platform; holding "
                            "without quarantine or budget until it "
                            "returns",
                        )
                    logger.info(
                        "group %s preempted (%s); holding budget-free",
                        group.id,
                        gen,
                    )
                self._remove_group_from_snapshot(state, group)
                continue
            if stamped:
                # Every preempted host returned: clear the stamp and
                # resume exactly where the roll stopped, this same pass.
                with self.provider.batched():
                    self.provider.change_nodes_upgrade_annotation(
                        stamped, since_key, "null"
                    )
                eff = group.effective_state(self.keys.state_label)
                if (
                    self.budget_ledger is not None
                    and eff in IN_PROGRESS_STATES
                ):
                    # The return is a fact, not an admission request:
                    # force the charge back on even if the freed slot
                    # was spent while the node was gone.
                    self.budget_ledger.try_claim(
                        group.id,
                        1 if unit == "slice" else group.size(),
                        force=True,
                    )
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_NORMAL,
                        "NodePreemptionReturned",
                        "Preempted capacity returned; resuming the roll "
                        "immediately (no re-admission dwell)",
                    )
                logger.info(
                    "group %s returned from preemption; resuming", group.id
                )

    @spanned("engine.maintenance_windows")
    def process_maintenance_windows(
        self,
        state: ClusterUpgradeState,
        policy: Optional[DriverUpgradePolicySpec],
    ) -> None:
        """Hold every group of a pool whose maintenance window is closed.

        The hold is a CONDITION, not a state: the window-wait annotation
        (value = pool name) marks it, the upgrade-state label never
        moves, and the group is dropped from this pass's snapshot so no
        processor acts on it — zero transitions, zero budget held (any
        ledger claim is released).  The first in-window pass clears the
        annotation and the roll resumes where it stopped."""
        pools = self._policy_pools(policy)
        window_key = self.keys.window_wait_annotation
        open_by_pool: dict[str, bool] = {}
        for pool in pools:
            is_open = True
            window = pool.maintenance_window
            if window is not None and window.cron:
                try:
                    is_open = window_open(window.cron)
                    self.window_cron_invalid.pop(pool.name, None)
                    self._window_invalid_emitted.discard(pool.name)
                except ValueError:
                    # Schema validation rejects bad crons; an unparseable
                    # leftover must fail OPEN — a typo in a window must
                    # not freeze the pool forever.  But never silently:
                    # record the fail-open so metrics can raise
                    # fleet_window_invalid{pool} and the group loop below
                    # emits a WindowCronInvalid Warning once.
                    is_open = True
                    self.window_cron_invalid[pool.name] = window.cron
            elif window is None or not window.cron:
                self.window_cron_invalid.pop(pool.name, None)
                self._window_invalid_emitted.discard(pool.name)
            open_by_pool[pool.name] = is_open
        self.pool_window_open = open_by_pool
        held = 0
        self.window_held_info = {}
        for group in list(state.all_groups()):
            pool_name = self._pool_for_group(group, policy)
            if (
                pool_name in self.window_cron_invalid
                and pool_name not in self._window_invalid_emitted
                and group.members
            ):
                self._window_invalid_emitted.add(pool_name)
                log_event(
                    self.event_recorder,
                    group.members[0].node.name,
                    EVENT_TYPE_WARNING,
                    "WindowCronInvalid",
                    f"Pool {pool_name} maintenanceWindow cron "
                    f"{self.window_cron_invalid[pool_name]!r} is "
                    "unparseable; failing OPEN (window treated as "
                    "always open) until the CR is fixed",
                )
            carriers = [
                m.node
                for m in group.members
                if window_key in m.node.annotations
            ]
            if pool_name is None or open_by_pool.get(pool_name, True):
                if carriers:
                    self.provider.change_nodes_upgrade_annotation(
                        carriers, window_key, "null"
                    )
                    if self.trace_recorder is not None:
                        self.trace_recorder.end_wait(group, "window")
                    logger.info(
                        "group %s maintenance window open; resuming",
                        group.id,
                    )
                continue
            if self.trace_recorder is not None and group.effective_state(
                self.keys.state_label
            ) not in (UpgradeState.DONE, UpgradeState.UNKNOWN):
                # Only in-roll groups earn a window-hold wait span; a
                # DONE group held by a closed window is not roll time.
                self.trace_recorder.begin_wait(
                    group, "window", pool=pool_name
                )
            if len(carriers) != group.size():
                with self.provider.batched():
                    self.provider.change_nodes_upgrade_annotation(
                        group.nodes, window_key, pool_name
                    )
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_NORMAL,
                        "MaintenanceWindowWait",
                        f"Pool {pool_name} is outside its maintenance "
                        "window; holding budget-free (condition, not a "
                        "state transition)",
                    )
            if self.budget_ledger is not None:
                self.budget_ledger.release(group.id)
            held += 1
            anchor_node = (
                group.members[0].node.name if group.members else ""
            )
            self.window_held_info.setdefault(pool_name, []).append(
                (group.id, group.size(), anchor_node)
            )
            self._remove_group_from_snapshot(state, group)
        self.window_held_groups = held

    # -- slice quarantine (data-plane fault tolerance) -----------------------

    @staticmethod
    def _quarantine_spec(policy):
        if isinstance(policy, TPUUpgradePolicySpec):
            return policy.slice_quarantine
        return None

    def _group_fault_reason(self, group: UpgradeGroup) -> Optional[str]:
        """Why this group cannot make progress on its hardware, or None
        if every member is present and Ready (Unknown counts as not
        ready)."""
        if (
            group.slice_info is not None
            and group.size() < group.slice_info.expected_hosts
        ):
            return (
                f"slice has {group.size()}/"
                f"{group.slice_info.expected_hosts} hosts visible"
            )
        not_ready = sorted(
            m.node.name for m in group.members if not node_ready(m.node)
        )
        if not_ready:
            return f"node(s) not ready: {', '.join(not_ready)}"
        return None

    def _straggler_fault_reason(
        self, group: UpgradeGroup, policy
    ) -> Optional[str]:
        """Opt-in: a confirmed health straggler is treated like a
        hardware fault for quarantine purposes.  Off by default
        (``health.quarantineStragglers``) — the telemetry plane is
        observe-only unless the operator explicitly routes verdicts
        into the quarantine path.  Dwell/cycle-cap semantics are the
        quarantine machinery's, unchanged."""
        plane = self.telemetry_plane
        if plane is None or not isinstance(policy, TPUUpgradePolicySpec):
            return None
        gate = policy.health_gate
        if gate is None or not getattr(gate, "quarantine_stragglers", False):
            return None
        confirmed = sorted(
            n.name for n in group.nodes if plane.is_straggler(n.name)
        )
        if not confirmed:
            return None
        return "confirmed health straggler(s): " + ", ".join(confirmed)

    def _move_group_bucket(
        self,
        state: ClusterUpgradeState,
        group: UpgradeGroup,
        new_state: UpgradeState,
    ) -> None:
        """Re-bucket a group (and its members) inside the snapshot after
        an out-of-band label transition, so the REST of this pass — slot
        math and processors — sees the group where its labels now say it
        is, instead of waiting a full build/apply cycle."""
        for groups in state.groups.values():
            if group in groups:
                groups.remove(group)
        state.groups.setdefault(new_state.value, []).append(group)
        for members in state.node_states.values():
            for member in group.members:
                if member in members:
                    members.remove(member)
        state.node_states.setdefault(new_state.value, []).extend(group.members)

    def _clear_quarantine_dwell(self, group: UpgradeGroup) -> None:
        """Reset the rejoin hysteresis clock (only writes if stamped, so
        a steadily-broken node doesn't patch annotations every pass)."""
        key = self.keys.quarantine_ready_since_annotation
        stamped = [
            m.node for m in group.members if key in m.node.annotations
        ]
        if stamped:
            self.provider.change_nodes_upgrade_annotation(
                stamped, key, "null"
            )

    @spanned("engine.quarantine")
    def process_quarantine(
        self,
        state: ClusterUpgradeState,
        policy: Optional[DriverUpgradePolicySpec],
    ) -> None:
        """Park in-flight groups that lost hardware; rejoin after a dwell.

        Park: any member of an in-flight group NotReady/Unknown, or a
        host missing from the slice entirely, moves the WHOLE group to
        ``quarantined`` — the prior state is remembered in an annotation
        so the roll can resume exactly where it stopped.  A quarantined
        group holds no parallel slot and no unavailability budget
        (IN_PROGRESS_STATES excludes it; the unavailability counters
        skip it explicitly), so the rest of the fleet keeps rolling.

        Rejoin: once every member is back and has stayed Ready for
        ``ready_dwell_second`` (hysteresis — any flap resets the clock,
        so a flapping node causes at most one park/rejoin cycle per
        dwell window), the group transitions back to its prior state and
        is re-bucketed so it resumes in this same pass."""
        spec = self._quarantine_spec(policy)
        enabled = spec is not None and spec.enable
        dwell_s = int(spec.ready_dwell_second) if spec is not None else 0
        max_cycles = (
            int(getattr(spec, "max_cycles", 0) or 0) if spec is not None else 0
        )
        prior_key = self.keys.quarantine_prior_state_annotation
        ready_key = self.keys.quarantine_ready_since_annotation
        cycle_key = self.keys.quarantine_cycle_count_annotation

        # Park scan.
        if enabled:
            for st in QUARANTINABLE_STATES:
                for group in list(state.groups_in(st)):
                    reason = self._group_fault_reason(group)
                    straggler_park = False
                    if reason is None:
                        reason = self._straggler_fault_reason(group, policy)
                        straggler_park = reason is not None
                    if reason is None:
                        continue
                    logger.warning(
                        "quarantining group %s (was %s): %s",
                        group.id,
                        st.value,
                        reason,
                    )
                    # Durable flap counter: one increment per park, so a
                    # slice cycling across dwell windows is capped below
                    # (max_cycles) instead of parking forever — and the
                    # count survives controller restarts.
                    cycles = 1 + max(
                        (
                            parse_int(m.node.annotations.get(cycle_key))
                            for m in group.members
                        ),
                        default=0,
                    )
                    # One combined metadata patch per node: prior-state +
                    # cycle-count annotations and the state label land in
                    # a single API round trip.
                    with self.provider.batched():
                        self.provider.change_nodes_upgrade_annotation(
                            group.nodes, prior_key, st.value
                        )
                        self.provider.change_nodes_upgrade_annotation(
                            group.nodes, cycle_key, str(cycles)
                        )
                        self._clear_quarantine_dwell(group)
                        self.provider.change_nodes_upgrade_state(
                            group.nodes, UpgradeState.QUARANTINED
                        )
                    trace_suffix = self._trace_event_suffix()
                    for node in group.nodes:
                        log_event(
                            self.event_recorder,
                            node.name,
                            EVENT_TYPE_WARNING,
                            "SliceQuarantined",
                            f"Slice quarantined mid-upgrade: {reason}; "
                            "unavailability budget released; the roll "
                            "resumes after all hosts stay Ready for "
                            f"{dwell_s}s{trace_suffix}",
                        )
                    # Losing hardware mid-roll is a black-box moment:
                    # capture the ring + span tree while the evidence
                    # (deltas, budget verdicts) is still in the buffer.
                    self._flightrec_trigger(
                        "quarantine", group=group.id, detail=reason
                    )
                    self.quarantines_total += 1
                    self.quarantine_reasons[group.id] = (
                        f"quarantined: {reason}"
                    )
                    if straggler_park and self.telemetry_plane is not None:
                        # Consume the verdict on park: the streak resets,
                        # so a rejoined slice needs M fresh slow batteries
                        # to re-confirm — no park loop on a stale verdict.
                        for node in group.nodes:
                            self.telemetry_plane.consume_straggler(node.name)
                    if self.budget_ledger is not None:
                        # A quarantined group holds no budget — same
                        # contract as the state-local counters, enforced
                        # at the ledger so other shards can spend the
                        # freed slot immediately.
                        self.budget_ledger.release(group.id)
                    self._move_group_bucket(
                        state, group, UpgradeState.QUARANTINED
                    )
                    # Quarantine-shrink: offer the parked slice for
                    # exclusion so the registered workload shrinks its
                    # mesh around the dead hardware instead of pausing.
                    # Stamp-if-absent — a park from negotiate-required
                    # keeps its open offer clock.
                    espec = self._elastic_spec(policy)
                    if (
                        espec is not None
                        and espec.enable
                        and self._group_elastic_registered(group)
                        and not self._group_elastic_excluded(group)
                    ):
                        posted = group_clock_start(
                            self.provider,
                            group,
                            self.keys.elastic_offer_annotation,
                            int(time.time()),
                        )
                        if posted is None:
                            for node in group.nodes:
                                log_event(
                                    self.event_recorder,
                                    node.name,
                                    EVENT_TYPE_NORMAL,
                                    "ElasticOfferPosted",
                                    "Exclusion offer posted for the "
                                    "quarantined slice (mesh shrink "
                                    "instead of a parked job)",
                                )

        # Rejoin scan (runs even when the feature was just disabled, so
        # already-parked groups are not wedged forever — dwell still
        # applies from the last configured spec).
        now = int(time.time())
        for group in list(state.groups_in(UpgradeState.QUARANTINED)):
            # Absorb a quarantine-shrink resize as soon as the workload
            # reports it — while the hardware is still dead.  The
            # exclusion marker then carries through the rest of the roll
            # once the slice rejoins.
            self._absorb_negotiation_response(
                group,
                parse_epoch(
                    self._group_annotation_value(
                        group, self.keys.elastic_offer_annotation
                    )
                ),
            )
            # Cycle cap: a slice that flapped across max_cycles dwell
            # windows is hardware that keeps lying about being back —
            # demote to upgrade-failed (documented QUARANTINED->FAILED
            # edge) so it surfaces for repair instead of parking forever.
            cycles = max(
                (
                    parse_int(m.node.annotations.get(cycle_key))
                    for m in group.members
                ),
                default=0,
            )
            if max_cycles > 0 and cycles >= max_cycles:
                logger.warning(
                    "group %s hit the quarantine cycle limit (%d/%d): "
                    "demoting to upgrade-failed",
                    group.id,
                    cycles,
                    max_cycles,
                )
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.FAILED
                )
                self.provider.change_nodes_upgrade_annotation(
                    group.nodes, prior_key, "null"
                )
                self._clear_quarantine_dwell(group)
                for node in group.nodes:
                    log_event(
                        self.event_recorder,
                        node.name,
                        EVENT_TYPE_WARNING,
                        "QuarantineCycleLimit",
                        f"Slice quarantined {cycles} times "
                        f"(limit {max_cycles}): hardware is flapping; "
                        "demoted to upgrade-failed for repair",
                    )
                self.quarantine_cycle_demotions += 1
                self.quarantine_reasons[group.id] = (
                    f"quarantine cycle limit reached ({cycles}/"
                    f"{max_cycles}); demoted to upgrade-failed"
                )
                if self.budget_ledger is not None:
                    # FAILED is in-progress for budget purposes (its
                    # hosts stay cordoned): re-charge, forced — the
                    # demotion must not be blocked by the caps.
                    unit = self._unavailability_unit(policy)
                    self.budget_ledger.try_claim(
                        group.id,
                        1 if unit == "slice" else group.size(),
                        force=True,
                    )
                self._move_group_bucket(state, group, UpgradeState.FAILED)
                continue
            reason = self._group_fault_reason(group)
            if reason is not None:
                # Still (or again) degraded: reset the dwell clock so a
                # flapping node can't rejoin before a full quiet window.
                self._clear_quarantine_dwell(group)
                self.quarantine_reasons[group.id] = f"quarantined: {reason}"
                continue
            start = group_clock_start(self.provider, group, ready_key, now)
            if start is None:
                continue  # dwell clock freshly stamped this pass
            if now - start < dwell_s:
                continue  # hysteresis: not quiet long enough yet
            if not self._group_elastic_excluded(
                group
            ) and not self._rejoin_budget_free(state, policy, group):
                # The roll spent the freed budget on other slices while
                # this one was parked; rejoining now would exceed
                # maxUnavailable.  (An excluded-by-resize slice bypasses
                # the check: the workload already reshaped around it, so
                # it holds no budget.)  Stay parked (dwell stamp kept)
                # until a slot frees up.
                self.quarantine_reasons[group.id] = (
                    "quarantined: healthy, awaiting unavailability budget"
                )
                continue
            prior_value = ""
            for member in group.members:
                prior_value = member.node.annotations.get(prior_key, "")
                if prior_value:
                    break
            try:
                target = UpgradeState(prior_value)
            except ValueError:
                target = UpgradeState.CORDON_REQUIRED
            if target not in QUARANTINABLE_STATES:
                # Lost/corrupt prior-state annotation: restart the ladder
                # from its earliest documented in-flight state (cordon is
                # idempotent), never invent an undocumented edge.
                target = UpgradeState.CORDON_REQUIRED
            logger.info(
                "group %s rejoining after quarantine -> %s",
                group.id,
                target.value,
            )
            with self.provider.batched():
                self.provider.change_nodes_upgrade_state(group.nodes, target)
                self.provider.change_nodes_upgrade_annotation(
                    group.nodes, prior_key, "null"
                )
                self.provider.change_nodes_upgrade_annotation(
                    group.nodes, ready_key, "null"
                )
            for node in group.nodes:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_NORMAL,
                    "SliceRejoined",
                    "Slice rejoined the upgrade roll after quarantine "
                    f"(resuming {target.value})",
                )
            self.rejoins_total += 1
            self.quarantine_reasons.pop(group.id, None)
            self._move_group_bucket(state, group, target)

    def _rejoin_budget_free(
        self,
        state: ClusterUpgradeState,
        policy: Optional[DriverUpgradePolicySpec],
        group: UpgradeGroup,
    ) -> bool:
        """Whether ``group`` can rejoin without busting ``maxUnavailable``.

        A rejoined group re-enters its prior in-flight state with its
        hosts typically still cordoned, so it re-charges the budget the
        park released — and the roll may have spent that budget on other
        slices in the meantime."""
        if policy is None or policy.max_unavailable is None:
            return True
        unit = self._unavailability_unit(policy)
        # Charge the rejoin as if fully resumed, even when no member is
        # cordoned yet (a group parked at cordon-required rejoins with
        # clean hosts but re-cordons them the same pass).
        if unit == "slice":
            charge = 1
        else:
            cordoned = sum(
                1
                for m in group.members
                if m.node.spec.unschedulable or not node_ready(m.node)
            )
            charge = cordoned or group.size()
        if self.budget_ledger is not None:
            # Sharded mode: the rejoin check IS the claim — atomic, so
            # two shards' simultaneous rejoins cannot jointly bust the
            # cap.  A rejected claim leaves the group parked with its
            # dwell stamp intact, exactly like the local-math path.
            # DCN gating mirrors the admission path: with the knob off,
            # a same-DCN slice in flight must not block the rejoin.
            dcn = (
                group_dcn_group(group, self.keys)
                if isinstance(policy, TPUUpgradePolicySpec)
                and policy.dcn_anti_affinity
                else None
            )
            return self.budget_ledger.try_claim(
                group.id, charge, dcn_group=dcn
            )
        cap = policy.max_unavailable.scaled_value(
            self._total_units(state, unit)
        )
        # Mirror the admission math: units about to be cordoned (still
        # labeled cordon-required, hosts not yet unschedulable) hold a
        # slot too.  Without this, a slice healing the same pass its
        # freed budget was re-spent rejoins past slices that were
        # admitted but not yet cordoned, and the pass then cordons all
        # of them — busting maxUnavailable.
        if unit == "slice":
            pending = len(state.groups_in(UpgradeState.CORDON_REQUIRED))
        else:
            pending = len(state.nodes_in(UpgradeState.CORDON_REQUIRED))
        return (
            self._unavailable_units(state, unit) + pending + charge <= cap
        )

    # -- shared helpers ------------------------------------------------------

    def _update_group_to_uncordon_or_done(self, group: UpgradeGroup) -> None:
        """Skip uncordon for groups whose every host started cordoned
        (upgrade_state.go:1000-1028); mixed groups go through uncordon,
        where per-host skip applies."""
        # The group is past every gate: clear stored progress-blocker
        # reasons so a stall in a FUTURE upgrade cycle is not attributed
        # to this one's (resolved) drain/validation failures.
        getattr(self.drain_manager, "last_error", {}).pop(group.id, None)
        getattr(self.validation_manager, "last_rejection", {}).pop(
            group.id, None
        )
        # Recovery re-validated the hardware, so a still-pending rollback
        # eviction is moot — stop tracking/retrying it.  The helper also
        # clears the retry-backoff stamp, so a FUTURE failure of this
        # group isn't silently delayed by this (resolved) one's backoff.
        clear = getattr(self.validation_manager, "clear_pending_rollback", None)
        if clear is not None:
            clear(group.id)
        else:  # injected fakes may predate the helper
            getattr(self.validation_manager, "pending_rollback", {}).pop(
                group.id, None
            )
        self.quarantine_reasons.pop(group.id, None)
        # The upgrade cycle is complete: retire this cycle's durable
        # progress clocks so the NEXT cycle starts with a clean ladder,
        # flap count, and attempt record.  Guarded per key (only nodes
        # actually carrying it), so the common path writes nothing.
        # Up to ~10 per-key clears plus the state flip collapse into ONE
        # combined metadata patch per node (provider.batched): the
        # write-amplification hot spot of every completed cycle.
        with self.provider.batched():
            for key in (
                self.keys.quarantine_cycle_count_annotation,
                self.keys.eviction_rung_annotation,
                self.keys.eviction_rung_since_annotation,
                self.keys.rollback_attempts_annotation,
                self.keys.rollback_last_attempt_annotation,
                self.keys.recovery_probe_since_annotation,
                self.keys.adopted_by_annotation,
                # Stale negotiation residue (e.g. a resize-complete stamped
                # after the offer already timed out into the drain fallback).
                # The exclusion + rejoin markers are NOT cleared — they must
                # survive until rejoin-resize finishes.
                self.keys.elastic_offer_annotation,
                self.keys.elastic_response_annotation,
                self.keys.elastic_resize_complete_annotation,
                # Trace anchor: the DONE-flip intent already deletes it
                # (annotation_source); this catches nodes whose terminal
                # write raced a crash and kept a stale anchor.
                self.keys.trace_annotation,
            ):
                carriers = [
                    m.node for m in group.members if key in m.node.annotations
                ]
                if carriers:
                    try:
                        self.provider.change_nodes_upgrade_annotation(
                            carriers, key, "null"
                        )
                    except Exception as e:  # noqa: BLE001 — best-effort
                        logger.warning(
                            "clearing %s on group %s failed: %s",
                            key,
                            group.id,
                            e,
                        )
            key = self.keys.initial_state_annotation
            if all(
                key in m.node.annotations for m in group.members
            ) and not self._group_elastic_excluded(group):
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.DONE
                )
                self.provider.change_nodes_upgrade_annotation(
                    group.nodes, key, "null"
                )
                if self.budget_ledger is not None:
                    # Straight to DONE (every host started cordoned): the
                    # uncordon processor will never see this group, so the
                    # ledger claim is released here.
                    self.budget_ledger.release(group.id)
            else:
                self.provider.change_nodes_upgrade_state(
                    group.nodes, UpgradeState.UNCORDON_REQUIRED
                )

    def _pod_in_sync_with_ds(
        self, member: NodeUpgradeState
    ) -> tuple[bool, bool]:
        """(synced, orphaned) via revision hashes (upgrade_state.go:552-578)."""
        if member.is_orphaned_pod():
            return False, True
        pod_hash = self.pod_manager.get_pod_controller_revision_hash(
            member.driver_pod
        )
        ds_hash = self.pod_manager.get_daemonset_controller_revision_hash(
            member.driver_daemon_set
        )
        return pod_hash == ds_hash, False

    def _artifact_in_sync(
        self, member: NodeUpgradeState, name: str
    ) -> tuple[bool, bool]:
        """(synced, orphaned) for a NON-primary artifact's pod on this
        member, by the same controller-revision-hash comparison as the
        primary.  A node carrying no pod for the artifact is vacuously
        synced — the artifact's DaemonSet simply does not schedule
        there, exactly how the classic path treats such a node."""
        art = member.artifact_state(name)
        if art is None or art.pod is None:
            return True, False
        if art.daemon_set is None:
            return False, True
        pod_hash = self.pod_manager.get_pod_controller_revision_hash(art.pod)
        ds_hash = self.pod_manager.get_daemonset_controller_revision_hash(
            art.daemon_set
        )
        return pod_hash == ds_hash, False

    def _artifact_pod_ready(self, member: NodeUpgradeState, name: str) -> bool:
        """Synced + Running + all containers ready, artifact edition."""
        synced, orphaned = self._artifact_in_sync(member, name)
        if orphaned or not synced:
            return False
        art = member.artifact_state(name)
        if art is None or art.pod is None:
            return True  # vacuously ready: nothing scheduled here
        pod = art.pod
        return pod.status.phase == "Running" and pod.all_containers_ready()

    def _artifact_gate_passed(
        self, group: UpgradeGroup, artifact, name: str
    ) -> bool:
        """Per-artifact validation gate inside the window.  No gate or
        no wired prober passes vacuously; a wired prober's healthy
        verdict is cached per (group, artifact) for the life of the
        step (in-memory only — a restarted controller re-probes, the
        safe direction).  Not-passed holds the stack at this step and
        counts into artifact_gate_holds."""
        gate = getattr(artifact, "gate", "") or ""
        if not gate:
            return True
        prober = self.artifact_gate_prober
        if prober is None:
            return True
        key = (group.id, name)
        if key in self._artifact_gate_ok:
            return True
        verdict = prober.probe(group, name)
        if getattr(verdict, "passed", False):
            self._artifact_gate_ok.add(key)
            self._artifact_gate_warned.discard(key)
            return True
        self.artifact_gate_holds[name] = (
            self.artifact_gate_holds.get(name, 0) + 1
        )
        detail = getattr(verdict, "detail", "")
        logger.info(
            "artifact %s of group %s held by %s gate: %s",
            name,
            group.id,
            gate,
            detail,
        )
        if key not in self._artifact_gate_warned:
            # One Warning per hold episode, not per pass.
            self._artifact_gate_warned.add(key)
            anchor = group.node_names[0] if group.node_names else group.id
            log_event(
                self.event_recorder,
                anchor,
                EVENT_TYPE_WARNING,
                "ArtifactGateHeld",
                f"group {group.id}: artifact {name!r} {gate} gate not "
                f"passed: {detail}",
            )
        return False

    def _drop_artifact_gate_state(self, group_id: str) -> None:
        for key in list(self._artifact_gate_ok):
            if key[0] == group_id:
                self._artifact_gate_ok.discard(key)
        for key in list(self._artifact_gate_warned):
            if key[0] == group_id:
                self._artifact_gate_warned.discard(key)

    def _is_driver_pod_in_sync(self, member: NodeUpgradeState) -> bool:
        """Synced + Running + all containers ready (upgrade_state.go:936-964)."""
        synced, orphaned = self._pod_in_sync_with_ds(member)
        if orphaned or not synced:
            return False
        pod = member.driver_pod
        return (
            pod is not None
            and pod.status.phase == "Running"
            and pod.all_containers_ready()
        )

    def _is_driver_pod_failing(self, pod: Pod) -> bool:
        """Repeated container restarts (upgrade_state.go:966-978)."""
        for status in list(pod.status.init_container_statuses) + list(
            pod.status.container_statuses
        ):
            if not status.ready and status.restart_count > (
                DRIVER_POD_FAILING_RESTART_THRESHOLD
            ):
                return True
        return False

    def _is_upgrade_requested(self, node: Node) -> bool:
        return (
            node.annotations.get(self.keys.upgrade_requested_annotation)
            == TRUE_STRING
        )

    @staticmethod
    def _unavailability_unit(policy: DriverUpgradePolicySpec) -> str:
        if isinstance(policy, TPUUpgradePolicySpec):
            return policy.unavailability_unit
        return "node"

    # -- counters (upgrade_state.go:1034-1120 + group variants) --------------

    def get_total_managed_nodes(self, state: ClusterUpgradeState) -> int:
        return sum(len(v) for v in state.node_states.values())

    def get_upgrades_in_progress(self, state: ClusterUpgradeState) -> int:
        return sum(
            len(state.nodes_in(s)) for s in IN_PROGRESS_STATES
        )

    def get_upgrades_done(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(UpgradeState.DONE))

    def get_upgrades_failed(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(UpgradeState.FAILED))

    def get_upgrades_pending(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(UpgradeState.UPGRADE_REQUIRED))

    def get_total_managed_groups(self, state: ClusterUpgradeState) -> int:
        return len(state.all_groups())

    def get_current_unavailable_nodes(self, state: ClusterUpgradeState) -> int:
        """Cordoned or not-ready nodes (upgrade_state.go:192-211).

        Quarantined nodes are excluded: a parked slice's hardware loss
        must not charge the ``maxUnavailable`` budget, or one broken host
        would freeze the rest of the fleet's roll for the whole repair."""
        count = 0
        for label, states in state.node_states.items():
            if label == UpgradeState.QUARANTINED.value:
                continue
            for nus in states:
                if nus.node.spec.unschedulable or not node_ready(nus.node):
                    count += 1
        return count

    def _group_unavailable(self, group: UpgradeGroup) -> bool:
        """A slice with any cordoned/not-ready host is an unavailable slice."""
        return any(
            m.node.spec.unschedulable or not node_ready(m.node)
            for m in group.members
        )

    def _total_units(self, state: ClusterUpgradeState, unit: str) -> int:
        if unit == "slice":
            return self.get_total_managed_groups(state)
        return self.get_total_managed_nodes(state)

    def _group_validating_schedulable(self, group: UpgradeGroup) -> bool:
        """True when the group is in validation with every host back in
        service — the pipelined-validation phase that releases its
        parallel slot (its workload is already readmitted).  Hosts that
        started cordoned (initial_state_annotation) stay cordoned by
        design and must not pin the group 'unavailable'."""
        key = self.keys.initial_state_annotation
        return not any(
            (m.node.spec.unschedulable and key not in m.node.annotations)
            or not node_ready(m.node)
            for m in group.members
        )

    def _in_progress_units(
        self, state: ClusterUpgradeState, unit: str, pipeline: bool = False
    ) -> int:
        if unit == "slice":
            count = 0
            for s in IN_PROGRESS_STATES:
                for group in state.groups_in(s):
                    if (
                        pipeline
                        and s == UpgradeState.VALIDATION_REQUIRED
                        and self._group_validating_schedulable(group)
                    ):
                        continue
                    count += 1
            return count
        if pipeline:
            key = self.keys.initial_state_annotation
            count = 0
            for s in IN_PROGRESS_STATES:
                for nus in state.nodes_in(s):
                    if (
                        s == UpgradeState.VALIDATION_REQUIRED
                        and (
                            not nus.node.spec.unschedulable
                            or key in nus.node.annotations
                        )
                        and node_ready(nus.node)
                    ):
                        continue
                    count += 1
            return count
        return self.get_upgrades_in_progress(state)

    def _unavailable_units(self, state: ClusterUpgradeState, unit: str) -> int:
        if unit == "slice":
            # Quarantined slices hold no unavailability budget (their
            # hardware loss is accounted by quarantine, not the roll).
            # Excluded-by-resize slices likewise: the workload already
            # reshaped around them, so the job sees no capacity loss.
            return sum(
                1
                for g in state.all_groups()
                if self._group_unavailable(g)
                and g.effective_state(self.keys.state_label)
                != UpgradeState.QUARANTINED
                and not self._group_elastic_excluded(g)
            )
        return self.get_current_unavailable_nodes(state)

    def get_upgrades_available_units(
        self,
        state: ClusterUpgradeState,
        max_parallel_upgrades: int,
        max_unavailable: int,
        unit: str = "node",
        pipeline: bool = False,
    ) -> int:
        """Slot math (upgrade_state.go:1074-1102), at node or slice
        granularity.  ``pipeline`` releases the slots of validating units
        whose hosts are already back in service (pipelined validation)."""
        in_progress = self._in_progress_units(state, unit, pipeline)
        total = self._total_units(state, unit)

        if max_parallel_upgrades == 0:
            # Unlimited: everything pending may start.
            if unit == "slice":
                available = len(state.groups_in(UpgradeState.UPGRADE_REQUIRED))
            else:
                available = len(state.nodes_in(UpgradeState.UPGRADE_REQUIRED))
        else:
            available = max_parallel_upgrades - in_progress

        # Units already unavailable plus those about to be cordoned.
        if unit == "slice":
            current_unavailable = self._unavailable_units(state, unit) + len(
                state.groups_in(UpgradeState.CORDON_REQUIRED)
            )
        else:
            current_unavailable = self._unavailable_units(state, unit) + len(
                state.nodes_in(UpgradeState.CORDON_REQUIRED)
            )

        available = min(available, max_unavailable)
        if current_unavailable >= max_unavailable:
            available = 0
        elif (
            max_unavailable < total
            and current_unavailable + available > max_unavailable
        ):
            available = max_unavailable - current_unavailable
        return max(0, available)

    # Reference-parity alias for the node-granular signature
    # (upgrade_state.go:1074).
    def get_upgrades_available(
        self,
        state: ClusterUpgradeState,
        max_parallel_upgrades: int,
        max_unavailable: int,
    ) -> int:
        return self.get_upgrades_available_units(
            state, max_parallel_upgrades, max_unavailable, "node"
        )

    # -- test/bench convenience ---------------------------------------------

    @spanned("engine.async_wait", joins="_layer_pass")
    def wait_for_async_work(self, timeout_s: float = 30.0) -> bool:
        """Join outstanding drain/eviction workers (including the
        validation manager's rollback-eviction workers) and any in-flight
        failed-group recovery probes."""
        ok = self.drain_manager.wait_idle(timeout_s)
        ok = self.pod_manager.wait_idle(timeout_s) and ok
        wait = getattr(self.validation_manager, "wait_idle", None)
        if wait is not None:  # injected fakes may lack it
            ok = wait(timeout_s) and ok
        ok = self._recovery_tracker.wait_idle(timeout_s) and ok
        return ok
