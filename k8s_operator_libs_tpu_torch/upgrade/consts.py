"""Upgrade states and node label / annotation key formats.

Capability parity with the reference's ``pkg/upgrade/consts.go:19-78``:
the same 11-state lattice (state values are identical strings so existing
tooling/runbooks transfer), with the key namespace moved from
``nvidia.com/<driver>-driver-upgrade-*`` to
``tpu.google.com/<driver>-driver-upgrade-*`` and one genuinely new state
dimension: slice-scoped keys for atomic multi-host TPU slice upgrades.
"""

from __future__ import annotations

import enum


class UpgradeState(str, enum.Enum):
    """The node/slice upgrade-state lattice.

    Same semantics as reference ``pkg/upgrade/consts.go:42-67``.  The value
    is stored in a node label and *is* the persistent state of the machine:
    the library itself is stateless between reconcile passes.
    """

    # Node not processed yet / upgrade flow disabled (label absent).
    UNKNOWN = ""
    # Driver pod on the node is outdated; no actions performed yet.
    UPGRADE_REQUIRED = "upgrade-required"
    # An elastic-coordination offer is posted to the slice's registered
    # workload; the slice waits (bounded by offerTimeoutSeconds) for the
    # workload to resize away from it before any disruptive action.
    NEGOTIATE_REQUIRED = "negotiate-required"
    # Node must be made unschedulable before the driver upgrade.
    CORDON_REQUIRED = "cordon-required"
    # Wait (up to a timeout) for user jobs on the node to complete.
    WAIT_FOR_JOBS_REQUIRED = "wait-for-jobs-required"
    # Deletion of selected workload pods is required to proceed.
    POD_DELETION_REQUIRED = "pod-deletion-required"
    # Node must be scheduled for drain.
    DRAIN_REQUIRED = "drain-required"
    # Driver pod on the node is scheduled for restart, or safe-load unblock.
    POD_RESTART_REQUIRED = "pod-restart-required"
    # New driver on the node must be validated (TPU: slice health probe).
    VALIDATION_REQUIRED = "validation-required"
    # Driver pod is up-to-date and Ready; node must be made schedulable.
    UNCORDON_REQUIRED = "uncordon-required"
    # Slice uncordoned while still excluded-by-resize: a rejoin offer is
    # posted so the workload resizes back over the slice before DONE.
    REJOIN_RESIZE_REQUIRED = "rejoin-resize-required"
    # Upgrade finished; node schedulable and driver current.
    DONE = "upgrade-done"
    # Any failure during the upgrade lands here.
    FAILED = "upgrade-failed"
    # A member of an in-flight slice went NotReady or vanished: the whole
    # slice is parked, releases its unavailability budget, and rejoins its
    # prior state after the hardware stays Ready past the hysteresis dwell.
    QUARANTINED = "quarantined"

    def __str__(self) -> str:  # label value
        return self.value


# Forward progress order used to resolve the effective state of a slice whose
# hosts momentarily disagree (e.g. after a crash mid-transition): the slice's
# effective state is the EARLIEST state any member is in, so re-running the
# pass re-drives every member forward idempotently.  FAILED dominates.
# DONE sorts LAST among normal states: a group partially flipped to done
# (one member stuck at uncordon-required after a crashed batch write) must
# resolve to the straggler's state so the next pass re-drives it — ranking
# done early would strand the straggler forever.
STATE_ORDER: dict[UpgradeState, float] = {
    UpgradeState.UNKNOWN: 0,
    UpgradeState.UPGRADE_REQUIRED: 2,
    # Between admission and cordon: a slice mid-negotiation has claimed a
    # slot but taken no disruptive action yet.
    UpgradeState.NEGOTIATE_REQUIRED: 2.5,
    UpgradeState.CORDON_REQUIRED: 3,
    UpgradeState.WAIT_FOR_JOBS_REQUIRED: 4,
    UpgradeState.POD_DELETION_REQUIRED: 5,
    UpgradeState.DRAIN_REQUIRED: 6,
    UpgradeState.POD_RESTART_REQUIRED: 7,
    UpgradeState.VALIDATION_REQUIRED: 8,
    UpgradeState.UNCORDON_REQUIRED: 9,
    # After uncordon, before done: hosts serve again but the workload has
    # not yet resized back over the slice.
    UpgradeState.REJOIN_RESIZE_REQUIRED: 9.5,
    UpgradeState.DONE: 10,
    UpgradeState.FAILED: 100,
    # Dominates even FAILED (UpgradeGroup.effective_state checks it first):
    # a partially-written quarantine batch must resolve to quarantined so
    # the next pass re-drives the remaining members into the parked state.
    UpgradeState.QUARANTINED: 200,
}


def parse_state(value: str) -> UpgradeState:
    """Map a node label value to an UpgradeState.

    The label is externally writable; an unrecognized value (typo, state
    from a future version) must not crash the reconcile loop — it resolves
    to UNKNOWN, which the done-or-unknown processor self-heals by
    relabeling the node.
    """
    try:
        return UpgradeState(value)
    except ValueError:
        return UpgradeState.UNKNOWN

# States counted as "upgrade in progress" (reference upgrade_state.go:1055-1062
# counts everything except unknown/done/upgrade-required).  QUARANTINED is
# deliberately NOT here: a quarantined slice holds neither a parallel slot
# nor unavailability budget (it is parked on broken hardware, not being
# upgraded), and the stuck detector — which walks exactly these states —
# must treat quarantine as a *reason* for a stall, never a stuck state.
IN_PROGRESS_STATES: tuple[UpgradeState, ...] = (
    # NEGOTIATE_REQUIRED holds the parallel slot / budget claim made at
    # admission (released only when the workload's resize-complete excludes
    # the slice), so it counts as in progress and is quarantinable.
    # REJOIN_RESIZE_REQUIRED is deliberately NOT here: its hosts are
    # uncordoned and serving, it holds no budget, and a member fault there
    # is handled by the rejoin-timeout path, not quarantine.
    UpgradeState.NEGOTIATE_REQUIRED,
    UpgradeState.CORDON_REQUIRED,
    UpgradeState.WAIT_FOR_JOBS_REQUIRED,
    UpgradeState.POD_DELETION_REQUIRED,
    UpgradeState.DRAIN_REQUIRED,
    UpgradeState.POD_RESTART_REQUIRED,
    UpgradeState.VALIDATION_REQUIRED,
    UpgradeState.UNCORDON_REQUIRED,
    UpgradeState.FAILED,
)

# States a slice can be quarantined FROM (and resumed BACK TO): exactly the
# in-flight states.  A pending (upgrade-required) or finished group has no
# budget to release, so node loss there needs no special transition.
QUARANTINABLE_STATES: tuple[UpgradeState, ...] = IN_PROGRESS_STATES

ALL_STATES: tuple[UpgradeState, ...] = tuple(UpgradeState)

# The transition graph of the machine: (from, to, condition).  This is the
# documented contract of apply_state and its sub-managers; tests assert
# that every transition the engine performs in the e2e tiers appears here,
# and tools/gen_state_diagram.py renders it into docs/state-diagram.md
# (drift-checked by `make generate-check`).  The reference ships a PNG
# explicitly flagged outdated (docs/automatic-ofed-upgrade.md:85); this
# one is generated from the table the engine is tested against.
_S = UpgradeState
STATE_TRANSITIONS: tuple[tuple[UpgradeState, UpgradeState, str], ...] = (
    (_S.UNKNOWN, _S.UPGRADE_REQUIRED,
     "driver pod outdated / safe-load wait / upgrade requested"),
    (_S.UNKNOWN, _S.DONE, "driver pod in sync"),
    (_S.DONE, _S.UPGRADE_REQUIRED,
     "new driver revision detected / upgrade requested"),
    (_S.UPGRADE_REQUIRED, _S.CORDON_REQUIRED,
     "slot available (or already cordoned); slice complete; DCN ring free"),
    (_S.UPGRADE_REQUIRED, _S.NEGOTIATE_REQUIRED,
     "slot claimed; elastic coordination enabled and workload registered"),
    (_S.NEGOTIATE_REQUIRED, _S.CORDON_REQUIRED,
     "offer accepted + resize complete (slice excluded, budget released) "
     "— or declined / offer timeout (drain fallback, charge kept)"),
    (_S.CORDON_REQUIRED, _S.WAIT_FOR_JOBS_REQUIRED, "slice cordoned"),
    (_S.WAIT_FOR_JOBS_REQUIRED, _S.POD_DELETION_REQUIRED,
     "jobs finished or wait timeout (pod deletion enabled)"),
    (_S.WAIT_FOR_JOBS_REQUIRED, _S.DRAIN_REQUIRED,
     "jobs finished or wait timeout (pod deletion disabled)"),
    (_S.POD_DELETION_REQUIRED, _S.POD_RESTART_REQUIRED,
     "workload pods evicted"),
    (_S.POD_DELETION_REQUIRED, _S.DRAIN_REQUIRED,
     "eviction incomplete, drain enabled (fallback)"),
    (_S.POD_DELETION_REQUIRED, _S.FAILED,
     "eviction incomplete, drain disabled"),
    (_S.DRAIN_REQUIRED, _S.POD_RESTART_REQUIRED,
     "drain finished (or drain disabled by policy)"),
    (_S.DRAIN_REQUIRED, _S.FAILED,
     "drain policy failure (transient faults retry in place)"),
    (_S.POD_RESTART_REQUIRED, _S.VALIDATION_REQUIRED,
     "driver pods in sync (pipelined mode uncordons on entry)"),
    (_S.POD_RESTART_REQUIRED, _S.UNCORDON_REQUIRED,
     "driver pods in sync + Ready (validation disabled)"),
    (_S.POD_RESTART_REQUIRED, _S.DONE,
     "in sync + Ready, validation disabled, all hosts started cordoned"),
    (_S.POD_RESTART_REQUIRED, _S.FAILED,
     "new driver pod crash-looping (restarts over threshold)"),
    (_S.VALIDATION_REQUIRED, _S.UNCORDON_REQUIRED,
     "health gate passed (slice re-formed, collectives complete)"),
    (_S.VALIDATION_REQUIRED, _S.DONE,
     "health gate passed, all hosts started cordoned"),
    (_S.VALIDATION_REQUIRED, _S.FAILED,
     "validation timeout (pipelined mode re-cordons + evicts)"),
    (_S.UNCORDON_REQUIRED, _S.DONE, "slice uncordoned"),
    (_S.UNCORDON_REQUIRED, _S.REJOIN_RESIZE_REQUIRED,
     "slice uncordoned while excluded-by-resize (rejoin offer posted)"),
    (_S.REJOIN_RESIZE_REQUIRED, _S.DONE,
     "workload rejoin-resize complete (or rejoin timeout — exclusion "
     "markers cleared either way)"),
    (_S.FAILED, _S.UNCORDON_REQUIRED,
     "auto-recovery: pods back in sync AND health gate passes"),
    (_S.FAILED, _S.DONE,
     "auto-recovery (all hosts started cordoned)"),
) + tuple(
    # Any in-flight state can lose a host: the slice parks in QUARANTINED
    # (budget released) and, once every host stays Ready past the
    # hysteresis dwell, resumes exactly the state it left.
    (src, _S.QUARANTINED, "member NotReady or vanished mid-roll")
    for src in QUARANTINABLE_STATES
) + tuple(
    (_S.QUARANTINED, dst, "all hosts Ready past quarantine dwell (resume)")
    for dst in QUARANTINABLE_STATES
) + (
    (_S.QUARANTINED, _S.FAILED,
     "quarantine cycle limit reached (hardware flapping across dwells)"),
)
del _S

# --- key formats -----------------------------------------------------------
# Reference: pkg/upgrade/consts.go:20-41 (nvidia.com/%s-driver-upgrade-*).
# We parameterize the domain as well as the driver name; defaults target a
# libtpu DaemonSet on GKE TPU node pools.
KEY_DOMAIN_DEFAULT = "tpu.google.com"

UPGRADE_STATE_LABEL_KEY_FMT = "{domain}/{driver}-driver-upgrade-state"
UPGRADE_SKIP_NODE_LABEL_KEY_FMT = "{domain}/{driver}-driver-upgrade.skip"
UPGRADE_WAIT_FOR_SAFE_DRIVER_LOAD_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade.driver-wait-for-safe-load"
)
UPGRADE_INITIAL_STATE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade.node-initial-state.unschedulable"
)
UPGRADE_WAIT_FOR_POD_COMPLETION_START_TIME_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-wait-for-pod-completion-start-time"
)
UPGRADE_VALIDATION_START_TIME_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-validation-start-time"
)
UPGRADE_REQUESTED_ANNOTATION_KEY_FMT = "{domain}/{driver}-driver-upgrade-requested"
# Slice quarantine bookkeeping.  The state label itself flips to
# "quarantined"; these annotations carry what the label cannot:
# - prior-state: the in-flight state the slice left, so rejoin resumes
#   exactly where the roll stopped instead of restarting the ladder;
# - ready-since: the dwell clock anchor, stamped when every host is first
#   observed Ready again (group_clock_start pattern) — a readiness flap
#   clears it, restarting the hysteresis window.
UPGRADE_QUARANTINE_PRIOR_STATE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-quarantine-prior-state"
)
UPGRADE_QUARANTINE_READY_SINCE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-quarantine-ready-since"
)
# How many times the slice has been parked (incremented at park time).
# Past SliceQuarantineSpec.max_cycles the slice demotes to upgrade-failed
# (QuarantineCycleLimit) instead of flapping across dwell windows forever.
UPGRADE_QUARANTINE_CYCLE_COUNT_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-quarantine-cycle-count"
)

# --- roll tracing (obs/) ----------------------------------------------------
# Durable trace anchor: "<trace_id>|<state>|<epoch>", staged into the SAME
# node intent as every state-label flip (zero extra writes) and read back
# by manager.adopt() so a restarted controller continues the same span
# tree — the AnnotationRungStore idiom applied to the roll trace.  Cleared
# when the group reaches done/unknown.
UPGRADE_TRACE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-trace"
)
# Durable per-node telemetry history: bounded JSON ring of the last K
# measured probe samples (obs/telemetry.py), riding the SAME combined
# metadata patch as the state label — zero extra write verbs.  Unlike the
# trace anchor above this one is LONGITUDINAL: it is never cleared on
# terminal states, so fleet baselines survive across rolls and restarts.
UPGRADE_TELEMETRY_HISTORY_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-telemetry-history"
)

# --- elastic roll coordination ---------------------------------------------
# The annotation-mediated negotiation protocol between the controller and
# an elastic workload (coordination.WorkloadCoordinator).  The node
# annotations ARE the wire: both sides are crash-safe because every message
# is an idempotent stamp.
# - elastic-workload: stamped by the workload agent at registration; its
#   presence is what routes an admitted slice to negotiate-required.
# - elastic-offer: epoch seconds when the controller posted the exclusion
#   offer.  Stamped only-if-absent (group_clock_start), so a restarted or
#   failed-over controller resumes the same offer clock — never
#   double-offers — and the offer timeout survives crashes.
# - elastic-response: "accept" | "decline", written by the workload.
# - elastic-resize-complete: epoch seconds when the workload finished
#   resizing away from the slice (written by the workload after accept).
# - elastic-excluded: "true" while the slice is excluded from the
#   workload's mesh; an excluded slice holds no maxUnavailable budget
#   (mirroring quarantine) and must pass through rejoin-resize before DONE.
# - elastic-rejoin-offer / elastic-rejoin-complete: the same clock pair for
#   the resize-back-up leg after uncordon.
UPGRADE_ELASTIC_WORKLOAD_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-workload"
)
UPGRADE_ELASTIC_OFFER_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-offer"
)
UPGRADE_ELASTIC_RESPONSE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-response"
)
UPGRADE_ELASTIC_RESIZE_COMPLETE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-resize-complete"
)
UPGRADE_ELASTIC_EXCLUDED_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-excluded"
)
UPGRADE_ELASTIC_REJOIN_OFFER_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-rejoin-offer"
)
UPGRADE_ELASTIC_REJOIN_COMPLETE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-elastic-rejoin-complete"
)
# Values the workload writes into the elastic-response annotation.
ELASTIC_RESPONSE_ACCEPT = "accept"
ELASTIC_RESPONSE_DECLINE = "decline"

# --- heterogeneous fleet: preemption + maintenance windows -----------------
# Platform preemption signal: stamped on a node by the infrastructure (on
# GKE a spot/preemptible VM gets a termination notice; the fake tier's
# node_preempt fault stamps the same key).  A FIXED key, not
# driver-scoped: preemption is a property of the machine, not of any one
# managed driver.  Presence = the node is preempted/being reclaimed.
NODE_PREEMPTION_ANNOTATION = "tpu.google.com/node-preempted"
# Engine-side bookkeeping stamped on a preempted in-flight group: epoch
# seconds when the controller first observed the preemption.  Its
# presence records that the budget claim was already released and the
# preemption counted (idempotent across passes and controller crashes);
# cleared at re-admission.  Unlike quarantine there is NO prior-state
# annotation and NO dwell clock: the state label never changes while the
# node is gone, and return re-admits on the first all-Ready pass.
UPGRADE_PREEMPTED_SINCE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-preempted-since"
)
# Condition marker for a pool held outside its maintenance window: the
# value is the pool name.  A CONDITION, not a state — the state label is
# untouched, the group makes zero transitions and holds zero budget
# while marked; cleared on the first pass inside the window.
UPGRADE_WINDOW_WAIT_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-window-wait"
)

# --- durable in-flight progress clocks -------------------------------------
# Every escalation/backoff decision the controller makes mid-roll is
# externalized into node annotations through the same idempotent patch
# path as the state label, so a controller crash or leader handoff
# resumes ladders and backoff windows where they stopped instead of
# restarting them from zero (and double-spending disruption budget).
#
# - eviction-rung: the highest eviction-ladder rung reached for the
#   node's pods ("evict" | "delete" | "force_delete");
# - eviction-rung-since: epoch seconds when that rung was entered (the
#   ladder's dwell clock — a new leader resumes the countdown, it does
#   not restart it);
# - rollback-attempts: count of rollback eviction attempts for a FAILED
#   pipelined-validation slice;
# - rollback-last-attempt: epoch seconds of the newest attempt (backoff
#   anchor for retry_pending_rollbacks);
# - recovery-probe-since: epoch seconds of the newest auto-recovery
#   health probe for a FAILED slice (probe dedupe across leader terms);
# - adopted-by: "<leader identity>@<lease term>" fencing stamp written
#   by the re-adoption pass on leader acquisition; a deposed leader's
#   stale workers observe a foreign stamp/term and must not act.
UPGRADE_EVICTION_RUNG_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-eviction-rung"
)
UPGRADE_EVICTION_RUNG_SINCE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-eviction-rung-since"
)
UPGRADE_ROLLBACK_ATTEMPTS_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-rollback-attempts"
)
UPGRADE_ROLLBACK_LAST_ATTEMPT_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-rollback-last-attempt"
)
UPGRADE_RECOVERY_PROBE_SINCE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-recovery-probe-since"
)
UPGRADE_ADOPTED_BY_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-adopted-by"
)

# --- TPU-specific keys (new; no reference analogue) ------------------------
# Slice identity label our topology layer writes/reads when GKE labels are
# absent (on GKE, cloud.google.com/gke-nodepool + gke-tpu-topology are used).
SLICE_ID_LABEL_KEY_FMT = "{domain}/{driver}-slice-id"
# Per-host health report published by the probe agent (health.agent) and
# consumed by the controller-side NodeReportProber: JSON HealthReport.
HEALTH_REPORT_ANNOTATION_KEY_FMT = "{domain}/{driver}-health-report"
# Multi-slice (DCN) group identity: slices in the same group serve one
# data-parallel JobSet and must never be down simultaneously.
DCN_GROUP_LABEL_KEY_FMT = "{domain}/{driver}-dcn-group"
# Explicit chips-per-host override for slice-shape math.  GKE's accelerator
# label only implies a per-host chip count for the standard machine shapes
# (topology/slices.ACCELERATOR_CHIPS_PER_HOST); sub-host topologies (v5e
# 1x1/2x2 single-chip or quad-chip hosts) and future shapes carry this
# label so host-count math and the health gate's chip-count predicate match
# the hardware actually attached, not the table's assumption.
CHIPS_PER_HOST_LABEL_KEY_FMT = "{domain}/{driver}-chips-per-host"

# GKE TPU node labels (canonical definitions live in topology.slices,
# which must not depend on this package; re-exported here for convenience).
from k8s_operator_libs_tpu_torch.topology.slices import (  # noqa: E402,F401
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
    GKE_TPU_WORKER_ID_LABEL,
)

# Field-selector format for listing pods on one node
# (reference consts.go:71-73).
NODE_NAME_FIELD_SELECTOR_FMT = "spec.nodeName={name}"

NULL_STRING = "null"
TRUE_STRING = "true"
