"""v1alpha1 policy API: CRD-embeddable upgrade policy types.

Capability parity with the reference's
``api/upgrade/v1alpha1/upgrade_spec.go:27-110`` (DriverUpgradePolicySpec,
WaitForCompletionSpec, PodDeletionSpec, DrainSpec with kubebuilder
defaults/validation) and ``zz_generated.deepcopy.go`` (deep-copy), plus the
TPU-native extensions specified in SURVEY.md §7 step 1: slice topology,
slice-atomicity mode, ICI health gate, and slice-granular unavailability.

Types serialize to/from the same camelCase JSON shape a consumer operator
would embed in its CRD, so a policy YAML written for the reference loads
unchanged into :class:`DriverUpgradePolicySpec`.
"""

from __future__ import annotations

import copy
import math
import re
from dataclasses import dataclass, field, fields
from typing import Any, Optional, Union


class ValidationError(ValueError):
    """Raised when a spec violates its (kubebuilder-style) validation rules."""


# ---------------------------------------------------------------------------
# IntOrString — analogue of k8s.io/apimachinery/pkg/util/intstr
# ---------------------------------------------------------------------------

_PERCENT_RE = re.compile(r"^(\d+)%$")


@dataclass(frozen=True)
class IntOrString:
    """An int count or a percentage string like ``"25%"``.

    Mirrors apimachinery's intstr type as used by MaxUnavailable
    (reference upgrade_spec.go:39-45).
    """

    value: Union[int, str]

    def __post_init__(self) -> None:
        if isinstance(self.value, str) and not _PERCENT_RE.match(self.value):
            raise ValidationError(
                f"invalid IntOrString {self.value!r}: string form must be 'N%'"
            )
        if isinstance(self.value, int) and self.value < 0:
            raise ValidationError("IntOrString int form must be >= 0")

    def scaled_value(self, total: int, round_up: bool = True) -> int:
        """Resolve to an absolute count against ``total``.

        Analogue of ``intstr.GetScaledValueFromIntOrPercent`` as called at
        reference upgrade_state.go:395-401 (percentage rounds up).
        """
        if isinstance(self.value, int):
            return self.value
        pct = int(_PERCENT_RE.match(self.value).group(1))
        if round_up:
            return math.ceil(pct * total / 100)
        return math.floor(pct * total / 100)

    @classmethod
    def parse(cls, raw: Union[int, str, "IntOrString"]) -> "IntOrString":
        if isinstance(raw, IntOrString):
            return raw
        return cls(raw)


# ---------------------------------------------------------------------------
# Spec base with camelCase JSON round-trip + deep copy
# ---------------------------------------------------------------------------


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


_JSON_NAME_OVERRIDES = {
    # Reference upgrade_spec.go:48: field DrainSpec serializes as "drain".
    "drain_spec": "drain",
    # Reference upgrade_spec.go:63,77,104: TimeoutSecond -> "timeoutSeconds".
    "timeout_second": "timeoutSeconds",
    "stuck_threshold_second": "stuckThresholdSeconds",
    "evict_timeout_second": "evictTimeoutSeconds",
    "delete_timeout_second": "deleteTimeoutSeconds",
    "ready_dwell_second": "readyDwellSeconds",
    "pdb_grace_second": "pdbGraceSeconds",
    "offer_timeout_second": "offerTimeoutSeconds",
    "rejoin_timeout_second": "rejoinTimeoutSeconds",
    "drift_threshold_second": "driftThresholdSeconds",
    "replan_interval_second": "replanIntervalSeconds",
    "soak_second": "soakSeconds",
    "lease_duration_second": "leaseDurationSeconds",
}


class _SpecBase:
    """camelCase JSON (de)serialization + deep-copy for all spec types."""

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, list) and not v:
                continue  # empty list = unset, like None
            key = _JSON_NAME_OVERRIDES.get(f.name, _camel(f.name))
            if isinstance(v, _SpecBase):
                out[key] = v.to_dict()
            elif isinstance(v, IntOrString):
                out[key] = v.value
            elif isinstance(v, list):
                out[key] = [
                    x.to_dict() if isinstance(x, _SpecBase) else x for x in v
                ]
            else:
                out[key] = v
        return out

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Any":
        kwargs: dict[str, Any] = {}
        by_json_name = {}
        for f in fields(cls):
            by_json_name[_JSON_NAME_OVERRIDES.get(f.name, _camel(f.name))] = f
        for key, raw in (data or {}).items():
            f = by_json_name.get(key)
            if f is None:
                continue  # tolerate unknown fields like the apiserver does
            if raw is None:
                # Explicit null = unset: a structural-schema apiserver
                # prunes nulls and applies the field default.
                continue
            typ = _NESTED_TYPES.get((cls.__name__, f.name))
            if typ is not None and isinstance(raw, list):
                kwargs[f.name] = [typ.from_dict(item) for item in raw]
            elif typ is not None and raw is not None:
                kwargs[f.name] = typ.from_dict(raw)
            elif f.name == "max_unavailable" and raw is not None:
                kwargs[f.name] = IntOrString.parse(raw)
            else:
                kwargs[f.name] = raw
        return cls(**kwargs)

    def deep_copy(self):
        """Analogue of the controller-gen DeepCopy (zz_generated.deepcopy.go)."""
        return copy.deepcopy(self)

    def validate(self) -> None:  # overridden where rules exist
        pass


# ---------------------------------------------------------------------------
# Reference-parity specs
# ---------------------------------------------------------------------------


@dataclass
class WaitForCompletionSpec(_SpecBase):
    """Wait-for-job-completion configuration (upgrade_spec.go:51-64)."""

    pod_selector: str = ""
    # 0 means wait forever.
    timeout_second: int = 0

    def validate(self) -> None:
        if self.timeout_second < 0:
            raise ValidationError("waitForCompletion.timeoutSeconds must be >= 0")


@dataclass
class PodDeletionSpec(_SpecBase):
    """Workload pod deletion configuration (upgrade_spec.go:66-83)."""

    force: bool = False
    timeout_second: int = 300
    delete_empty_dir: bool = False

    def validate(self) -> None:
        if self.timeout_second < 0:
            raise ValidationError("podDeletion.timeoutSeconds must be >= 0")


@dataclass
class EvictionEscalationSpec(_SpecBase):
    """Eviction escalation ladder (new; no reference analogue).

    When a drain's eviction stalls — a PodDisruptionBudget that never
    releases, or a pod held Terminating by a finalizer — the ladder
    escalates evict → delete → force-delete (grace 0), each rung gated
    by its own timeout.  Disabled by default; the force rung is
    separately opt-in because force-deleting a pod whose kubelet is
    still alive can leave containers running on the ICI domain.
    """

    enable: bool = False
    # Seconds a pod may resist eviction before escalating to delete.
    evict_timeout_second: int = 300
    # Seconds a delete may dangle (stuck Terminating) before force.
    delete_timeout_second: int = 300
    # Allow the final rung: delete with gracePeriodSeconds=0.
    allow_force_delete: bool = False
    # PDB-aware hold: extra seconds a pod whose evictions are rejected
    # by a PodDisruptionBudget may stay at the evict rung PAST
    # evictTimeoutSeconds before escalating to a PDB-bypassing delete —
    # the budget releasing is plausibly imminent, so keep asking instead
    # of timing out blind.  0 disables the hold.
    pdb_grace_second: int = 0

    def validate(self) -> None:
        if self.evict_timeout_second < 0 or self.delete_timeout_second < 0:
            raise ValidationError(
                "evictionEscalation timeouts must be >= 0"
            )
        if self.pdb_grace_second < 0:
            raise ValidationError(
                "evictionEscalation.pdbGraceSeconds must be >= 0"
            )


@dataclass
class DrainSpec(_SpecBase):
    """Node drain configuration (upgrade_spec.go:85-110), extended with
    the opt-in eviction escalation ladder."""

    enable: bool = False
    force: bool = False
    pod_selector: str = ""
    timeout_second: int = 300
    delete_empty_dir: bool = False
    eviction_escalation: Optional[EvictionEscalationSpec] = None

    def validate(self) -> None:
        if self.timeout_second < 0:
            raise ValidationError("drain.timeoutSeconds must be >= 0")
        if self.eviction_escalation is not None:
            self.eviction_escalation.validate()


@dataclass
class DriverUpgradePolicySpec(_SpecBase):
    """Automatic-upgrade policy (upgrade_spec.go:24-49).

    Defaults mirror the reference's kubebuilder markers: autoUpgrade=false,
    maxParallelUpgrades=1 (0 = unlimited), maxUnavailable="25%".
    """

    auto_upgrade: bool = False
    max_parallel_upgrades: int = 1
    max_unavailable: Optional[IntOrString] = field(
        default_factory=lambda: IntOrString("25%")
    )
    pod_deletion: Optional[PodDeletionSpec] = None
    wait_for_completion: Optional[WaitForCompletionSpec] = None
    drain_spec: Optional[DrainSpec] = None

    def validate(self) -> None:
        if self.max_parallel_upgrades < 0:
            raise ValidationError("maxParallelUpgrades must be >= 0")
        for sub in (self.pod_deletion, self.wait_for_completion, self.drain_spec):
            if sub is not None:
                sub.validate()


# ---------------------------------------------------------------------------
# TPU-native extensions (new; SURVEY.md §7 step 1)
# ---------------------------------------------------------------------------


@dataclass
class SliceTopologySpec(_SpecBase):
    """Explicit slice-topology override.

    Normally slice membership is discovered from GKE TPU node labels
    (cloud.google.com/gke-tpu-topology et al.); this spec lets a consumer
    pin the expectation so discovery drift fails loudly.
    """

    # e.g. "tpu-v5p-slice"
    accelerator: str = ""
    # Chip topology string, e.g. "2x2x4" (v5p-16: 8 chips? no — chips) —
    # product of dims = chips in the slice.
    topology: str = ""
    # Hosts forming one ICI domain; 0 = derive from topology/accelerator.
    hosts_per_slice: int = 0

    _TOPOLOGY_RE = re.compile(r"^\d+x\d+(x\d+)?$")

    def validate(self) -> None:
        if self.topology and not self._TOPOLOGY_RE.match(self.topology):
            raise ValidationError(
                f"topology {self.topology!r} must look like '2x2x4'"
            )
        if self.hosts_per_slice < 0:
            raise ValidationError("hostsPerSlice must be >= 0")

    def chips(self) -> int:
        if not self.topology:
            return 0
        dims = [int(d) for d in self.topology.split("x")]
        n = 1
        for d in dims:
            n *= d
        return n


@dataclass
class SliceHealthGateSpec(_SpecBase):
    """ICI/XLA health gate run in the validation state (new component).

    Replaces the reference's out-of-repo nvidia-smi validation pods
    (SURVEY.md §5 'Collective-health probing'): "validated" means the slice
    re-formed completely and an XLA all-reduce over ICI completes.
    """

    enable: bool = True
    # Seconds to wait for one all-reduce probe before declaring it hung.
    all_reduce_timeout_second: int = 60
    # Fraction of expected devices that must re-enumerate; north star = 1.0.
    min_reformation_fraction: float = 1.0
    # Also probe DCN reachability between slices of one multi-slice group.
    dcn_check: bool = False
    # Overall validation deadline before the slice is marked failed
    # (reference validation_manager.go:32 uses a fixed 600s).
    timeout_second: int = 600
    # Route confirmed fleet-health stragglers (sustained below-baseline
    # probe telemetry) into the slice-quarantine path.  Off by default:
    # the telemetry plane is observe-only unless the operator opts in.
    quarantine_stragglers: bool = False

    def validate(self) -> None:
        if not (0.0 <= self.min_reformation_fraction <= 1.0):
            raise ValidationError("minReformationFraction must be in [0, 1]")
        if self.all_reduce_timeout_second < 0 or self.timeout_second < 0:
            raise ValidationError("health gate timeouts must be >= 0")


@dataclass
class SliceQuarantineSpec(_SpecBase):
    """Data-plane fault handling for in-flight slices (new component).

    When a member of an in-flight slice goes NotReady or vanishes, the
    whole slice parks in the ``quarantined`` state: it stops charging
    the unavailability budget and holds its position until every host
    stays Ready for ``ready_dwell_second`` (hysteresis — a flapping
    kubelet must not thrash cordon/uncordon), then resumes the exact
    state it left.  Enabled by default: parking a slice on dead
    hardware is strictly safer than letting it pin budget forever.
    """

    enable: bool = True
    # Seconds every host must stay Ready before the slice rejoins the
    # roll.  The dwell clock restarts on any readiness flap.
    ready_dwell_second: int = 300
    # Cap on quarantine cycles per slice: hardware that keeps flapping
    # across dwell windows demotes to upgrade-failed (with a
    # QuarantineCycleLimit event) once it has been parked this many
    # times, instead of park/rejoin thrashing forever.  0 = unlimited.
    max_cycles: int = 3

    def validate(self) -> None:
        if self.ready_dwell_second < 0:
            raise ValidationError(
                "sliceQuarantine.readyDwellSeconds must be >= 0"
            )
        if self.max_cycles < 0:
            raise ValidationError(
                "sliceQuarantine.maxCycles must be >= 0"
            )


@dataclass
class ElasticCoordinationSpec(_SpecBase):
    """Workload-negotiated mesh reshaping for zero-downtime rolls (new
    component, Tenplex-style elasticity).

    With coordination enabled, an admitted slice whose nodes carry a
    workload registration annotation is offered for exclusion instead of
    being cordoned outright: the workload resizes its mesh away from the
    slice (checkpoint-free, host-side snapshot + re-shard), the roll
    proceeds with zero workload downtime, and after uncordon the slice is
    offered back for a rejoin-resize.  Decline or timeout falls back to
    the pre-existing drain path — coordination only adds capability,
    never removes safety.  Disabled by default: it requires an elastic
    workload agent (coordination.WorkloadCoordinator) in the job.
    """

    enable: bool = False
    # Seconds the controller waits for the workload's accept/decline +
    # resize-complete before falling back to the drain path.
    offer_timeout_second: int = 60
    # Seconds the controller waits after uncordon for the rejoin-resize
    # before declaring the group done anyway (the workload can rejoin
    # later on its own schedule; the roll must not hang on it).
    rejoin_timeout_second: int = 300

    def validate(self) -> None:
        if self.offer_timeout_second < 0:
            raise ValidationError(
                "elastic.offerTimeoutSeconds must be >= 0"
            )
        if self.rejoin_timeout_second < 0:
            raise ValidationError(
                "elastic.rejoinTimeoutSeconds must be >= 0"
            )


@dataclass
class MaintenanceWindowSpec(_SpecBase):
    """Cron-style UTC maintenance window for one pool (new component).

    The expression is a standard 5-field cron (minute hour day-of-month
    month day-of-week, UTC) read as a *membership test*: the window is
    open at an instant iff every field matches, so ``"* 2-5 * * 6,0"``
    means 02:00-05:59 UTC on weekends.  Outside the window the pool's
    groups hold in a budget-free ``window-wait`` condition — no state
    transitions, no budget charge — and resume where they stopped when
    the window opens.
    """

    # 5-field cron membership expression, UTC.  "* * * * *" = always open.
    cron: str = "* * * * *"

    def validate(self) -> None:
        from k8s_operator_libs_tpu_torch.fleet.windows import validate_window

        try:
            validate_window(self.cron)
        except ValueError as e:
            raise ValidationError(f"maintenanceWindow.cron: {e}") from e


@dataclass
class PoolSpec(_SpecBase):
    """One pool of a heterogeneous fleet (new component).

    A pool is a labelled subset of the managed nodes — typically one
    device generation — with its own roll envelope: target driver
    version, budget overrides, and an optional maintenance window.
    Budgets compose as a hierarchy: an admission must fit the FLEET caps
    and the pool's own caps simultaneously.
    """

    # Pool identity (required, unique within the policy).
    name: str = ""
    # Label selector matching this pool's nodes (all pairs must match),
    # e.g. {"cloud.google.com/gke-tpu-accelerator": "tpu-v4-podslice"}.
    node_selector: dict[str, str] = field(default_factory=dict)
    # Target driver version for this pool's DaemonSet (informational +
    # surfaced in status; the DaemonSet template hash remains the
    # authoritative "outdated" predicate).
    driver_version: str = ""
    # Per-pool maxUnavailable override; unset inherits the fleet cap.
    max_unavailable: Optional[IntOrString] = None
    # Per-pool maxParallelUpgrades override; unset inherits, 0 = unlimited
    # within the pool (the fleet cap still applies).
    max_parallel_upgrades: Optional[int] = None
    # Optional maintenance window; unset = always open.
    maintenance_window: Optional[MaintenanceWindowSpec] = None

    def validate(self) -> None:
        if not self.name:
            raise ValidationError("pool.name must be non-empty")
        if (
            self.max_parallel_upgrades is not None
            and self.max_parallel_upgrades < 0
        ):
            raise ValidationError(
                f"pool {self.name!r}: maxParallelUpgrades must be >= 0"
            )
        if self.maintenance_window is not None:
            try:
                self.maintenance_window.validate()
            except ValidationError as e:
                raise ValidationError(f"pool {self.name!r}: {e}") from e


@dataclass
class PlanningSpec(_SpecBase):
    """Predictive rollout planning knobs (new component).

    Tunes the drift watchdog that anchors an active roll to its
    analytic plan: how far reality may diverge from the projection
    before the controller re-plans, how often it may re-plan, and a
    ceiling on automatic re-plans per roll.  Planning itself is always
    on and read-only — these knobs only shape the watchdog's reaction.
    """

    # Drift (seconds behind projection) beyond which the watchdog
    # re-plans from the live snapshot.
    drift_threshold_second: int = 300
    # Minimum seconds between automatic re-plans.
    replan_interval_second: int = 60
    # Ceiling on automatic re-plans per roll (planning must never
    # become the hot path on a pathological fleet).
    max_replans: int = 5
    # How the admission pass orders chargeable groups.  "greedy" keeps
    # the historical generation-then-id order; "packed" lets admission
    # consult the watchdog's anchored plan and first-fit-decreasing
    # pack each wave (falls back to greedy whenever no fresh plan is
    # anchored).  Packing never relaxes budgets, DCN anti-affinity,
    # maintenance windows, or oldest-generation-first ordering.
    admission_mode: str = "greedy"

    ADMISSION_MODES = ("greedy", "packed")

    def validate(self) -> None:
        if self.drift_threshold_second < 0:
            raise ValidationError(
                "planning.driftThresholdSeconds must be >= 0"
            )
        if self.replan_interval_second < 0:
            raise ValidationError(
                "planning.replanIntervalSeconds must be >= 0"
            )
        if self.max_replans < 0:
            raise ValidationError("planning.maxReplans must be >= 0")
        if self.admission_mode not in self.ADMISSION_MODES:
            raise ValidationError(
                "planning.admissionMode must be 'greedy' or 'packed'"
            )


@dataclass
class FederationClusterSpec(_SpecBase):
    """One member cluster of a federated roll."""

    # Unique cluster name (the budget-hierarchy key).
    name: str = ""
    # Region the cluster belongs to (the canary/promotion unit).
    region: str = ""

    def validate(self) -> None:
        if not self.name:
            raise ValidationError("federation cluster: name is required")
        if not self.region:
            raise ValidationError(
                f"federation cluster {self.name!r}: region is required"
            )


@dataclass
class FederationCanarySpec(_SpecBase):
    """Regional canary gate for federated rolls."""

    # Region that rolls first (must match a cluster's region).
    region: str = ""
    # Seconds the canary region's health baselines must stay clean
    # after its roll completes before promotion to remaining regions.
    soak_second: int = 300

    def validate(self) -> None:
        if not self.region:
            raise ValidationError("federation.canary.region is required")
        if self.soak_second < 0:
            raise ValidationError(
                "federation.canary.soakSeconds must be >= 0"
            )


@dataclass
class FederationSpec(_SpecBase):
    """Federated (multi-cluster) roll configuration.

    Declares the member clusters, the canary region and soak, the
    GLOBAL unavailability budget (checked-and-charged above every
    cluster's own caps: global ∧ cluster ∧ pool), and the health-probe
    ladder that drives fail-static degradation (Reachable → Degraded →
    Partitioned).  See docs/federation.md.
    """

    enable: bool = False
    # Member clusters; each name must be unique.
    clusters: list[FederationClusterSpec] = field(default_factory=list)
    # Regional canary gate (required when enabled).
    canary: Optional[FederationCanarySpec] = None
    # GLOBAL maxUnavailable across every cluster (int or percentage of
    # the federation's total units); unset = no global cap beyond the
    # per-cluster policies.
    max_unavailable: Optional[IntOrString] = None
    # Global in-flight group ceiling across clusters (0 = unlimited).
    max_parallel_upgrades: int = 0
    # Consecutive failed health probes before a cluster is Degraded.
    degraded_after_probes: int = 1
    # Consecutive failed probes before Partitioned (an open circuit
    # breaker escalates straight here).
    partitioned_after_probes: int = 3
    # Consecutive clean probes a Partitioned cluster needs to step back
    # down the ladder (hysteresis against flapping WAN links).
    heal_probes: int = 2
    # Observer-clock staleness bound for member controller leases.
    lease_duration_second: int = 30

    def validate(self) -> None:
        if not self.enable:
            return
        if not self.clusters:
            raise ValidationError(
                "federation.enable requires at least one cluster"
            )
        seen: set[str] = set()
        regions: set[str] = set()
        for cluster in self.clusters:
            cluster.validate()
            if cluster.name in seen:
                raise ValidationError(
                    f"duplicate federation cluster name {cluster.name!r}"
                )
            seen.add(cluster.name)
            regions.add(cluster.region)
        if self.canary is None:
            raise ValidationError(
                "federation.enable requires federation.canary"
            )
        self.canary.validate()
        if self.canary.region not in regions:
            raise ValidationError(
                f"federation.canary.region {self.canary.region!r} "
                f"matches no cluster's region"
            )
        if self.max_parallel_upgrades < 0:
            raise ValidationError(
                "federation.maxParallelUpgrades must be >= 0"
            )
        if self.degraded_after_probes < 1:
            raise ValidationError(
                "federation.degradedAfterProbes must be >= 1"
            )
        if self.partitioned_after_probes < self.degraded_after_probes:
            raise ValidationError(
                "federation.partitionedAfterProbes must be >= "
                "degradedAfterProbes"
            )
        if self.heal_probes < 1:
            raise ValidationError("federation.healProbes must be >= 1")
        if self.lease_duration_second < 0:
            raise ValidationError(
                "federation.leaseDurationSeconds must be >= 0"
            )
        huge = 1 << 30
        if (
            self.max_unavailable is not None
            and self.max_unavailable.scaled_value(huge, round_up=True) == 0
        ):
            raise ValidationError(
                "federation.maxUnavailable admits zero units: the global "
                "roll can never start (plan-infeasible)"
            )


@dataclass
class ArtifactSpec(_SpecBase):
    """One artifact of a composable driver stack (device driver, network
    driver, device plugin, ...) managed as a node of the upgrade DAG."""

    # Unique artifact name (the DAG node id).
    name: str = ""
    # DaemonSet selector: pods/DaemonSets carrying these labels belong
    # to this artifact.
    match_labels: dict[str, str] = field(default_factory=dict)
    # Version the roll targets (compared by edges' requires constraints).
    target_version: str = ""
    # Per-artifact validation gate run inside the drain window before
    # the stack may advance past this artifact: "" (none) or
    # "network-path" (DCN reachability + ICI link state).
    gate: str = ""

    def validate(self) -> None:
        if not self.name:
            raise ValidationError("artifact: name is required")
        if not self.match_labels:
            raise ValidationError(
                f"artifact {self.name!r}: matchLabels is required"
            )


@dataclass
class ArtifactEdgeSpec(_SpecBase):
    """Dependency edge ``before -> after`` of the artifact DAG."""

    # Upstream artifact (must restart no later than `after`).
    before: str = ""
    # Downstream artifact.
    after: str = ""
    # Version-compatibility constraint the upstream's targetVersion must
    # satisfy (">=1.2", "==535.104.05", bare version = exact; empty =
    # unconstrained).  Checked at admission against declared targets.
    requires: str = ""
    # "lockstep": both ends restart in the same step of the shared
    # window.  "pinned-order": `after` may not restart until `before`
    # is fully synced (and gated, if it declares a gate).
    skew: str = "lockstep"

    def validate(self) -> None:
        if not self.before or not self.after:
            raise ValidationError(
                "artifact edge: before and after are required"
            )


@dataclass
class ArtifactDAGSpec(_SpecBase):
    """The policy's composable driver stack: artifacts + edges.

    Structural validation (cycles, dangling edges, skew conflicts,
    unsatisfiable constraints) lives in
    :class:`k8s_operator_libs_tpu_torch.artifacts.dag.ArtifactDAG` and runs
    through ``_validate_feasibility`` — an invalid stack rejects the
    policy at admission.  A single-item stack is the classic
    one-DaemonSet path, byte for byte.
    """

    items: list[ArtifactSpec] = field(default_factory=list)
    edges: list[ArtifactEdgeSpec] = field(default_factory=list)

    def validate(self) -> None:
        for item in self.items:
            item.validate()
        for edge in self.edges:
            edge.validate()


@dataclass
class TPUUpgradePolicySpec(DriverUpgradePolicySpec):
    """Slice-aware upgrade policy for TPU node pools.

    Extends the reference policy with the TPU north-star fields:

    - ``slice_atomic``: all hosts of one ICI domain transition as a unit —
      the torus is never split (SURVEY.md §7 step 2);
    - ``unavailability_unit``: whether maxParallelUpgrades/maxUnavailable
      count slices or individual hosts;
    - ``health_gate``: the ICI/XLA validation gate;
    - ``dcn_anti_affinity``: never take two slices of the same DCN
      (multi-slice data-parallel) group down simultaneously.
    """

    UNAVAILABILITY_UNITS = ("slice", "node")

    slice_atomic: bool = True
    # "slice" or "node".
    unavailability_unit: str = "slice"
    topology: Optional[SliceTopologySpec] = None
    health_gate: Optional[SliceHealthGateSpec] = field(
        default_factory=SliceHealthGateSpec
    )
    dcn_anti_affinity: bool = True
    # Seconds a group may dwell in one in-progress state before the
    # engine emits stuck-state Warning events with the progress-blocker
    # reason (0 disables).  Distinct from the validation timeout: this is
    # telemetry, not a transition.
    stuck_threshold_second: int = 300
    # Pipelined validation ("optimistic uncordon"): as soon as a slice's
    # driver pods are back in sync, its hosts are uncordoned and the
    # workload readmitted WHILE the health gate still runs; a slice in
    # that phase is schedulable, so it stops consuming parallel slots and
    # unavailability budget and the next slice's drain overlaps its
    # validation.  A failed/timed-out gate re-cordons the slice and marks
    # it upgrade-failed.  Tradeoff (opt-in): the workload may run briefly
    # on a slice the gate later rejects — acceptable when the continuous
    # per-host probe agents already vouch for basic chip health, and
    # required to meet a <2 min budget on multi-slice pools.
    pipeline_validation: bool = False
    # Data-plane fault handling: quarantine in-flight slices that lose a
    # host instead of charging the budget while hardware is dead.
    slice_quarantine: Optional[SliceQuarantineSpec] = field(
        default_factory=SliceQuarantineSpec
    )
    # Elastic roll coordination: negotiate workload mesh reshaping before
    # cordoning a slice (None/disabled = today's drain rolls unchanged).
    elastic: Optional[ElasticCoordinationSpec] = None
    # Heterogeneous-fleet pools: per-generation node subsets, each with
    # its own driver target, budget overrides, and maintenance window.
    # Empty = the whole fleet is one implicit pool (prior behavior).
    pools: list[PoolSpec] = field(default_factory=list)
    # Predictive rollout planning / drift-watchdog knobs; None = planner
    # defaults (planning is always on — it is read-only).
    planning: Optional[PlanningSpec] = None
    # Federated (multi-cluster) roll: member clusters, regional canary
    # gate, global budget, partition-tolerance ladder.  None/disabled =
    # single-cluster behavior unchanged.
    federation: Optional[FederationSpec] = None
    # Multi-artifact upgrade DAG: the composable driver stack this
    # policy rolls under ONE cordon/drain window per node.  None or a
    # single item = the classic one-DaemonSet behavior unchanged.
    artifacts: Optional[ArtifactDAGSpec] = None

    def validate(self) -> None:
        super().validate()
        if self.stuck_threshold_second < 0:
            raise ValidationError("stuckThresholdSeconds must be >= 0")
        if self.unavailability_unit not in self.UNAVAILABILITY_UNITS:
            raise ValidationError(
                "unavailabilityUnit must be 'slice' or 'node', got "
                f"{self.unavailability_unit!r}"
            )
        if self.topology is not None:
            self.topology.validate()
        if self.health_gate is not None:
            self.health_gate.validate()
        if self.slice_quarantine is not None:
            self.slice_quarantine.validate()
        if self.elastic is not None:
            self.elastic.validate()
        if self.planning is not None:
            self.planning.validate()
        if self.federation is not None:
            self.federation.validate()
        if self.artifacts is not None:
            self.artifacts.validate()
        seen_pools: set[str] = set()
        for pool in self.pools:
            pool.validate()
            if pool.name in seen_pools:
                raise ValidationError(f"duplicate pool name {pool.name!r}")
            seen_pools.add(pool.name)
        self._validate_feasibility()

    def _validate_feasibility(self) -> None:
        """Admission-time plan feasibility: reject a policy whose roll
        can PROVABLY never finish — a budget that admits zero units
        regardless of fleet size, or a maintenance window whose cron is
        syntactically valid but never matches a real instant (Feb 31).
        Fleet-dependent deadlocks (a slice whose node cost exceeds a
        nonzero cap) are a runtime planner/watchdog verdict — they
        depend on the observed fleet, not the policy alone."""
        from k8s_operator_libs_tpu_torch.fleet.windows import next_open

        huge = 1 << 30  # any positive percentage of this rounds up >= 1
        if (
            self.auto_upgrade
            and self.max_unavailable is not None
            and self.max_unavailable.scaled_value(huge, round_up=True) == 0
        ):
            raise ValidationError(
                "maxUnavailable admits zero units: the roll can never "
                "start (plan-infeasible)"
            )
        for pool in self.pools:
            if (
                pool.max_unavailable is not None
                and pool.max_unavailable.scaled_value(huge, round_up=True)
                == 0
            ):
                raise ValidationError(
                    f"pool {pool.name!r}: maxUnavailable admits zero "
                    "units — the pool can never be upgraded "
                    "(plan-infeasible)"
                )
            window = pool.maintenance_window
            if window is not None and window.cron:
                try:
                    opens = next_open(window.cron)
                except ValueError:
                    continue  # pool.validate() already rejected syntax
                if opens is None:
                    raise ValidationError(
                        f"pool {pool.name!r}: maintenanceWindow.cron "
                        f"{window.cron!r} never opens (plan-infeasible)"
                    )
        if self.artifacts is not None and self.artifacts.items:
            # Structural DAG feasibility: cycles, dangling/self edges,
            # lockstep/pinned-order conflicts, unsatisfiable version
            # constraints.  Deferred import — artifacts.dag is pure
            # graph code but api must stay importable standalone.
            from k8s_operator_libs_tpu_torch.artifacts.dag import (
                ArtifactDAG,
                ArtifactDAGError,
            )

            try:
                ArtifactDAG.from_spec(self.artifacts).validate()
            except ArtifactDAGError as e:
                raise ValidationError(f"artifacts: {e}") from e


# Nested-type registry for from_dict (maps (class, field) -> spec type).
_NESTED_TYPES: dict[tuple[str, str], Any] = {
    ("DriverUpgradePolicySpec", "pod_deletion"): PodDeletionSpec,
    ("DriverUpgradePolicySpec", "wait_for_completion"): WaitForCompletionSpec,
    ("DriverUpgradePolicySpec", "drain_spec"): DrainSpec,
    ("DrainSpec", "eviction_escalation"): EvictionEscalationSpec,
    ("TPUUpgradePolicySpec", "pod_deletion"): PodDeletionSpec,
    ("TPUUpgradePolicySpec", "wait_for_completion"): WaitForCompletionSpec,
    ("TPUUpgradePolicySpec", "drain_spec"): DrainSpec,
    ("TPUUpgradePolicySpec", "topology"): SliceTopologySpec,
    ("TPUUpgradePolicySpec", "health_gate"): SliceHealthGateSpec,
    ("TPUUpgradePolicySpec", "slice_quarantine"): SliceQuarantineSpec,
    ("TPUUpgradePolicySpec", "elastic"): ElasticCoordinationSpec,
    ("TPUUpgradePolicySpec", "planning"): PlanningSpec,
    ("TPUUpgradePolicySpec", "federation"): FederationSpec,
    ("FederationSpec", "canary"): FederationCanarySpec,
    ("TPUUpgradePolicySpec", "artifacts"): ArtifactDAGSpec,
    # List-of-nested: from_dict maps each element through the type.
    ("TPUUpgradePolicySpec", "pools"): PoolSpec,
    ("FederationSpec", "clusters"): FederationClusterSpec,
    ("ArtifactDAGSpec", "items"): ArtifactSpec,
    ("ArtifactDAGSpec", "edges"): ArtifactEdgeSpec,
    ("PoolSpec", "maintenance_window"): MaintenanceWindowSpec,
}
