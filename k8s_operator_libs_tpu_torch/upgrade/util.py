"""Label/annotation key builder for one managed driver.

A copy of ``k8s_operator_libs_tpu.upgrade.util.UpgradeKeys`` and the key
formats it reads (``k8s_operator_libs_tpu.upgrade.consts``), kept in the
port so the health agent and probers publish and read exactly the keys
the upgrade engine writes, without importing the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

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
UPGRADE_REQUESTED_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-requested"
)
UPGRADE_QUARANTINE_PRIOR_STATE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-quarantine-prior-state"
)
UPGRADE_QUARANTINE_READY_SINCE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-quarantine-ready-since"
)
UPGRADE_QUARANTINE_CYCLE_COUNT_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-quarantine-cycle-count"
)
UPGRADE_TRACE_ANNOTATION_KEY_FMT = "{domain}/{driver}-driver-upgrade-trace"
UPGRADE_TELEMETRY_HISTORY_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-telemetry-history"
)
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
UPGRADE_PREEMPTED_SINCE_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-preempted-since"
)
UPGRADE_WINDOW_WAIT_ANNOTATION_KEY_FMT = (
    "{domain}/{driver}-driver-upgrade-window-wait"
)
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
SLICE_ID_LABEL_KEY_FMT = "{domain}/{driver}-slice-id"
HEALTH_REPORT_ANNOTATION_KEY_FMT = "{domain}/{driver}-health-report"
DCN_GROUP_LABEL_KEY_FMT = "{domain}/{driver}-dcn-group"
CHIPS_PER_HOST_LABEL_KEY_FMT = "{domain}/{driver}-chips-per-host"


@dataclass(frozen=True)
class UpgradeKeys:
    """All label/annotation keys for one managed driver."""

    driver_name: str = "libtpu"
    domain: str = KEY_DOMAIN_DEFAULT

    def _fmt(self, fmt: str) -> str:
        return fmt.format(domain=self.domain, driver=self.driver_name)

    @property
    def state_label(self) -> str:
        return self._fmt(UPGRADE_STATE_LABEL_KEY_FMT)

    @property
    def skip_label(self) -> str:
        return self._fmt(UPGRADE_SKIP_NODE_LABEL_KEY_FMT)

    @property
    def safe_load_annotation(self) -> str:
        return self._fmt(UPGRADE_WAIT_FOR_SAFE_DRIVER_LOAD_ANNOTATION_KEY_FMT)

    @property
    def initial_state_annotation(self) -> str:
        return self._fmt(UPGRADE_INITIAL_STATE_ANNOTATION_KEY_FMT)

    @property
    def pod_completion_start_time_annotation(self) -> str:
        return self._fmt(
            UPGRADE_WAIT_FOR_POD_COMPLETION_START_TIME_ANNOTATION_KEY_FMT
        )

    @property
    def validation_start_time_annotation(self) -> str:
        return self._fmt(UPGRADE_VALIDATION_START_TIME_ANNOTATION_KEY_FMT)

    @property
    def upgrade_requested_annotation(self) -> str:
        return self._fmt(UPGRADE_REQUESTED_ANNOTATION_KEY_FMT)

    @property
    def quarantine_prior_state_annotation(self) -> str:
        return self._fmt(UPGRADE_QUARANTINE_PRIOR_STATE_ANNOTATION_KEY_FMT)

    @property
    def quarantine_ready_since_annotation(self) -> str:
        return self._fmt(UPGRADE_QUARANTINE_READY_SINCE_ANNOTATION_KEY_FMT)

    @property
    def quarantine_cycle_count_annotation(self) -> str:
        return self._fmt(UPGRADE_QUARANTINE_CYCLE_COUNT_ANNOTATION_KEY_FMT)

    @property
    def elastic_workload_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_WORKLOAD_ANNOTATION_KEY_FMT)

    @property
    def elastic_offer_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_OFFER_ANNOTATION_KEY_FMT)

    @property
    def elastic_response_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_RESPONSE_ANNOTATION_KEY_FMT)

    @property
    def elastic_resize_complete_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_RESIZE_COMPLETE_ANNOTATION_KEY_FMT)

    @property
    def elastic_excluded_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_EXCLUDED_ANNOTATION_KEY_FMT)

    @property
    def elastic_rejoin_offer_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_REJOIN_OFFER_ANNOTATION_KEY_FMT)

    @property
    def elastic_rejoin_complete_annotation(self) -> str:
        return self._fmt(UPGRADE_ELASTIC_REJOIN_COMPLETE_ANNOTATION_KEY_FMT)

    @property
    def preempted_since_annotation(self) -> str:
        return self._fmt(UPGRADE_PREEMPTED_SINCE_ANNOTATION_KEY_FMT)

    @property
    def window_wait_annotation(self) -> str:
        return self._fmt(UPGRADE_WINDOW_WAIT_ANNOTATION_KEY_FMT)

    @property
    def eviction_rung_annotation(self) -> str:
        return self._fmt(UPGRADE_EVICTION_RUNG_ANNOTATION_KEY_FMT)

    @property
    def eviction_rung_since_annotation(self) -> str:
        return self._fmt(UPGRADE_EVICTION_RUNG_SINCE_ANNOTATION_KEY_FMT)

    @property
    def rollback_attempts_annotation(self) -> str:
        return self._fmt(UPGRADE_ROLLBACK_ATTEMPTS_ANNOTATION_KEY_FMT)

    @property
    def rollback_last_attempt_annotation(self) -> str:
        return self._fmt(UPGRADE_ROLLBACK_LAST_ATTEMPT_ANNOTATION_KEY_FMT)

    @property
    def recovery_probe_since_annotation(self) -> str:
        return self._fmt(UPGRADE_RECOVERY_PROBE_SINCE_ANNOTATION_KEY_FMT)

    @property
    def adopted_by_annotation(self) -> str:
        return self._fmt(UPGRADE_ADOPTED_BY_ANNOTATION_KEY_FMT)

    @property
    def trace_annotation(self) -> str:
        return self._fmt(UPGRADE_TRACE_ANNOTATION_KEY_FMT)

    @property
    def telemetry_history_annotation(self) -> str:
        return self._fmt(UPGRADE_TELEMETRY_HISTORY_ANNOTATION_KEY_FMT)

    @property
    def slice_id_label(self) -> str:
        return self._fmt(SLICE_ID_LABEL_KEY_FMT)

    @property
    def dcn_group_label(self) -> str:
        return self._fmt(DCN_GROUP_LABEL_KEY_FMT)

    @property
    def chips_per_host_label(self) -> str:
        return self._fmt(CHIPS_PER_HOST_LABEL_KEY_FMT)

    @property
    def health_report_annotation(self) -> str:
        return self._fmt(HEALTH_REPORT_ANNOTATION_KEY_FMT)

    @property
    def event_reason(self) -> str:
        return f"{self.driver_name.upper()}DriverUpgrade"
