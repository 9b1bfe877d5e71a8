"""Controller-side health probers.

Counterpart of ``k8s_operator_libs_tpu.health.slice_prober``.  Both
classes implement the ``SliceProber`` protocol of the upgrade engine's
``ValidationManager`` (``probe(group) -> ProbeResult``):

- :class:`LocalDeviceProber` runs the battery in-process on the local
  GPUs (single-host path);
- :class:`NodeReportProber` aggregates the ``HealthReport`` annotation
  each node's agent publishes into one group verdict, with the JAX
  package's rejection strings.

Groups are duck-typed: ``.id``, ``.nodes`` (each with ``.name``,
``.annotations`` and, optionally, ``.labels``), ``.members`` (each with
``.driver_daemon_set``), ``.slice_info`` (None, or with ``.host_chips()``,
``.chips``, ``.accelerator`` and ``.dcn_group``) and ``.size()``.

The engine builds ``slice_info`` only from TPU labels, so every GPU node
reaches the gate as a singleton group without one.  For such a group the
accelerator and the device count come from each node's own labels
(``fleet.profiles.node_accelerator``, the engine's own reader, and
``fleet.profiles.GPU_COUNT_LABELS``), and the count
check and the generation's floors apply per node; a node without them
is unknown and nothing is enforced, as for an unknown accelerator.  Its
DCN ring comes from ``fleet.profiles.group_dcn_group`` (the node's
``keys.dcn_group_label``, then its JobSet), so ``require_dcn_check``
holds a GPU node of a ring to a report with a DCN check.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    GPU_COUNT_LABELS,
    _node_label,
    generation_profile,
    group_dcn_group,
    node_accelerator,
)
from k8s_operator_libs_tpu_torch.health.probes import run_host_probe
from k8s_operator_libs_tpu_torch.health.report import (
    HealthReport,
    measured_node_stats,
)
from k8s_operator_libs_tpu_torch.layers import layer_span, spanned
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys
from k8s_operator_libs_tpu_torch.upgrade.validation_manager import ProbeResult

logger = get_logger(__name__)

# A report older than this can't validate: the driver pod restarted more
# recently than the probe ran, or the agent is wedged.
DEFAULT_MAX_REPORT_AGE_S = 600.0

class LocalDeviceProber:
    """Run the probe battery in-process on locally-visible devices."""

    # Real device work: ValidationManager dispatches this prober to a
    # worker thread so the battery never blocks a reconcile tick.
    async_probe = True

    def __init__(
        self,
        devices: Optional[Sequence[torch.device]] = None,
        expected_devices: int = 0,
        matmul_n: int = 4096,
        hbm_mib: int = 1024,
        allreduce_elems: int = 1 << 20,
        fused: Optional[bool] = None,
    ) -> None:
        self.devices = list(devices) if devices is not None else None
        self.expected_devices = expected_devices
        self.matmul_n = matmul_n
        self.hbm_mib = hbm_mib
        self.allreduce_elems = allreduce_elems
        self.fused = fused

    def probe(self, group) -> ProbeResult:
        checks = run_host_probe(
            self.devices,
            expected_devices=self.expected_devices,
            matmul_n=self.matmul_n,
            hbm_mib=self.hbm_mib,
            allreduce_elems=self.allreduce_elems,
            fused=self.fused,
        )
        # The battery ran once in-process, so every member host gets the
        # same telemetry sample.
        stats = measured_node_stats(checks)
        telemetry = (
            {n.name: dict(stats) for n in group.nodes} if stats else None
        )
        failed = [c for c in checks if not c.ok]
        if failed:
            detail = "; ".join(f"{c.name}: {c.detail}" for c in failed)
            logger.info("group %s local probe failed: %s", group.id, detail)
            return ProbeResult(False, detail, telemetry=telemetry)
        return ProbeResult(
            True,
            f"all {len(checks)} local device checks passed",
            telemetry=telemetry,
        )


def expected_chips_per_host(group, node=None) -> int:
    """Devices each host of this group should enumerate (0 = unknown,
    don't enforce): the slice's, else ``node``'s GPU count label."""
    if group.slice_info is not None:
        return group.slice_info.host_chips()
    raw = _node_label(node, GPU_COUNT_LABELS)
    return int(raw) if raw.isdigit() else 0


class NodeReportProber:
    """Aggregate per-host HealthReport annotations into a group verdict."""

    def __init__(
        self,
        keys: UpgradeKeys,
        max_report_age_s: float = DEFAULT_MAX_REPORT_AGE_S,
        # Resolves the driver revision a report must match.
        revision_resolver=None,
        # Optional floors on reported HBM / all-reduce bus bandwidth;
        # 0 disables (enumeration and correctness checks still apply).
        min_hbm_gbps: float = 0.0,
        min_ici_busbw_gbps: float = 0.0,
        # When > 0 and no explicit min_hbm_gbps is given, derive the HBM
        # floor as this fraction of the group's accelerator spec.
        hbm_floor_fraction: float = 0.0,
        # Resolve floors from the GenerationProfile registry when no
        # explicit value is configured.
        generation_floors: bool = False,
    ) -> None:
        self.keys = keys
        self.max_report_age_s = max_report_age_s
        self.revision_resolver = revision_resolver
        self.min_hbm_gbps = min_hbm_gbps
        self.min_ici_busbw_gbps = min_ici_busbw_gbps
        self.hbm_floor_fraction = hbm_floor_fraction
        self.generation_floors = generation_floors
        # Pushed from the policy's health gate by the engine: reject
        # reports that carry no DCN check for groups in a DCN group.
        self.require_dcn_check = False

    def _required_revision(self, group) -> str:
        if self.revision_resolver is None:
            return ""
        for member in group.members:
            if member.driver_daemon_set is not None:
                return self.revision_resolver(member.driver_daemon_set) or ""
        return ""

    def _group_profile(self, group, node=None):
        """The GenerationProfile of the group's slice, else of ``node``'s
        accelerator label, or None."""
        if group.slice_info is not None:
            return generation_profile(group.slice_info.accelerator)
        return generation_profile(node_accelerator(node))

    def _hbm_floor(self, group, node=None) -> float:
        """Effective HBM floor: explicit wins; else the policy fraction
        (or the profile's own floor under ``generation_floors``)."""
        if self.min_hbm_gbps:
            return self.min_hbm_gbps
        if not self.hbm_floor_fraction and not self.generation_floors:
            return 0.0
        profile = self._group_profile(group, node)
        if profile is None:
            return 0.0
        if self.hbm_floor_fraction:
            return profile.hbm_floor(self.hbm_floor_fraction)
        return profile.hbm_floor()

    def _ici_floor(self, group, node=None) -> float:
        """Effective bus-bandwidth floor: explicit wins; else the
        generation's profile floor under ``generation_floors``."""
        if self.min_ici_busbw_gbps or not self.generation_floors:
            return self.min_ici_busbw_gbps
        profile = self._group_profile(group, node)
        if profile is None:
            return 0.0
        return profile.ici_floor()

    def _check_report(
        self, report: HealthReport, group, required_rev: str,
        now: float, hbm_floor: float = 0.0,
        ici_floor: Optional[float] = None, node=None,
    ) -> Optional[str]:
        """Return a rejection reason, or None if the report is acceptable.

        ``now`` is the staleness reference point (the gate's start time
        when one is recorded: a report must have been fresh when the gate
        opened); ``node`` is the reporting node, whose labels give the
        device count when the group has no slice."""
        if ici_floor is None:
            ici_floor = self.min_ici_busbw_gbps
        if required_rev and report.driver_revision != required_rev:
            return (
                f"report is for driver revision "
                f"{report.driver_revision or '<none>'}, want {required_rev}"
            )
        age = report.age_seconds(now)
        if self.max_report_age_s and age > self.max_report_age_s:
            return f"report is stale ({age:.0f}s old)"
        if not report.checks:
            return "report has no checks"
        failed = report.failed_checks()
        if failed:
            return "; ".join(f"{c.name}: {c.detail}" for c in failed)
        chips = expected_chips_per_host(group, node)
        if report.slice_wide and group.slice_info is not None:
            want = group.slice_info.chips
            if want and report.visible_devices != want:
                return (
                    f"slice-wide probe saw {report.visible_devices} chips, "
                    f"torus has {want}"
                )
        elif chips and report.visible_devices != chips:
            return (
                f"host enumerates {report.visible_devices} chips, "
                f"expected {chips}"
            )
        if (
            self.require_dcn_check
            and group_dcn_group(group, self.keys) is not None
            and not any(
                c.name in ("dcn_collective", "dcn_reachability")
                for c in report.checks
            )
        ):
            return (
                "dcn_check is enabled but the report carries no "
                "dcn_collective/dcn_reachability check (agent not "
                "configured with HEALTH_DCN_GROUP(S)/HEALTH_DCN_PEERS?)"
            )
        for check in report.checks:
            # A check with no measured figure (timing_inconclusive)
            # neither passes nor fails a floor.
            if (
                hbm_floor
                and check.name == "hbm_bandwidth"
                and "gbps" in check.metrics
                and check.metrics["gbps"] < hbm_floor
            ):
                return (
                    f"HBM bandwidth {check.metrics['gbps']:.1f} "
                    f"GB/s below floor {hbm_floor:.1f}"
                )
            if (
                ici_floor
                and check.name == "ici_allreduce"
                and "busbw_gbps" in check.metrics
                and check.metrics["busbw_gbps"] < ici_floor
            ):
                return (
                    f"ICI bus bandwidth "
                    f"{check.metrics['busbw_gbps']:.1f} GB/s below "
                    f"floor {ici_floor:.1f}"
                )
        return None

    @spanned("prober.probe")
    def probe(self, group) -> ProbeResult:
        key = self.keys.health_report_annotation
        start_key = self.keys.validation_start_time_annotation
        required_rev = self._required_revision(group)
        now = time.time()
        # Measured per-node telemetry, kept even on a failing verdict.
        telemetry: dict[str, dict[str, float]] = {}
        for node in group.nodes:
            raw = node.annotations.get(key)
            if not raw:
                return ProbeResult(
                    False,
                    f"no health report from node {node.name}",
                    telemetry=telemetry or None,
                )
            try:
                with layer_span("prober.parse"):
                    report = HealthReport.from_json(raw)
            except ValueError as e:
                return ProbeResult(
                    False,
                    f"node {node.name}: {e}",
                    telemetry=telemetry or None,
                )
            with layer_span("prober.judge"):
                stats = measured_node_stats(report.checks)
                if stats:
                    telemetry[node.name] = stats
                raw_start = node.annotations.get(start_key, "")
                ref = (min(now, float(raw_start)) if raw_start.isdigit()
                       else now)
                reason = self._check_report(
                    report, group, required_rev, ref,
                    self._hbm_floor(group, node),
                    self._ici_floor(group, node), node,
                )
            if reason is not None:
                return ProbeResult(
                    False,
                    f"node {node.name}: {reason}",
                    telemetry=telemetry or None,
                )
        return ProbeResult(
            True,
            f"all {group.size()} host report(s) healthy"
            + (f" @ revision {required_rev}" if required_rev else ""),
            telemetry=telemetry or None,
        )
