"""The per-host health report and its node-annotation wire format.

Counterpart of ``k8s_operator_libs_tpu.health.report``.  The wire format
is the JAX package's byte for byte, so a report published by the port's
agent parses with either package's ``HealthReport.from_json`` and gates
the same ``NodeReportProber`` logic.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from k8s_operator_libs_tpu_torch.health.probes import CheckResult

# Every check `run_host_probe` can emit, in emission order.
HEALTH_CHECKS_ALL = (
    "device_enumeration",
    "mxu_matmul",
    "hbm_bandwidth",
    "ici_allreduce",
    "ici_ring",
    "ici_ring_attention",
    "dcn_reachability",
)


def _battery_keys(check: CheckResult) -> dict[str, float]:
    return {
        k: v
        for k, v in check.metrics.items()
        if k == "fused" or k.startswith("battery_")
    }


def fused_battery_telemetry(checks) -> dict[str, float]:
    """Battery telemetry carried in fused-check metrics, or {} when the
    report came from the unfused path."""
    for c in checks:
        if c.metrics.get("fused"):
            return _battery_keys(c)
    return {}


def battery_telemetry(checks) -> dict[str, float]:
    """Battery telemetry regardless of which battery ran: the presence
    of the ``fused`` key marks a battery check, its value only says
    which implementation ran."""
    for c in checks:
        if "fused" in c.metrics:
            return _battery_keys(c)
    return {}


def measured_node_stats(checks) -> dict[str, float]:
    """One host's measured side-channel stats across all its checks:
    throughput figures plus the battery timing keys.  Shape-only keys
    are excluded; a timing-inconclusive check contributes nothing."""
    out: dict[str, float] = {}
    for c in checks:
        if c.metrics.get("timing_inconclusive"):
            continue
        for k in ("tflops", "mfu", "gbps", "busbw_gbps"):
            if k in c.metrics:
                out[k] = c.metrics[k]
    out.update(
        {
            k: v
            for k, v in battery_telemetry(checks).items()
            if k.startswith("battery_") and k != "battery_cache_hit"
        }
    )
    return out


@dataclass
class HealthReport:
    """One host's probe outcome, as published to its node annotation."""

    node_name: str = ""
    # ControllerRevision hash of the driver DaemonSet the probe ran under;
    # must match the current DS hash for the report to count.
    driver_revision: str = ""
    checks: list[CheckResult] = field(default_factory=list)
    # Unix seconds when the probe finished.
    timestamp: float = 0.0
    # Devices visible to this host's agent.
    visible_devices: int = 0
    # True when the agent probed the whole multi-host group at once.
    slice_wide: bool = False

    @property
    def healthy(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)

    def failed_checks(self) -> list[CheckResult]:
        return [c for c in self.checks if not c.ok]

    def age_seconds(self, now: float | None = None) -> float:
        return (now if now is not None else time.time()) - self.timestamp

    def to_json(self) -> str:
        return json.dumps(
            {
                "node": self.node_name,
                "revision": self.driver_revision,
                "ts": round(self.timestamp, 3),
                "devices": self.visible_devices,
                "slice_wide": self.slice_wide,
                "checks": [c.as_dict() for c in self.checks],
            },
            separators=(",", ":"),
        )

    @staticmethod
    def from_json(raw: str) -> "HealthReport":
        """Parse an annotation value; raises ValueError on malformed input
        (callers treat that as "no report")."""
        try:
            d = json.loads(raw)
            if not isinstance(d, dict):
                raise ValueError("not an object")
            return HealthReport(
                node_name=str(d.get("node", "")),
                driver_revision=str(d.get("revision", "")),
                timestamp=float(d.get("ts", 0.0)),
                visible_devices=int(d.get("devices", 0)),
                slice_wide=bool(d.get("slice_wide", False)),
                checks=[
                    CheckResult.from_dict(c) for c in d.get("checks", [])
                ],
            )
        except (ValueError, TypeError, AttributeError, KeyError) as e:
            raise ValueError(f"malformed health report: {e}") from e
