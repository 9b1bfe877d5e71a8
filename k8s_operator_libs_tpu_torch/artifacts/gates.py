"""Per-artifact validation gates inside the drain window.

Counterpart of ``k8s_operator_libs_tpu.artifacts.gates``.  A
``network-path`` gated artifact (the network driver) may not be counted
synced, and the stack may not advance past its restart step, until the
data paths it owns are back: the cross-host world and every link of the
host's GPU ring, the fused battery's network-path checks
(:func:`k8s_operator_libs_tpu_torch.health.fused.run_network_path_checks`).

The engine consults any object with ``probe(group, artifact_name)``
returning ``.passed`` and ``.detail``.  Verdicts are in memory only: a
restarted controller probes again, the safe direction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger

logger = get_logger(__name__)


@dataclass
class GateResult:
    """Verdict of one artifact gate probe."""

    passed: bool
    detail: str = ""
    # Per-check name -> ok, for events/metrics.
    checks: dict[str, bool] = field(default_factory=dict)


class NetworkPathGateProber:
    """Gate prober backed by the fused battery's network-path checks.

    ``runner`` is injected for tests; the default imports
    :mod:`~k8s_operator_libs_tpu_torch.health.fused` (and with it torch)
    only when it first probes, and runs on every CUDA device of the
    host."""

    def __init__(self, runner=None, expected_processes: Optional[int] = None):
        self._runner = runner
        self._expected_processes = expected_processes

    def _run(self):
        if self._runner is not None:
            return self._runner()
        from k8s_operator_libs_tpu_torch.health.fused import (
            run_network_path_checks,
        )
        from k8s_operator_libs_tpu_torch.health.probes import cuda_devices

        return run_network_path_checks(
            cuda_devices(), expected_processes=self._expected_processes
        )

    def probe(self, group, artifact_name: str) -> GateResult:
        """Fail-closed: an infrastructure fault is a gate not passed (the
        stack holds at this step and probes again next pass), never a
        pass."""
        try:
            results = list(self._run())
        except Exception as e:  # noqa: BLE001 — hold the gate, don't crash
            logger.warning(
                "network-path gate probe for artifact %s of group %s "
                "failed to run: %s",
                artifact_name,
                getattr(group, "id", group),
                e,
            )
            return GateResult(False, f"probe error: {e}")
        checks = {r.name: bool(r.ok) for r in results}
        failed = [r for r in results if not r.ok]
        if failed:
            return GateResult(
                False,
                "; ".join(f"{r.name}: {r.detail}" for r in failed),
                checks,
            )
        return GateResult(True, ", ".join(sorted(checks)) + " verified", checks)
