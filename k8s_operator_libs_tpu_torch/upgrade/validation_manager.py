"""The prober verdict type the upgrade engine consumes.

A copy of ``k8s_operator_libs_tpu.upgrade.validation_manager.ProbeResult``:
the engine's ``ValidationManager`` reads ``healthy``, ``detail`` and
``telemetry`` by name, so a port prober plugs into the unchanged engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ProbeResult:
    healthy: bool
    detail: str = ""
    # Measured side-channel telemetry per node ({node name: {stat:
    # value}}).  Observability only: the verdict above is the gate.
    telemetry: Optional[dict] = None
