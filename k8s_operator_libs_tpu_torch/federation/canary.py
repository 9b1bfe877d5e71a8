"""Telemetry-gated regional canary soak.

The first region rolls alone; promotion to the remaining regions
requires the fleet-health baselines (``obs/telemetry.py`` /
``obs/baseline.py``) to stay CLEAN for a configurable soak window.  A
straggler confirmed by the telemetry plane during the soak — the same
``confirm_batteries``-deep longitudinal verdict the engine's health
gate uses — hard-stops promotion: the gate latches ``held`` with the
regression's node/stat/z and the roll's trace id, and only an explicit
operator ``clear_hold`` (or a fresh roll) releases it.

Crash durability: the soak start is persisted as an epoch by the
coordinator's durable store and rebased onto the process monotonic
clock on adoption via :func:`~k8s_operator_libs_tpu_torch.upgrade.durable.
monotonic_from_epoch` — the same annotation-anchored rebase every
engine progress clock uses — so a restarted coordinator resumes the
soak AT its elapsed point instead of restarting it (a crash can only
lengthen a soak, never shorten it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.upgrade.durable import monotonic_from_epoch

logger = get_logger(__name__)

# Gate phases.
PENDING = "pending"  # canary region still rolling
SOAKING = "soaking"  # canary done, baselines under observation
HELD = "held"  # regression confirmed: promotion hard-stopped
PROMOTE = "promote"  # soak elapsed clean


@dataclass
class CanaryVerdict:
    phase: str
    reason: str = ""
    trace_id: str = ""
    soak_remaining_s: float = 0.0
    confirmations: List[dict] = field(default_factory=list)


class CanaryGate:
    """Soak clock + telemetry verdict latch for the canary region."""

    def __init__(
        self,
        soak_s: float,
        mono_clock: Callable[[], float] = time.monotonic,
        epoch_clock: Callable[[], float] = time.time,
    ) -> None:
        self.soak_s = max(0.0, float(soak_s))
        self.mono_clock = mono_clock
        self.epoch_clock = epoch_clock
        # Monotonic anchor of the soak start (None = not started) and
        # its durable wall-clock twin (what the store persists).
        self._soak_anchor: Optional[float] = None
        self.soak_started_epoch: Optional[float] = None
        # Latched hold: {"reason", "trace_id", "epoch", "confirmations"}.
        self.held: Optional[dict] = None
        self.holds_total = 0

    # -- soak clock ----------------------------------------------------------

    def begin_soak(self, now_epoch: Optional[float] = None) -> bool:
        """Start the soak (idempotent).  Returns True on the first call
        — the coordinator persists the epoch exactly then."""
        if self._soak_anchor is not None:
            return False
        self._soak_anchor = self.mono_clock()
        self.soak_started_epoch = (
            self.epoch_clock() if now_epoch is None else now_epoch
        )
        return True

    def adopt_soak(
        self, started_epoch: float, now_epoch: Optional[float] = None
    ) -> None:
        """Resume a persisted soak: rebase the wall-clock anchor onto
        this process's monotonic clock (elapsed time survives the
        restart; wall-clock regressions clamp to zero elapsed)."""
        self.soak_started_epoch = started_epoch
        # Pass now_epoch explicitly: monotonic_from_epoch's default
        # truncates to whole seconds, which a sub-second soak anchor
        # cannot afford.
        if now_epoch is None:
            now_epoch = self.epoch_clock()
        self._soak_anchor = monotonic_from_epoch(
            started_epoch, now_epoch=now_epoch
        )

    @property
    def soaking(self) -> bool:
        return self._soak_anchor is not None

    # -- verdicts ------------------------------------------------------------

    def observe_plane(self, plane, trace_id: str = "") -> List[dict]:
        """Fold one telemetry-plane reading into the gate.  Any NEW
        straggler confirmation while the gate is armed latches a hold.
        Returns the fresh confirmations (for event emission)."""
        if plane is None:
            return []
        try:
            plane.recompute()
            fresh = plane.new_confirmations()
        except Exception:
            # The plane is fail-open everywhere else; a broken reading
            # must not silently PROMOTE either — it simply yields no
            # verdict this pass.
            logger.debug("canary telemetry read failed", exc_info=True)
            return []
        if fresh and self.held is None:
            worst = fresh[0]
            self.hold(
                reason=(
                    f"telemetry regression: node {worst.get('node')} "
                    f"{worst.get('worstStat')} z={worst.get('z')} "
                    f"(score {worst.get('score')}, "
                    f"streak {worst.get('streak')})"
                ),
                trace_id=trace_id,
                confirmations=fresh,
            )
        return fresh

    def hold(
        self,
        reason: str,
        trace_id: str = "",
        confirmations: Optional[List[dict]] = None,
    ) -> None:
        if self.held is not None:
            return
        self.held = {
            "reason": reason,
            "trace_id": trace_id,
            "epoch": self.epoch_clock(),
            "confirmations": list(confirmations or []),
        }
        self.holds_total += 1
        logger.warning("canary held: %s (trace %s)", reason, trace_id)

    def clear_hold(self) -> None:
        self.held = None

    def evaluate(self) -> CanaryVerdict:
        if self.held is not None:
            return CanaryVerdict(
                phase=HELD,
                reason=self.held["reason"],
                trace_id=self.held.get("trace_id", ""),
                confirmations=list(self.held.get("confirmations", [])),
            )
        if self._soak_anchor is None:
            return CanaryVerdict(phase=PENDING)
        remaining = self.soak_s - (self.mono_clock() - self._soak_anchor)
        if remaining > 0:
            return CanaryVerdict(phase=SOAKING, soak_remaining_s=remaining)
        return CanaryVerdict(phase=PROMOTE)
