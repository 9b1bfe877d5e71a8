"""Flight recorder: a ring of recent facts + black-box dumps on failure.

Aviation-style black box for the controller: a fixed-size in-memory
ring buffer absorbs a cheap note per interesting fact (informer deltas,
admission decisions, budget verdicts, API errors, span openings), and a
*trigger* — stuck-detector fire, ``fleet_roll_infeasible``, quarantine,
circuit-open, crash-adoption — freezes the ring together with the
active span tree, informer cache ages, and ledger state into one
redacted JSON snapshot on a bounded on-disk spool.

Contracts:

- ``note()`` is O(1) and fail-open — it can run on the reconcile hot
  path with tracing's < 5% overhead budget.
- Dumps are throttled per trigger reason so an event storm (every tick
  re-fires infeasibility) cannot write the disk full; the spool itself
  enforces a total byte cap by deleting oldest-first.
- Snapshots are redacted: values under secret-shaped keys (token,
  secret, password, authorization, bearer) are replaced before
  anything touches disk.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.consts import get_logger

logger = get_logger(__name__)

DEFAULT_RING_CAPACITY = 512
DEFAULT_SPOOL_CAP_BYTES = 4 * 1024 * 1024
DEFAULT_THROTTLE_S = 60.0

# Trigger reasons (metrics label values; free-form reasons also work).
TRIGGER_STUCK = "stuck"
TRIGGER_INFEASIBLE = "infeasible"
TRIGGER_QUARANTINE = "quarantine"
TRIGGER_CIRCUIT_OPEN = "circuit_open"
TRIGGER_ADOPTION = "adoption"

_SECRET_MARKERS = ("token", "secret", "password", "authorization", "bearer")
_REDACTED = "[REDACTED]"


def redact(obj):
    """Recursively replace values under secret-shaped keys."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            key = str(k)
            lowered = key.lower()
            if any(m in lowered for m in _SECRET_MARKERS):
                out[key] = _REDACTED
            else:
                out[key] = redact(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [redact(v) for v in obj]
    return obj


class FlightRecorder:
    """Bounded ring + throttled, byte-capped black-box spool.

    ``snapshot_providers`` is a name → zero-arg callable map; each is
    invoked (fail-open) at dump time so the snapshot always reflects
    the moment of the trigger, not construction time.  The trace
    recorder, informer, and budget ledger register themselves here.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_RING_CAPACITY,
        spool_dir: Optional[str] = None,
        spool_cap_bytes: int = DEFAULT_SPOOL_CAP_BYTES,
        throttle_s: float = DEFAULT_THROTTLE_S,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self._ring: deque = deque(maxlen=max(1, capacity))
        self.spool_dir = spool_dir
        self.spool_cap_bytes = spool_cap_bytes
        self.throttle_s = throttle_s
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._last_dump: dict[str, float] = {}
        self._seq = 0
        self.snapshot_providers: dict[str, Callable[[], object]] = {}
        # Counters (exported via metrics.observe_trace).
        self.dumps_total: dict[str, int] = {}
        self.throttled_total = 0
        self.note_drops = 0

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------

    def note(self, kind: str, **fields) -> None:
        """Append one fact to the ring.  O(1), lock-lite, fail-open."""
        try:
            entry = {"t": round(time.time(), 3), "kind": kind}
            if fields:
                entry.update(fields)
            self._ring.append(entry)
        except Exception:  # noqa: BLE001 — observe-only
            self.note_drops += 1

    # ------------------------------------------------------------------
    # triggers
    # ------------------------------------------------------------------

    def trigger(self, reason: str, **context) -> Optional[str]:
        """Dump a black-box snapshot for ``reason`` unless throttled.
        Returns the spool path written, or None."""
        try:
            now = self._clock()
            with self._lock:
                last = self._last_dump.get(reason)
                if last is not None and now - last < self.throttle_s:
                    self.throttled_total += 1
                    return None
                self._last_dump[reason] = now
                self._seq += 1
                seq = self._seq
            snapshot = self._build_snapshot(reason, context)
            path = self._spool_write(reason, seq, snapshot)
            with self._lock:
                self.dumps_total[reason] = (
                    self.dumps_total.get(reason, 0) + 1
                )
            return path
        except Exception as e:  # noqa: BLE001 — a failing black box
            # must never take down the flight it was recording.
            logger.debug("flight recorder trigger(%s) failed: %s", reason, e)
            return None

    def _build_snapshot(self, reason: str, context: dict) -> dict:
        snapshot = {
            "reason": reason,
            "at_epoch": round(time.time(), 3),
            "context": context,
            "ring": list(self._ring),
        }
        for name, provider in list(self.snapshot_providers.items()):
            try:
                snapshot[name] = provider()
            except Exception as e:  # noqa: BLE001 — partial snapshots
                # beat no snapshot
                snapshot[name] = {"error": str(e)}
        return redact(snapshot)

    # ------------------------------------------------------------------
    # spool
    # ------------------------------------------------------------------

    def _spool_write(self, reason: str, seq: int, snapshot: dict) -> Optional[str]:
        if not self.spool_dir:
            return None
        os.makedirs(self.spool_dir, exist_ok=True)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in reason
        )
        name = f"blackbox-{int(time.time())}-{seq:06d}-{safe_reason}.json"
        path = os.path.join(self.spool_dir, name)
        data = json.dumps(snapshot, default=str, separators=(",", ":"))
        encoded = data.encode("utf-8", errors="replace")
        if len(encoded) > self.spool_cap_bytes:
            # One snapshot larger than the whole spool: shed the ring
            # (the bulkiest section) and keep the structural parts.
            snapshot = dict(snapshot)
            snapshot["ring"] = [
                {"dropped": "ring shed: snapshot exceeded spool cap"}
            ]
            encoded = json.dumps(
                snapshot, default=str, separators=(",", ":")
            ).encode("utf-8", errors="replace")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(encoded)
        os.replace(tmp, path)
        self._enforce_spool_cap()
        return path

    def _enforce_spool_cap(self) -> None:
        """Delete oldest dumps until the spool fits its byte cap."""
        try:
            entries = []
            for name in os.listdir(self.spool_dir):
                if not name.startswith("blackbox-"):
                    continue
                full = os.path.join(self.spool_dir, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append((st.st_mtime, name, full, st.st_size))
            entries.sort()
            total = sum(size for (_, _, _, size) in entries)
            while entries and total > self.spool_cap_bytes:
                _, _, full, size = entries.pop(0)
                try:
                    os.remove(full)
                    total -= size
                except OSError:
                    break
        except Exception as e:  # noqa: BLE001 — cap enforcement is
            # best-effort; a failure here only risks spool growth.
            logger.debug("flight recorder spool cap enforcement: %s", e)

    def spool_bytes(self) -> int:
        """Current spool footprint (bench/metrics)."""
        if not self.spool_dir or not os.path.isdir(self.spool_dir):
            return 0
        total = 0
        try:
            for name in os.listdir(self.spool_dir):
                if not name.startswith("blackbox-"):
                    continue
                try:
                    total += os.stat(
                        os.path.join(self.spool_dir, name)
                    ).st_size
                except OSError:
                    continue
        except OSError:
            return total
        return total

    def spool_files(self) -> list[str]:
        if not self.spool_dir or not os.path.isdir(self.spool_dir):
            return []
        return sorted(
            os.path.join(self.spool_dir, n)
            for n in os.listdir(self.spool_dir)
            if n.startswith("blackbox-") and n.endswith(".json")
        )

    def ring_size(self) -> int:
        return len(self._ring)
