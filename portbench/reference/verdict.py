"""What a node's validation gate should decide, from the report on the
node and what the benchmark knows of the node.

A report passes when it is for the revision the gate asks for, was made
in the last ``max_age_s`` seconds, enumerates the node's GPUs, carries
every check the battery runs and every check passed.  The battery's own
rows are judged against :mod:`reference.battery` apart: here ``failing``
names the checks whose rows were wrong, which the report must fail, and
every other check must pass.
"""

from __future__ import annotations

import json
import time
from typing import Optional

# The checks a node's battery reports, in order.
BATTERY_CHECKS = ("device_enumeration", "mxu_matmul", "hbm_bandwidth",
                  "ici_allreduce", "ici_ring")
DEEP_CHECK = "ici_ring_attention"


def expected_checks(deep: bool) -> tuple:
    return BATTERY_CHECKS + ((DEEP_CHECK,) if deep else ())


def report_faults(raw: Optional[str], gpus: int, deep: bool,
                  failing: set) -> list[str]:
    """What is wrong with a report as a report: its check names and
    verdicts against the battery's, and its device count."""
    if not raw:
        return ["no report"]
    try:
        rep = json.loads(raw)
        names = tuple(str(c["name"]) for c in rep["checks"])
        oks = [bool(c["ok"]) for c in rep["checks"]]
        devices = int(rep["devices"])
    except (ValueError, KeyError, TypeError) as e:
        return [f"malformed report: {e}"]
    faults = []
    if names != expected_checks(deep):
        faults.append(f"checks {names}")
    want = [name not in failing for name in names]
    if oks != want:
        faults.append(f"check verdicts {oks}, want {want}")
    if devices != gpus:
        faults.append(f"devices {devices} for {gpus}")
    return faults


def verdict(raw: Optional[str], required_revision: str, gpus: int,
            deep: bool, failing: set, max_age_s: float,
            now: Optional[float] = None) -> bool:
    """Whether the gate should pass the node on this report."""
    if not raw:
        return False
    try:
        rep = json.loads(raw)
    except ValueError:
        return False
    if str(rep.get("revision", "")) != required_revision:
        return False
    now = time.time() if now is None else now
    if now - float(rep.get("ts", 0.0)) > max_age_s:
        return False
    return not failing and not report_faults(raw, gpus, deep, failing)
