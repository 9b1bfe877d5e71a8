"""What the layer metrics' readers share: the program's own spans
(``harness/program.py``) in the window, by name, by parent and by
request, and its counters.  Each returns None where the run holds no
program spans."""

from __future__ import annotations

from typing import Optional

import numpy as np

from harness import work
from harness.readers import gates_ms
from harness.trace import kernel_seconds


def window_records(run, prefix: str) -> Optional[list]:
    """``(index, record)`` of the program's closed spans whose name
    starts with ``prefix`` and that ended inside the window; None
    without program spans."""
    spans = run.facts.get("program_spans")
    if not spans:
        return None
    return [(i, r) for i, r in enumerate(spans)
            if r[0].startswith(prefix) and r[2] is not None
            and run.in_window(r[2] / 1e9)]


def _ms(rec) -> float:
    return (rec[2] - rec[1]) / 1e6


def api_ms_per_gate(run) -> Optional[float]:
    """Milliseconds of ``k8s.*`` spans in the window over its gates."""
    calls = window_records(run, "k8s.")
    gates = gates_ms(run)
    if not calls or not gates:
        return None
    return sum(_ms(r) for _, r in calls) / len(gates)


def battery_host_ms(run) -> Optional[float]:
    """The mean of ``battery.fused`` less its ``fused.readback``: the
    battery's host time but for its wait on the card."""
    batteries = window_records(run, "battery.fused")
    if not batteries:
        return None
    spans = run.facts["program_spans"]
    readback: dict = {}
    for r in spans:
        if r[0] == "fused.readback" and r[2] is not None:
            readback[r[3]] = readback.get(r[3], 0.0) + _ms(r)
    return float(np.mean([_ms(r) - readback.get(i, 0.0)
                          for i, r in batteries]))


def k1_roofline_pct(run) -> Optional[float]:
    """K1's bytes in the window over the HBM bandwidth, over the device
    seconds of its launches (``stream_increment`` kernels) in the trace.
    The window's bytes are its batteries times the bytes a battery
    counts (``k1.bytes`` over ``fused.batteries``)."""
    t = run.device_trace
    counters = run.facts.get("program_counters") or {}
    batteries = window_records(run, "battery.fused")
    peak = work.peaks(run.facts.get("device_kind", ""))
    if (not t or not batteries or peak is None
            or not counters.get("k1.bytes") or not counters.get(
                "fused.batteries")):
        return None
    secs = kernel_seconds(t["by_name"], ("stream_increment",))
    if secs <= 0:
        return None
    nbytes = (counters["k1.bytes"] / counters["fused.batteries"]
              * len(batteries))
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / secs


def api_ms_per_pass(run) -> Optional[float]:
    """Milliseconds of ``k8s.*`` spans in the engine's passes (the
    requests its ``engine.build_state`` spans open) over the window's
    passes."""
    passes = window_records(run, "engine.build_state")
    if not passes:
        return None
    ids = {r[4] for _, r in passes}
    calls = window_records(run, "k8s.") or []
    return sum(_ms(r) for _, r in calls if r[4] in ids) / len(passes)
