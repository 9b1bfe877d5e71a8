"""What the metric readers share: means of spans, percentiles, the
canary's steps in the window and the trace's numbers."""

from __future__ import annotations

from typing import Optional

import numpy as np

from harness import work
from harness.trace import busy_within, kernel_seconds


def mean_span_ms(run, name: str) -> Optional[float]:
    spans = run.window_spans(name)
    if not spans:
        return None
    return float(np.mean([e - s for s, e in spans])) * 1e3


def gates_ms(run) -> list:
    """Every gate completed in the window, in milliseconds."""
    w0, w1 = run.window
    return [(e - s) * 1e3 for s, e in run.facts.get("gates", ())
            if s >= w0 and e <= w1]


def window_steps(run) -> list:
    w0, w1 = run.window
    return [t for t in run.facts.get("canary_steps", ()) if w0 <= t <= w1]


def median_step_s(run) -> Optional[float]:
    steps = window_steps(run)
    if len(steps) < 2:
        return None
    return float(np.median(np.diff(steps)))


def idle_pct(run) -> Optional[float]:
    t = run.device_trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def collective_ms_per_gate(run) -> Optional[float]:
    t = run.device_trace
    gates = run.facts.get("gates", [])
    if not t or not gates:
        return None
    secs = kernel_seconds(t["by_name"], ("peer_reduce", "peer_gather"))
    if secs <= 0:
        return None
    return secs / len(gates) * 1e3


def battery_roofline_pct(run) -> Optional[float]:
    """The least time the window's batteries need over the device time
    inside their spans, summed over the cell's cards."""
    t = run.device_trace
    spans = run.window_spans("battery")
    peak = work.peaks(run.facts.get("device_kind", ""))
    if not t or not spans or peak is None:
        return None
    busy = busy_within(t["unions"], t["offset_ns"], spans)
    if busy <= 0:
        return None
    cfg = run.config
    b = cfg["battery"]
    w = work.battery_work(cfg["gpus"], b["matmul_n"], b["hbm_mib"],
                          b["allreduce_elems"])
    least = work.least_time_s(w, peak)
    if run.traffic.get("deep"):
        least += work.least_time_s(work.deep_probe_work(cfg["gpus"]), peak)
    return 100.0 * len(spans) * least / busy


def canary_mfu_pct(run) -> Optional[float]:
    dt = median_step_s(run)
    peak = work.peaks(run.facts.get("device_kind", ""))
    prec = run.facts.get("canary_matmul_precision")
    if dt is None or peak is None or prec not in peak["flops_per_s"]:
        return None
    c = run.facts["canary_cfg"]
    flops = work.canary_flops_per_step(
        c["vocab"], c["d_model"], c["n_heads"], c["n_layers"], c["d_ff"],
        c["seq_len"], c["batch"])
    return 100.0 * flops / dt / peak["flops_per_s"][prec]
