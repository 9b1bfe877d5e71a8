"""The device side of a run: the card check, the memory peak and the
profiler's trace, reduced to what the metric readers and the result line
read.

The trace records device activity only (kernels, copies, sets), not the
host's operators, so that tracing a window of many thousands of
launches stays cheap.  The profiler stamps device activity on the wall
clock (nanoseconds since the epoch); the run's spans are on
``time.perf_counter``, and :class:`Trace` keeps the offset between the
two, read when tracing starts.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np


class NoCardError(RuntimeError):
    """The cell's cards are not there; the run prints no result."""


def require_cards(chips: int) -> list:
    """The cell's CUDA devices, or :class:`NoCardError`.  Never the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCardError("no CUDA device: torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    if count < chips:
        raise NoCardError(f"the cell needs {chips} CUDA devices, found {count}")
    return [torch.device("cuda", i) for i in range(chips)]


def device_info(cards: list) -> dict:
    """The result line's ``device``: platform, kind, count and the peak of
    allocated memory on the fullest card."""
    import torch

    if any(c.type != "cuda" for c in cards):
        return {"platform": "cpu", "kind": "cpu", "count": len(cards),
                "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(cards[0]),
        "count": len(cards),
        "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(c)
                                     for c in cards)),
    }


def synchronize(cards: list) -> None:
    import torch

    for c in cards:
        if c.type == "cuda":
            torch.cuda.synchronize(c)


class Trace:
    """``torch.profiler`` over the window, device activity only."""

    def __init__(self, cards: list) -> None:
        import torch

        self.cards = cards
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.offset_ns = 0

    def start(self) -> None:
        self._prof.start()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def stop(self) -> None:
        synchronize(self.cards)
        self._prof.stop()

    def reduce(self, window: tuple, spans: dict) -> dict:
        """Busy intervals per device inside ``window`` (perf_counter
        seconds), the time by operation and the idle time by what the
        host was doing (the innermost run span around each gap)."""
        from torch.autograd import DeviceType

        per_dev: dict = defaultdict(list)
        by_name: dict = defaultdict(float)
        w0 = int(window[0] * 1e9) + self.offset_ns
        w1 = int(window[1] * 1e9) + self.offset_ns
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = ev.start_ns()
            e = s + ev.duration_ns()
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            per_dev[ev.device_index()].append((s, e))
            by_name[ev.name()] += (e - s) / 1e9
        unions = {d: _union(iv) for d, iv in per_dev.items()}
        window_s = (w1 - w0) / 1e9
        n_dev = len(self.cards)
        busy_s = sum(float((u[:, 1] - u[:, 0]).sum()) / 1e9
                     for u in unions.values()) / n_dev
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = self._idle_by_host(unions, w0, w1, spans)
        return {
            "window_s": window_s,
            "busy_s": busy_s,
            "devices": n_dev,
            "unions": unions,
            "by_name": dict(by_name),
            "offset_ns": self.offset_ns,
            "breakdown": {
                "device_ops": [[_short(n), s] for n, s in top],
                "idle_gaps": idle[:10],
            },
        }

    def _idle_by_host(self, unions: dict, w0: int, w1: int,
                      spans: dict) -> list:
        """Seconds during which no device ran, summed by the innermost run
        span that covers each gap's middle ("other host work" when none
        does)."""
        allv = [u for u in unions.values() if len(u)]
        merged = _union(np.concatenate(allv)) if allv else np.zeros((0, 2),
                                                                  np.int64)
        edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        named = []
        for name, ss in spans.items():
            for s, e in ss:
                named.append((int(s * 1e9) + self.offset_ns,
                              int(e * 1e9) + self.offset_ns, name))
        named.sort()
        starts = np.array([n[0] for n in named], dtype=np.int64)
        out: dict = defaultdict(float)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            best, best_len = "other host work", None
            hi = int(np.searchsorted(starts, mid, side="right"))
            for s, e, name in named[max(0, hi - 64):hi]:
                if s <= mid <= e and (best_len is None or e - s < best_len):
                    best, best_len = name, e - s
            out[best] += (g1 - g0) / 1e9
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])]


def _union(intervals) -> np.ndarray:
    """Sorted, merged ``[start, end]`` rows (int64 nanoseconds)."""
    a = np.asarray(intervals, dtype=np.int64).reshape(-1, 2)
    if not len(a):
        return a
    a = a[np.argsort(a[:, 0], kind="stable")]
    ends = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:, 0] > ends[:-1]
    idx = np.flatnonzero(new)
    starts = a[idx, 0]
    last = np.append(idx[1:] - 1, len(a) - 1)
    return np.stack([starts, ends[last]], axis=1)


def busy_within(unions: dict, offset_ns: int, spans: list) -> float:
    """Device-busy seconds, summed over devices, inside the given
    perf_counter ``spans``."""
    if not spans:
        return 0.0
    sp = _union([(int(s * 1e9) + offset_ns, int(e * 1e9) + offset_ns)
                 for s, e in spans])
    total = 0
    for u in unions.values():
        for s, e in sp:
            lo = np.searchsorted(u[:, 1], s, side="right")
            hi = np.searchsorted(u[:, 0], e, side="left")
            if hi > lo:
                seg = u[lo:hi]
                total += int((np.minimum(seg[:, 1], e)
                              - np.maximum(seg[:, 0], s)).clip(min=0).sum())
    return total / 1e9


def kernel_seconds(by_name: dict, needles: tuple) -> float:
    """Device seconds of the operations whose name holds any needle."""
    return sum(s for n, s in by_name.items() if any(k in n for k in needles))


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."
