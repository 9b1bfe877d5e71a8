"""What a run records, and what every metric reader reads.

A :class:`Run` holds the benchmark's own spans (host-clock intervals
around calls into the port's layers), its counters, the window's bounds
and, in a traced run, the reduced device trace.  Spans are kept in
memory and read after the window; in a traced run the trace reader
also uses them to say what the host was doing while the device idled.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Run:
    """One run of one cell."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    # name -> [(start, end)] in time.perf_counter() seconds.
    spans: dict = field(default_factory=lambda: defaultdict(list))
    # The measured window, perf_counter seconds.
    window: tuple = (0.0, 0.0)
    # What the loop hands the metric readers (gates, steps, rolls...).
    facts: dict = field(default_factory=dict)
    # The reduced device trace (harness.trace.reduce_trace), traced runs.
    device_trace: Optional[dict] = None
    spans_on: bool = False
    # (phase, perf_counter second it ended) of the set-up.
    phases: list = field(default_factory=list)
    # (object, attribute, original) of every spy the loop set.
    patched: list = field(default_factory=list)

    def patch(self, obj, name: str, value) -> None:
        """Set ``obj.name`` to ``value`` (a spy) until :meth:`unpatch`."""
        self.patched.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def unpatch(self) -> None:
        """Put back what :meth:`patch` replaced, newest first."""
        while self.patched:
            obj, name, original = self.patched.pop()
            setattr(obj, name, original)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed on standard error)."""
        self.phases.append((name, time.perf_counter()))

    @contextlib.contextmanager
    def span(self, name: str):
        """Record ``name`` around the block when spans are on."""
        if not self.spans_on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.perf_counter()))

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t <= self.window[1]

    def window_spans(self, name: str) -> list:
        """The spans of ``name`` that ended inside the window."""
        return [s for s in self.spans.get(name, ()) if self.in_window(s[1])]
