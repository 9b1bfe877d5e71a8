"""Programmable fault injection for the fake and wire control planes.

A :class:`FaultSchedule` is a thread-safe list of :class:`FaultRule`\\ s
matched against the verb of each API call ("get_node", "PATCH nodes",
"watch pods", ...).  The same schedule object plugs into both tiers:

* ``FakeCluster.fault_schedule`` — :meth:`FaultSchedule.raise_for` is
  consulted inside ``FakeCluster._call`` and raises the mapped client
  exception (``ThrottledError``, ``ServerError``, ``ConnectionResetError``,
  ``TimeoutError``, ``ConflictError``) before the store mutates, and
  ``watch_events`` ends its stream when a ``watch_drop`` rule fires.
* ``KubeApiServer(fault_schedule=...)`` — the HTTP handler consults
  :meth:`FaultSchedule.decide` per request and synthesizes the wire
  shape of the same fault (429 + ``Retry-After``, 500/503 Status body,
  an RST via ``SO_LINGER``, a stalled response, a dropped chunked watch
  stream).

Rules are matched as case-insensitive substrings so one rule covers the
fake tier's ``patch_node_labels`` and the wire tier's ``PATCH nodes``
(write ``match="patch"``).  Each rule carries an optional probability,
a ``skip`` count (let the first N matching calls through — "the outage
starts mid-roll") and a ``max_hits`` budget ("the outage ends"), which
together express an outage *window* deterministically.
"""

from __future__ import annotations

import random
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["Fault", "FaultRule", "FaultSchedule"]

# Fault kinds understood by both tiers.  ``watch_drop`` is special: it is
# only honored by streaming loops (FakeCluster.watch_events and the wire
# handler's _stream_watch) and ignored by unary call sites, so a
# watch_drop rule's budget is never consumed by regular verbs.
_KINDS = ("throttle", "error", "reset", "timeout", "conflict", "watch_drop")

# Data-plane fault kinds mutate CLUSTER STATE instead of failing the
# matching call: the call succeeds, and as a side effect a node loses
# readiness / flaps / vanishes, or a pod gets stuck Terminating / starts
# crash-looping.  API traffic is their clock — the store applies them
# after each successful verb (FakeCluster._apply_data_plane_faults), so
# both the fake tier and the wire tier (whose handlers route through the
# same store) tick them.  ``decide``/``raise_for`` skip them entirely.
_DATA_PLANE_KINDS = (
    "node_down",
    "node_flap",
    "node_delete",
    "node_preempt",
    "pod_stick",
    "pod_crashloop",
)


@dataclass
class Fault:
    """One injected fault occurrence, as decided for a single call."""

    kind: str
    status: int = 500
    retry_after_s: float = 1.0
    delay_s: float = 0.0
    message: str = "injected fault"
    # Data-plane kinds only: which objects to hit (substring of the node
    # or pod name; empty hits everything) and how hard (restart-count
    # increment for pod_crashloop).
    target: str = ""
    amount: int = 1


@dataclass
class FaultRule:
    """Matches a verb and describes the fault to inject.

    match:        case-insensitive substring of the verb ("patch",
                  "get nodes", "watch", ...).  Empty matches everything.
    kind:         one of ``throttle|error|reset|timeout|conflict|watch_drop``.
    probability:  chance a matching call is faulted (1.0 = always).
    skip:         let this many matching calls through before firing.
    max_hits:     stop firing after this many hits (None = unbounded).
    """

    match: str = ""
    kind: str = "error"
    status: int = 500
    retry_after_s: float = 1.0
    delay_s: float = 0.0
    probability: float = 1.0
    skip: int = 0
    max_hits: Optional[int] = None
    message: str = ""
    target: str = ""
    amount: int = 1
    _seen: int = field(default=0, repr=False)
    _hits: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS and self.kind not in _DATA_PLANE_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{_KINDS + _DATA_PLANE_KINDS}"
            )

    def _matches(self, verb: str) -> bool:
        return self.match.lower() in verb.lower()

    def _decide_locked(self, verb: str, rng: random.Random) -> Optional[Fault]:
        """Called by FaultSchedule under its lock."""
        if not self._matches(verb):
            return None
        if self.max_hits is not None and self._hits >= self.max_hits:
            return None
        self._seen += 1
        if self._seen <= self.skip:
            return None
        if self.probability < 1.0 and rng.random() >= self.probability:
            return None
        self._hits += 1
        return Fault(
            kind=self.kind,
            status=self.status,
            retry_after_s=self.retry_after_s,
            delay_s=self.delay_s,
            message=self.message
            or f"injected {self.kind} for {verb!r} (hit {self._hits})",
            target=self.target,
            amount=self.amount,
        )


class FaultSchedule:
    """Thread-safe ordered rule list; first firing rule wins.

    The fluent methods (:meth:`throttle`, :meth:`server_error`, ...)
    return ``self`` so schedules read like a scenario description::

        schedule = (
            FaultSchedule(seed=7)
            .throttle("patch", retry_after_s=0.01, max_hits=20)
            .server_error("get nodes", skip=30, max_hits=12)
            .watch_drop(max_hits=2)
        )
    """

    def __init__(self, seed: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = []
        self._rng = random.Random(seed)
        #: verb -> number of faults injected for it (for test assertions).
        self.hits: Counter[str] = Counter()
        #: optional hook observing every injected fault (verb, fault).
        self.on_fault: Optional[Callable[[str, Fault], None]] = None

    # -- building ---------------------------------------------------------
    def add(self, rule: FaultRule) -> "FaultSchedule":
        with self._lock:
            self._rules.append(rule)
        return self

    def throttle(
        self,
        match: str = "",
        retry_after_s: float = 1.0,
        **kw,
    ) -> "FaultSchedule":
        """429 with a Retry-After hint (API priority & fairness)."""
        return self.add(
            FaultRule(
                match=match, kind="throttle", status=429,
                retry_after_s=retry_after_s, **kw,
            )
        )

    def server_error(
        self, match: str = "", status: int = 500, **kw
    ) -> "FaultSchedule":
        """500/503-style Status response."""
        return self.add(
            FaultRule(match=match, kind="error", status=status, **kw)
        )

    def connection_reset(self, match: str = "", **kw) -> "FaultSchedule":
        """TCP RST: the connection dies without an HTTP response."""
        return self.add(FaultRule(match=match, kind="reset", **kw))

    def timeout(
        self, match: str = "", delay_s: float = 0.05, **kw
    ) -> "FaultSchedule":
        """The request stalls for ``delay_s`` and then fails client-side."""
        return self.add(
            FaultRule(match=match, kind="timeout", delay_s=delay_s, **kw)
        )

    def conflict(self, match: str = "", **kw) -> "FaultSchedule":
        """Stale-resourceVersion 409 (optimistic-concurrency storm)."""
        return self.add(
            FaultRule(match=match, kind="conflict", status=409, **kw)
        )

    def watch_drop(self, match: str = "watch", **kw) -> "FaultSchedule":
        """Server closes a watch stream mid-flight (client must re-list)."""
        return self.add(FaultRule(match=match, kind="watch_drop", **kw))

    # -- data-plane faults (mutate cluster state, never fail the call) -----

    def node_down(
        self, target: str, match: str = "", **kw
    ) -> "FaultSchedule":
        """Nodes whose name contains ``target`` go NotReady."""
        return self.add(
            FaultRule(match=match, kind="node_down", target=target, **kw)
        )

    def node_flap(
        self, target: str, match: str = "", **kw
    ) -> "FaultSchedule":
        """Toggle readiness of matching nodes on each hit — the
        flapping-kubelet shape the quarantine hysteresis exists for."""
        return self.add(
            FaultRule(match=match, kind="node_flap", target=target, **kw)
        )

    def node_delete(
        self, target: str, match: str = "", **kw
    ) -> "FaultSchedule":
        """Delete matching nodes outright (hardware reclaimed mid-roll)."""
        return self.add(
            FaultRule(match=match, kind="node_delete", target=target, **kw)
        )

    def node_preempt(
        self, target: str, match: str = "", amount: int = 1, **kw
    ) -> "FaultSchedule":
        """Preempt matching nodes: stamp the platform preemption
        annotation and take them NotReady — the spot-VM reclaim signal
        the preemptible fast path handles without quarantine.
        ``amount=0`` instead RETURNS the node (clears the annotation,
        restores readiness), so one schedule can script the full
        preempt/return cycle."""
        return self.add(
            FaultRule(
                match=match, kind="node_preempt", target=target,
                amount=amount, **kw,
            )
        )

    def pod_stick(
        self, target: str, match: str = "", **kw
    ) -> "FaultSchedule":
        """Add a finalizer to matching pods so deletes park them in
        Terminating (what the eviction escalation ladder must clear)."""
        return self.add(
            FaultRule(match=match, kind="pod_stick", target=target, **kw)
        )

    def pod_crashloop(
        self, target: str, match: str = "", amount: int = 1, **kw
    ) -> "FaultSchedule":
        """Matching pods lose container readiness and gain ``amount``
        restarts per hit (CrashLoopBackOff shape)."""
        return self.add(
            FaultRule(
                match=match, kind="pod_crashloop", target=target,
                amount=amount, **kw,
            )
        )

    def clear(self) -> None:
        """Drop every rule — 'the faults clear'."""
        with self._lock:
            self._rules = []

    # -- deciding ---------------------------------------------------------
    def decide(self, verb: str) -> Optional[Fault]:
        """First firing rule's fault for this call, or None.

        Consumes skip/probability/budget state, so call exactly once per
        API call.
        """
        with self._lock:
            fault = None
            for rule in self._rules:
                if rule.kind == "watch_drop":
                    continue  # stream loops consult decide_watch_drop
                if rule.kind in _DATA_PLANE_KINDS:
                    continue  # the store consults decide_data_plane
                fault = rule._decide_locked(verb, self._rng)
                if fault is not None:
                    break
            if fault is not None:
                self.hits[verb] += 1
        if fault is not None and self.on_fault is not None:
            self.on_fault(verb, fault)
        return fault

    def decide_data_plane(self, verb: str) -> list[Fault]:
        """Store entry point: ALL firing data-plane faults for this call.

        Unlike :meth:`decide`, every matching rule fires (a node can go
        down while another pod sticks); unary/watch rules are never
        consulted, so their budgets are untouched."""
        fired: list[Fault] = []
        with self._lock:
            for rule in self._rules:
                if rule.kind not in _DATA_PLANE_KINDS:
                    continue
                fault = rule._decide_locked(verb, self._rng)
                if fault is not None:
                    fired.append(fault)
            if fired:
                self.hits[verb] += len(fired)
        if self.on_fault is not None:
            for fault in fired:
                self.on_fault(verb, fault)
        return fired

    def decide_watch_drop(self, verb: str = "watch") -> Optional[Fault]:
        """Streaming-loop entry point: consult ONLY ``watch_drop`` rules.

        Stream loops poll every heartbeat; going through :meth:`decide`
        would burn unary rules' skip/probability/budget state on every
        poll, so drops get their own path."""
        with self._lock:
            fault = None
            for rule in self._rules:
                if rule.kind != "watch_drop":
                    continue
                fault = rule._decide_locked(verb, self._rng)
                if fault is not None:
                    break
            if fault is not None:
                self.hits[verb] += 1
        if fault is not None and self.on_fault is not None:
            self.on_fault(verb, fault)
        return fault

    def raise_for(self, verb: str) -> None:
        """Fake-tier entry point: raise the client-visible exception for
        the first firing unary rule, if any (``watch_drop`` rules only
        apply to streams, via :meth:`decide_watch_drop`)."""
        fault = self.decide(verb)
        if fault is None:
            return
        # Imported late to avoid a client<->faults import cycle.
        from .client import ConflictError, ServerError, ThrottledError

        if fault.kind == "throttle":
            raise ThrottledError(
                f"{verb}: {fault.message}", retry_after_s=fault.retry_after_s
            )
        if fault.kind == "error":
            raise ServerError(
                f"{verb}: {fault.message}", status=fault.status
            )
        if fault.kind == "reset":
            raise ConnectionResetError(f"{verb}: {fault.message}")
        if fault.kind == "timeout":
            if fault.delay_s > 0:
                time.sleep(fault.delay_s)
            raise TimeoutError(f"{verb}: {fault.message}")
        if fault.kind == "conflict":
            raise ConflictError(f"{verb}: {fault.message}")
