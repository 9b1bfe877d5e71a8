"""Span model + recorder: every roll becomes a causal span tree.

The engine already has one choke point per interesting fact: the
provider's ``transition_observer`` sees every group-level state flip,
the admission pass knows which groups it charged, the window/quarantine
/negotiation processors know why a group is parked, and the drain
helper knows which eviction rung each node occupies.  The
:class:`TraceRecorder` listens at exactly those points and grows a
bounded in-memory span tree::

    roll (trace root)
      pool
        wave-N            (one per pool per admission pass that charged)
          slice-group
            phase         (cordon, drain, validation, ... — one per
                           occupied state, closed by the next flip)
            wait          (budget-denied/queued, window-held, quarantine
                           dwell, elastic negotiation)
            node
              wait        (eviction rung ladder: evict -> delete ->
                           force-delete)

Design rules, all load-bearing:

- **Observe-only, fail-open.**  Every public method is wrapped so a
  recorder bug can never block a state transition; failures count into
  ``drops`` (exported as ``trace_drops_total``) instead of raising.
- **Deterministic ids.**  ``trace_id = roll-<epoch>``; span ids are
  ``<trace>/<pool>/<group>/<name>`` paths.  Re-recording the same fact
  after a crash lands on the same id and is a no-op, which is what
  makes adoption idempotent.  A *legitimately* repeated span (second
  quarantine cycle) gets an ``#n`` occurrence suffix.
- **Monotonic timestamps.**  Span clocks are ``time.monotonic`` so they
  are immune to wall-clock steps; the durable anchor carries wall
  epochs and is rebased through
  :func:`~k8s_operator_libs_tpu_torch.upgrade.durable.monotonic_from_epoch`
  on adoption (the same idiom as the eviction-rung store).
- **Crash durability rides existing writes.**  ``annotation_source``
  returns the anchor annotation patch that the provider merges into
  the SAME node intent as the state label — zero extra API writes, so
  the write-hygiene bench pins hold with tracing on.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState
from k8s_operator_libs_tpu_torch.upgrade.durable import monotonic_from_epoch

logger = get_logger(__name__)

# Span kinds (tree levels + leaf activities).
KIND_ROLL = "roll"
KIND_POOL = "pool"
KIND_WAVE = "wave"
KIND_GROUP = "group"
KIND_NODE = "node"
KIND_PHASE = "phase"
KIND_WAIT = "wait"
# Per-artifact step inside a phase (multi-artifact stacks): nested under
# the group's open phase span.  Deliberately NOT a makespan bucket —
# critical.py buckets only PHASE/WAIT kinds, so the phase spans keep
# summing exactly to the makespan with artifact nesting present.
KIND_ARTIFACT = "artifact"

# Wait-span reasons (the critical-path buckets key off these).
WAIT_BUDGET = "budget"
WAIT_WINDOW = "window"
WAIT_QUARANTINE = "quarantine"
WAIT_NEGOTIATE = "negotiate"
WAIT_API_RETRY = "api_retry"
WAIT_RUNG_PREFIX = "evict:"  # + rung name (evict/delete/force-delete)

# Serialized name for the pool-less bucket ("" internally) — matches
# planning/clocks.py so trace pools line up with phase-clock pools.
DEFAULT_POOL_KEY = "default"

_TERMINAL = (UpgradeState.DONE.value, UpgradeState.UNKNOWN.value)
_QUEUED = UpgradeState.UPGRADE_REQUIRED.value
_QUARANTINED = UpgradeState.QUARANTINED.value

# Anchor annotation value: "<trace_id>|<state>|<epoch>".
_ANCHOR_SEP = "|"


def format_anchor(trace_id: str, state_value: str, epoch: float) -> str:
    return f"{trace_id}{_ANCHOR_SEP}{state_value}{_ANCHOR_SEP}{epoch:.3f}"


def parse_anchor(value: Optional[str]) -> Optional[tuple[str, str, float]]:
    """Parse a durable anchor annotation; garbage reads as absent."""
    if not value:
        return None
    parts = value.split(_ANCHOR_SEP)
    if len(parts) != 3:
        return None
    trace_id, state_value, epoch_s = parts
    if not trace_id or not state_value:
        return None
    try:
        epoch = float(epoch_s)
    except ValueError:
        return None
    return trace_id, state_value, epoch


@dataclass
class Span:
    """One timed activity.  ``start``/``end`` are process-monotonic."""

    span_id: str
    trace_id: str
    parent_id: Optional[str]
    kind: str
    name: str
    start: float
    end: Optional[float] = None
    attrs: dict = field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.end is None

    def duration(self, now: Optional[float] = None) -> float:
        stop = self.end
        if stop is None:
            stop = time.monotonic() if now is None else now
        return max(0.0, stop - self.start)

    def to_dict(self, origin: float = 0.0) -> dict:
        return {
            "id": self.span_id,
            "parent": self.parent_id,
            "kind": self.kind,
            "name": self.name,
            "start_s": round(self.start - origin, 6),
            "end_s": (
                None if self.end is None else round(self.end - origin, 6)
            ),
            "attrs": dict(self.attrs),
        }


@dataclass
class CompletedTrace:
    """Immutable snapshot handed to obs/critical.py on roll completion."""

    trace_id: str
    start: float
    end: float
    spans: list  # list[Span], the roll span first

    @property
    def makespan(self) -> float:
        return max(0.0, self.end - self.start)

    def roll_span(self) -> Optional[Span]:
        for s in self.spans:
            if s.kind == KIND_ROLL:
                return s
        return None


def _failopen(method: Callable) -> Callable:
    """Observe-only contract: a recorder failure must never block a
    state transition.  Any exception is swallowed, counted into
    ``drops``, and logged at debug."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        try:
            return method(self, *args, **kwargs)
        except Exception as e:  # noqa: BLE001 — fail-open by contract
            self.drops += 1
            logger.debug("trace recorder %s failed: %s", method.__name__, e)
            return None

    return wrapper


class TraceRecorder:
    """Bounded, thread-safe, fail-open span recorder for fleet rolls.

    One instance per manager; tracks at most one active roll trace at a
    time (the controller is the single admission point for a fleet, so
    concurrent rolls collapse into one trace with per-pool subtrees).
    """

    def __init__(
        self,
        max_spans: int = 8192,
        clock: Optional[Callable[[], float]] = None,
        epoch_clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.max_spans = max_spans
        self._clock = clock or time.monotonic
        self._epoch = epoch_clock or time.time
        self._lock = threading.RLock()
        # Fail-open accounting (exported as trace_drops_total).
        self.drops = 0
        # Completed rolls, newest last (bounded).
        self.completed: list[CompletedTrace] = []
        self.max_completed = 4
        # Optional: flight recorder notified of span openings (ring
        # deltas); duck-typed, fail-open.
        self.flight_recorder = None
        self._reset_locked()

    # ------------------------------------------------------------------
    # internal state
    # ------------------------------------------------------------------

    def _reset_locked(self) -> None:
        self.trace_id: Optional[str] = None
        self._roll_id: Optional[str] = None
        self._roll_started_epoch: Optional[float] = None
        self._spans: dict[str, Span] = {}
        # group key (lexicographically-first node name) -> last state
        self._group_state: dict[str, str] = {}
        # group key -> open phase span id
        self._group_phase: dict[str, str] = {}
        # (group key, artifact name) -> open artifact span id
        self._group_artifact: dict[tuple[str, str], str] = {}
        # (group key, wait reason) -> open wait span id
        self._group_wait: dict[tuple[str, str], str] = {}
        # node name -> (group key, open rung-wait span id or None)
        self._node_rung: dict[str, tuple[str, Optional[str]]] = {}
        self._node_group: dict[str, str] = {}
        self._node_pool: dict[str, str] = {}
        self._group_pool: dict[str, str] = {}
        # occurrence counters for repeated deterministic ids
        self._occurrence: dict[str, int] = {}
        # wave bookkeeping: pool -> wave ordinal / last admission pass
        self._pool_wave: dict[str, int] = {}
        self._pool_wave_pass: dict[str, int] = {}
        self._pass_token = 0

    def _new_span(
        self,
        span_id: str,
        parent_id: Optional[str],
        kind: str,
        name: str,
        start: float,
        attrs: Optional[dict] = None,
    ) -> Optional[Span]:
        """Insert a span; deterministic-id no-op if it is already open,
        ``#n``-suffixed re-occurrence if it exists closed."""
        existing = self._spans.get(span_id)
        if existing is not None:
            if existing.open:
                return existing  # idempotent re-record (crash replay)
            n = self._occurrence.get(span_id, 1) + 1
            self._occurrence[span_id] = n
            span_id = f"{span_id}#{n}"
            again = self._spans.get(span_id)
            if again is not None and again.open:
                return again
        if len(self._spans) >= self.max_spans:
            self.drops += 1
            return None
        span = Span(
            span_id=span_id,
            trace_id=self.trace_id or "",
            parent_id=parent_id,
            kind=kind,
            name=name,
            start=start,
            attrs=dict(attrs or {}),
        )
        self._spans[span_id] = span
        fr = self.flight_recorder
        if fr is not None:
            try:
                fr.note("span", kind=kind, name=name, id=span_id)
            except Exception:  # noqa: BLE001 — observe-only
                pass
        return span

    def _pool_of(self, group_key: str) -> str:
        pool = self._group_pool.get(group_key)
        if pool is None:
            pool = self._node_pool.get(group_key, "")
            self._group_pool[group_key] = pool
        return pool

    def _ensure_roll_locked(self, now: float, trace_id: Optional[str] = None):
        if self.trace_id is not None:
            return self._spans.get(self._roll_id)
        epoch = self._epoch()
        if trace_id is None:
            trace_id = f"roll-{int(epoch)}"
        self.trace_id = trace_id
        self._roll_started_epoch = epoch
        self._roll_id = trace_id
        return self._new_span(trace_id, None, KIND_ROLL, trace_id, now)

    def _ensure_pool_locked(self, pool: str, now: float) -> Optional[str]:
        name = pool or DEFAULT_POOL_KEY
        span_id = f"{self.trace_id}/{name}"
        if span_id not in self._spans:
            self._new_span(span_id, self._roll_id, KIND_POOL, name, now)
        return span_id if span_id in self._spans else self._roll_id

    def _ensure_group_locked(self, group_key: str, now: float) -> str:
        pool = self._pool_of(group_key)
        pool_name = pool or DEFAULT_POOL_KEY
        span_id = f"{self.trace_id}/{pool_name}/{group_key}"
        if span_id in self._spans:
            return span_id
        pool_id = self._ensure_pool_locked(pool, now)
        created = self._new_span(span_id, pool_id, KIND_GROUP, group_key, now)
        return span_id if created is not None else pool_id

    def _assign_wave_locked(self, group_key: str, now: float) -> None:
        """Admission: hang the group under this pass's wave span.  The
        group span usually predates admission (created when the group
        queued), so assignment is a reparent, not a create."""
        pool = self._pool_of(group_key)
        pool_name = pool or DEFAULT_POOL_KEY
        group_id = self._ensure_group_locked(group_key, now)
        gspan = self._spans.get(group_id)
        if gspan is None or gspan.kind != KIND_GROUP:
            return
        if gspan.parent_id and "/wave-" in gspan.parent_id:
            return  # already assigned (crash replay)
        pool_id = self._ensure_pool_locked(pool, now)
        # Groups charged in the same admission pass share one wave span
        # per pool.
        if self._pool_wave_pass.get(pool) != self._pass_token:
            self._pool_wave[pool] = self._pool_wave.get(pool, 0) + 1
            self._pool_wave_pass[pool] = self._pass_token
        wave_n = self._pool_wave.get(pool, 1)
        wave_id = f"{self.trace_id}/{pool_name}/wave-{wave_n}"
        if wave_id not in self._spans:
            self._new_span(wave_id, pool_id, KIND_WAVE, f"wave-{wave_n}", now)
        if wave_id in self._spans:
            gspan.parent_id = wave_id
            gspan.attrs.setdefault("wave", wave_n)

    def _group_span_id(self, group_key: str) -> Optional[str]:
        pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
        span_id = f"{self.trace_id}/{pool_name}/{group_key}"
        return span_id if span_id in self._spans else None

    def _close_phase_locked(self, group_key: str, now: float) -> None:
        # Artifact steps nest under the phase: a rotating phase takes its
        # open artifact spans with it.
        for (gkey, artifact) in list(self._group_artifact):
            if gkey != group_key:
                continue
            aid = self._group_artifact.pop((gkey, artifact))
            aspan = self._spans.get(aid)
            if aspan is not None and aspan.open:
                aspan.end = now
        span_id = self._group_phase.pop(group_key, None)
        if span_id is not None:
            span = self._spans.get(span_id)
            if span is not None and span.open:
                span.end = now

    def _close_wait_locked(
        self, group_key: str, reason: str, now: float
    ) -> None:
        span_id = self._group_wait.pop((group_key, reason), None)
        if span_id is not None:
            span = self._spans.get(span_id)
            if span is not None and span.open:
                span.end = now

    def _open_wait_locked(
        self,
        group_key: str,
        reason: str,
        now: float,
        parent_id: Optional[str] = None,
        attrs: Optional[dict] = None,
    ) -> None:
        if (group_key, reason) in self._group_wait:
            return  # already waiting for this reason
        if parent_id is None:
            parent_id = self._ensure_group_locked(group_key, now)
        pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
        span_id = f"{self.trace_id}/{pool_name}/{group_key}/wait:{reason}"
        span = self._new_span(
            span_id, parent_id, KIND_WAIT, f"wait:{reason}", now, attrs
        )
        if span is not None:
            self._group_wait[(group_key, reason)] = span.span_id

    def _close_node_rungs_locked(self, group_key: str, now: float) -> None:
        for node, (gkey, wait_id) in list(self._node_rung.items()):
            if gkey != group_key:
                continue
            if wait_id is not None:
                span = self._spans.get(wait_id)
                if span is not None and span.open:
                    span.end = now
            node_span_id = self._node_span_id(node, group_key)
            if node_span_id is not None:
                span = self._spans.get(node_span_id)
                if span is not None and span.open:
                    span.end = now
            del self._node_rung[node]

    def _node_span_id(self, node: str, group_key: str) -> Optional[str]:
        pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
        span_id = f"{self.trace_id}/{pool_name}/{group_key}/{node}"
        return span_id if span_id in self._spans else None

    def _close_group_locked(self, group_key: str, now: float) -> None:
        self._close_phase_locked(group_key, now)
        for (gkey, reason) in list(self._group_wait):
            if gkey == group_key:
                self._close_wait_locked(gkey, reason, now)
        self._close_node_rungs_locked(group_key, now)
        span_id = self._group_span_id(group_key)
        if span_id is not None:
            span = self._spans[span_id]
            if span.open:
                span.end = now

    @staticmethod
    def _group_key_of(nodes: Iterable) -> Optional[str]:
        names = sorted(
            n.name for n in nodes if getattr(n, "name", None) is not None
        )
        return names[0] if names else None

    def _gkey(self, group_or_nodes) -> Optional[str]:
        nodes = getattr(group_or_nodes, "nodes", None)
        if nodes is not None:
            return self._group_key_of(nodes)
        if isinstance(group_or_nodes, str):
            return group_or_nodes
        try:
            return self._group_key_of(group_or_nodes)
        except TypeError:
            return None

    # ------------------------------------------------------------------
    # wiring (controller/manager)
    # ------------------------------------------------------------------

    @_failopen
    def seed_pools(self, node_pool: dict[str, str]) -> None:
        """Refresh node→pool attribution (mirrors PhaseClockTracker)."""
        with self._lock:
            self._node_pool.update(node_pool)

    # ------------------------------------------------------------------
    # observation: provider transition_observer choke point
    # ------------------------------------------------------------------

    @_failopen
    def observe_group_transition(
        self, nodes: Iterable, new_state, now: Optional[float] = None
    ) -> None:
        """One group-level transition (fired BEFORE labels change).

        This single callback drives the whole tree: the first non-DONE
        transition begins the roll trace; entering ``upgrade-required``
        opens the budget/queue wait; entering a phase state closes that
        wait (admission) and rotates the phase span; quarantine opens
        the dwell wait; DONE closes the group.
        """
        names = sorted(
            n.name for n in nodes if getattr(n, "name", None) is not None
        )
        if not names:
            return
        group_key = names[0]
        ts = self._clock() if now is None else now
        new_value = getattr(new_state, "value", new_state)
        with self._lock:
            prev = self._group_state.get(group_key)
            if prev == new_value:
                return  # idempotent re-issue (crash replay, re-drive)
            if self.trace_id is None:
                if new_value in _TERMINAL:
                    return  # cleanup traffic outside any roll
                self._ensure_roll_locked(ts)
            self._group_state[group_key] = new_value
            for n in names:
                self._node_group[n] = group_key
            if new_value in _TERMINAL:
                self._close_group_locked(group_key, ts)
                return
            admitted = prev == _QUEUED
            group_id = self._ensure_group_locked(group_key, ts)
            if new_value == _QUEUED:
                self._close_phase_locked(group_key, ts)
                self._open_wait_locked(
                    group_key, WAIT_BUDGET, ts, parent_id=group_id
                )
                return
            if admitted:
                self._close_wait_locked(group_key, WAIT_BUDGET, ts)
                self._assign_wave_locked(group_key, ts)
            if new_value == _QUARANTINED:
                self._close_phase_locked(group_key, ts)
                self._close_node_rungs_locked(group_key, ts)
                self._open_wait_locked(
                    group_key, WAIT_QUARANTINE, ts, parent_id=group_id
                )
                return
            if prev == _QUARANTINED:
                self._close_wait_locked(group_key, WAIT_QUARANTINE, ts)
            # Rotate the phase span: close the occupied phase, open the
            # entered one.  (Leaving DRAIN also retires rung ladders.)
            self._close_phase_locked(group_key, ts)
            self._close_node_rungs_locked(group_key, ts)
            pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
            span_id = f"{self.trace_id}/{pool_name}/{group_key}/{new_value}"
            span = self._new_span(
                span_id, group_id, KIND_PHASE, new_value, ts
            )
            if span is not None:
                self._group_phase[group_key] = span.span_id

    # ------------------------------------------------------------------
    # engine hooks
    # ------------------------------------------------------------------

    @_failopen
    def begin_admission_pass(self) -> None:
        """Wave boundary: groups admitted in one pass share a wave."""
        with self._lock:
            self._pass_token += 1

    @_failopen
    def begin_wait(self, group_or_nodes, reason: str, **attrs) -> None:
        group_key = self._gkey(group_or_nodes)
        if group_key is None:
            return
        with self._lock:
            if self.trace_id is None:
                return
            self._open_wait_locked(
                group_key, reason, self._clock(), attrs=attrs or None
            )

    @_failopen
    def end_wait(self, group_or_nodes, reason: str) -> None:
        group_key = self._gkey(group_or_nodes)
        if group_key is None:
            return
        with self._lock:
            if self.trace_id is None:
                return
            self._close_wait_locked(group_key, reason, self._clock())

    @_failopen
    def rung_entered(self, node_name: str, rung: str) -> None:
        """Eviction-ladder hook (DrainHelper): one node span per host,
        one wait span per rung occupancy."""
        with self._lock:
            if self.trace_id is None:
                return
            group_key = self._node_group.get(node_name)
            if group_key is None:
                return
            ts = self._clock()
            prev = self._node_rung.get(node_name)
            if prev is not None and prev[1] is not None:
                span = self._spans.get(prev[1])
                if span is not None:
                    if span.open and span.name == f"wait:{WAIT_RUNG_PREFIX}{rung}":
                        return  # idempotent re-entry of the same rung
                    if span.open:
                        span.end = ts
            group_id = self._ensure_group_locked(group_key, ts)
            pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
            node_id = f"{self.trace_id}/{pool_name}/{group_key}/{node_name}"
            if node_id not in self._spans:
                self._new_span(node_id, group_id, KIND_NODE, node_name, ts)
            parent = node_id if node_id in self._spans else group_id
            wait_name = f"{WAIT_RUNG_PREFIX}{rung}"
            wait_id = f"{node_id}/wait:{wait_name}"
            span = self._new_span(
                wait_id, parent, KIND_WAIT, f"wait:{wait_name}", ts
            )
            self._node_rung[node_name] = (
                group_key,
                span.span_id if span is not None else None,
            )

    @_failopen
    def artifact_step(
        self, group_or_nodes, artifact: str, done: bool = False
    ) -> None:
        """Multi-artifact stack hook: one nested span per artifact step
        under the group's OPEN phase span (pod-restart today), opened
        when the engine starts restarting that artifact's pods and
        closed when the artifact is fully synced (``done=True``).  The
        span kind is excluded from makespan bucketing by construction
        (critical.py walks PHASE/WAIT only), so nesting artifact steps
        never perturbs the buckets-sum-exactly invariant."""
        group_key = self._gkey(group_or_nodes)
        if group_key is None:
            return
        with self._lock:
            if self.trace_id is None:
                return
            ts = self._clock()
            key = (group_key, artifact)
            open_id = self._group_artifact.get(key)
            if done:
                if open_id is not None:
                    span = self._spans.get(open_id)
                    if span is not None and span.open:
                        span.end = ts
                    del self._group_artifact[key]
                return
            if open_id is not None:
                span = self._spans.get(open_id)
                if span is not None and span.open:
                    return  # idempotent re-issue while the step runs
            parent = self._group_phase.get(group_key)
            if parent is None or parent not in self._spans:
                parent = self._group_span_id(group_key)
            if parent is None:
                return
            span = self._new_span(
                f"{parent}/artifact:{artifact}",
                parent,
                KIND_ARTIFACT,
                f"artifact:{artifact}",
                ts,
            )
            if span is not None:
                self._group_artifact[key] = span.span_id

    @_failopen
    def note_gate(self, group_or_nodes, detail: str) -> None:
        """Validation-gate hook: annotate the open validation phase span
        with the latest rejection detail (bounded, last-writer-wins)."""
        group_key = self._gkey(group_or_nodes)
        if group_key is None:
            return
        with self._lock:
            span_id = self._group_phase.get(group_key)
            span = self._spans.get(span_id) if span_id else None
            if span is not None and span.open:
                span.attrs["gate_rejection"] = str(detail)[:200]
                span.attrs["gate_rejections"] = (
                    int(span.attrs.get("gate_rejections", 0)) + 1
                )

    @_failopen
    def note_api_retry(self, group_or_nodes, seconds: float) -> None:
        """Charge API retry/backoff time to the group (closed wait span,
        recorded after the fact — retries are measured, not predicted)."""
        group_key = self._gkey(group_or_nodes)
        if group_key is None or seconds <= 0:
            return
        with self._lock:
            if self.trace_id is None:
                return
            ts = self._clock()
            parent = self._ensure_group_locked(group_key, ts)
            pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
            base = (
                f"{self.trace_id}/{pool_name}/{group_key}"
                f"/wait:{WAIT_API_RETRY}"
            )
            span = self._new_span(
                base,
                parent,
                KIND_WAIT,
                f"wait:{WAIT_API_RETRY}",
                ts - seconds,
            )
            if span is not None and span.open:
                span.end = ts

    # ------------------------------------------------------------------
    # crash durability
    # ------------------------------------------------------------------

    @_failopen
    def annotation_source(self, node, new_state) -> dict:
        """Durable anchor patch merged into the state-label intent by the
        provider (``transition_annotation_source``).  Same idiom as
        AnnotationRungStore: wall epochs in, rebased on adoption."""
        key = getattr(self, "annotation_key", None)
        if key is None:
            return {}
        new_value = getattr(new_state, "value", new_state)
        if new_value in _TERMINAL:
            # Roll over for this group: delete the anchor in the same
            # patch that flips the label to done.
            return {key: None}
        with self._lock:
            if self.trace_id is None:
                return {}
            return {
                key: format_anchor(self.trace_id, new_value, self._epoch())
            }

    @_failopen
    def reopen_group(
        self,
        group_or_nodes,
        anchor_value: Optional[str],
        pool: Optional[str] = None,
        adopted_by: Optional[str] = None,
        now_epoch: Optional[float] = None,
    ) -> bool:
        """Adoption path: continue the persisted trace for one in-flight
        group under a restarted controller.

        Re-opens the roll/pool/group spans plus the group's current
        phase (or wait) span with starts rebased from the persisted wall
        epochs, and primes the dedupe state so the engine's idempotent
        re-drive of the same transition records nothing new.  Returns
        True when a span was re-opened.
        """
        parsed = parse_anchor(anchor_value)
        if parsed is None:
            return False
        trace_id, state_value, epoch = parsed
        group_key = self._gkey(group_or_nodes)
        if group_key is None:
            return False
        nodes = getattr(group_or_nodes, "nodes", None)
        now_ep = int(self._epoch() if now_epoch is None else now_epoch)
        phase_start = monotonic_from_epoch(int(epoch), now_ep)
        with self._lock:
            if self.trace_id is not None and self.trace_id != trace_id:
                # A different roll's leftovers: ignore rather than graft
                # a foreign subtree onto the active trace.
                return False
            if self.trace_id is None:
                # Rebase the roll start from the epoch baked into the
                # trace id (trace ids are deterministic: roll-<epoch>).
                roll_epoch = None
                _, _, tail = trace_id.rpartition("-")
                try:
                    roll_epoch = int(tail)
                except ValueError:
                    roll_epoch = None
                roll_start = (
                    monotonic_from_epoch(roll_epoch, now_ep)
                    if roll_epoch is not None
                    else phase_start
                )
                self._ensure_roll_locked(roll_start, trace_id=trace_id)
            if self._group_state.get(group_key) == state_value:
                return False  # already continued (idempotent re-adopt)
            if pool is not None:
                self._group_pool[group_key] = pool
            if nodes is not None:
                for n in nodes:
                    name = getattr(n, "name", None)
                    if name is not None:
                        self._node_group[name] = group_key
            else:
                self._node_group[group_key] = group_key
            self._group_state[group_key] = state_value
            group_id = self._ensure_group_locked(group_key, phase_start)
            gspan = self._spans.get(group_id)
            if gspan is not None:
                gspan.attrs.setdefault("reopened", True)
                if adopted_by:
                    gspan.attrs["adopted_by"] = adopted_by
            if state_value in _TERMINAL:
                self._close_group_locked(group_key, phase_start)
                return True
            if state_value == _QUEUED:
                self._open_wait_locked(
                    group_key, WAIT_BUDGET, phase_start, parent_id=group_id
                )
                return True
            if state_value == _QUARANTINED:
                self._open_wait_locked(
                    group_key,
                    WAIT_QUARANTINE,
                    phase_start,
                    parent_id=group_id,
                )
                return True
            pool_name = self._pool_of(group_key) or DEFAULT_POOL_KEY
            span_id = (
                f"{self.trace_id}/{pool_name}/{group_key}/{state_value}"
            )
            span = self._new_span(
                span_id, group_id, KIND_PHASE, state_value, phase_start
            )
            if span is not None:
                span.attrs.setdefault("reopened", True)
                self._group_phase[group_key] = span.span_id
            return True

    # ------------------------------------------------------------------
    # roll lifecycle
    # ------------------------------------------------------------------

    @_failopen
    def maybe_end_roll(self, now: Optional[float] = None):
        """Close the trace when every observed group has reached a
        terminal state (called at the end of each full engine pass).
        Returns the :class:`CompletedTrace` on the closing call."""
        with self._lock:
            if self.trace_id is None or not self._group_state:
                return None
            if any(
                state not in _TERMINAL
                for state in self._group_state.values()
            ):
                return None
            ts = self._clock() if now is None else now
            # Everything should already be closed (DONE closes groups);
            # force-close stragglers so a completed trace can never
            # contain an open span.
            forced = 0
            for span in self._spans.values():
                if span.open and span.kind != KIND_ROLL:
                    span.end = ts
                    forced += 1
            roll = self._spans.get(self._roll_id)
            if roll is None:
                self._reset_locked()
                return None
            roll.end = ts
            if forced:
                roll.attrs["force_closed_spans"] = forced
            completed = CompletedTrace(
                trace_id=self.trace_id,
                start=roll.start,
                end=ts,
                spans=list(self._spans.values()),
            )
            self.completed.append(completed)
            del self.completed[: -self.max_completed]
            self._reset_locked()
            return completed

    # ------------------------------------------------------------------
    # introspection (status CLI, flight recorder, tests)
    # ------------------------------------------------------------------

    @property
    def active(self) -> bool:
        return self.trace_id is not None

    def active_trace_id(self) -> Optional[str]:
        return self.trace_id

    def last_completed(self) -> Optional[CompletedTrace]:
        return self.completed[-1] if self.completed else None

    def spans(self) -> list:
        with self._lock:
            return list(self._spans.values())

    def open_span_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._spans.values() if s.open)

    def export(self) -> dict:
        """JSON-shaped snapshot of the ACTIVE trace (flight recorder)."""
        with self._lock:
            roll = self._spans.get(self._roll_id) if self._roll_id else None
            origin = roll.start if roll is not None else 0.0
            return {
                "trace_id": self.trace_id,
                "open_spans": sum(
                    1 for s in self._spans.values() if s.open
                ),
                "drops": self.drops,
                "spans": [s.to_dict(origin) for s in self._spans.values()],
            }
