"""Transactional write plane: per-tick write planner, APF-aware flow
scheduler, and kubelet-style event aggregation.

Reads are pinned at zero per steady-state tick by the informer cache
and the sharded reconcile; this module pins the *write* side.  Every producer — the
engine pass, the drain/probe/validation worker threads, the controller's
CR-status and Event publishers — records mutation *intents* into a
shared :class:`WritePlan` instead of issuing API calls directly.  The
plan

- coalesces per-object: all label/annotation deltas staged for one node
  flush as ONE combined metadata patch (with a field manager, the
  server-side-apply idiom) instead of one round trip per key-group;
- dedupes no-op writes against the informer snapshot at flush time and
  against the caller's cached object at stage time (counted in
  ``writes_suppressed_total``);
- replays 409 conflicts through the taxonomy's CAS rule — ConflictError
  is *fatal* to blind retry loops (`retry.py`), so the plan re-reads the
  object with quorum, re-checks the fence, re-dedupes against the fresh
  object, and re-applies the surviving delta exactly once;
- fences at FLUSH time: a deposed leader's queued plan is dropped whole
  (liveness fence on every flush, term fence on a bounded sample of the
  staged nodes), never partially applied;
- flushes with bounded parallelism and free write-echo into the
  informer (the plan writes through the provider's CachedKubeClient, so
  ``_echo`` → ``observe_write`` read-your-writes is preserved).

On top sits an APF-aware :class:`FlowScheduler`: a client-side
token-bucket limiter with two *distinct* flows — ``mutating`` (node
state transitions, durable clocks) and ``status`` (CR status, Events) —
so status churn can never starve a state transition.  429/Retry-After
feedback tightens the offending flow's bucket (rate halves, a
not-before floor honors Retry-After) and additive recovery restores it.
A mutating write that cannot get a token waits (bounded) and then
proceeds — correctness beats hygiene; a status/event write that cannot
get a token is *deferred* to the next tick instead.

Events ride an :class:`EventAggregator`: identical
(namespace, object, type, reason, message) within a window collapse
into one count-carrying event, kubelet-style — the first occurrence
publishes immediately, repeats absorb into a local count that is
republished as a single count update when the window elapses.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import threading
import time
import uuid
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from k8s_operator_libs_tpu_torch.k8s.client import (
    ConflictError,
    NotFoundError,
    ThrottledError,
)
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.objects import Node

logger = logging.getLogger(__name__)

FLOW_MUTATING = "mutating"
FLOW_STATUS = "status"

# How many staged nodes the term fence quorum-reads per flush.  The term
# fence costs a quorum GET per node checked; sampling bounds that cost
# while still catching the deposed-leader window (any single stamped
# node reveals the higher term).
TERM_FENCE_SAMPLE = 3


class TokenBucket:
    """Client-side token bucket with 429 feedback.

    ``penalize(retry_after_s)`` halves the refill rate (floored at 1/8
    of base) and sets a not-before floor honoring Retry-After; the rate
    recovers additively back to base over ``recovery_s`` once penalties
    stop.  Thread-safe.
    """

    def __init__(
        self,
        rate_per_s: float,
        burst: float,
        recovery_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.base_rate = float(rate_per_s)
        self.rate = float(rate_per_s)
        self.capacity = float(burst)
        self.tokens = float(burst)
        self.recovery_s = recovery_s
        self._clock = clock
        self._last = clock()
        self._not_before = 0.0
        self.penalties = 0
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        elapsed = max(0.0, now - self._last)
        self._last = now
        if self.rate < self.base_rate and self.recovery_s > 0:
            self.rate = min(
                self.base_rate,
                self.rate + self.base_rate * elapsed / self.recovery_s,
            )
        self.tokens = min(self.capacity, self.tokens + elapsed * self.rate)

    def try_acquire(self, n: float = 1.0) -> float:
        """Take ``n`` tokens if available; return 0.0 on success, else
        the seconds to wait before retrying."""
        with self._lock:
            now = self._clock()
            self._refill_locked(now)
            if now < self._not_before:
                return self._not_before - now
            if self.tokens >= n:
                self.tokens -= n
                return 0.0
            deficit = n - self.tokens
            return deficit / max(self.rate, 1e-9)

    def penalize(self, retry_after_s: Optional[float] = None) -> None:
        with self._lock:
            now = self._clock()
            self._refill_locked(now)
            self.rate = max(self.base_rate / 8.0, self.rate / 2.0)
            self.penalties += 1
            if retry_after_s and retry_after_s > 0:
                # Cap the freeze so a hostile Retry-After cannot wedge
                # the write plane for minutes.
                self._not_before = max(
                    self._not_before, now + min(retry_after_s, 30.0)
                )

    def throttled(self) -> bool:
        with self._lock:
            now = self._clock()
            return now < self._not_before or self.rate < self.base_rate

    def state(self) -> dict[str, float]:
        with self._lock:
            now = self._clock()
            self._refill_locked(now)
            return {
                "tokens": self.tokens,
                "rate": self.rate,
                "throttled": 1.0
                if (now < self._not_before or self.rate < self.base_rate)
                else 0.0,
                "penalties": float(self.penalties),
            }


class FlowScheduler:
    """Two-flow APF-style scheduler: ``mutating`` and ``status`` each
    own an independent token bucket, so saturation of one flow never
    delays the other *by construction* (flow isolation).

    ``acquire(FLOW_MUTATING)`` waits (bounded by ``max_wait_s``) and
    then proceeds regardless — dropping a state transition for hygiene
    would be a correctness bug.  ``acquire(FLOW_STATUS)`` returns False
    when the bucket is dry so the caller defers to the next tick.
    """

    def __init__(
        self,
        mutating_rate: float = 400.0,
        mutating_burst: float = 800.0,
        status_rate: float = 100.0,
        status_burst: float = 200.0,
        max_wait_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.buckets = {
            FLOW_MUTATING: TokenBucket(
                mutating_rate, mutating_burst, clock=clock
            ),
            FLOW_STATUS: TokenBucket(status_rate, status_burst, clock=clock),
        }
        self.max_wait_s = max_wait_s
        self._sleep = sleep
        self.stats: Counter = Counter()
        self._stats_lock = threading.Lock()

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def acquire(self, flow: str) -> bool:
        bucket = self.buckets[flow]
        budget = self.max_wait_s
        while True:
            wait = bucket.try_acquire()
            if wait <= 0.0:
                return True
            if flow == FLOW_STATUS:
                # Status traffic defers rather than queueing behind the
                # bucket — next tick re-stages the freshest status.
                self._count("deferred_status")
                return False
            if budget <= 0.0:
                # Out of patience: a mutating write goes through anyway.
                self._count("overruns_mutating")
                return True
            step = min(wait, budget, 0.25)
            self._count("throttle_waits_mutating")
            self._sleep(step)
            budget -= step

    def feedback(
        self, flow: str, retry_after_s: Optional[float] = None
    ) -> None:
        """429/Retry-After feedback from the apiserver tightens the
        offending flow's bucket."""
        self.buckets[flow].penalize(retry_after_s)
        self._count(f"penalties_{flow}")

    def state(self) -> dict[str, dict[str, float]]:
        return {flow: b.state() for flow, b in self.buckets.items()}


@dataclass
class _EventEntry:
    event: dict[str, Any]
    namespace: str
    count: int = 0  # occurrences observed but not yet published
    published: int = 0  # occurrences already carried by published events
    first_ts: float = 0.0
    last_ts: float = 0.0
    last_publish: float = 0.0


class EventAggregator:
    """Kubelet-style event aggregation: identical
    (namespace, involved object, type, reason, message) within
    ``window_s`` collapse into one count-carrying event.

    The first occurrence publishes immediately (count = observed so
    far); repeats inside the window absorb into the entry's local count
    (``events_aggregated_total``) and are republished as a single count
    update once the window elapses.  Entries idle for two windows are
    dropped.
    """

    def __init__(
        self,
        window_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_s = window_s
        self._clock = clock
        self._entries: dict[tuple, _EventEntry] = {}
        self._lock = threading.Lock()

    @staticmethod
    def key_for(namespace: str, event: dict[str, Any]) -> tuple:
        involved = event.get("involvedObject") or {}
        return (
            namespace,
            involved.get("kind", ""),
            involved.get("name", ""),
            event.get("type", ""),
            event.get("reason", ""),
            event.get("message", ""),
        )

    def observe(
        self, namespace: str, event: dict[str, Any], count: int = 1
    ) -> None:
        now = self._clock()
        key = self.key_for(namespace, event)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or now - entry.last_ts > self.window_s:
                entry = _EventEntry(
                    event=event, namespace=namespace, first_ts=now
                )
                self._entries[key] = entry
            entry.event = event
            entry.count += count
            entry.last_ts = now

    def drain_publishable(self, force: bool = False) -> list[_EventEntry]:
        """Entries that should publish now: never-published entries
        publish immediately; already-published entries republish their
        absorbed count once per window (or on ``force``)."""
        now = self._clock()
        out: list[_EventEntry] = []
        with self._lock:
            for key in list(self._entries):
                entry = self._entries[key]
                if entry.count > 0 and (
                    force
                    or entry.published == 0
                    or now - entry.last_publish >= self.window_s
                ):
                    out.append(entry)
                elif (
                    entry.count == 0
                    and now - entry.last_ts > 2 * self.window_s
                ):
                    del self._entries[key]
        return out

    def mark_published(self, entry: _EventEntry) -> int:
        """Move the entry's absorbed count into published; returns the
        cumulative count the published event should carry."""
        with self._lock:
            entry.published += entry.count
            entry.count = 0
            entry.last_publish = self._clock()
            return entry.published

    def pending(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if e.count > 0)


@dataclass
class NodeIntent:
    """Coalesced per-node mutation intent: one combined metadata patch."""

    name: str
    labels: dict[str, Optional[str]] = field(default_factory=dict)
    annotations: dict[str, Optional[str]] = field(default_factory=dict)
    node: Optional[Node] = None  # caller's cached object, for waits
    stage_calls: int = 0

    def merge(
        self,
        labels: Optional[dict[str, Optional[str]]],
        annotations: Optional[dict[str, Optional[str]]],
        node: Optional[Node],
    ) -> None:
        if labels:
            self.labels.update(labels)
        if annotations:
            self.annotations.update(annotations)
        if node is not None:
            self.node = node
        self.stage_calls += 1

    def empty(self) -> bool:
        return not self.labels and not self.annotations


@dataclass
class _StatusIntent:
    group: str
    version: str
    plural: str
    namespace: str
    name: str
    obj: dict[str, Any]


class _Scope:
    __slots__ = ("names",)

    def __init__(self) -> None:
        self.names: set[str] = set()


class WritePlan:
    """Per-tick transactional write plan.

    Thread-safe (unlike the thread-local ``_WriteBatch`` it replaces):
    the engine pass opens a *scope* (via the provider's ``batched()``)
    whose staged node intents flush together at scope exit; worker
    threads without a scope stage-and-flush standalone intents through
    the same dedupe/fence/flow/replay path, so their durable-clock
    patches coalesce too.  Scopes are tracked per-thread over the shared
    pending map, so concurrent shard scopes never cross-flush.
    """

    def __init__(
        self,
        client: KubeClient,
        flows: Optional[FlowScheduler] = None,
        fence: Optional[Callable[[], bool]] = None,
        term_fence: Optional[Callable[[list], bool]] = None,
        field_manager: str = "tpu-upgrade-controller",
        max_concurrency: int = 32,
    ) -> None:
        self.client = client
        self.flows = flows or FlowScheduler()
        self.fence = fence
        self.term_fence = term_fence
        self.field_manager = field_manager
        self.max_concurrency = max_concurrency
        self.aggregator = EventAggregator()
        self._pending: dict[str, NodeIntent] = {}
        self._status: dict[tuple, _StatusIntent] = {}
        self._lock = threading.Lock()
        self._scopes = threading.local()
        self.stats: Counter = Counter()
        self._stats_lock = threading.Lock()
        self._node_locks: dict[str, threading.Lock] = {}
        self._supports_fm = self._probe_field_manager(client)

    @staticmethod
    def _probe_field_manager(client: KubeClient) -> bool:
        try:
            sig = inspect.signature(client.patch_node_metadata)
        except (TypeError, ValueError, AttributeError):
            return False
        return "field_manager" in sig.parameters

    # -- stats ---------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def note_suppressed(self, n: int = 1) -> None:
        """A producer skipped a write whose value already matched the
        cached object (stage-time no-op suppression)."""
        self._count("suppressed", n)

    def counters(self) -> dict[str, int]:
        with self._stats_lock:
            merged = dict(self.stats)
        for k, v in self.flows.stats.items():
            merged.setdefault(k, 0)
            merged[k] += v
        return merged

    def pending_depth(self) -> dict[str, int]:
        with self._lock:
            nodes = len(self._pending)
            status = len(self._status)
        return {
            "nodes": nodes,
            "status": status,
            "events": self.aggregator.pending(),
        }

    # -- scopes --------------------------------------------------------

    def begin_scope(self) -> Optional[_Scope]:
        """Open a coalescing scope on this thread; returns None when one
        is already open (nested scopes join the outer one)."""
        stack = getattr(self._scopes, "stack", None)
        if stack is None:
            stack = self._scopes.stack = []
        if stack:
            return None
        scope = _Scope()
        stack.append(scope)
        return scope

    def end_scope(self, scope: _Scope) -> list[str]:
        stack = getattr(self._scopes, "stack", None)
        if stack and stack[-1] is scope:
            stack.pop()
        return sorted(scope.names)

    def in_scope(self) -> bool:
        return bool(getattr(self._scopes, "stack", None))

    def discard(self, names: list[str]) -> None:
        """Drop pending intents without flushing (a scope body raised —
        matching the old batch-drop semantics)."""
        with self._lock:
            for name in names:
                if self._pending.pop(name, None) is not None:
                    self._count("dropped_on_error")

    # -- staging -------------------------------------------------------

    def stage(
        self,
        name: str,
        labels: Optional[dict[str, Optional[str]]] = None,
        annotations: Optional[dict[str, Optional[str]]] = None,
        node: Optional[Node] = None,
    ) -> Optional[NodeIntent]:
        """Record a node mutation intent.  Inside a scope the intent
        merges into the shared pending map and flushes at scope exit
        (returns None); outside a scope a standalone intent is returned
        for the caller to flush immediately."""
        stack = getattr(self._scopes, "stack", None)
        if stack:
            with self._lock:
                intent = self._pending.get(name)
                if intent is None:
                    intent = self._pending[name] = NodeIntent(name=name)
                intent.merge(labels, annotations, node)
            stack[0].names.add(name)
            return None
        intent = NodeIntent(name=name)
        intent.merge(labels, annotations, node)
        return intent

    def stage_cr_status(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str,
        obj: dict[str, Any],
    ) -> None:
        """Stage a CR status update (last writer wins per object)."""
        key = (group, version, plural, namespace, obj["metadata"]["name"])
        with self._lock:
            self._status[key] = _StatusIntent(
                group, version, plural, namespace, key[-1], obj
            )

    def stage_event(
        self, namespace: str, event: dict[str, Any], count: int = 1
    ) -> None:
        self.aggregator.observe(namespace, event, count)

    # -- fences --------------------------------------------------------

    def _fenced(self, names: list[str]) -> bool:
        """True when this process must NOT flush: the liveness fence
        says we are no longer leading, or the term fence finds a
        higher-term adoption stamp on a sample of the staged nodes."""
        if self.fence is not None:
            try:
                if not self.fence():
                    return True
            except Exception:  # noqa: BLE001 — fail closed on fence error
                return True
        if self.term_fence is not None and names:
            sample: list[Node] = []
            with self._lock:
                for name in names[:TERM_FENCE_SAMPLE]:
                    intent = self._pending.get(name)
                    if intent is not None and intent.node is not None:
                        sample.append(intent.node)
            if sample:
                try:
                    if not self.term_fence(sample):
                        return True
                except Exception:  # noqa: BLE001
                    return False  # term fence fails open (durable.py)
        return False

    def _drop_fenced(self, names: list[str]) -> None:
        with self._lock:
            dropped = 0
            for name in names:
                if self._pending.pop(name, None) is not None:
                    dropped += 1
        if dropped:
            self._count("fenced_drops", dropped)
        logger.warning(
            "write plan fenced at flush: dropped %d queued node intent(s)",
            dropped,
        )

    # -- flush: nodes --------------------------------------------------

    def _node_lock(self, name: str) -> threading.Lock:
        with self._lock:
            lock = self._node_locks.get(name)
            if lock is None:
                lock = self._node_locks[name] = threading.Lock()
            return lock

    def _peek(self, name: str) -> Optional[Node]:
        """Flush-time dedupe source: the informer snapshot when the
        client is cache-backed, else nothing (no extra reads)."""
        informer = getattr(self.client, "informer", None)
        if informer is None or not getattr(informer, "synced", False):
            return None
        try:
            return informer.get_node(name)
        except Exception:  # noqa: BLE001 — cache miss is not an error
            return None

    @staticmethod
    def _dedupe(
        patch: dict[str, Optional[str]], current: dict[str, str]
    ) -> tuple[dict[str, Optional[str]], int]:
        out: dict[str, Optional[str]] = {}
        dropped = 0
        for k, v in patch.items():
            if v is None:
                if k in current:
                    out[k] = v
                else:
                    dropped += 1
            elif current.get(k) != v:
                out[k] = v
            else:
                dropped += 1
        return out, dropped

    def _patch_once(
        self,
        name: str,
        labels: dict[str, Optional[str]],
        annotations: dict[str, Optional[str]],
    ) -> Node:
        if self._supports_fm:
            return self.client.patch_node_metadata(
                name,
                labels=labels or None,
                annotations=annotations or None,
                field_manager=self.field_manager,
            )
        return self.client.patch_node_metadata(
            name, labels=labels or None, annotations=annotations or None
        )

    def flush_intent(self, intent: NodeIntent) -> Optional[Node]:
        """Flush one node intent: dedupe against the informer snapshot,
        take a mutating-flow token, apply ONE combined metadata patch,
        and replay a 409 once through quorum re-read + re-fence +
        re-dedupe (the taxonomy's CAS rule: conflicts re-read, they
        don't blind-retry)."""
        name = intent.name
        if self.fence is not None:
            try:
                leading = self.fence()
            except Exception:  # noqa: BLE001 — fail closed
                leading = False
            if not leading:
                self._count("fenced_drops")
                return None
        with self._node_lock(name):
            labels = dict(intent.labels)
            annotations = dict(intent.annotations)
            cached = self._peek(name)
            if cached is not None:
                labels, d1 = self._dedupe(labels, cached.metadata.labels)
                annotations, d2 = self._dedupe(
                    annotations, cached.metadata.annotations
                )
                if d1 or d2:
                    self._count("suppressed", d1 + d2)
            if not labels and not annotations:
                self._count("flushes_empty")
                return None
            self.flows.acquire(FLOW_MUTATING)
            try:
                fresh = self._patch_once(name, labels, annotations)
            except ConflictError:
                self._count("conflict_replays")
                # The replay does its own write accounting (it may also
                # dedupe the whole delta away against the fresh read).
                return self._replay_conflict(name, labels, annotations)
            except ThrottledError as e:
                self.flows.feedback(
                    FLOW_MUTATING, getattr(e, "retry_after_s", None)
                )
                raise
            self._count("writes")
            self._count("writes_mutating")
            self._count(
                "coalesced_keys",
                max(0, len(labels) + len(annotations) - 1),
            )
            return fresh

    def _replay_conflict(
        self,
        name: str,
        labels: dict[str, Optional[str]],
        annotations: dict[str, Optional[str]],
    ) -> Optional[Node]:
        """409 replay: quorum re-read, re-check the fences, re-dedupe
        the delta against the fresh object, re-apply once.  A second
        conflict propagates (fatal, per the retry taxonomy)."""
        try:
            fresh = self.client.get_node(name, cached=False)
        except TypeError:
            fresh = self.client.get_node(name)
        except NotFoundError:
            self._count("replay_dropped_notfound")
            return None
        if self.fence is not None:
            try:
                leading = self.fence()
            except Exception:  # noqa: BLE001
                leading = False
            if not leading:
                self._count("fenced_drops")
                return None
        if self.term_fence is not None:
            try:
                if not self.term_fence([fresh]):
                    self._count("fenced_drops")
                    return None
            except Exception:  # noqa: BLE001
                pass  # term fence fails open
        labels, d1 = self._dedupe(labels, fresh.metadata.labels)
        annotations, d2 = self._dedupe(
            annotations, fresh.metadata.annotations
        )
        if d1 or d2:
            self._count("suppressed", d1 + d2)
        if not labels and not annotations:
            return fresh
        out = self._patch_once(name, labels, annotations)
        self._count("writes")
        self._count("writes_mutating")
        return out

    def write_node(
        self,
        name: str,
        labels: Optional[dict[str, Optional[str]]] = None,
        annotations: Optional[dict[str, Optional[str]]] = None,
        node: Optional[Node] = None,
    ) -> Optional[Node]:
        """Stage-and-flush convenience for producers without a provider
        (e.g. the durable rung store).  Inside a scope the write defers
        to scope exit; outside it flushes immediately (fence-checked)."""
        intent = self.stage(name, labels, annotations, node=node)
        if intent is None:
            return None  # joined the open scope
        return self.flush_intent(intent)

    def flush_nodes(
        self,
        names: Optional[list[str]] = None,
        post: Optional[Callable[[NodeIntent, Optional[Node]], None]] = None,
        on_error: Optional[Callable[[NodeIntent, Exception], None]] = None,
    ) -> list[NodeIntent]:
        """Flush pending node intents (all when ``names`` is None) with
        bounded parallelism.  Fence first: a deposed leader's queued
        plan is dropped whole.  Every intent is attempted; the first
        error re-raises after the batch completes (run_batch
        semantics)."""
        from k8s_operator_libs_tpu_torch.upgrade.util import run_batch

        with self._lock:
            targets = (
                sorted(self._pending) if names is None else list(names)
            )
        if not targets:
            return []
        if self._fenced(targets):
            self._drop_fenced(targets)
            return []
        taken: list[NodeIntent] = []
        with self._lock:
            for name in targets:
                intent = self._pending.pop(name, None)
                if intent is not None and not intent.empty():
                    taken.append(intent)
        if not taken:
            return []
        self._count("flushes")

        flushed: list[NodeIntent] = []
        flushed_lock = threading.Lock()

        def _one(intent: NodeIntent) -> None:
            try:
                fresh = self.flush_intent(intent)
            except Exception as e:
                if on_error is not None:
                    with contextlib.suppress(Exception):
                        on_error(intent, e)
                raise
            if fresh is not None:
                with flushed_lock:
                    flushed.append(intent)
                if post is not None:
                    post(intent, fresh)

        run_batch(
            [lambda i=i: _one(i) for i in taken],
            max_workers=self.max_concurrency,
        )
        return flushed

    # -- flush: CR status ---------------------------------------------

    def flush_status(self) -> int:
        """Flush staged CR status updates on the status flow.  A dry
        bucket defers (the next tick re-stages the freshest status); a
        409 replays once onto a fresh read; NotFound drops.  Other
        errors propagate to the caller (matching the controller's
        previous direct-write behavior)."""
        with self._lock:
            staged = list(self._status.items())
        written = 0
        for key, intent in staged:
            if self.fence is not None:
                try:
                    leading = self.fence()
                except Exception:  # noqa: BLE001
                    leading = False
                if not leading:
                    with self._lock:
                        self._status.pop(key, None)
                    self._count("fenced_drops_status")
                    continue
            if not self.flows.acquire(FLOW_STATUS):
                continue  # deferred — stays staged
            with self._lock:
                self._status.pop(key, None)
            try:
                self.client.update_custom_object_status(
                    intent.group,
                    intent.version,
                    intent.plural,
                    intent.namespace,
                    intent.obj,
                )
            except ConflictError:
                self._count("status_conflict_replays")
                if self._replay_status(intent):
                    written += 1
                continue
            except NotFoundError:
                self._count("status_dropped_notfound")
                continue
            except ThrottledError as e:
                self.flows.feedback(
                    FLOW_STATUS, getattr(e, "retry_after_s", None)
                )
                raise
            written += 1
            self._count("writes")
            self._count("writes_status")
        return written

    def _replay_status(self, intent: _StatusIntent) -> bool:
        """409 on a status write: re-read the CR, graft the staged
        status onto the fresh object, re-apply once."""
        try:
            fresh = self.client.get_custom_object(
                intent.group,
                intent.version,
                intent.plural,
                intent.namespace,
                intent.name,
            )
        except Exception:  # noqa: BLE001 — CR gone or unreadable: drop
            return False
        fresh["status"] = intent.obj.get("status", {})
        try:
            self.client.update_custom_object_status(
                intent.group,
                intent.version,
                intent.plural,
                intent.namespace,
                fresh,
            )
        except (ConflictError, NotFoundError):
            return False  # second conflict is fatal per the taxonomy
        self._count("writes")
        self._count("writes_status")
        return True

    # -- flush: events -------------------------------------------------

    def flush_events(self, force: bool = False) -> int:
        """Publish aggregated events on the status flow.  Each entry
        publishes at most one count-carrying event per window; a dry
        bucket stops the drain (the remainder publishes next tick)."""
        published = 0
        for entry in self.aggregator.drain_publishable(force=force):
            if self.fence is not None:
                try:
                    leading = self.fence()
                except Exception:  # noqa: BLE001
                    leading = False
                if not leading:
                    self.aggregator.mark_published(entry)
                    self._count("fenced_drops_events")
                    continue
            if not self.flows.acquire(FLOW_STATUS):
                break
            absorbed = entry.count
            total = self.aggregator.mark_published(entry)
            event = dict(entry.event)
            event["count"] = total
            involved = event.get("involvedObject") or {}
            obj = involved.get("name", "object")
            event.setdefault("metadata", {})
            event["metadata"] = dict(event["metadata"])
            event["metadata"].setdefault(
                "name", f"{obj}.{uuid.uuid4().hex[:12]}"
            )
            try:
                self.client.create_event(entry.namespace, event)
            except ThrottledError as e:
                self.flows.feedback(
                    FLOW_STATUS, getattr(e, "retry_after_s", None)
                )
                self._count("event_publish_errors")
                continue
            except Exception as e:  # noqa: BLE001 — telemetry best-effort
                logger.debug("event publish failed: %s", e)
                self._count("event_publish_errors")
                continue
            published += 1
            self._count("writes")
            self._count("writes_status")
            self._count("events_published")
            if absorbed > 1:
                self._count("events_aggregated", absorbed - 1)
        return published
