"""Synchronized node mutation with read-your-writes guarantees.

Capability parity with the reference's ``NodeUpgradeStateProvider``
(node_upgrade_state_provider.go:33-216): per-node keyed mutex, label patch
for the upgrade state, merge-patch for annotations with the ``"null"``
delete convention, then **poll the (possibly stale) read cache until the
write is visible** — the trick that makes the stateless reconcile loop safe
when the controller cache lags the apiserver
(node_upgrade_state_provider.go:92-99).

TPU redesign on top of parity: **batched group transitions** riding the
transactional write plane (``k8s/writeplan.py``).  The reference pays
(patch + up-to-10s poll) serially per node; on a 16-host v5p-64 slice
that alone eats the <2 min downtime budget (SURVEY.md §7 'hard parts').
``change_nodes_upgrade_state`` issues all patches concurrently and then
polls all nodes concurrently, so a whole slice's label flip costs one
round-trip + one cache-sync wait, not N.

Every write is an *intent* staged into the shared, thread-safe
:class:`~k8s_operator_libs_tpu_torch.k8s.writeplan.WritePlan` (which replaced
the old thread-local ``_WriteBatch``): the engine pass coalesces inside
``batched()`` scopes while drain/probe/validation worker threads flush
standalone intents through the same dedupe / fence / flow-control /
409-replay path, so their durable-clock patches coalesce too.  Writes
whose value already matches the cached object are suppressed at stage
time and counted in ``writes_suppressed_total``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.objects import Node
from k8s_operator_libs_tpu_torch.k8s.writeplan import NodeIntent, WritePlan
from k8s_operator_libs_tpu_torch.upgrade.consts import NULL_STRING, UpgradeState
from k8s_operator_libs_tpu_torch.upgrade.util import (
    EVENT_TYPE_NORMAL,
    EVENT_TYPE_WARNING,
    EventRecorder,
    KeyedMutex,
    UpgradeKeys,
    log_event,
    run_batch,
)

logger = get_logger(__name__)


class CacheSyncTimeout(RuntimeError):
    """The written value never became visible in the read cache."""


def node_ready(node: Node) -> bool:
    """Single source of truth for node readiness.

    A Ready condition with status ``Unknown`` (node-lifecycle controller
    lost contact with the kubelet) counts as NOT ready — same as
    ``False`` — because a slice cannot roll on a host whose state is
    unknowable.  Absent Ready condition counts as ready (matches
    reference upgrade_state.go:986-993 via Node.is_ready)."""
    return node.is_ready()


class NodeUpgradeStateProvider:
    """Synchronized node label/annotation writes with cache-sync waits."""

    def __init__(
        self,
        client: KubeClient,
        keys: UpgradeKeys,
        event_recorder: Optional[EventRecorder] = None,
        poll_interval_s: float = 1.0,
        poll_timeout_s: float = 10.0,
        max_concurrency: int = 32,
        max_staleness_s: float = 30.0,
        plan: Optional[WritePlan] = None,
    ) -> None:
        # Reference defaults: 1 s poll, 10 s timeout
        # (node_upgrade_state_provider.go:100-103).
        self.client = client
        self.keys = keys
        self.event_recorder = event_recorder
        self.poll_interval_s = poll_interval_s
        self.poll_timeout_s = poll_timeout_s
        self.max_concurrency = max_concurrency
        # Staleness guard for decision-feeding reads: build_state and
        # the managers act on what get_node returns (cordon, drain,
        # state transitions), so a cache older than this bound is
        # upgraded to a quorum read by the client.  The write-then-poll
        # waits below intentionally do NOT pass it — they are
        # convergence polls and the whole point is to read the cache.
        self.max_staleness_s = max_staleness_s
        self._node_mutex = KeyedMutex()
        # All writes route through the shared write plane: coalescing,
        # no-op suppression, flow control, fence-at-flush, 409 replay.
        self.plan = plan or WritePlan(
            client, max_concurrency=max_concurrency
        )
        # Transition observers (phase clocks, trace recorder, ...):
        # each is called once per GROUP transition with
        # (nodes, new_state) BEFORE the new labels are staged —
        # change_nodes_upgrade_state is the one choke point every
        # group-level transition goes through.  Read-only; observers
        # are exception-isolated from each other and a failing observer
        # must never block a transition.
        self._transition_observers: list = []
        # Durable annotation sources (obs/trace.py anchor, obs/
        # telemetry.py history ring): each returns an annotation patch
        # merged into the SAME intent as the state label — crash
        # durability that costs zero extra API writes.  Multicast like
        # the transition observers above; sources are exception-isolated
        # from each other.
        self._transition_annotation_sources: list = []

    # -- transition observers ------------------------------------------------

    @property
    def transition_observer(self):
        """Back-compat single-slot view: the first registered observer
        (None when the list is empty).  Assigning REPLACES the whole
        list — multi-observer users must go through
        :meth:`add_transition_observer`."""
        return (
            self._transition_observers[0]
            if self._transition_observers
            else None
        )

    @transition_observer.setter
    def transition_observer(self, fn) -> None:
        self._transition_observers = [] if fn is None else [fn]

    def add_transition_observer(self, fn) -> None:
        """Register an additional group-transition observer."""
        if fn is not None and fn not in self._transition_observers:
            self._transition_observers.append(fn)

    def remove_transition_observer(self, fn) -> None:
        try:
            self._transition_observers.remove(fn)
        except ValueError:
            pass

    def _fire_transition_observers(self, nodes, new_state) -> None:
        """Multicast with per-observer exception isolation: one raising
        observer never starves the others, and none can block the
        transition itself."""
        for observer in list(self._transition_observers):
            try:
                observer(nodes, new_state)
            except Exception:
                logger.exception("transition observer failed; continuing")

    @property
    def transition_annotation_source(self):
        """Back-compat single-slot view (same contract as
        ``transition_observer``): the first registered source, or None.
        Assigning replaces the whole list."""
        return (
            self._transition_annotation_sources[0]
            if self._transition_annotation_sources
            else None
        )

    @transition_annotation_source.setter
    def transition_annotation_source(self, fn) -> None:
        self._transition_annotation_sources = [] if fn is None else [fn]

    def add_transition_annotation_source(self, fn) -> None:
        """Register an additional durable-annotation source."""
        if fn is not None and fn not in self._transition_annotation_sources:
            self._transition_annotation_sources.append(fn)

    def remove_transition_annotation_source(self, fn) -> None:
        try:
            self._transition_annotation_sources.remove(fn)
        except ValueError:
            pass

    def _trace_annotations(self, node, new_state) -> dict:
        """Durable annotation patches riding the state-label intent
        (fail-open: observability must never block or dirty a
        transition).  Multicast: each source contributes its keys; a
        raising source is isolated and contributes nothing."""
        if not self._transition_annotation_sources:
            return {}
        extra: dict = {}
        for source in list(self._transition_annotation_sources):
            try:
                patch = source(node, new_state)
            except Exception:
                logger.exception("transition annotation source failed")
                continue
            if patch:
                extra.update(patch)
        if not extra:
            return {}
        # Suppress no-op writes against the cached object so an
        # idempotent re-drive stays write-free.
        out = {}
        for key, value in extra.items():
            current = node.metadata.annotations.get(key)
            if value is None and key not in node.metadata.annotations:
                continue
            if value is not None and current == value:
                continue
            out[key] = value
        return out

    # -- write coalescing ----------------------------------------------------

    @contextlib.contextmanager
    def batched(self):
        """Coalesce node writes into one patch per node via the write
        plan.

        Inside the context, ``change_node(s)_upgrade_state`` /
        ``change_node(s)_upgrade_annotation`` apply their mutation to the
        caller's Node objects immediately (read-your-writes within the
        pass) and stage the API write as a plan intent; on exit every
        node gets a single combined labels+annotations patch
        (``patch_node_metadata``) and one cache-sync wait.  A transition
        that today costs a label patch plus N annotation round trips per
        node collapses to one.

        Nested use joins the outer scope.  Scopes are per-thread over
        the shared plan, so concurrently-running workers stage into the
        same plan without cross-flushing each other's scopes.  If the
        body raises, this scope's staged intents are discarded (the old
        batch-drop semantics) — the next idempotent pass re-drives them.
        """
        scope = self.plan.begin_scope()
        if scope is None:
            yield self
            return
        ok = False
        try:
            yield self
            ok = True
        finally:
            names = self.plan.end_scope(scope)
            if not ok:
                self.plan.discard(names)
        self._flush_names(names)

    def _flush_names(self, names: list[str]) -> None:
        if not names:
            return

        def _post(intent: NodeIntent, fresh: Node) -> None:
            node = intent.node
            if node is None:
                return
            with self._node_mutex.lock(intent.name):
                self._wait_metadata_visible(
                    node, intent.labels, intent.annotations
                )

        def _on_error(intent: NodeIntent, exc: Exception) -> None:
            log_event(
                self.event_recorder,
                intent.name,
                EVENT_TYPE_WARNING,
                self.keys.event_reason,
                "Failed to apply coalesced node metadata patch",
            )

        self.plan.flush_nodes(names, post=_post, on_error=_on_error)

    def _wait_metadata_visible(
        self,
        node: Node,
        labels: dict[str, Optional[str]],
        annotations: dict[str, Optional[str]],
    ) -> None:
        """Poll the read cache until every batched key shows its patched
        value (None = absent) — the same write-then-poll contract as the
        single-key waits, amortized over the whole patch."""
        deadline = time.monotonic() + self.poll_timeout_s
        while True:
            try:
                fresh = self.client.get_node(node.name, cached=True)
            except NotFoundError:
                fresh = None
            if fresh is not None:
                ok = all(
                    fresh.labels.get(k) == v
                    if v is not None
                    else k not in fresh.labels
                    for k, v in labels.items()
                ) and all(
                    fresh.annotations.get(k) == v
                    if v is not None
                    else k not in fresh.annotations
                    for k, v in annotations.items()
                )
                if ok:
                    node.metadata = fresh.metadata
                    node.spec = fresh.spec
                    node.status = fresh.status
                    return
            if time.monotonic() >= deadline:
                raise CacheSyncTimeout(
                    f"node {node.name}: coalesced patch "
                    f"({len(labels)} labels, {len(annotations)} "
                    f"annotations) not visible within {self.poll_timeout_s}s"
                )
            time.sleep(
                min(self.poll_interval_s, max(0.0, deadline - time.monotonic()))
            )

    # -- reads -------------------------------------------------------------

    def get_node(self, node_name: str) -> Node:
        with self._node_mutex.lock(node_name):
            return self.client.get_node(
                node_name, cached=True, max_staleness_s=self.max_staleness_s
            )

    # -- single-node writes (reference parity) ------------------------------

    def change_node_upgrade_state(self, node: Node, new_state: UpgradeState) -> None:
        """Patch the state label and wait until the cache shows it."""
        # UNKNOWN means "label absent": a strategic-merge delete.
        value = new_state.value if new_state != UpgradeState.UNKNOWN else None
        key = self.keys.state_label
        current = node.metadata.labels.get(key)
        if (value is None and key not in node.metadata.labels) or (
            value is not None and current == value
        ):
            # No-op against the cached object: suppress the round trip.
            self.plan.note_suppressed()
            return
        trace_annotations = self._trace_annotations(node, new_state)
        if self.plan.in_scope():
            # Scoped: stage the intent and apply to the caller's object
            # immediately (read-your-writes within the pass); the API
            # write lands at scope exit.
            self.plan.stage(
                node.name,
                labels={key: value},
                annotations=trace_annotations or None,
                node=node,
            )
            if value is None:
                node.metadata.labels.pop(key, None)
            else:
                node.metadata.labels[key] = value
            for akey, avalue in trace_annotations.items():
                if avalue is None:
                    node.metadata.annotations.pop(akey, None)
                else:
                    node.metadata.annotations[akey] = avalue
            return
        intent = self.plan.stage(
            node.name,
            labels={key: value},
            annotations=trace_annotations or None,
            node=node,
        )
        with self._node_mutex.lock(node.name):
            try:
                flushed = self.plan.flush_intent(intent)
            except Exception:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_WARNING,
                    self.keys.event_reason,
                    f"Failed to update node state label to {new_state.value}",
                )
                raise
            if flushed is None:
                return  # suppressed against the snapshot, or fenced
            self._wait_label_visible(node, key, new_state.value)

    def change_node_upgrade_annotation(
        self, node: Node, key: str, value: str
    ) -> None:
        """Patch an annotation; ``value == "null"`` deletes it
        (node_upgrade_state_provider.go:147-150)."""
        patch_value = None if value == NULL_STRING else value
        current = node.metadata.annotations.get(key)
        if (
            patch_value is None and key not in node.metadata.annotations
        ) or (patch_value is not None and current == patch_value):
            self.plan.note_suppressed()
            return
        if self.plan.in_scope():
            self.plan.stage(
                node.name, annotations={key: patch_value}, node=node
            )
            if patch_value is None:
                node.metadata.annotations.pop(key, None)
            else:
                node.metadata.annotations[key] = patch_value
            return
        intent = self.plan.stage(
            node.name, annotations={key: patch_value}, node=node
        )
        with self._node_mutex.lock(node.name):
            try:
                flushed = self.plan.flush_intent(intent)
            except Exception:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_WARNING,
                    self.keys.event_reason,
                    f"Failed to update node annotation {key}={value}",
                )
                raise
            if flushed is None:
                return
            self._wait_annotation_visible(node, key, value)

    # -- batched group writes (TPU-native fast path) -------------------------

    def change_nodes_upgrade_state(
        self, nodes: Sequence[Node], new_state: UpgradeState
    ) -> None:
        """Atomically-intended batch: flip the state label on every node of
        a slice, concurrently, then wait for all writes to be visible.

        Raises on the first failure after all attempts complete, so a
        partially-written slice is re-driven by the next idempotent pass
        (the group's effective_state resolves to the earliest member)."""
        if nodes:
            self._fire_transition_observers(nodes, new_state)
        if self.plan.in_scope():
            # Inside a coalescing scope: fanning out to worker threads
            # would leave this thread's scope behind, so stage in-line
            # (recording an intent is cheap — round trips happen at
            # flush).
            for n in nodes:
                self.change_node_upgrade_state(n, new_state)
            return
        run_batch(
            [
                (lambda n=n: self.change_node_upgrade_state(n, new_state))
                for n in nodes
            ],
            self.max_concurrency,
        )

    def change_nodes_upgrade_annotation(
        self, nodes: Sequence[Node], key: str, value: str
    ) -> None:
        if self.plan.in_scope():
            for n in nodes:
                self.change_node_upgrade_annotation(n, key, value)
            return
        run_batch(
            [
                (lambda n=n: self.change_node_upgrade_annotation(n, key, value))
                for n in nodes
            ],
            self.max_concurrency,
        )

    # -- internals ----------------------------------------------------------

    def _wait_label_visible(
        self, node: Node, label_key: str, expected: str
    ) -> None:
        deadline = time.monotonic() + self.poll_timeout_s
        while True:
            try:
                fresh = self.client.get_node(node.name, cached=True)
            except NotFoundError:
                # Object not yet visible in the read cache — keep polling,
                # that is exactly the situation this loop exists for.
                fresh = None
            actual = fresh.labels.get(label_key, "") if fresh else None
            if fresh is not None and actual == expected:
                # Refresh caller's node object (the reference mutates the
                # passed *corev1.Node via Get into it).
                node.metadata = fresh.metadata
                node.spec = fresh.spec
                node.status = fresh.status
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_NORMAL,
                    self.keys.event_reason,
                    f"Successfully updated node state label to {expected}",
                )
                return
            if time.monotonic() >= deadline:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_WARNING,
                    self.keys.event_reason,
                    f"Failed to update node state label to {expected}: "
                    "cache sync timeout",
                )
                raise CacheSyncTimeout(
                    f"node {node.name}: label {label_key}={expected!r} not "
                    f"visible within {self.poll_timeout_s}s (saw {actual!r})"
                )
            time.sleep(min(self.poll_interval_s, max(0.0, deadline - time.monotonic())))

    def _wait_annotation_visible(self, node: Node, key: str, value: str) -> None:
        deadline = time.monotonic() + self.poll_timeout_s
        while True:
            try:
                fresh = self.client.get_node(node.name, cached=True)
            except NotFoundError:
                fresh = None
            if fresh is None:
                ok = False
                actual = None
            else:
                actual = fresh.annotations.get(key)
                ok = (
                    (actual is None)
                    if value == NULL_STRING
                    else (actual == value)
                )
            if ok:
                node.metadata = fresh.metadata
                node.spec = fresh.spec
                node.status = fresh.status
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_NORMAL,
                    self.keys.event_reason,
                    f"Successfully updated node annotation {key}={value}",
                )
                return
            if time.monotonic() >= deadline:
                log_event(
                    self.event_recorder,
                    node.name,
                    EVENT_TYPE_WARNING,
                    self.keys.event_reason,
                    f"Failed to update node annotation {key}={value}: "
                    "cache sync timeout",
                )
                raise CacheSyncTimeout(
                    f"node {node.name}: annotation {key}={value!r} not visible "
                    f"within {self.poll_timeout_s}s"
                )
            time.sleep(min(self.poll_interval_s, max(0.0, deadline - time.monotonic())))
