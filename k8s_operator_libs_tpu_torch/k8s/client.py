"""In-memory Kubernetes apiserver: the envtest analogue.

The reference's test/bench substrate is envtest — a real kube-apiserver +
etcd with nothing running behind it (SURVEY.md §4).  This module provides
the same trick natively: :class:`FakeCluster` stores typed objects and
implements the exact API semantics the engine depends on —

- strategic-merge label patches / merge-patch annotations with ``null``
  deletes (node_upgrade_state_provider.go:80,147-150),
- label + field selectors on list calls,
- DaemonSet ControllerRevision hashes,
- the Eviction API path used by drain,
- **configurable cache lag**: reads are served through an optionally
  stale cache, reproducing the controller-runtime cache-coherency
  problem the reference's write-then-poll loop exists to solve
  (node_upgrade_state_provider.go:92-117),
- **configurable per-call latency** and per-verb call counters, so
  bench.py can model apiserver round-trip cost.

Everything is thread-safe: the engine's drain/pod managers run per-slice
worker threads against this client, like the reference's goroutines run
against envtest.
"""

from __future__ import annotations

import base64
import copy
import json
import queue
import threading
import time
import uuid
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from k8s_operator_libs_tpu_torch.k8s.objects import (
    ControllerRevision,
    DaemonSet,
    Node,
    NodeCondition,
    ObjectMeta,
    Pod,
    deep_copy,
    freeze,
    is_frozen,
)
from k8s_operator_libs_tpu_torch.k8s.selectors import (
    matches_labels,
    matches_selector,
)
from k8s_operator_libs_tpu_torch.layers import layer_span


class NotFoundError(KeyError):
    """Object does not exist (or is not yet visible in the read cache)."""


class ConflictError(RuntimeError):
    pass


class ExpiredError(RuntimeError):
    """HTTP 410 Gone: the requested resourceVersion (a watch resume point
    or a list continue token) predates the server's retained history —
    etcd compaction in a real cluster, the bounded watch cache here.  The
    client-go informer contract on receiving this: throw away the resume
    point, RE-LIST, and watch again from the fresh list's
    resourceVersion."""


class EvictionBlockedError(RuntimeError):
    """Eviction rejected by a PodDisruptionBudget (HTTP 429 on the
    Eviction subresource).

    kubectl drain retries these until the drain timeout; DrainHelper does
    the same."""


class ThrottledError(RuntimeError):
    """Request throttled by apiserver priority & fairness (HTTP 429 on a
    non-eviction path).  Retryable; carries the server's Retry-After
    seconds when provided."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ServerError(RuntimeError):
    """HTTP 5xx: the apiserver (or something between) failed to serve the
    request.  Transient by classification (retry.is_transient) — the
    canonical breaker-opening failure when it persists."""

    def __init__(self, message: str, status: int = 500) -> None:
        super().__init__(message)
        self.status = status


class InvalidError(ValueError):
    """Object rejected by schema validation (HTTP 422 Invalid) — what a
    real apiserver returns when a CR violates its CRD's structural
    schema.  ``causes`` carries per-field error strings."""

    def __init__(self, message: str, causes: Optional[list[str]] = None):
        super().__init__(message)
        self.causes = list(causes or [])


_HISTORY_CAP = 64


@dataclass
class WatchEvent:
    """One change notification: ADDED | MODIFIED | DELETED + a snapshot
    of the object at mutation time (typed object for built-in kinds).

    ``rv``: the cluster resourceVersion assigned to this change — the
    consumer's watch resume point (pass it back as ``since_rv``)."""

    type: str
    kind: str
    object: object
    rv: int = 0


# Guards the one-time in-place freeze of a shared event snapshot.  This is
# deliberately NOT the cluster lock: freezing happens on consumer threads,
# and the only contention is two subscribers racing to freeze the same
# event — never a consumer blocking an API writer.
_freeze_lock = threading.Lock()


class WatchSubscription:
    """Handle for one watch: iterate/get events, close to unsubscribe."""

    def __init__(self, cluster: "FakeCluster", entry) -> None:
        self._cluster = cluster
        self._entry = entry
        self._queue: queue.Queue = entry[1]

    def get(self, timeout_s: Optional[float] = None) -> Optional[WatchEvent]:
        """Next event, or None on timeout.

        The queued event's snapshot is SHARED (with the event log, the
        cache-lag history, and every other subscriber) — publishing
        enqueues one object under the cluster lock instead of paying a
        per-watcher deepcopy while holding it.  Isolation is by
        immutability, not copying: the first consumer to dequeue an
        event freezes its snapshot in place (on the consumer's thread),
        and every subscriber then shares that one frozen copy — reads
        are free, mutation raises FrozenObjectError, and a consumer
        that needs a private mutable object calls deep_copy() (which
        thaws) exactly where it needs it."""
        try:
            ev = self._queue.get(timeout=timeout_s)
        except queue.Empty:
            return None
        obj = ev.object
        if obj is None:
            return ev
        if not is_frozen(obj):
            with _freeze_lock:
                ev.object = obj = freeze(ev.object)
        return WatchEvent(ev.type, ev.kind, obj, ev.rv)

    def close(self) -> None:
        self._cluster._unwatch(self._entry)

    def __enter__(self) -> "WatchSubscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Store:
    """One kind's storage with per-key write history for cache-lag reads
    and an optional change callback (the watch feed).

    ``next_rv`` draws from the cluster-wide revision counter: like etcd,
    every write to ANY kind advances one shared sequence, and an object's
    resourceVersion is the revision of its last write — which is what
    makes a single list-envelope RV a valid resume point for watches over
    every kind."""

    def __init__(self, on_change=None, next_rv=None) -> None:
        self.objs: dict = {}
        # key -> [(monotonic_ts, snapshot-or-None)]; None = deleted
        self.history: dict = defaultdict(list)
        # Called as on_change(event_type, snapshot) with "ADDED" |
        # "MODIFIED" | "DELETED" after every mutation.
        self.on_change = on_change
        self.next_rv = next_rv or _counter()

    def put(self, key, obj) -> None:
        event = "MODIFIED" if key in self.objs else "ADDED"
        obj.metadata.resource_version = self.next_rv()
        self.objs[key] = obj
        h = self.history[key]
        snap = deep_copy(obj)
        h.append((time.monotonic(), snap))
        if len(h) > _HISTORY_CAP:
            del h[: len(h) - _HISTORY_CAP]
        if self.on_change is not None:
            self.on_change(event, snap)

    def delete(self, key) -> None:
        gone = self.objs.pop(key, None)
        self.history[key].append((time.monotonic(), None))
        if gone is not None:
            # A delete advances the cluster revision too; the DELETED
            # event carries the object at its deletion revision.
            gone.metadata.resource_version = self.next_rv()
            if self.on_change is not None:
                self.on_change("DELETED", deep_copy(gone))

    def get_live(self, key):
        return self.objs.get(key)

    def get_cached(self, key, lag_s: float):
        """Newest snapshot at least ``lag_s`` old; None if not yet visible."""
        if lag_s <= 0:
            return self.objs.get(key)
        cutoff = time.monotonic() - lag_s
        chosen = None
        for ts, snap in self.history.get(key, ()):  # oldest -> newest
            if ts <= cutoff:
                chosen = snap
            else:
                break
        return chosen


def _counter():
    """Standalone revision counter for a _Store used outside a cluster."""
    state = {"rv": 0}

    def next_rv() -> int:
        state["rv"] += 1
        return state["rv"]

    return next_rv


class FakeCluster:
    """In-memory apiserver + object store (see module docstring)."""

    def __init__(
        self,
        api_latency_s: float = 0.0,
        cache_lag_s: float = 0.0,
        watch_cache_size: int = 1024,
    ):
        self._lock = threading.RLock()
        # Cluster-wide revision counter (the etcd revision analogue):
        # every write to any kind advances it; an object's
        # resourceVersion is the revision of its last write.
        self._rv = 0
        # Bounded history of published watch events [(rv, WatchEvent)]:
        # the watch cache.  Resume points older than its tail are GONE —
        # the 410/relist behavior a real apiserver shows after etcd
        # compaction.  ``_log_evicted_to``: highest rv already evicted.
        self._watch_cache_size = max(int(watch_cache_size), 1)
        self._event_log: list[tuple[int, WatchEvent]] = []
        self._log_evicted_to = 0
        self._nodes = _Store(self._make_notifier("Node"), self._next_rv)
        self._pods = _Store(self._make_notifier("Pod"), self._next_rv)
        self._daemon_sets = _Store(
            self._make_notifier("DaemonSet"), self._next_rv
        )
        self._revisions = _Store(
            self._make_notifier("ControllerRevision"), self._next_rv
        )
        # Active watch subscriptions: list of (kinds-or-None, Queue).
        self._watchers: list[tuple[Optional[set], "queue.Queue"]] = []
        self.api_latency_s = api_latency_s
        self.cache_lag_s = cache_lag_s
        # verb -> count; exposed for bench round-trip accounting
        self.stats: Counter = Counter()
        self._pod_deleted_hooks: list[Callable[[Pod], None]] = []
        # Registered CRDs: (group, version, plural) -> admission validator.
        self._custom_kinds: dict[
            tuple[str, str, str], Optional[Callable[[dict], list[str]]]
        ] = {}
        # (group, version, plural, namespace, name) -> raw object dict.
        self._custom: dict[tuple[str, str, str, str, str], dict] = {}
        # core/v1 Events, append-only with a cap (see create_event).
        self._events: list[dict] = []
        # (namespace, name) pairs whose eviction a PodDisruptionBudget
        # currently blocks (429 in the real API) — test/bench knob.
        self._eviction_blocked: set[tuple[str, str]] = set()
        # Optional fault injector called before every verb; raising makes
        # the call fail like a flaky apiserver (chaos-test knob — the
        # reference has no fault injection at all, SURVEY.md §5).
        self.fault_injector: Optional[Callable[[str], None]] = None
        # Optional structured fault schedule (k8s.faults.FaultSchedule):
        # consulted per verb after fault_injector; raises the mapped
        # client exception (429/5xx/reset/timeout/409), and watch_drop
        # rules end watch_events streams mid-flight.
        self.fault_schedule = None

    # -- plumbing ----------------------------------------------------------

    def _next_rv(self) -> int:
        with self._lock:
            self._rv += 1
            return self._rv

    @staticmethod
    def _snapshot_rv(snapshot) -> int:
        """resourceVersion of a watch-event object, typed or dict."""
        if isinstance(snapshot, dict):
            return int((snapshot.get("metadata") or {}).get(
                "resourceVersion", 0
            ))
        return int(snapshot.metadata.resource_version)

    def current_resource_version(self) -> int:
        """The cluster's latest revision — what a real list envelope
        carries in ``metadata.resourceVersion``; valid as a watch
        ``since_rv`` resume point."""
        with self._lock:
            return self._rv

    def _notify(self, kind: str, event_type: str, snapshot) -> None:
        # Log-append AND subscriber delivery happen under one lock hold:
        # the bookmark path reads current_resource_version() and treats
        # an empty queue as proof that every event <= that snapshot was
        # delivered.  If the puts happened after releasing the lock, a
        # writer descheduled between rv-advance and q.put would let a
        # BOOKMARK advance past an undelivered event, and a client
        # resuming from that bookmark would skip it.  The puts are cheap
        # and non-blocking (unbounded queues), so holding the lock
        # through them is safe.
        with self._lock:
            rv = self._snapshot_rv(snapshot)
            event = WatchEvent(event_type, kind, snapshot, rv)
            self._event_log.append((rv, event))
            while len(self._event_log) > self._watch_cache_size:
                evicted_rv, _ = self._event_log.pop(0)
                self._log_evicted_to = evicted_rv
            for kinds, q in self._watchers:
                if kinds is None or kind in kinds:
                    # The SHARED event object is enqueued — no per-
                    # watcher deepcopy while holding the cluster-global
                    # lock (at 256-node scale that would serialize every
                    # API call behind O(watchers x object-size) copying).
                    # WatchSubscription.get makes the isolating copy on
                    # the consumer's thread.
                    q.put(event)

    def _make_notifier(self, kind: str):
        def notify(event_type: str, snapshot) -> None:
            self._notify(kind, event_type, snapshot)

        return notify

    def watch(
        self,
        kinds: Optional[Sequence[str]] = None,
        since_rv: Optional[int] = None,
    ) -> "WatchSubscription":
        """Subscribe to object changes (the informer/watch analogue).

        ``kinds`` filters by kind name ("Node", "Pod", "DaemonSet",
        "ControllerRevision"); None = all.  Events carry a snapshot of
        the object at mutation time.  Close the subscription (or use it
        as a context manager) to unsubscribe.

        ``since_rv`` resumes from a resourceVersion (a prior list
        envelope's RV or the last event's ``rv``): every retained event
        with a higher rv is replayed first, then the live feed continues
        — the watch-from-resourceVersion contract clients use to bridge
        a reconnect without missing events.  Raises :class:`ExpiredError`
        (410 Gone) when the resume point predates the bounded watch
        cache; the caller must re-list and resume from the fresh RV."""
        q: "queue.Queue" = queue.Queue()
        kind_set = set(kinds) if kinds is not None else None
        entry = (kind_set, q)
        with self._lock:
            if since_rv is not None:
                if since_rv < self._log_evicted_to:
                    raise ExpiredError(
                        f"too old resource version: {since_rv} "
                        f"(oldest retained: {self._log_evicted_to + 1})"
                    )
                for rv, ev in self._event_log:
                    if rv > since_rv and (
                        kind_set is None or ev.kind in kind_set
                    ):
                        # Shared replay too: get() isolates on consume.
                        q.put(ev)
            self._watchers.append(entry)
        return WatchSubscription(self, entry)

    def _unwatch(self, entry) -> None:
        with self._lock:
            if entry in self._watchers:
                self._watchers.remove(entry)

    def watch_events(
        self,
        kinds: Optional[Sequence[str]] = None,
        since_rv: Optional[int] = None,
        bookmarks: bool = False,
    ):
        """Generator form of :meth:`watch`, yielding WatchEvents with
        periodic ``None`` heartbeats (so a consumer can check its stop
        flag while idle).  Same duck type as RestClient.watch_events —
        including custom-resource kinds given as
        "group/version/namespace/plural" (normalized to the plural,
        which is how CR watch events are keyed).

        ``since_rv=None``: live-only, no replay — pair with a periodic
        full resync, exactly like controller-runtime.  With ``since_rv``
        the retained history after that RV replays first (see
        :meth:`watch`); :class:`ExpiredError` means re-list.

        ``bookmarks=True`` (the allowWatchBookmarks contract): when the
        cluster revision advances past everything this stream has
        delivered, idle heartbeats carry BOOKMARK events (``object``
        None, ``rv`` = a safe resume point) — one per watched kind —
        so a consumer's resume point stays fresh on kinds that rarely
        change and a reconnect doesn't 410 just because OTHER kinds
        churned the watch cache."""
        if kinds is not None:
            kinds = [k.split("/")[-1] if "/" in k else k for k in kinds]
        sub = self.watch(kinds, since_rv=since_rv)
        # Per KIND: one churning kind's delivered events must not
        # suppress BOOKMARKs for a quiet kind (the quiet kind is exactly
        # who needs them; also matches the wire tier, where each kind is
        # its own stream).  kinds=None bookmarks the same built-in trio
        # the wire tier's default streams cover.
        marks = {
            k: since_rv or 0
            for k in (kinds if kinds is not None
                      else ["Node", "Pod", "DaemonSet"])
        }
        try:
            while True:
                schedule = self.fault_schedule
                if schedule is not None:
                    if schedule.decide_watch_drop("watch") is not None:
                        # Injected stream drop: end the generator like a
                        # server closing the connection — the consumer's
                        # reconnect contract (re-list, re-watch) applies.
                        return
                # Snapshot BEFORE the timed get: an empty queue over the
                # get window proves every event <= snapshot was already
                # delivered, so the snapshot is a safe bookmark.  (Only
                # needed when bookmarking — skip the lock acquire on the
                # default hot path.)
                snapshot = (
                    self.current_resource_version() if bookmarks else 0
                )
                ev = sub.get(timeout_s=0.5)
                if ev is not None:
                    if ev.rv and ev.kind in marks:
                        marks[ev.kind] = max(marks[ev.kind], ev.rv)
                    yield ev
                    continue
                if bookmarks:
                    stale = [k for k, m in marks.items() if snapshot > m]
                    if stale:
                        for kind in stale:
                            marks[kind] = snapshot
                            yield WatchEvent(
                                "BOOKMARK", kind, None, snapshot
                            )
                        continue
                yield None
        finally:
            sub.close()

    def _call(self, verb: str) -> None:
        with layer_span("k8s", verb):
            self.stats[verb] += 1
            if self.api_latency_s > 0:
                time.sleep(self.api_latency_s)
            if self.fault_injector is not None:
                self.fault_injector(verb)
            if self.fault_schedule is not None:
                self.fault_schedule.raise_for(verb)
                # Data-plane faults (node NotReady/flap/delete, stuck
                # pods, crash loops) mutate CLUSTER STATE rather than
                # failing this call; API traffic is their clock, so both
                # tiers (fake verbs and wire requests routed through this
                # store) tick them.
                self._apply_data_plane_faults(verb)

    def on_pod_deleted(self, hook: Callable[[Pod], None]) -> None:
        """Register a hook fired after a pod is deleted/evicted (lets tests
        and bench emulate the DaemonSet controller recreating driver pods)."""
        self._pod_deleted_hooks.append(hook)

    # -- nodes -------------------------------------------------------------

    def create_node(self, node: Node) -> Node:
        self._call("create_node")
        with self._lock:
            if self._nodes.get_live(node.name) is not None:
                raise ConflictError(f"node {node.name} exists")
            self._nodes.put(node.name, node)
            return deep_copy(node)

    def get_node(
        self,
        name: str,
        cached: bool = True,
        max_staleness_s: Optional[float] = None,
    ) -> Node:
        """Read a node. ``cached=True`` models the controller-runtime cache
        (subject to cache lag); ``cached=False`` is a quorum read.  A
        ``max_staleness_s`` bound tighter than the configured cache lag
        upgrades the read to quorum — the staleness-guard contract for
        reads that feed mutating decisions."""
        self._call("get_node")
        if (
            cached
            and max_staleness_s is not None
            and self.cache_lag_s > max_staleness_s
        ):
            cached = False
        with self._lock:
            obj = (
                self._nodes.get_cached(name, self.cache_lag_s)
                if cached
                else self._nodes.get_live(name)
            )
            if obj is None:
                raise NotFoundError(f"node {name}")
            return deep_copy(obj)

    def list_nodes(self, label_selector: str = "") -> list[Node]:
        self._call("list_nodes")
        with self._lock:
            return [
                deep_copy(n)
                for n in self._nodes.objs.values()
                if matches_selector(n.labels, label_selector)
            ]

    def patch_node_labels(self, name: str, patch: dict[str, Optional[str]]) -> Node:
        """Strategic-merge patch of ``metadata.labels`` (None deletes)."""
        self._call("patch_node")
        with self._lock:
            node = self._nodes.get_live(name)
            if node is None:
                raise NotFoundError(f"node {name}")
            for k, v in patch.items():
                if v is None:
                    node.metadata.labels.pop(k, None)
                else:
                    node.metadata.labels[k] = v
            self._nodes.put(name, node)
            return deep_copy(node)

    def patch_node_annotations(
        self, name: str, patch: dict[str, Optional[str]]
    ) -> Node:
        """Merge patch of ``metadata.annotations`` (None deletes — the
        reference's ``"null"`` convention, node_upgrade_state_provider.go:147)."""
        self._call("patch_node")
        with self._lock:
            node = self._nodes.get_live(name)
            if node is None:
                raise NotFoundError(f"node {name}")
            for k, v in patch.items():
                if v is None:
                    node.metadata.annotations.pop(k, None)
                else:
                    node.metadata.annotations[k] = v
            self._nodes.put(name, node)
            return deep_copy(node)

    def patch_node_metadata(
        self,
        name: str,
        labels: Optional[dict[str, Optional[str]]] = None,
        annotations: Optional[dict[str, Optional[str]]] = None,
        field_manager: Optional[str] = None,
    ) -> Node:
        """Combined labels+annotations merge patch: ONE API call (one
        stats tick), atomic under the store lock — the coalesced write
        path batched slice transitions ride.  ``field_manager`` is
        recorded for test introspection (the fake has no managedFields
        machinery)."""
        self._call("patch_node")
        if field_manager is not None:
            self.last_field_manager = field_manager
        with self._lock:
            node = self._nodes.get_live(name)
            if node is None:
                raise NotFoundError(f"node {name}")
            for k, v in (labels or {}).items():
                if v is None:
                    node.metadata.labels.pop(k, None)
                else:
                    node.metadata.labels[k] = v
            for k, v in (annotations or {}).items():
                if v is None:
                    node.metadata.annotations.pop(k, None)
                else:
                    node.metadata.annotations[k] = v
            self._nodes.put(name, node)
            return deep_copy(node)

    def set_node_unschedulable(self, name: str, unschedulable: bool) -> Node:
        self._call("patch_node")
        with self._lock:
            node = self._nodes.get_live(name)
            if node is None:
                raise NotFoundError(f"node {name}")
            node.spec.unschedulable = unschedulable
            self._nodes.put(name, node)
            return deep_copy(node)

    def set_node_ready(self, name: str, ready: bool) -> Node:
        self._call("patch_node")
        with self._lock:
            node = self._nodes.get_live(name)
            if node is None:
                raise NotFoundError(f"node {name}")
            for cond in node.status.conditions:
                if cond.type == "Ready":
                    cond.status = "True" if ready else "False"
                    break
            else:
                node.status.conditions.append(
                    NodeCondition("Ready", "True" if ready else "False")
                )
            self._nodes.put(name, node)
            return deep_copy(node)

    def delete_node(self, name: str) -> None:
        """Delete a node, garbage-collecting its pods the way the pod GC
        does for a vanished kubelet: force (finalizers cannot hold a pod
        on hardware that no longer exists).  DaemonSet-owned pods also
        decrement their owner's desiredNumberScheduled — the DS
        controller's bookkeeping — so build_state's completeness guard
        stays coherent after the loss."""
        self._call("delete_node")
        with self._lock:
            if self._nodes.get_live(name) is None:
                raise NotFoundError(f"node {name}")
            self._delete_node_locked(name)

    def _delete_node_locked(self, name: str) -> None:
        doomed = [
            p for p in self._pods.objs.values() if p.spec.node_name == name
        ]
        for pod in doomed:
            for ref in pod.metadata.owner_references:
                if ref.kind != "DaemonSet":
                    continue
                for ds in self._daemon_sets.objs.values():
                    if ds.metadata.uid == ref.uid:
                        ds.status.desired_number_scheduled = max(
                            0, ds.status.desired_number_scheduled - 1
                        )
                        self._daemon_sets.put((ds.namespace, ds.name), ds)
            key = self._pod_key(pod.namespace, pod.name)
            pod.metadata.deletion_timestamp = time.time()
            self._pods.delete(key)
            self._eviction_blocked.discard(key)
        self._nodes.delete(name)

    # -- data-plane fault application ---------------------------------------

    def _apply_data_plane_faults(self, verb: str) -> None:
        """Apply any node/pod faults the schedule fires for this verb.
        Mutations go through the internal locked paths (not the public
        verbs), so applying a fault never re-enters fault evaluation."""
        schedule = self.fault_schedule
        if schedule is None:
            return
        for fault in schedule.decide_data_plane(verb):
            with self._lock:
                if fault.kind in ("node_down", "node_flap"):
                    for name in list(self._nodes.objs):
                        if fault.target in name:
                            node = self._nodes.objs[name]
                            ready = (
                                not node.is_ready()
                                if fault.kind == "node_flap"
                                else False
                            )
                            self._set_node_ready_locked(node, ready)
                elif fault.kind == "node_delete":
                    for name in list(self._nodes.objs):
                        if fault.target in name:
                            self._delete_node_locked(name)
                elif fault.kind == "node_preempt":
                    # amount >= 1: preempt (stamp + NotReady);
                    # amount == 0: the node returns (clear + Ready).
                    from k8s_operator_libs_tpu_torch.upgrade.consts import (
                        NODE_PREEMPTION_ANNOTATION,
                    )

                    preempted = fault.amount >= 1
                    for name in list(self._nodes.objs):
                        if fault.target in name:
                            node = self._nodes.objs[name]
                            if preempted:
                                node.metadata.annotations[
                                    NODE_PREEMPTION_ANNOTATION
                                ] = str(int(time.time()))
                            else:
                                node.metadata.annotations.pop(
                                    NODE_PREEMPTION_ANNOTATION, None
                                )
                            self._set_node_ready_locked(node, not preempted)
                elif fault.kind == "pod_stick":
                    for key in list(self._pods.objs):
                        if fault.target in key[1]:
                            pod = self._pods.objs[key]
                            if not pod.metadata.finalizers:
                                pod.metadata.finalizers.append(
                                    "fault-injection/stuck-terminating"
                                )
                                self._pods.put(key, pod)
                elif fault.kind == "pod_crashloop":
                    for key in list(self._pods.objs):
                        if fault.target in key[1]:
                            pod = self._pods.objs[key]
                            for cs in pod.status.container_statuses:
                                cs.ready = False
                                cs.restart_count += fault.amount
                            self._pods.put(key, pod)

    def _set_node_ready_locked(self, node: Node, ready: bool) -> None:
        status = "True" if ready else "False"
        for cond in node.status.conditions:
            if cond.type == "Ready":
                cond.status = status
                break
        else:
            node.status.conditions.append(NodeCondition("Ready", status))
        self._nodes.put(node.name, node)

    # -- paginated list (the client-go chunked-list contract) ---------------

    def list_page(
        self,
        kind: str,
        namespace: str = "",
        label_selector: str = "",
        limit: Optional[int] = None,
        continue_: Optional[str] = None,
    ) -> dict:
        """Chunked list with continue tokens (client-go pagination).

        Returns ``{"items", "resourceVersion", "continue"}``.  Items are
        served in (namespace, name) key order — how etcd pages a range
        read.  ``continue`` is an opaque token; passing it back serves
        the next chunk.  A token whose snapshot revision has aged out of
        the retained history raises :class:`ExpiredError` (410 Gone,
        reason Expired) and the caller must restart the list — the
        failure mode a real apiserver shows when etcd compacts under a
        slow pager.  (Unlike etcd, chunks after the first serve the
        CURRENT state rather than the original snapshot; the conformance
        properties consumers rely on — full coverage, no duplicates,
        bounded chunks, expiry — hold.)"""
        self._call("list_page")
        with self._lock:
            if kind == "Node":
                objs = {
                    ("", n.name): n
                    for n in self._nodes.objs.values()
                    if matches_selector(n.labels, label_selector)
                }
            elif kind == "Pod":
                objs = {
                    (p.namespace, p.name): p
                    for p in self._pods.objs.values()
                    if (not namespace or p.namespace == namespace)
                    and matches_selector(p.labels, label_selector)
                }
            else:
                raise NotFoundError(f"list_page: unsupported kind {kind}")
            if continue_:
                try:
                    token = json.loads(
                        base64.urlsafe_b64decode(continue_.encode()).decode()
                    )
                    snapshot_rv = int(token["rv"])
                    after = tuple(token["after"])
                except (ValueError, KeyError, TypeError) as exc:
                    raise InvalidError(
                        f"malformed continue token: {exc}"
                    ) from exc
                if snapshot_rv < self._log_evicted_to:
                    raise ExpiredError(
                        "The provided continue parameter is too old to "
                        "display a consistent list result. You must start "
                        "a new list without the continue parameter."
                    )
            else:
                snapshot_rv = self._rv
                after = None
            keys = sorted(k for k in objs if after is None or k > after)
            page = keys if limit is None else keys[: max(int(limit), 0)]
            next_token = None
            if limit is not None and len(keys) > len(page) and page:
                next_token = base64.urlsafe_b64encode(
                    json.dumps(
                        {"rv": snapshot_rv, "after": list(page[-1])}
                    ).encode()
                ).decode()
            return {
                "items": [deep_copy(objs[k]) for k in page],
                "resourceVersion": str(snapshot_rv),
                "continue": next_token,
            }

    # -- pods --------------------------------------------------------------

    @staticmethod
    def _pod_key(namespace: str, name: str) -> tuple[str, str]:
        return (namespace, name)

    def create_pod(self, pod: Pod) -> Pod:
        self._call("create_pod")
        with self._lock:
            key = self._pod_key(pod.namespace, pod.name)
            if self._pods.get_live(key) is not None:
                raise ConflictError(f"pod {key} exists")
            self._pods.put(key, pod)
            return deep_copy(pod)

    def get_pod(self, namespace: str, name: str) -> Pod:
        self._call("get_pod")
        with self._lock:
            obj = self._pods.get_live(self._pod_key(namespace, name))
            if obj is None:
                raise NotFoundError(f"pod {namespace}/{name}")
            return deep_copy(obj)

    def list_pods(
        self,
        namespace: str = "",
        label_selector: str = "",
        node_name: Optional[str] = None,
        match_labels: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        """List pods; ``namespace=""`` lists all namespaces, ``node_name``
        models the ``spec.nodeName=`` field selector (consts.go:71-73)."""
        self._call("list_pods")
        with self._lock:
            out = []
            for pod in self._pods.objs.values():
                if namespace and pod.namespace != namespace:
                    continue
                if node_name is not None and pod.spec.node_name != node_name:
                    continue
                if not matches_selector(pod.labels, label_selector):
                    continue
                if match_labels and not matches_labels(pod.labels, match_labels):
                    continue
                out.append(deep_copy(pod))
            return out

    def update_pod(self, pod: Pod) -> Pod:
        """Replace pod object (tests use this to forge status, mirroring
        envtest status updates — upgrade_suit_test.go:365-368)."""
        self._call("update_pod")
        with self._lock:
            key = self._pod_key(pod.namespace, pod.name)
            if self._pods.get_live(key) is None:
                raise NotFoundError(f"pod {key}")
            self._pods.put(key, pod)
            return deep_copy(pod)

    def delete_pod(
        self,
        namespace: str,
        name: str,
        grace_period_seconds: Optional[int] = None,
    ) -> None:
        self._call("delete_pod")
        self._delete_pod_impl(
            namespace, name, grace_period_seconds=grace_period_seconds
        )

    def set_eviction_blocked(
        self, namespace: str, name: str, blocked: bool = True
    ) -> None:
        """Model a PodDisruptionBudget blocking (or releasing) a pod's
        eviction."""
        with self._lock:
            key = (namespace, name)
            if blocked:
                self._eviction_blocked.add(key)
            else:
                self._eviction_blocked.discard(key)

    def evict_pod(self, namespace: str, name: str) -> None:
        """Eviction-API analogue (what drain actually calls)."""
        self._call("evict_pod")
        with self._lock:
            # Existence first: the real API 404s a deleted pod before any
            # PDB admission check.
            if self._pods.get_live(self._pod_key(namespace, name)) is None:
                raise NotFoundError(f"pod {namespace}/{name}")
            if (namespace, name) in self._eviction_blocked:
                raise EvictionBlockedError(
                    f"Cannot evict pod {namespace}/{name}: disruption budget"
                )
        self._delete_pod_impl(namespace, name)

    def _delete_pod_impl(
        self,
        namespace: str,
        name: str,
        grace_period_seconds: Optional[int] = None,
    ) -> None:
        with self._lock:
            key = self._pod_key(namespace, name)
            pod = self._pods.get_live(key)
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name}")
            if pod.metadata.finalizers and grace_period_seconds != 0:
                # Finalizers hold a graceful delete in Terminating: the
                # deletion timestamp lands, the pod stays served, and no
                # deletion hooks fire until the finalizers are removed or
                # the delete is re-issued with grace period 0.
                if pod.metadata.deletion_timestamp is None:
                    pod.metadata.deletion_timestamp = time.time()
                self._pods.put(key, pod)
                return
            pod.metadata.deletion_timestamp = time.time()
            self._pods.delete(key)
            self._eviction_blocked.discard(key)
            hooks = list(self._pod_deleted_hooks)
        for hook in hooks:
            hook(pod)

    def set_pod_finalizers(
        self, namespace: str, name: str, finalizers: list[str]
    ) -> None:
        """Test knob: replace a pod's finalizers.  Clearing the last
        finalizer on a Terminating pod completes the held deletion (the
        finalizer-controller behaviour the stuck-Terminating fault
        models)."""
        with self._lock:
            key = self._pod_key(namespace, name)
            pod = self._pods.get_live(key)
            if pod is None:
                raise NotFoundError(f"pod {namespace}/{name}")
            pod.metadata.finalizers = list(finalizers)
            if not pod.metadata.finalizers and pod.is_terminating():
                self._pods.delete(key)
                self._eviction_blocked.discard(key)
                hooks = list(self._pod_deleted_hooks)
            else:
                self._pods.put(key, pod)
                hooks = []
        for hook in hooks:
            hook(pod)

    # -- daemonsets + controller revisions ----------------------------------

    def create_daemon_set(self, ds: DaemonSet) -> DaemonSet:
        self._call("create_daemon_set")
        with self._lock:
            key = (ds.namespace, ds.name)
            if self._daemon_sets.get_live(key) is not None:
                raise ConflictError(f"daemonset {key} exists")
            self._daemon_sets.put(key, ds)
            return deep_copy(ds)

    def update_daemon_set(self, ds: DaemonSet) -> DaemonSet:
        self._call("update_daemon_set")
        with self._lock:
            key = (ds.namespace, ds.name)
            if self._daemon_sets.get_live(key) is None:
                raise NotFoundError(f"daemonset {key}")
            self._daemon_sets.put(key, ds)
            return deep_copy(ds)

    def get_daemon_set(self, namespace: str, name: str) -> DaemonSet:
        self._call("get_daemon_set")
        with self._lock:
            obj = self._daemon_sets.get_live((namespace, name))
            if obj is None:
                raise NotFoundError(f"daemonset {namespace}/{name}")
            return deep_copy(obj)

    def list_daemon_sets(
        self, namespace: str = "", match_labels: Optional[dict[str, str]] = None
    ) -> list[DaemonSet]:
        self._call("list_daemon_sets")
        with self._lock:
            return [
                deep_copy(ds)
                for ds in self._daemon_sets.objs.values()
                if (not namespace or ds.namespace == namespace)
                and matches_labels(ds.metadata.labels, match_labels or {})
            ]

    def create_controller_revision(self, rev: ControllerRevision) -> ControllerRevision:
        self._call("create_controller_revision")
        with self._lock:
            key = (rev.metadata.namespace, rev.metadata.name)
            self._revisions.put(key, rev)
            return deep_copy(rev)

    def list_controller_revisions(
        self, namespace: str = "", label_selector: str = ""
    ) -> list[ControllerRevision]:
        self._call("list_controller_revisions")
        with self._lock:
            return [
                deep_copy(r)
                for r in self._revisions.objs.values()
                if (not namespace or r.metadata.namespace == namespace)
                and matches_selector(r.metadata.labels, label_selector)
            ]

    # -- events --------------------------------------------------------------
    # Dict-shaped core/v1 Events (reference util.go:141-153 records one
    # per transition/failure via client-go's EventRecorder; kubectl
    # describe shows them).  Bounded: a busy controller must not grow
    # the store without limit — real clusters TTL events similarly.

    _EVENTS_CAP = 2048

    def create_event(self, namespace: str, event: dict) -> dict:
        self._call("create_event")
        with self._lock:
            stored = copy.deepcopy(event)
            meta = stored.setdefault("metadata", {})
            # Real-apiserver semantics: the CLIENT names the event (or
            # asks for generateName); auto-filling here would mask a
            # publisher that real clusters reject 422.
            if not meta.get("name"):
                if meta.get("generateName"):
                    meta["name"] = (
                        meta["generateName"] + uuid.uuid4().hex[:10]
                    )
                else:
                    raise InvalidError(
                        "metadata.name (or generateName) is required"
                    )
            meta["namespace"] = namespace
            meta["uid"] = f"uid-{uuid.uuid4().hex[:12]}"
            self._events.append(stored)
            if len(self._events) > self._EVENTS_CAP:
                del self._events[: len(self._events) - self._EVENTS_CAP]
            return copy.deepcopy(stored)

    def list_events(
        self, namespace: str = "", involved_name: str = ""
    ) -> list[dict]:
        self._call("list_events")
        with self._lock:
            return [
                copy.deepcopy(e)
                for e in self._events
                if (
                    not namespace
                    or e["metadata"].get("namespace") == namespace
                )
                and (
                    not involved_name
                    or (e.get("involvedObject") or {}).get("name")
                    == involved_name
                )
            ]

    # -- custom resources ----------------------------------------------------
    # Generic dict-shaped CR storage, the apiextensions analogue: a CRD
    # must be registered (like installing config/crd/ on a real cluster)
    # before its group/plural routes exist; an optional validator models
    # the structural-schema admission step (422 Invalid).

    def register_custom_resource(
        self,
        group: str,
        version: str,
        plural: str,
        validator: Optional[Callable[[dict], list[str]]] = None,
    ) -> None:
        """Install a CRD: enable CRUD for ``/apis/{group}/{version}/.../
        {plural}``.  ``validator(obj) -> [errors]`` runs on create/update
        and rejects with :class:`InvalidError` like apiserver admission."""
        with self._lock:
            self._custom_kinds[(group, version, plural)] = validator

    def _custom_kind(self, group: str, version: str, plural: str):
        key = (group, version, plural)
        if key not in self._custom_kinds:
            raise NotFoundError(
                f"the server could not find the requested resource "
                f"({plural}.{group}/{version} — CRD not registered)"
            )
        return key

    def _admit_custom(self, kind_key, obj: dict) -> None:
        validator = self._custom_kinds[kind_key]
        if validator is None:
            return
        errors = validator(obj)
        if errors:
            name = (obj.get("metadata") or {}).get("name", "")
            raise InvalidError(
                f"{kind_key[2]}.{kind_key[0]} {name!r} is invalid: "
                + "; ".join(errors),
                causes=errors,
            )

    def create_custom_object(
        self, group: str, version: str, plural: str, namespace: str, obj: dict
    ) -> dict:
        self._call("create_custom_object")
        with self._lock:
            kind_key = self._custom_kind(group, version, plural)
            name = (obj.get("metadata") or {}).get("name")
            if not name:
                raise InvalidError("metadata.name is required")
            self._admit_custom(kind_key, obj)
            key = kind_key + (namespace, name)
            if key in self._custom:
                raise ConflictError(
                    f"{plural} {namespace}/{name} already exists"
                )
            stored = copy.deepcopy(obj)
            meta = stored.setdefault("metadata", {})
            meta["namespace"] = namespace
            meta["uid"] = f"uid-{uuid.uuid4().hex[:12]}"
            meta["resourceVersion"] = str(self._next_rv())
            self._custom[key] = stored
            # Watch feed keys custom resources by their plural.
            self._notify(plural, "ADDED", copy.deepcopy(stored))
            return copy.deepcopy(stored)

    def get_custom_object(
        self, group: str, version: str, plural: str, namespace: str, name: str
    ) -> dict:
        self._call("get_custom_object")
        with self._lock:
            key = self._custom_kind(group, version, plural) + (namespace, name)
            obj = self._custom.get(key)
            if obj is None:
                raise NotFoundError(f"{plural} {namespace}/{name} not found")
            return copy.deepcopy(obj)

    def _replace_custom(
        self,
        group: str,
        version: str,
        plural: str,
        namespace: str,
        obj: dict,
        subresource_status: bool,
    ) -> dict:
        kind_key = self._custom_kind(group, version, plural)
        name = (obj.get("metadata") or {}).get("name")
        key = kind_key + (namespace, name)
        current = self._custom.get(key)
        if current is None:
            raise NotFoundError(f"{plural} {namespace}/{name} not found")
        sent_rv = (obj.get("metadata") or {}).get("resourceVersion")
        cur_rv = current["metadata"]["resourceVersion"]
        if sent_rv is not None and str(sent_rv) != str(cur_rv):
            raise ConflictError(
                f"{plural} {namespace}/{name}: the object has been "
                f"modified (resourceVersion {sent_rv} != {cur_rv})"
            )
        if subresource_status:
            # The status endpoint replaces ONLY .status; spec edits in
            # the body are ignored (apiextensions subresource semantics).
            stored = copy.deepcopy(current)
            stored["status"] = copy.deepcopy(obj.get("status"))
        else:
            self._admit_custom(kind_key, obj)
            stored = copy.deepcopy(obj)
            # The main resource ignores .status when the status
            # subresource is enabled (all CRDs here declare it): writes
            # to status must go through update_custom_object_status.
            if "status" in current:
                stored["status"] = copy.deepcopy(current["status"])
            else:
                stored.pop("status", None)
        meta = stored.setdefault("metadata", {})
        meta["namespace"] = namespace
        meta["uid"] = current["metadata"]["uid"]
        meta["resourceVersion"] = str(self._next_rv())
        self._custom[key] = stored
        self._notify(plural, "MODIFIED", copy.deepcopy(stored))
        return copy.deepcopy(stored)

    def update_custom_object(
        self, group: str, version: str, plural: str, namespace: str, obj: dict
    ) -> dict:
        """Replace (PUT) with optimistic concurrency: a body carrying a
        stale resourceVersion conflicts, like a real apiserver update.
        ``.status`` in the body is stripped — the status subresource owns
        it."""
        self._call("update_custom_object")
        with self._lock:
            return self._replace_custom(
                group, version, plural, namespace, obj,
                subresource_status=False,
            )

    def update_custom_object_status(
        self, group: str, version: str, plural: str, namespace: str, obj: dict
    ) -> dict:
        """PUT to the ``/status`` subresource: replaces only ``.status``."""
        self._call("update_custom_object_status")
        with self._lock:
            return self._replace_custom(
                group, version, plural, namespace, obj,
                subresource_status=True,
            )

    def delete_custom_object(
        self, group: str, version: str, plural: str, namespace: str, name: str
    ) -> None:
        self._call("delete_custom_object")
        with self._lock:
            key = self._custom_kind(group, version, plural) + (namespace, name)
            if key not in self._custom:
                raise NotFoundError(f"{plural} {namespace}/{name} not found")
            gone = self._custom.pop(key)
            # The delete advances the cluster revision (etcd semantics);
            # the DELETED event carries the deletion revision.
            gone = copy.deepcopy(gone)
            gone.setdefault("metadata", {})["resourceVersion"] = str(
                self._next_rv()
            )
            self._notify(plural, "DELETED", gone)

    def list_custom_objects(
        self, group: str, version: str, plural: str, namespace: str = ""
    ) -> list[dict]:
        self._call("list_custom_objects")
        with self._lock:
            kind_key = self._custom_kind(group, version, plural)
            return [
                copy.deepcopy(o)
                for key, o in sorted(self._custom.items())
                if key[:3] == kind_key
                and (not namespace or key[3] == namespace)
            ]

    # -- fixtures ----------------------------------------------------------

    def add_daemon_set_revision(
        self, ds: DaemonSet, hash_suffix: str, revision: int
    ) -> ControllerRevision:
        """Record a ControllerRevision ``<ds>-<hash>`` for a DaemonSet, the
        way the real DS controller does on template change."""
        rev = ControllerRevision(
            metadata=ObjectMeta(
                name=f"{ds.name}-{hash_suffix}",
                namespace=ds.namespace,
                labels=dict(ds.spec.selector.match_labels),
            ),
            revision=revision,
        )
        return self.create_controller_revision(rev)
