"""Watch-driven shared object cache: the client-go informer analogue.

The reconcile hot path (`upgrade_state.build_state` + the provider's
read-your-writes waits + `_pod_in_sync_with_ds`) historically paid a
full `list_daemon_sets` + `list_pods` plus one `get_node` round trip per
driver pod on EVERY tick — O(nodes) API traffic even when nothing
changed.  client-go solved this with the SharedInformer: list once,
then maintain the store from the watch delta stream, and serve every
read from memory.  This module is that layer for the typed
:class:`~k8s_operator_libs_tpu_torch.k8s.interface.KubeClient` boundary:

- :class:`Informer` — per-kind stores (Node / Pod / DaemonSet /
  ControllerRevision) filled by one baseline list and kept current by
  `handle_event` deltas.  resourceVersion guards make replayed events
  idempotent (the controller pump resumes from the MIN per-kind floor,
  so overlap is expected); 410 Gone invalidates the store until the
  next `sync()` re-list; BOOKMARKs and stream heartbeats refresh the
  staleness clock without implying change.  Reads return deep copies
  under one lock, and `snapshot()` yields a single coherent view for a
  whole reconcile pass.
- :class:`CachedKubeClient` — a KubeClient wrapper that serves reads
  from a fresh synced informer and falls through to the real client
  otherwise.  Writes delegate and then apply the patch ECHO to the
  store (`observe_write`), which is what makes the provider's
  write-then-poll cache wait resolve in zero extra round trips: the
  patched object is visible in the cache the instant the write returns,
  and the watch delivers the same change later (RV guard: no-op).

Staleness safety: a cache is only served while `age_s()` — time since
the feed last HEARD from the apiserver (event, bookmark, or heartbeat)
— is within `max_staleness_s`.  A standby replica (leader-gated pump
stopped) or a broken stream therefore degrades to passthrough reads
automatically; mutating decisions can tighten the bound per call via
``get_node(..., max_staleness_s=...)`` for a quorum re-read on breach.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter
from typing import Optional, Sequence

from k8s_operator_libs_tpu_torch.k8s.client import ExpiredError, WatchEvent
from k8s_operator_libs_tpu_torch.k8s.objects import (
    ControllerRevision,
    DaemonSet,
    Node,
    Pod,
    deep_copy,
)
from k8s_operator_libs_tpu_torch.k8s.selectors import (
    matches_labels,
    matches_selector,
)

logger = logging.getLogger(__name__)

# The kinds the reconcile hot path reads.  ControllerRevision matters:
# the steady-state pass checks every pod's template hash against the
# DaemonSet's newest revision, which is a LIST per member per tick when
# served by the API.
DEFAULT_KINDS = ("Node", "Pod", "DaemonSet", "ControllerRevision")


class InformerSnapshot:
    """One coherent point-in-time view of the informer's stores, taken
    under a single lock acquisition: `build_state` resolves daemonsets,
    pods, and every pod's node from the SAME world state, with no
    torn-read window between list calls.

    ``shared=True`` marks a copy-on-write view: its maps are shallow and
    reference the store's own objects, which is safe to hold across
    later writes because every ingest path REPLACES store objects (never
    mutates them in place) — but consumers must treat the view as
    read-only and deep-copy any object before mutating it.  ``version``
    stamps the store version the view was taken at."""

    def __init__(
        self,
        nodes: dict[str, Node],
        pods: dict[tuple[str, str], Pod],
        daemon_sets: dict[tuple[str, str], DaemonSet],
        revisions: dict[tuple[str, str], ControllerRevision],
        version: int = 0,
        shared: bool = False,
    ) -> None:
        self.nodes = nodes
        self.pods = pods
        self.daemon_sets = daemon_sets
        self.revisions = revisions
        self.version = version
        self.shared = shared

    def get_node(self, name: str) -> Optional[Node]:
        return self.nodes.get(name)

    def list_pods(
        self,
        namespace: str = "",
        label_selector: str = "",
        node_name: Optional[str] = None,
        match_labels: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        return [
            p
            for p in self.pods.values()
            if (not namespace or p.namespace == namespace)
            and (node_name is None or p.spec.node_name == node_name)
            and matches_selector(p.labels, label_selector)
            and matches_labels(p.labels, match_labels or {})
        ]

    def list_daemon_sets(
        self, namespace: str = "", match_labels: Optional[dict] = None
    ) -> list[DaemonSet]:
        return [
            ds
            for ds in self.daemon_sets.values()
            if (not namespace or ds.namespace == namespace)
            and matches_labels(ds.metadata.labels, match_labels or {})
        ]

    def list_controller_revisions(
        self, namespace: str = "", label_selector: str = ""
    ) -> list[ControllerRevision]:
        return [
            r
            for r in self.revisions.values()
            if (not namespace or r.metadata.namespace == namespace)
            and matches_selector(r.metadata.labels, label_selector)
        ]


def _key_of(kind: str, obj) -> object:
    if kind == "Node":
        return obj.metadata.name
    return (obj.metadata.namespace, obj.metadata.name)


class Informer:
    """List-once + watch-delta store for the hot-path kinds.

    Feed it either from the controller's watch pump (`handle_event` per
    event, `sync()` per (re)connect baseline) or standalone via
    `start()`, which runs its own list-then-watch loop with the same
    reconnect contract the pump uses (min-floor resume, 410 → re-list).
    """

    def __init__(
        self,
        client,
        kinds: Sequence[str] = DEFAULT_KINDS,
        max_staleness_s: float = 30.0,
        pod_namespace: str = "",
        pod_match_labels: Optional[dict[str, str]] = None,
    ) -> None:
        self.client = client
        self.kinds = tuple(kinds)
        # Default freshness bound for cache-served reads; per-read
        # overrides tighten it for mutating decisions.
        self.max_staleness_s = max_staleness_s
        # Pod scope (field-selector analogue): when set, the baseline
        # LIST is namespace/label-scoped server-side and watch deltas
        # for out-of-scope pods are dropped at ingest, so non-driver pod
        # volume (batch jobs, system pods on a 10k-node fleet) cannot
        # bloat the store.  CachedKubeClient serves a pod query from
        # this store only when the query provably falls WITHIN the
        # scope; anything else (e.g. the drain path's all-namespace
        # per-node listing) passes through to the live API.
        self.pod_namespace = pod_namespace
        self.pod_match_labels = (
            dict(pod_match_labels) if pod_match_labels else None
        )
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._pods: dict[tuple[str, str], Pod] = {}
        self._daemon_sets: dict[tuple[str, str], DaemonSet] = {}
        self._revisions: dict[tuple[str, str], ControllerRevision] = {}
        # Secondary indexes (client-go Indexer analogue): pods by node
        # for the drain path's per-node listing, nodes by exact label
        # pair for equality selectors.  Rebuilt incrementally on every
        # put/delete; complex selector shapes fall back to a scan.
        self._pods_by_node: dict[str, set[tuple[str, str]]] = {}
        self._node_label_index: dict[tuple[str, str], set[str]] = {}
        # Store version clock: the global counter advances on every
        # effective mutation (sync swap, RV-accepted put, delete), the
        # per-kind counters on mutations of that kind.  Snapshot views
        # and the per-kind shallow-map caches key off these, so an
        # unchanged store serves the SAME snapshot object again with
        # zero copying.
        self._version = 0
        self._kind_versions: Counter = Counter()
        self._snapshot_cache: Optional[InformerSnapshot] = None
        self._kind_map_cache: dict[str, tuple[int, dict]] = {}
        # Change listeners (materialized-view feed): called UNDER the
        # informer lock as fn(kind, op, obj) with op in
        # {"set", "delete", "reset"} after every effective store change.
        # "set"/"delete" carry the store's own object (replace-on-write:
        # safe to hold a reference, never mutate); "reset" (kind "*",
        # obj None) signals a wholesale re-list — incremental consumers
        # must drop their derived state.  Listeners must be O(1)-ish and
        # must NEVER call back into the informer (lock ordering:
        # informer -> listener, only).
        self._listeners: list = []
        self.synced = False
        self._last_heard = 0.0
        self.stats: Counter = Counter()
        # Standalone-thread mode state.
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- freshness -----------------------------------------------------------

    def heartbeat(self) -> None:
        """The feed heard from the apiserver (idle heartbeat or
        bookmark): the cache is coherent as of now even though nothing
        changed.  Without this, an idle cluster would look 'stale'."""
        with self._lock:
            self._last_heard = time.monotonic()

    def age_s(self) -> float:
        """Seconds since the feed last heard from the apiserver; inf
        before the first sync."""
        with self._lock:
            if not self.synced:
                return float("inf")
            return time.monotonic() - self._last_heard

    def fresh(self, max_staleness_s: Optional[float] = None) -> bool:
        bound = (
            self.max_staleness_s
            if max_staleness_s is None
            else min(max_staleness_s, self.max_staleness_s)
        )
        return self.synced and self.age_s() <= bound

    def invalidate(self) -> None:
        """410 Gone (or any loss of stream continuity that cannot be
        resumed): reads fall through to the API until the next sync."""
        with self._lock:
            self.synced = False
            self.stats["relists_410"] += 1

    # -- fill / delta --------------------------------------------------------

    def sync(self) -> int:
        """Baseline: grab the cluster RV first, then list every kind.
        Returns the RV for the watch to resume from — objects written
        between the RV grab and the lists are covered twice (list + the
        watch replay), which the RV guards make idempotent.  The inverse
        order would LOSE such writes."""
        baseline = int(
            self.client.list_page("Node", limit=1)["resourceVersion"]
        )
        nodes = (
            {n.metadata.name: n for n in self.client.list_nodes()}
            if "Node" in self.kinds
            else {}
        )
        pods = (
            {
                (p.namespace, p.name): p
                for p in self.client.list_pods(
                    namespace=self.pod_namespace,
                    match_labels=self.pod_match_labels,
                )
            }
            if "Pod" in self.kinds
            else {}
        )
        daemon_sets = (
            {
                (d.namespace, d.name): d
                for d in self.client.list_daemon_sets()
            }
            if "DaemonSet" in self.kinds
            else {}
        )
        revisions = (
            {
                (r.metadata.namespace, r.metadata.name): r
                for r in self.client.list_controller_revisions()
            }
            if "ControllerRevision" in self.kinds
            else {}
        )
        with self._lock:
            self._nodes = nodes
            self._pods = pods
            self._daemon_sets = daemon_sets
            self._revisions = revisions
            self._pods_by_node = {}
            self._node_label_index = {}
            for key, pod in pods.items():
                self._pods_by_node.setdefault(
                    pod.spec.node_name, set()
                ).add(key)
            for name, node in nodes.items():
                for pair in node.labels.items():
                    self._node_label_index.setdefault(pair, set()).add(
                        name
                    )
            for kind in DEFAULT_KINDS:
                self._bump(kind)
            self._fire("*", "reset", None)
            self.synced = True
            self._last_heard = time.monotonic()
            self.stats["lists"] += 1
        return baseline

    def _pod_in_scope(self, pod: Pod) -> bool:
        """Whether a pod belongs in this (possibly scoped) store."""
        if self.pod_namespace and pod.namespace != self.pod_namespace:
            return False
        if self.pod_match_labels and not matches_labels(
            pod.labels, self.pod_match_labels
        ):
            return False
        return True

    def covers_pod_query(
        self,
        namespace: str = "",
        label_selector: str = "",
        node_name: Optional[str] = None,
        match_labels: Optional[dict[str, str]] = None,
    ) -> bool:
        """Whether a ``list_pods`` query provably falls within the pod
        scope (i.e. every pod it could match is in the store).  With no
        scope configured the store holds everything and every query is
        covered; with a scope, the query must pin the same namespace and
        carry a label requirement at least as tight as the scope's."""
        if not self.pod_namespace and not self.pod_match_labels:
            return True
        if self.pod_namespace and namespace != self.pod_namespace:
            return False
        if self.pod_match_labels:
            required = dict(_equality_pairs(label_selector))
            required.update(match_labels or {})
            for k, v in self.pod_match_labels.items():
                if required.get(k) != v:
                    return False
        return True

    def _store_for(self, kind: str):
        return {
            "Node": self._nodes,
            "Pod": self._pods,
            "DaemonSet": self._daemon_sets,
            "ControllerRevision": self._revisions,
        }.get(kind)

    def add_change_listener(self, fn) -> None:
        """Register fn(kind, op, obj) for effective store changes (see
        the ``_listeners`` contract in ``__init__``)."""
        with self._lock:
            self._listeners.append(fn)

    def _bump(self, kind: str) -> None:
        self._version += 1
        self._kind_versions[kind] += 1

    def _fire(self, kind: str, op: str, obj) -> None:
        for fn in self._listeners:
            fn(kind, op, obj)

    def _index_node(self, node: Node, add: bool) -> None:
        for pair in node.labels.items():
            bucket = self._node_label_index.setdefault(pair, set())
            if add:
                bucket.add(node.name)
            else:
                bucket.discard(node.name)

    def _index_pod(self, pod: Pod, add: bool) -> None:
        bucket = self._pods_by_node.setdefault(pod.spec.node_name, set())
        key = (pod.namespace, pod.name)
        if add:
            bucket.add(key)
        else:
            bucket.discard(key)

    def _put(self, kind: str, obj, rv: int) -> bool:
        """RV-guarded upsert: replayed or out-of-order deltas (watch
        overlap after a min-floor resume, a patch echo racing its own
        watch event) never roll an object backwards."""
        store = self._store_for(kind)
        if store is None:
            return False
        key = _key_of(kind, obj)
        current = store.get(key)
        if (
            current is not None
            and current.metadata.resource_version
            > obj.metadata.resource_version
        ):
            return False
        if kind == "Node":
            if current is not None:
                self._index_node(current, add=False)
            self._index_node(obj, add=True)
        elif kind == "Pod":
            if current is not None:
                self._index_pod(current, add=False)
            self._index_pod(obj, add=True)
        store[key] = obj
        self._bump(kind)
        self._fire(kind, "set", obj)
        return True

    def _delete(self, kind: str, obj, rv: int) -> bool:
        store = self._store_for(kind)
        if store is None:
            return False
        key = _key_of(kind, obj)
        current = store.get(key)
        if current is None:
            return False
        # A DELETED delta older than the stored object means the object
        # was recreated and we already saw the newer incarnation.
        if rv and current.metadata.resource_version > rv:
            return False
        if kind == "Node":
            self._index_node(current, add=False)
        elif kind == "Pod":
            self._index_pod(current, add=False)
        store.pop(key, None)
        self._bump(kind)
        self._fire(kind, "delete", current)
        return True

    def handle_event(self, ev: Optional[WatchEvent]) -> None:
        """Apply one watch delta.  ``None`` (a stream heartbeat) and
        BOOKMARKs refresh the staleness clock only."""
        if ev is None:
            self.heartbeat()
            return
        with self._lock:
            self._last_heard = time.monotonic()
            if ev.type == "BOOKMARK" or ev.object is None:
                return
            if ev.kind not in self.kinds:
                return
            self.stats["events"] += 1
            if not self.synced:
                return  # invalidated: the next sync() re-lists everything
            if ev.type == "DELETED":
                self._delete(ev.kind, ev.object, ev.rv)
            else:
                if ev.kind == "Pod" and not self._pod_in_scope(ev.object):
                    # Out-of-scope pod churn never enters the store.  A
                    # pod relabelled OUT of scope is dropped like a
                    # delete (it no longer belongs here).
                    self._delete(ev.kind, ev.object, ev.rv)
                    self.stats["pods_out_of_scope"] += 1
                    return
                self._put(ev.kind, deep_copy(ev.object), ev.rv)

    def observe_write(self, obj) -> None:
        """Apply a write's response echo (the patched object the API
        returned) so read-your-writes resolves from the cache with zero
        extra round trips.  RV-guarded like any delta — the watch will
        deliver the same change again and no-op."""
        kind = {
            Node: "Node",
            Pod: "Pod",
            DaemonSet: "DaemonSet",
            ControllerRevision: "ControllerRevision",
        }.get(type(obj))
        if kind is None or kind not in self.kinds:
            return
        if kind == "Pod" and not self._pod_in_scope(obj):
            return
        with self._lock:
            if not self.synced:
                return
            self._put(kind, deep_copy(obj), obj.metadata.resource_version)

    # -- reads ---------------------------------------------------------------

    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            obj = self._nodes.get(name)
            return deep_copy(obj) if obj is not None else None

    def list_nodes(self, label_selector: str = "") -> list[Node]:
        with self._lock:
            candidates = self._nodes.values()
            pairs = _equality_pairs(label_selector)
            if pairs:
                # Index intersection for pure-equality selectors; the
                # full selector still runs on the survivors (cheap).
                names: Optional[set[str]] = None
                for pair in pairs:
                    bucket = self._node_label_index.get(pair, set())
                    names = bucket if names is None else names & bucket
                candidates = [
                    self._nodes[n] for n in (names or set())
                    if n in self._nodes
                ]
            return [
                deep_copy(n)
                for n in candidates
                if matches_selector(n.labels, label_selector)
            ]

    def list_pods(
        self,
        namespace: str = "",
        label_selector: str = "",
        node_name: Optional[str] = None,
        match_labels: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        with self._lock:
            if node_name is not None:
                keys = self._pods_by_node.get(node_name, set())
                candidates = [
                    self._pods[k] for k in keys if k in self._pods
                ]
            else:
                candidates = list(self._pods.values())
            return [
                deep_copy(p)
                for p in candidates
                if (not namespace or p.namespace == namespace)
                and matches_selector(p.labels, label_selector)
                and matches_labels(p.labels, match_labels or {})
            ]

    def list_daemon_sets(
        self, namespace: str = "", match_labels: Optional[dict] = None
    ) -> list[DaemonSet]:
        with self._lock:
            return [
                deep_copy(ds)
                for ds in self._daemon_sets.values()
                if (not namespace or ds.namespace == namespace)
                and matches_labels(ds.metadata.labels, match_labels or {})
            ]

    def list_controller_revisions(
        self, namespace: str = "", label_selector: str = ""
    ) -> list[ControllerRevision]:
        with self._lock:
            return [
                deep_copy(r)
                for r in self._revisions.values()
                if (not namespace or r.metadata.namespace == namespace)
                and matches_selector(r.metadata.labels, label_selector)
            ]

    def _shared_kind_map(self, kind: str) -> dict:
        """Shallow copy of one kind's store, cached by that kind's
        version: while the kind is unchanged every snapshot shares the
        SAME map object; a change builds a fresh map and leaves the old
        one untouched in any held snapshot.  Caller holds the lock."""
        version = self._kind_versions[kind]
        cached = self._kind_map_cache.get(kind)
        if cached is not None and cached[0] == version:
            self.stats["kind_map_reuses"] += 1
            return cached[1]
        shallow = dict(self._store_for(kind))
        self._kind_map_cache[kind] = (version, shallow)
        return shallow

    def snapshot(
        self, node_names: Optional[set[str]] = None
    ) -> InformerSnapshot:
        """Copy-on-write coherent view of every store, one lock hold.

        No object is deep-copied: the view's maps are shallow and share
        the store's objects, which stay point-in-time correct because
        every ingest REPLACES objects rather than mutating them.  While
        the store version is unchanged the same snapshot object is
        returned again (zero allocation); consumers (`build_state`)
        deep-copy only the objects they materialize into engine state.

        ``node_names`` (sharded dirty-set reconcile) scopes the view to
        those nodes and the pods scheduled on them (via the per-node
        index) — O(pool) map construction, with the fleet-small
        DaemonSet/revision maps shared from the version-keyed cache."""
        with self._lock:
            if node_names is None:
                snap = self._snapshot_cache
                if snap is not None and snap.version == self._version:
                    self.stats["snapshot_reuses"] += 1
                    return snap
                snap = InformerSnapshot(
                    nodes=dict(self._nodes),
                    pods=dict(self._pods),
                    daemon_sets=self._shared_kind_map("DaemonSet"),
                    revisions=self._shared_kind_map("ControllerRevision"),
                    version=self._version,
                    shared=True,
                )
                self._snapshot_cache = snap
                self.stats["snapshot_builds"] += 1
                return snap
            nodes = {
                name: self._nodes[name]
                for name in node_names
                if name in self._nodes
            }
            pods = {}
            for name in node_names:
                for key in self._pods_by_node.get(name, ()):
                    pod = self._pods.get(key)
                    if pod is not None:
                        pods[key] = pod
            self.stats["snapshot_scoped_builds"] += 1
            return InformerSnapshot(
                nodes=nodes,
                pods=pods,
                daemon_sets=self._shared_kind_map("DaemonSet"),
                revisions=self._shared_kind_map("ControllerRevision"),
                version=self._version,
                shared=True,
            )

    # -- standalone list-then-watch loop -------------------------------------

    def start(self) -> "Informer":
        """Run the informer's own feed thread (tests / embedders without
        a controller pump).  Same reconnect contract as the pump:
        baseline list, per-kind floors, min-floor resume on stream
        break, invalidate + re-list on 410."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="informer-feed", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None

    def wait_synced(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.synced:
                return True
            time.sleep(0.005)
        return self.synced

    def _run(self) -> None:
        resume_rv: Optional[int] = None
        floors: dict[str, int] = {}
        while not self._stop.is_set():
            try:
                if resume_rv is None or not self.synced:
                    resume_rv = self.sync()
                floors = {k: resume_rv for k in self.kinds}
                for ev in self.client.watch_events(
                    self.kinds, since_rv=resume_rv, bookmarks=True
                ):
                    if self._stop.is_set():
                        return
                    self.handle_event(ev)
                    if ev is not None and ev.rv and ev.kind in floors:
                        floors[ev.kind] = max(floors[ev.kind], ev.rv)
                # Stream ended (dropped): resume from the slowest kind.
                self.stats["watch_reconnects"] += 1
                resume_rv = min(floors.values()) if floors else None
            except ExpiredError:
                self.invalidate()
                resume_rv = None
                floors = {}
            except Exception as e:  # noqa: BLE001 — reconnect, don't die
                if self._stop.is_set():
                    return
                logger.warning("informer stream broke (%s); retrying", e)
                self.stats["watch_reconnects"] += 1
                resume_rv = min(floors.values()) if floors else None
                time.sleep(0.05)


def _equality_pairs(selector: str) -> list[tuple[str, str]]:
    """The (k, v) pairs of a pure-equality selector; [] when the
    selector has any other requirement shape (scan instead)."""
    if not selector or not selector.strip():
        return []
    pairs = []
    for req in selector.split(","):
        if "==" in req:
            k, _, v = req.partition("==")
        elif "=" in req and "!=" not in req:
            k, _, v = req.partition("=")
        else:
            return []
        k, v = k.strip(), v.strip()
        if not k or any(ch in k for ch in "!()"):
            return []
        pairs.append((k, v))
    return pairs


class CachedKubeClient:
    """KubeClient wrapper serving hot-path reads from an Informer.

    Reads with cache semantics (`get_node(cached=True)`, the four hot
    list verbs) come from the store while it is synced and fresh;
    everything else — quorum reads (`cached=False`), `get_pod`, custom
    objects, events, watches, pagination — delegates untouched via
    ``__getattr__`` (which also forwards `stats`, `breaker`,
    `retry_stats`, and the fake tier's test knobs).  Writes delegate and
    then feed the response echo back into the store, so a
    write-then-poll cache wait resolves on its first cached read.
    """

    def __init__(self, client, informer: Optional[Informer] = None) -> None:
        self._client = client
        self.informer = (
            informer if informer is not None else Informer(client)
        )

    def __getattr__(self, name: str):
        return getattr(self._client, name)

    # -- cached reads --------------------------------------------------------

    def _cache(self, max_staleness_s: Optional[float] = None):
        inf = self.informer
        if inf.fresh(max_staleness_s):
            return inf
        if inf.synced:
            inf.stats["stale_reads"] += 1
        return None

    def get_node(
        self,
        name: str,
        cached: bool = True,
        max_staleness_s: Optional[float] = None,
    ) -> Node:
        if cached:
            inf = self._cache(max_staleness_s)
            if inf is not None:
                obj = inf.get_node(name)
                if obj is not None:
                    inf.stats["cache_hits"] += 1
                    return obj
                inf.stats["cache_misses"] += 1
        node = self._client.get_node(
            name, cached=cached, max_staleness_s=max_staleness_s
        )
        # A passthrough read is as good as an echo: newest state we
        # have seen, RV-guarded into the store.
        self.informer.observe_write(node)
        return node

    def _cached_list(self, verb: str, *args, **kwargs):
        inf = self._cache()
        if inf is not None:
            inf.stats["cache_hits"] += 1
            return getattr(inf, verb)(*args, **kwargs)
        inf = self.informer
        if inf.synced:
            inf.stats["cache_misses"] += 1
        return getattr(self._client, verb)(*args, **kwargs)

    def list_nodes(self, label_selector: str = "") -> list[Node]:
        return self._cached_list("list_nodes", label_selector)

    def list_pods(
        self,
        namespace: str = "",
        label_selector: str = "",
        node_name: Optional[str] = None,
        match_labels: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        if not self.informer.covers_pod_query(
            namespace=namespace,
            label_selector=label_selector,
            node_name=node_name,
            match_labels=match_labels,
        ):
            # A pod-scoped store cannot answer queries outside its scope
            # (the drain path lists ALL pods on a node, any namespace):
            # those go to the live API, correctness over cache hits.
            self.informer.stats["scope_passthroughs"] += 1
            return self._client.list_pods(
                namespace=namespace,
                label_selector=label_selector,
                node_name=node_name,
                match_labels=match_labels,
            )
        return self._cached_list(
            "list_pods",
            namespace=namespace,
            label_selector=label_selector,
            node_name=node_name,
            match_labels=match_labels,
        )

    def list_daemon_sets(
        self, namespace: str = "", match_labels: Optional[dict] = None
    ) -> list[DaemonSet]:
        return self._cached_list(
            "list_daemon_sets", namespace, match_labels
        )

    def list_controller_revisions(
        self, namespace: str = "", label_selector: str = ""
    ) -> list[ControllerRevision]:
        return self._cached_list(
            "list_controller_revisions", namespace, label_selector
        )

    def coherent_snapshot(
        self, node_names: Optional[set[str]] = None
    ) -> Optional[InformerSnapshot]:
        """One consistent view for a whole reconcile pass, or None when
        the cache cannot serve (unsynced / stale) — the caller falls
        back to direct lists.  ``node_names`` scopes the snapshot to one
        pool's nodes (sharded reconcile)."""
        inf = self._cache()
        if inf is None:
            return None
        inf.stats["cache_hits"] += 1
        return inf.snapshot(node_names=node_names)

    # -- writes: delegate, then apply the echo -------------------------------

    def _echo(self, obj):
        self.informer.observe_write(obj)
        return obj

    def patch_node_labels(
        self, name: str, patch: dict[str, Optional[str]]
    ) -> Node:
        return self._echo(self._client.patch_node_labels(name, patch))

    def patch_node_annotations(
        self, name: str, patch: dict[str, Optional[str]]
    ) -> Node:
        return self._echo(self._client.patch_node_annotations(name, patch))

    def patch_node_metadata(
        self,
        name: str,
        labels: Optional[dict[str, Optional[str]]] = None,
        annotations: Optional[dict[str, Optional[str]]] = None,
        field_manager: Optional[str] = None,
    ) -> Node:
        return self._echo(
            self._client.patch_node_metadata(
                name,
                labels=labels,
                annotations=annotations,
                field_manager=field_manager,
            )
        )

    def set_node_unschedulable(
        self, name: str, unschedulable: bool
    ) -> Node:
        return self._echo(
            self._client.set_node_unschedulable(name, unschedulable)
        )

    def create_daemon_set(self, ds: DaemonSet) -> DaemonSet:
        return self._echo(self._client.create_daemon_set(ds))

    def update_daemon_set(self, ds: DaemonSet) -> DaemonSet:
        return self._echo(self._client.update_daemon_set(ds))
