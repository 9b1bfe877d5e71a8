"""Incrementally-maintained materialized pool views (the O(delta) core).

The sharded loop made *dispatch* event-driven, but every dirty pool
still paid a full scoped ``build_state`` — O(pool) object copying and
grouping per tick — and every snapshot deep-copied the informer stores.
This module closes the remaining gap: a :class:`MaterializedFleetView`
keeps per-pool node rows (compact ``__slots__`` records with interned
state strings) up to date IN PLACE from the informer's own change feed,
so a ``ShardedReconciler`` tick consumes the view directly and a single
delta reconciles in O(changed objects).

Correctness doctrine — the view is an optimization, never an authority:

- **Feed, not stream**: the view subscribes to the informer's store
  change listener (`Informer.add_change_listener`), not the raw watch.
  It therefore sees exactly what the store accepted — RV-guarded watch
  deltas AND write echoes (`observe_write`) — and inherits the store's
  replace-on-write discipline: rows hold references to store objects
  that are never mutated in place, and every object the view hands to
  the engine is deep-copied at materialization time.
- **Fail open, always**: any condition the view cannot serve — not
  seeded, informer re-listed (``reset``), pool invalidated by a shard
  error, informer stale — returns ``None`` from
  :meth:`build_pool_state` and the caller falls back to the classic
  scoped ``build_state``.  The view can make a tick cheaper; it can
  never make one wrong in a new way.
- **Audited at every resync**: :meth:`diff_against` compares the view's
  rows (membership, state labels, resource versions) against the full
  ``build_state`` the resync just produced, without copying anything.
  Mismatches are counted (``matview_diff_mismatches_total``) and the
  view is reseeded from a fresh copy-on-write snapshot — a fail-open
  rebuild, not a crash.

Term-fence, ledger, and write-plane semantics are untouched: the view
lives strictly on the read path, upstream of the same ``apply_state``
every other path uses.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.artifacts.dag import artifact_dag_of
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.objects import deep_copy
from k8s_operator_libs_tpu_torch.k8s.selectors import matches_labels
from k8s_operator_libs_tpu_torch.topology.slices import slice_info_for_node
from k8s_operator_libs_tpu_torch.upgrade.pod_manager import (
    POD_CONTROLLER_REVISION_HASH_LABEL_KEY,
)
from k8s_operator_libs_tpu_torch.upgrade.types import (
    ArtifactNodeState,
    ClusterUpgradeState,
    NodeUpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = get_logger(__name__)


class StringInterner:
    """Canonicalize the small closed sets the view stores per node
    (upgrade-state label values, pool keys): 100k rows reference the
    same handful of string objects instead of 100k per-event copies."""

    def __init__(self) -> None:
        self._pool: dict[str, str] = {}

    def intern(self, s: str) -> str:
        got = self._pool.get(s)
        if got is None:
            self._pool[s] = s
            got = s
        return got

    def __len__(self) -> int:
        return len(self._pool)


class NodeRow:
    """One node's materialized state: references into the informer store
    (replace-on-write: safe to hold, never mutated) plus the interned
    state-label value the pool groups by."""

    __slots__ = (
        "name",
        "pool",
        "state",
        "node",
        "pods",
        "extra_pods",
        "artifact_hashes",
    )

    def __init__(self, name: str, pool: str, state: str, node) -> None:
        self.name = name
        self.pool = pool
        self.state = state
        self.node = node
        # (namespace, name) -> Pod reference; normally exactly one
        # driver pod, transiently two during a pod recreate.
        self.pods: dict = {}
        # In-namespace pods NOT matching the driver labels — candidate
        # non-primary artifact pods for multi-artifact stacks.  Kept
        # separate so ``pods`` (and the resync audit's pair count)
        # stays driver-only.
        self.extra_pods: dict = {}
        # artifact name -> interned controller-revision-hash of that
        # artifact's pod on this node; maintained once the view has
        # learned the policy's artifact selectors.
        self.artifact_hashes: dict = {}


class PoolView:
    """One pool's rows plus a generation counter bumped on every applied
    delta — consumers can cheaply detect 'changed since I looked'."""

    __slots__ = ("key", "rows", "generation", "valid")

    def __init__(self, key: str) -> None:
        self.key = key
        self.rows: dict = {}  # node name -> NodeRow
        self.generation = 0
        self.valid = True


class MaterializedFleetView:
    """Per-pool materialized node/group state fed by informer deltas.

    Locking: the view has its own lock, acquired INSIDE the informer
    lock (listener callbacks run under it) — the view never calls the
    informer while holding its own lock, so the ordering is acyclic.
    """

    def __init__(
        self,
        keys: UpgradeKeys,
        namespace: str,
        driver_labels: dict[str, str],
        fresh_fn: Optional[Callable[[], bool]] = None,
        covers_pod_fn: Optional[Callable[..., bool]] = None,
    ) -> None:
        self.keys = keys
        self.namespace = namespace
        self.driver_labels = dict(driver_labels or {})
        # When set, build_pool_state refuses to serve unless this
        # returns True (wired to Informer.fresh): a stale feed must
        # fall back to build_state, which has its own staleness path.
        self.fresh_fn = fresh_fn
        # When set (wired to Informer.covers_pod_query), multi-artifact
        # policies are served from the view only if the informer's pod
        # scope provably includes every artifact's selector; otherwise
        # the feed would silently miss artifact pods and the build must
        # fall back to build_state (which reads through the live
        # client).  None = assume NOT covered (fail open).
        self.covers_pod_fn = covers_pod_fn
        self._lock = threading.Lock()
        self.interner = StringInterner()
        self._pools: dict[str, PoolView] = {}
        self._node_pool: dict[str, str] = {}  # node name -> pool key
        # Driver DaemonSets by uid (references, replace-on-write).
        self._daemon_sets: dict = {}
        # Non-driver in-namespace DaemonSets by uid — owners of
        # candidate artifact pods.
        self._extra_daemon_sets: dict = {}
        # Learned from the last multi-artifact policy served: artifact
        # name -> matchLabels, in topological order, primary excluded.
        # Purely derived config; survives resets (reseed re-applies it).
        self._artifact_selectors: dict[str, dict[str, str]] = {}
        # Whether covers_pod_fn vouched for every learned selector —
        # cached at learn time so the hot path never calls back out.
        self._artifact_scope_covered = False
        # Driver pods whose node has no row yet (pod delta raced ahead
        # of its node): adopted when the node row appears.  build_state
        # skips such pods too, so limbo pods are invisible to builds.
        self._limbo_pods: dict = {}  # (ns, name) -> Pod
        self._pod_node: dict = {}  # (ns, name) -> node name
        self.seeded = False
        self.stats: Counter = Counter()
        self.apply_total_s = 0.0

    # -- pool/row helpers (caller holds self._lock) --------------------------

    def _pool_key_for_node(self, node) -> str:
        info = slice_info_for_node(node, self.keys)
        key = info.slice_id if info is not None else node.name
        return self.interner.intern(key)

    def _pool(self, key: str) -> PoolView:
        pv = self._pools.get(key)
        if pv is None:
            pv = PoolView(key)
            self._pools[key] = pv
        return pv

    def _state_of(self, node) -> str:
        return self.interner.intern(
            node.labels.get(self.keys.state_label, "")
        )

    def _pod_in_scope(self, pod) -> bool:
        if self.namespace and pod.namespace != self.namespace:
            return False
        return matches_labels(pod.labels, self.driver_labels)

    def _pod_class(self, pod) -> Optional[str]:
        """``"driver"`` for driver-label pods, ``"extra"`` for other
        in-namespace pods (candidate artifact pods), None for pods the
        view does not track.  With no namespace configured there is no
        bound on 'extra', so only driver pods are tracked."""
        if self.namespace:
            if pod.namespace != self.namespace:
                return None
            if matches_labels(pod.labels, self.driver_labels):
                return "driver"
            return "extra"
        if matches_labels(pod.labels, self.driver_labels):
            return "driver"
        return None

    def _refresh_artifact_hashes(self, row) -> None:
        """Recompute ``row.artifact_hashes`` from its extra pods using
        the learned selectors (no-op until a multi-artifact policy has
        been served)."""
        if not self._artifact_selectors:
            return
        hashes: dict = {}
        for pod in row.extra_pods.values():
            for name, sel in self._artifact_selectors.items():
                if matches_labels(pod.labels, sel):
                    hashes[name] = self.interner.intern(
                        pod.labels.get(
                            POD_CONTROLLER_REVISION_HASH_LABEL_KEY, ""
                        )
                    )
                    break
        row.artifact_hashes = hashes

    def _upsert_node(self, node) -> None:
        name = node.metadata.name
        new_pool = self._pool_key_for_node(node)
        old_pool = self._node_pool.get(name)
        if old_pool is not None and old_pool != new_pool:
            # Relabel moved the node between pools: both sides change.
            old_pv = self._pools.get(old_pool)
            if old_pv is not None:
                row = old_pv.rows.pop(name, None)
                old_pv.generation += 1
                if row is not None:
                    for pod_key in row.pods:
                        self._pod_node.pop(pod_key, None)
                    for pod_key in row.extra_pods:
                        self._pod_node.pop(pod_key, None)
                    # Its pods re-attach under the new pool below.
                    self._limbo_pods.update(row.pods)
                    self._limbo_pods.update(row.extra_pods)
        pv = self._pool(new_pool)
        row = pv.rows.get(name)
        if row is None:
            row = NodeRow(name, new_pool, self._state_of(node), node)
            pv.rows[name] = row
            # Adopt limbo pods that were waiting for this node.
            adopted_extra = False
            for pod_key, pod in list(self._limbo_pods.items()):
                if pod.spec.node_name == name:
                    del self._limbo_pods[pod_key]
                    if self._pod_class(pod) == "driver":
                        row.pods[pod_key] = pod
                    else:
                        row.extra_pods[pod_key] = pod
                        adopted_extra = True
                    self._pod_node[pod_key] = name
            if adopted_extra:
                self._refresh_artifact_hashes(row)
        else:
            row.node = node
            row.state = self._state_of(node)
            row.pool = new_pool
        self._node_pool[name] = new_pool
        pv.generation += 1

    def _delete_node(self, node) -> None:
        name = node.metadata.name
        pool = self._node_pool.pop(name, None)
        if pool is None:
            return
        pv = self._pools.get(pool)
        if pv is None:
            return
        row = pv.rows.pop(name, None)
        pv.generation += 1
        if row is not None:
            for pod_key in row.pods:
                self._pod_node.pop(pod_key, None)
            for pod_key in row.extra_pods:
                self._pod_node.pop(pod_key, None)
            # Keep the pods: a deleted-then-recreated node (repair)
            # re-adopts its still-live driver pods on return.
            self._limbo_pods.update(row.pods)
            self._limbo_pods.update(row.extra_pods)

    def _upsert_pod(self, pod) -> None:
        pod_key = (pod.namespace, pod.metadata.name)
        cls = self._pod_class(pod)
        if cls is None or not pod.spec.node_name:
            self._remove_pod_key(pod_key)
            return
        prev_node = self._pod_node.get(pod_key)
        if prev_node is not None and prev_node != pod.spec.node_name:
            self._remove_pod_key(pod_key)
        node_name = pod.spec.node_name
        pool = self._node_pool.get(node_name)
        if pool is None:
            self._limbo_pods[pod_key] = pod
            return
        pv = self._pools.get(pool)
        row = pv.rows.get(node_name) if pv is not None else None
        if row is None:
            self._limbo_pods[pod_key] = pod
            return
        if cls == "driver":
            # A relabel can flip a pod between classes mid-flight.
            had_extra = row.extra_pods.pop(pod_key, None) is not None
            row.pods[pod_key] = pod
            if had_extra:
                self._refresh_artifact_hashes(row)
        else:
            row.pods.pop(pod_key, None)
            row.extra_pods[pod_key] = pod
            self._refresh_artifact_hashes(row)
        self._pod_node[pod_key] = node_name
        pv.generation += 1

    def _remove_pod_key(self, pod_key) -> None:
        self._limbo_pods.pop(pod_key, None)
        node_name = self._pod_node.pop(pod_key, None)
        if node_name is None:
            return
        pool = self._node_pool.get(node_name)
        pv = self._pools.get(pool) if pool is not None else None
        if pv is None:
            return
        row = pv.rows.get(node_name)
        if row is not None:
            row.pods.pop(pod_key, None)
            if row.extra_pods.pop(pod_key, None) is not None:
                self._refresh_artifact_hashes(row)
        pv.generation += 1

    # -- informer feed -------------------------------------------------------

    def on_store_change(self, kind: str, op: str, obj) -> None:
        """Informer change listener (runs UNDER the informer lock)."""
        t0 = time.perf_counter()
        with self._lock:
            if op == "reset":
                # Wholesale re-list: incremental continuity is broken.
                # Drop everything; the next full resync reseeds.
                self._pools.clear()
                self._node_pool.clear()
                self._daemon_sets.clear()
                self._extra_daemon_sets.clear()
                self._limbo_pods.clear()
                self._pod_node.clear()
                self.seeded = False
                self.stats["resets"] += 1
                return
            if not self.seeded:
                return
            self.stats["events"] += 1
            if kind == "Node":
                if op == "delete":
                    self._delete_node(obj)
                else:
                    self._upsert_node(obj)
            elif kind == "Pod":
                if op == "delete":
                    self._remove_pod_key(
                        (obj.namespace, obj.metadata.name)
                    )
                else:
                    self._upsert_pod(obj)
            elif kind == "DaemonSet":
                uid = obj.metadata.uid
                if op == "delete":
                    self._daemon_sets.pop(uid, None)
                    self._extra_daemon_sets.pop(uid, None)
                elif (
                    not self.namespace
                    or obj.namespace == self.namespace
                ) and matches_labels(
                    obj.metadata.labels, self.driver_labels
                ):
                    self._daemon_sets[uid] = obj
                    self._extra_daemon_sets.pop(uid, None)
                elif self.namespace and obj.namespace == self.namespace:
                    # Candidate artifact-owning DaemonSet.
                    self._extra_daemon_sets[uid] = obj
                    self._daemon_sets.pop(uid, None)
                else:
                    self._daemon_sets.pop(uid, None)
                    self._extra_daemon_sets.pop(uid, None)
            # ControllerRevision deltas don't touch rows: the engine
            # reads revisions through the (cached) client, and the
            # DeltaRouter already dirties every pool on template churn.
            self.apply_total_s += time.perf_counter() - t0

    # -- seeding / audit -----------------------------------------------------

    def reseed(self, snapshot) -> None:
        """Rebuild all rows from a coherent (copy-on-write) informer
        snapshot — O(fleet) reference walking, zero object copies.
        Called at every full resync anchor."""
        t0 = time.perf_counter()
        with self._lock:
            self._pools.clear()
            self._node_pool.clear()
            self._daemon_sets.clear()
            self._extra_daemon_sets.clear()
            self._limbo_pods.clear()
            self._pod_node.clear()
            for ds in snapshot.list_daemon_sets(self.namespace):
                if matches_labels(
                    ds.metadata.labels, self.driver_labels
                ):
                    self._daemon_sets[ds.metadata.uid] = ds
                elif self.namespace:
                    self._extra_daemon_sets[ds.metadata.uid] = ds
            for node in snapshot.nodes.values():
                name = node.metadata.name
                pool = self._pool_key_for_node(node)
                pv = self._pool(pool)
                pv.rows[name] = NodeRow(
                    name, pool, self._state_of(node), node
                )
                self._node_pool[name] = pool
            for pod in snapshot.pods.values():
                cls = self._pod_class(pod)
                if cls is None or not pod.spec.node_name:
                    continue
                node_name = pod.spec.node_name
                pool = self._node_pool.get(node_name)
                pv = self._pools.get(pool) if pool is not None else None
                row = (
                    pv.rows.get(node_name) if pv is not None else None
                )
                pod_key = (pod.namespace, pod.metadata.name)
                if row is None:
                    self._limbo_pods[pod_key] = pod
                    continue
                if cls == "driver":
                    row.pods[pod_key] = pod
                else:
                    row.extra_pods[pod_key] = pod
                self._pod_node[pod_key] = node_name
            for pv in self._pools.values():
                pv.generation += 1
                pv.valid = True
                if self._artifact_selectors:
                    for row in pv.rows.values():
                        if row.extra_pods:
                            self._refresh_artifact_hashes(row)
            self.seeded = True
            self.stats["reseeds"] += 1
        self.stats["reseed_last_s_x1000"] = int(
            (time.perf_counter() - t0) * 1000
        )

    def mark_stale(self) -> None:
        """No coherent snapshot available at the resync anchor: stop
        serving until one is."""
        with self._lock:
            self.seeded = False
            self.stats["mark_stale"] += 1

    def invalidate_pool(self, key: str) -> None:
        """A shard error mid-pool: distrust this pool's rows until the
        next reseed (its builds fall back to build_state)."""
        with self._lock:
            pv = self._pools.get(key)
            if pv is not None:
                pv.valid = False
                pv.generation += 1
            self.stats["pool_invalidations"] += 1

    def generation_of(self, key: str) -> int:
        with self._lock:
            pv = self._pools.get(key)
            return pv.generation if pv is not None else 0

    def diff_against(self, state: ClusterUpgradeState) -> int:
        """Audit the view against a freshly built full ``build_state``:
        membership, state labels, and resource versions must agree.
        Read-only and copy-free; returns the mismatch count (0 = the
        incremental path provably tracked the store since last seed)."""
        mismatches = 0
        state_pairs = 0
        with self._lock:
            if not self.seeded:
                return 0
            for label, nus_list in state.node_states.items():
                for nus in nus_list:
                    state_pairs += 1
                    name = nus.node.metadata.name
                    pool = self._node_pool.get(name)
                    pv = (
                        self._pools.get(pool)
                        if pool is not None
                        else None
                    )
                    row = (
                        pv.rows.get(name) if pv is not None else None
                    )
                    if row is None:
                        mismatches += 1
                        continue
                    if row.state != label:
                        mismatches += 1
                        continue
                    if (
                        row.node.metadata.resource_version
                        != nus.node.metadata.resource_version
                    ):
                        mismatches += 1
                        continue
                    pod = nus.driver_pod
                    if pod is not None:
                        row_pod = row.pods.get(
                            (pod.namespace, pod.metadata.name)
                        )
                        if (
                            row_pod is None
                            or row_pod.metadata.resource_version
                            != pod.metadata.resource_version
                        ):
                            mismatches += 1
                            continue
                    # Artifact pods are audited only when the feed
                    # provably carries them — a pod-scoped informer
                    # never sees them, and counting those as
                    # mismatches would reseed-churn every resync.
                    if self._artifact_scope_covered and nus.artifacts:
                        for ast in nus.artifacts.values():
                            apod = ast.pod
                            if apod is None:
                                continue
                            row_pod = row.extra_pods.get(
                                (apod.namespace, apod.metadata.name)
                            )
                            if (
                                row_pod is None
                                or row_pod.metadata.resource_version
                                != apod.metadata.resource_version
                            ):
                                mismatches += 1
            view_pairs = sum(
                len(row.pods)
                for pv in self._pools.values()
                for row in pv.rows.values()
            )
            if view_pairs != state_pairs:
                mismatches += abs(view_pairs - state_pairs)
            if mismatches:
                self.stats["diff_mismatches"] += mismatches
                logger.warning(
                    "matview diff found %d mismatches; reseeding "
                    "(fail-open)",
                    mismatches,
                )
        return mismatches

    # -- the read path -------------------------------------------------------

    def _artifact_serving_ready(
        self, selectors: dict[str, dict[str, str]]
    ) -> bool:
        """Whether the view can serve a multi-artifact policy with
        these NON-primary selectors: the informer's pod scope must
        provably cover every one of them (otherwise artifact pods never
        reach the feed and the engine would see them all as vacuously
        synced — the one wrongness the view must never introduce).
        Learns the selectors as a side effect so ingest can maintain
        per-row artifact revision hashes."""
        if not self.namespace or self.covers_pod_fn is None:
            return False
        with self._lock:
            if selectors == self._artifact_selectors:
                return self._artifact_scope_covered
        # Coverage depends only on static scope + selectors: computed
        # once per policy shape, cached, never called on the hot path
        # (and never under the view lock — ordering doctrine).
        try:
            covered = all(
                self.covers_pod_fn(
                    namespace=self.namespace, match_labels=sel
                )
                for sel in selectors.values()
            )
        except Exception:
            logger.exception("artifact scope probe failed; fail open")
            covered = False
        with self._lock:
            self._artifact_selectors = dict(selectors)
            self._artifact_scope_covered = covered
            for pv in self._pools.values():
                for row in pv.rows.values():
                    if row.extra_pods or row.artifact_hashes:
                        self._refresh_artifact_hashes(row)
        return covered

    def build_pool_state(
        self, key: str, policy, manager
    ) -> Optional[ClusterUpgradeState]:
        """Materialize one pool's ``ClusterUpgradeState`` from the view:
        deep-copies ONLY this pool's node/pod rows and the daemonsets
        they reference, then reuses the manager's own ``_build_groups``
        for byte-identical grouping semantics.  Returns None whenever
        the view cannot prove it is serving current data — the caller
        must fall back to ``build_state``.  Multi-artifact policies are
        served only when the informer feed provably carries every
        artifact's pods (see :meth:`_artifact_serving_ready`)."""
        try:
            dag = artifact_dag_of(policy)
        except Exception:
            self.stats["misses_artifact_policy"] += 1
            return None
        selectors: dict[str, dict[str, str]] = {}
        if dag is not None:
            primary = dag.primary()
            for name in dag.topo_order():
                if name != primary:
                    selectors[name] = dict(
                        dag.artifact(name).match_labels
                    )
            if not self._artifact_serving_ready(selectors):
                self.stats["misses_artifact_scope"] += 1
                return None
        with self._lock:
            if not self.seeded:
                self.stats["misses_unseeded"] += 1
                return None
            pv = self._pools.get(key)
            if pv is None or not pv.valid:
                self.stats["misses_invalid"] += 1
                return None
            # (node ref, driver pod refs, extra pod refs) triples + the
            # ds refs: grabbed under the lock, copied outside it.
            rows = [
                (
                    row.node,
                    list(row.pods.values()),
                    list(row.extra_pods.values()) if dag else (),
                )
                for row in pv.rows.values()
            ]
            ds_refs = dict(self._daemon_sets)
            extra_ds_refs = (
                dict(self._extra_daemon_sets) if dag else {}
            )
        if self.fresh_fn is not None and not self.fresh_fn():
            self.stats["misses_stale"] += 1
            return None
        state = ClusterUpgradeState()
        node_states_by_name: dict[str, NodeUpgradeState] = {}
        ds_copies: dict = {}
        for node_ref, pods, extra_pods in rows:
            node_copy = None
            for pod in pods:
                if pod.is_orphaned():
                    ds = None
                else:
                    uid = pod.metadata.owner_references[0].uid
                    if uid not in ds_refs:
                        # Owned by a non-driver controller: build_state
                        # excludes such pods entirely.
                        continue
                    ds = ds_copies.get(uid)
                    if ds is None:
                        ds = deep_copy(ds_refs[uid])
                        ds_copies[uid] = ds
                if node_copy is None:
                    node_copy = deep_copy(node_ref)
                nus = NodeUpgradeState(
                    node=node_copy,
                    driver_pod=deep_copy(pod),
                    driver_daemon_set=ds,
                )
                node_states_by_name[node_copy.name] = nus
                label_state = node_copy.labels.get(
                    self.keys.state_label, ""
                )
                state.node_states.setdefault(label_state, []).append(
                    nus
                )
            if dag is None or node_copy is None or not extra_pods:
                continue
            # Attach non-primary artifacts, mirroring the engine's
            # _attach_artifacts: pod paired to a DaemonSet matching the
            # SAME artifact's selector via owner uid; no pod for an
            # artifact = no entry = vacuously synced.
            nus = node_states_by_name[node_copy.name]
            for name, sel in selectors.items():
                for apod in extra_pods:
                    if not matches_labels(apod.labels, sel):
                        continue
                    ads = None
                    if not apod.is_orphaned():
                        uid = apod.metadata.owner_references[0].uid
                        ref = extra_ds_refs.get(uid)
                        if ref is not None and matches_labels(
                            ref.metadata.labels, sel
                        ):
                            ads = ds_copies.get(uid)
                            if ads is None:
                                ads = deep_copy(ref)
                                ds_copies[uid] = ads
                    if nus.artifacts is None:
                        nus.artifacts = {}
                    nus.artifacts[name] = ArtifactNodeState(
                        pod=deep_copy(apod), daemon_set=ads
                    )
        manager._build_groups(state, node_states_by_name, policy)
        self.stats["pool_builds"] += 1
        return state

    # -- observability -------------------------------------------------------

    def snapshot_stats(self) -> dict:
        with self._lock:
            events = self.stats["events"]
            return {
                "pools": len(self._pools),
                "rows": sum(
                    len(pv.rows) for pv in self._pools.values()
                ),
                "interned_strings": len(self.interner),
                "seeded": self.seeded,
                "artifact_selectors": len(self._artifact_selectors),
                "artifact_scope_covered": self._artifact_scope_covered,
                "apply_avg_us": (
                    (self.apply_total_s / events) * 1e6 if events else 0.0
                ),
            }
