"""Sharded, event-driven dirty-set reconcile.

The informer zeroed steady-state API *reads*, but every tick still
rebuilt full cluster state and walked every pool — tick cost was
O(fleet) even when nothing changed.  This module flips the loop inside
out (the Podracer shape from PAPERS.md: many cheap workers fed by a
central queue, no global barrier):

- :class:`DirtySetQueue` — a coalescing work queue keyed by *pool* (an
  ICI slice, or a single non-TPU node).  Rapid deltas on one slice fold
  into one entry; per-pool serialization guarantees a pool is never
  reconciled by two shards at once (a key re-dirtied mid-reconcile is
  requeued at the tail, which is also what keeps a hot pool from
  starving cold ones — FIFO over distinct keys).
- :class:`DeltaRouter` — maps informer watch deltas to dirty pool keys.
  Node events resolve their slice from the event object's own labels;
  Pod events resolve through a node→pool index; DaemonSet /
  ControllerRevision / policy-CR events legitimately dirty the whole
  fleet (a template or policy bump changes every pool's sync verdict).
- :class:`BudgetLedger` — the shared ``maxUnavailable`` /
  ``maxParallelUpgrades`` arbiter.  Scoped passes see only their own
  pool, so the state-local slot math (which is what the unsharded path
  uses) would let two shards each compute "1 slot free" and jointly
  overspend; the ledger makes the claim itself atomic.  It is rebuilt
  from the observed fleet state on every full resync, so a crash
  between a claim and its label write self-corrects instead of leaking
  budget forever.
- :class:`ShardedReconciler` — a thread pool of reconcile shards.
  ``tick()`` drains the dirty set: each pool gets a `build_state`-scoped
  rebuild and a scoped ``apply_state`` pass on its own shard, fenced by
  the controller's leadership fence (a deposed leader's shards abandon
  without mutating, exactly like the async workers).  An idle tick
  takes zero pools, builds zero state, and costs O(µs).  The periodic
  full resync (the controller's classic ``reconcile_once``) survives as
  the low-frequency safety net that catches missed deltas, re-seeds the
  pool registry, and re-baselines the ledger.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import (
    group_accelerator,
    group_dcn_group,
)
from k8s_operator_libs_tpu_torch.fleet.scheduler import pool_sort_key
from k8s_operator_libs_tpu_torch.k8s.client import WatchEvent
from k8s_operator_libs_tpu_torch.topology.slices import slice_info_for_node
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    IN_PROGRESS_STATES,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade.matview import MaterializedFleetView
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = get_logger(__name__)


def pool_key_for_node(node, keys: UpgradeKeys) -> str:
    """The dirty-set key a node reconciles under: its ICI slice id, or
    its own name when it carries no slice identity (singleton pool).
    Pool granularity is always slice-level — with ``slice_atomic=False``
    a pool simply contains several singleton groups, which keeps routing
    independent of the policy knob."""
    info = slice_info_for_node(node, keys)
    return info.slice_id if info is not None else node.name


class DirtySetQueue:
    """Thread-safe coalescing dirty set with per-pool serialization.

    ``mark`` is idempotent while a key is queued (rapid events on one
    slice coalesce); ``take`` claims keys FIFO and holds them in-flight
    so no second shard can pick the same pool up; ``done`` releases the
    claim and requeues at the tail if the pool was re-dirtied while its
    reconcile ran (or if the shard asks for a retry)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> first-marked monotonic time; insertion order is FIFO.
        self._dirty: dict[str, float] = {}
        self._in_flight: set[str] = set()
        self._redirty: set[str] = set()
        self.stats: Counter = Counter()

    def mark(self, key: str) -> bool:
        """Dirty one pool.  Returns True when newly enqueued, False when
        coalesced into an existing entry (queued or in-flight)."""
        with self._lock:
            self.stats["events_routed"] += 1
            if key in self._in_flight:
                self._redirty.add(key)
                self.stats["events_coalesced"] += 1
                return False
            if key in self._dirty:
                self.stats["events_coalesced"] += 1
                return False
            self._dirty[key] = time.monotonic()
            return True

    def mark_many(self, keys) -> int:
        return sum(1 for k in keys if self.mark(k))

    def take(
        self,
        max_n: Optional[int] = None,
        sort_key: Optional[Callable[[str], object]] = None,
    ) -> list[tuple[str, float]]:
        """Claim up to ``max_n`` dirty pools (FIFO).  Returns
        ``(key, queued_for_seconds)`` pairs; each key stays in-flight
        until ``done``.

        ``sort_key`` overrides FIFO for *batch selection* — the
        generation-aware scheduler passes one so oldest-generation pools
        canary first when the queue holds more work than the batch
        admits.  Coalescing and per-pool serialization are unaffected,
        and a key skipped by the sort keeps its original mark time, so
        queue-age metrics still expose any pool the sort perpetually
        defers."""
        now = time.monotonic()
        with self._lock:
            n = len(self._dirty) if max_n is None else max_n
            candidates = list(self._dirty)
            if sort_key is not None:
                candidates.sort(key=sort_key)
            batch: list[tuple[str, float]] = []
            for key in candidates:
                if len(batch) >= n:
                    break
                marked_at = self._dirty.pop(key)
                self._in_flight.add(key)
                batch.append((key, now - marked_at))
            self.stats["pools_taken"] += len(batch)
            return batch

    def done(self, key: str, requeue: bool = False) -> None:
        with self._lock:
            self._in_flight.discard(key)
            if requeue or key in self._redirty:
                self._redirty.discard(key)
                # Tail of the FIFO: a hot pool goes to the back, so cold
                # pools marked meanwhile are served first (no starvation).
                self._dirty.setdefault(key, time.monotonic())

    def depth(self) -> int:
        with self._lock:
            return len(self._dirty)

    def in_flight(self) -> int:
        with self._lock:
            return len(self._in_flight)

    def oldest_wait_s(self) -> float:
        with self._lock:
            if not self._dirty:
                return 0.0
            return time.monotonic() - min(self._dirty.values())

    def clear_marked_before(self, ts: float) -> int:
        """Drop queued keys first marked at or before ``ts`` — a full
        resync that STARTED at ``ts`` has already covered them.  Keys
        marked later (mid-resync deltas that may postdate the snapshot)
        and in-flight claims are kept."""
        with self._lock:
            stale = [k for k, at in self._dirty.items() if at <= ts]
            for k in stale:
                del self._dirty[k]
            return len(stale)


class DeltaRouter:
    """WatchEvent → dirty pool keys, via a node→pool index the full
    resync seeds and Node deltas keep current."""

    def __init__(self, keys: UpgradeKeys, queue: DirtySetQueue) -> None:
        self.keys = keys
        self.queue = queue
        self._lock = threading.Lock()
        self._node_pool: dict[str, str] = {}
        self._pool_nodes: dict[str, set[str]] = {}
        self.stats: Counter = Counter()

    # -- registry ------------------------------------------------------------

    def seed(self, node_pool: dict[str, str]) -> None:
        """Replace the node→pool index from a full-resync snapshot."""
        with self._lock:
            self._node_pool = dict(node_pool)
            self._pool_nodes = {}
            for node, pool in self._node_pool.items():
                self._pool_nodes.setdefault(pool, set()).add(node)

    def nodes_of(self, pool: str) -> set[str]:
        with self._lock:
            return set(self._pool_nodes.get(pool, ()))

    def pools(self) -> list[str]:
        with self._lock:
            return list(self._pool_nodes)

    def pool_of_group(self, group_id: str) -> Optional[str]:
        """A slice group's id IS its pool key; a singleton group's id is
        its node name, resolved through the node index."""
        with self._lock:
            if group_id in self._pool_nodes:
                return group_id
            return self._node_pool.get(group_id)

    def _remember(self, node_name: str, pool: Optional[str]) -> Optional[str]:
        """Update the index; returns the PREVIOUS pool when it changed
        (both sides of a relabel must reconcile)."""
        with self._lock:
            old = self._node_pool.get(node_name)
            if pool is None:
                if old is not None:
                    del self._node_pool[node_name]
                    bucket = self._pool_nodes.get(old)
                    if bucket is not None:
                        bucket.discard(node_name)
                        if not bucket:
                            del self._pool_nodes[old]
                return old
            if old == pool:
                return None
            if old is not None:
                bucket = self._pool_nodes.get(old)
                if bucket is not None:
                    bucket.discard(node_name)
                    if not bucket:
                        del self._pool_nodes[old]
            self._node_pool[node_name] = pool
            self._pool_nodes.setdefault(pool, set()).add(node_name)
            return old

    # -- routing -------------------------------------------------------------

    def mark_all(self) -> int:
        """Fleet-wide dirty: a driver template / revision / policy change
        legitimately invalidates every pool's sync verdict."""
        self.stats["mark_all"] += 1
        return self.queue.mark_many(self.pools())

    def route(self, ev: Optional[WatchEvent]) -> None:
        """Feed one watch delta.  Heartbeats and bookmarks carry no
        change; everything else dirties the pools it touches."""
        if ev is None or ev.type == "BOOKMARK" or ev.object is None:
            return
        if ev.kind == "Node":
            node = ev.object
            if ev.type == "DELETED":
                old = self._remember(node.metadata.name, None)
                if old is not None:
                    self.queue.mark(old)
                return
            pool = pool_key_for_node(node, self.keys)
            old = self._remember(node.metadata.name, pool)
            self.queue.mark(pool)
            if old is not None:
                self.queue.mark(old)
            return
        if ev.kind == "Pod":
            node_name = getattr(ev.object.spec, "node_name", "") or ""
            with self._lock:
                pool = self._node_pool.get(node_name)
            if pool is not None:
                self.queue.mark(pool)
            else:
                # A pod on a node we have never seen: the node's own
                # ADDED event (or the next full resync) routes it.
                self.stats["pod_events_unrouted"] += 1
            return
        # DaemonSet, ControllerRevision, the policy CR, and any kind we
        # do not model: conservatively dirty the fleet.
        self.mark_all()


class LedgerSnapshot(dict):
    """Plain-dict view of the ledger for logging/metrics."""


class LedgerError(RuntimeError):
    """A caller violated a ledger invariant (negative charge, strict-mode
    double release).  Raised instead of silently corrupting the budget
    hierarchy: a negative cost would mint capacity out of thin air, and a
    double release under a federated parent would free the same global
    units twice."""


class BudgetLedger:
    """Fleet-wide, atomic ``maxUnavailable`` / ``maxParallelUpgrades`` /
    DCN-anti-affinity arbitration for parallel shards.

    A scoped pass sees only its own pool's state, so slot math computed
    from that state is blind to what other shards are doing in the same
    instant.  All admission therefore goes through ``try_claim`` — one
    lock, check-and-charge in a single step.  Claims are idempotent per
    group (a re-reconciled pool re-claims its own charge for free) and
    are released when the group leaves the in-progress lattice (done,
    quarantined).  ``sync_from_state`` re-derives every charge from the
    observed fleet during the periodic full resync, which makes the
    ledger crash-safe and self-correcting: a leaked or stale claim
    survives at most one resync interval."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.unit = "node"
        self.max_parallel = 0  # 0 = unlimited
        self.max_unavailable = 0
        self.total_units = 0
        self._charges: dict[str, int] = {}
        self._dcn_of: dict[str, str] = {}
        # Unavailability (cordoned / not-ready units) not attributable
        # to any claimed group — external faults.  Counted against the
        # cap, refreshed at resync.
        self.external_unavailable = 0
        # Groups denied a claim since the last release.  A denied pool
        # emits no further watch events, so nothing would ever re-dirty
        # it; releasing budget drains this set through ``on_release`` and
        # the reconciler re-marks those pools — the roll progresses
        # event-free instead of stalling until the next full resync.
        self._waiters: set[str] = set()
        self.on_release: Optional[Callable[[set[str]], None]] = None
        # Per-pool budget hierarchy (heterogeneous fleets): pool name →
        # (max_unavailable_units, max_parallel).  A claim must clear the
        # fleet caps AND its pool's caps — fleet ∧ pool.  Empty = the
        # classic single-pool behaviour.
        self._pool_caps: dict[str, tuple[int, int]] = {}
        # group_id → pool name, recorded at claim time.
        self._pool_of_charge: dict[str, str] = {}
        # group_id → pool name resolver supplied by the engine; lets
        # callers omit the ``pool=`` argument on try_claim.
        self.pool_resolver: Optional[Callable[[str], Optional[str]]] = None
        # Observe-only verdict tap (flight recorder): called as
        # ``trace_hook(verdict, group_id, **info)`` outside the lock,
        # never allowed to fail a claim.
        self.trace_hook: Optional[Callable[..., None]] = None
        # Federated hierarchy (federation/ledger.py): when set, a claim
        # must clear this cluster's caps AND the parent's global ∧
        # cluster caps — global ∧ cluster ∧ pool.  The parent is
        # consulted while this ledger's lock is held (lock order is
        # strictly cluster → global; the global ledger never calls back
        # into a cluster ledger), charged under ``cluster_name``, and
        # released/resynced in step with the local charge.
        self.parent = None
        self.cluster_name = ""
        # Opt-in strict mode: releasing a group that holds no charge
        # raises LedgerError instead of being a silent no-op.  The engine
        # deliberately stays tolerant (it calls release as an idempotent
        # "ensure free" on several exit paths); the federation tier and
        # the guard tests opt in.
        self.strict_release = False

    def _tap(self, verdict: str, group_id: str, **info) -> None:
        hook = self.trace_hook
        if hook is None:
            return
        try:
            hook(verdict, group_id, **info)
        except Exception:  # observe-only: never fail admission
            logger.debug("budget trace hook failed", exc_info=True)

    def configure(
        self,
        total_units: int,
        max_parallel: int,
        max_unavailable: int,
        unit: str,
    ) -> None:
        with self._lock:
            self.total_units = total_units
            self.max_parallel = max_parallel
            self.max_unavailable = max_unavailable
            self.unit = unit

    def configure_pools(
        self, pool_caps: dict[str, tuple[int, int]]
    ) -> None:
        """Install per-pool ``(max_unavailable_units, max_parallel)``
        caps.  0 max_parallel = unlimited; a pool absent from the map is
        only bounded by the fleet caps."""
        with self._lock:
            self._pool_caps = dict(pool_caps)

    # -- claims --------------------------------------------------------------

    def _pool_usage(self, pool: str) -> tuple[int, int]:
        """(unavailable units, parallel count) charged to ``pool``.
        Caller holds the lock."""
        used = 0
        count = 0
        for gid, p in self._pool_of_charge.items():
            if p == pool:
                used += self._charges.get(gid, 0)
                count += 1
        return used, count

    def _dcn_held_by_other(self, group_id: str, dcn_group: str) -> bool:
        return any(
            d == dcn_group and g != group_id
            for g, d in self._dcn_of.items()
        )

    def _denied_locked(
        self,
        group_id: str,
        cost: int,
        dcn_group: Optional[str],
        pool: Optional[str],
    ) -> bool:
        """Every admission gate in order: DCN anti-affinity, fleet
        parallel, fleet budget, then the pool's own caps.  Caller holds
        the lock; shared by try_claim and the read-only can_claim."""
        if dcn_group is not None and self._dcn_held_by_other(
            group_id, dcn_group
        ):
            return True
        if (
            self.max_parallel > 0
            and len(self._charges) >= self.max_parallel
        ):
            return True
        used = sum(self._charges.values()) + self.external_unavailable
        if used + cost > self.max_unavailable:
            return True
        if pool is not None:
            caps = self._pool_caps.get(pool)
            if caps is not None:
                pool_max_unavailable, pool_max_parallel = caps
                pool_used, pool_count = self._pool_usage(pool)
                if (
                    pool_max_parallel > 0
                    and pool_count >= pool_max_parallel
                ):
                    return True
                if pool_used + cost > pool_max_unavailable:
                    return True
        return False

    def can_claim(
        self,
        group_id: str,
        cost: int,
        dcn_group: Optional[str] = None,
        pool: Optional[str] = None,
    ) -> bool:
        """Read-only probe: would ``try_claim`` succeed right now?
        Never charges and never registers a waiter — the admission
        pass's idle-budget canary and the targeted wakeup path use it
        to ask without committing."""
        if cost < 0:
            raise LedgerError(
                f"negative charge for {group_id!r}: {cost}"
            )
        if pool is None and self.pool_resolver is not None:
            pool = self.pool_resolver(group_id)
        with self._lock:
            if group_id in self._charges:
                return True
            if self._denied_locked(group_id, cost, dcn_group, pool):
                return False
        if self.parent is not None:
            return self.parent.can_claim(self.cluster_name, group_id, cost)
        return True

    def try_claim(
        self,
        group_id: str,
        cost: int,
        dcn_group: Optional[str] = None,
        force: bool = False,
        pool: Optional[str] = None,
    ) -> bool:
        """Atomically admit ``group_id`` at ``cost`` unavailability
        units.  ``force`` charges past the caps (an already-cordoned
        group is genuinely unavailable whether or not we admit it — the
        reference's bypass, upgrade_state.go:606-616) but still records
        the charge so other claims see it.  ``pool`` scopes the claim to
        a per-pool budget when the policy declares pools; omitted, the
        installed ``pool_resolver`` is consulted."""
        if cost < 0:
            raise LedgerError(
                f"negative charge for {group_id!r}: {cost}"
            )
        if pool is None and self.pool_resolver is not None:
            pool = self.pool_resolver(group_id)
        with self._lock:
            if group_id in self._charges:
                # Idempotent re-claim by the group's own pool.  A parent
                # that lost this charge (e.g. rebaselined while the group
                # stayed in flight) is force-recharged: the unavailability
                # is a fact, not an admission request.
                if dcn_group is not None:
                    self._dcn_of[group_id] = dcn_group
                if pool is not None:
                    self._pool_of_charge[group_id] = pool
                if self.parent is not None:
                    self.parent.try_claim(
                        self.cluster_name, group_id,
                        self._charges[group_id], force=True,
                    )
                return True
            if not force:
                if self._denied_locked(group_id, cost, dcn_group, pool):
                    self._waiters.add(group_id)
                    denied = True
                else:
                    denied = False
            else:
                denied = False
            if not denied and self.parent is not None:
                # Global ∧ cluster gate, checked-and-charged atomically
                # under the cluster lock (lock order cluster → global).
                if not self.parent.try_claim(
                    self.cluster_name, group_id, cost, force=force
                ):
                    self._waiters.add(group_id)
                    denied = True
            if not denied:
                self._charges[group_id] = cost
                self._waiters.discard(group_id)
                if dcn_group is not None:
                    self._dcn_of[group_id] = dcn_group
                if pool is not None:
                    self._pool_of_charge[group_id] = pool
        self._tap(
            "denied" if denied else "granted",
            group_id,
            cost=cost,
            pool=pool,
            forced=force,
        )
        return not denied

    def release(self, group_id: str) -> None:
        waiters: set[str] = set()
        with self._lock:
            had = self._charges.pop(group_id, None)
            self._dcn_of.pop(group_id, None)
            self._pool_of_charge.pop(group_id, None)
            self._waiters.discard(group_id)
            if had is not None and self._waiters:
                waiters, self._waiters = self._waiters, set()
        if had is None and self.strict_release:
            raise LedgerError(
                f"double release of {group_id!r}: no charge held"
            )
        # Parent release only for a REAL release — the engine's
        # idempotent "ensure free" no-ops never reach the global ledger,
        # so its own strict double-release guard stays sound.
        if had is not None and self.parent is not None:
            self.parent.release(self.cluster_name, group_id)
        # Callback OUTSIDE the lock: it marks the dirty queue (its own
        # lock) and may wake the controller.
        if had is not None:
            self._tap("released", group_id, cost=had, woke=len(waiters))
        if waiters and self.on_release is not None:
            self.on_release(waiters)

    def requeue_waiters(self, group_ids) -> None:
        """Re-register waiters a targeted wakeup chose NOT to wake.

        ``release`` swaps the whole waiter set out before the callback
        runs; a plan-guided callback wakes only the planned-next groups
        and hands the rest back here so the following release considers
        them again (already-charged groups are dropped — they are no
        longer waiting)."""
        with self._lock:
            self._waiters.update(
                g for g in group_ids if g not in self._charges
            )

    # -- introspection -------------------------------------------------------

    def unavailable_used(self) -> int:
        with self._lock:
            return sum(self._charges.values()) + self.external_unavailable

    def parallel_used(self) -> int:
        with self._lock:
            return len(self._charges)

    def holds(self, group_id: str) -> bool:
        with self._lock:
            return group_id in self._charges

    def pool_unavailable_used(self, pool: str) -> int:
        with self._lock:
            return self._pool_usage(pool)[0]

    def pool_parallel_used(self, pool: str) -> int:
        with self._lock:
            return self._pool_usage(pool)[1]

    def pool_caps(self) -> dict[str, tuple[int, int]]:
        with self._lock:
            return dict(self._pool_caps)

    def snapshot(self) -> LedgerSnapshot:
        with self._lock:
            return LedgerSnapshot(
                unit=self.unit,
                total_units=self.total_units,
                max_parallel=self.max_parallel,
                max_unavailable=self.max_unavailable,
                charges=dict(self._charges),
                external_unavailable=self.external_unavailable,
                pool_caps=dict(self._pool_caps),
                pool_of_charge=dict(self._pool_of_charge),
            )

    def sync_from_state(self, manager, state, policy) -> None:
        """Re-baseline every charge from the observed fleet (full-resync
        snapshot): in-progress groups are charged at their real cost,
        unavailable units outside any claimed group become the external
        charge, and stale claims for vanished groups are dropped."""
        from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (
            node_ready,
        )

        unit = manager._unavailability_unit(policy)
        total = manager._total_units(state, unit)
        max_unavailable = total
        if policy is not None and policy.max_unavailable is not None:
            max_unavailable = policy.max_unavailable.scaled_value(
                total, round_up=True
            )
        max_parallel = getattr(policy, "max_parallel_upgrades", 0) or 0
        # DCN arbitration only exists when the policy asks for it —
        # recording dcn_of with the knob off would make try_claim deny
        # same-DCN groups the admission path deliberately allows.
        dcn_anti_affinity = bool(getattr(policy, "dcn_anti_affinity", False))
        pipeline = bool(getattr(policy, "pipeline_validation", False))
        # Heterogeneous fleets: per-pool membership, per-pool caps.
        pools = list(getattr(policy, "pools", None) or [])
        pool_for_group = getattr(manager, "_pool_for_group", None)
        budget_exempt = getattr(manager, "_group_budget_exempt", None)
        pool_of: dict[str, str] = {}
        pool_units: dict[str, int] = {}
        if pools and pool_for_group is not None:
            for group in state.all_groups():
                pool_name = pool_for_group(group, policy)
                if pool_name is None:
                    continue
                pool_of[group.id] = pool_name
                pool_units[pool_name] = pool_units.get(pool_name, 0) + (
                    1 if unit == "slice" else group.size()
                )
        pool_caps: dict[str, tuple[int, int]] = {}
        for pool_spec in pools:
            units_in_pool = pool_units.get(pool_spec.name, 0)
            cap = units_in_pool  # no override: bounded by fleet caps only
            if pool_spec.max_unavailable is not None:
                cap = pool_spec.max_unavailable.scaled_value(
                    units_in_pool, round_up=True
                )
            pool_caps[pool_spec.name] = (
                cap,
                pool_spec.max_parallel_upgrades or 0,
            )
        charges: dict[str, int] = {}
        dcn_of: dict[str, str] = {}
        pool_of_charge: dict[str, str] = {}
        for st in IN_PROGRESS_STATES:
            for group in state.groups_in(st):
                if budget_exempt is not None and budget_exempt(group):
                    # Preempted or window-held: the group holds no budget
                    # while gone — re-charging at resync would undo the
                    # fast-path release.
                    continue
                if (
                    pipeline
                    and st == UpgradeState.VALIDATION_REQUIRED
                    and manager._group_validating_schedulable(group)
                ):
                    # Pipelined gate with every host back in service: the
                    # admission path released this claim at optimistic
                    # uncordon — re-charging it here would silently undo
                    # the pipeline every full resync (mirrors the local
                    # slot math's _in_progress_units(pipeline=True)).
                    continue
                if manager._group_elastic_excluded(group):
                    # Excluded-by-resize: the workload reshaped around the
                    # slice, so it holds no budget (mirrors quarantine);
                    # re-charging at resync would undo the exclusion's
                    # release.
                    continue
                charges[group.id] = 1 if unit == "slice" else group.size()
                if group.id in pool_of:
                    pool_of_charge[group.id] = pool_of[group.id]
                ring = group_dcn_group(group, manager.keys)
                if dcn_anti_affinity and ring is not None:
                    dcn_of[group.id] = ring
        external = 0
        for group in state.all_groups():
            eff = group.effective_state(manager.keys.state_label)
            if eff in IN_PROGRESS_STATES or eff == UpgradeState.QUARANTINED:
                continue  # claimed above, or quarantine holds no budget
            if manager._group_elastic_excluded(group):
                continue  # excluded-by-resize holds no budget either
            if budget_exempt is not None and budget_exempt(group):
                continue  # preempted / window-held holds no budget
            if unit == "slice":
                if manager._group_unavailable(group):
                    external += 1
            else:
                external += sum(
                    1
                    for m in group.members
                    if m.node.spec.unschedulable or not node_ready(m.node)
                )
        with self._lock:
            self.unit = unit
            self.total_units = total
            self.max_parallel = max_parallel
            self.max_unavailable = max_unavailable
            self._charges = charges
            self._dcn_of = dcn_of
            self.external_unavailable = external
            self._pool_caps = pool_caps
            self._pool_of_charge = pool_of_charge
        # Rebaseline this cluster's slice of the federated parent from
        # the same observed snapshot (outside the lock: cluster → global
        # order, and sync_cluster takes only the global lock).  Other
        # clusters' charges — including a partitioned peer's fail-static
        # reservations — are untouched.
        if self.parent is not None:
            self.parent.sync_cluster(
                self.cluster_name, charges, total_units=total, unit=unit
            )


@dataclass
class TickReport:
    """What one dirty tick did — the O(changed) evidence."""

    pools_walked: int = 0
    fenced: int = 0
    errors: int = 0
    requeued: int = 0
    queue_depth_after: int = 0
    max_queue_wait_s: float = 0.0
    duration_s: float = 0.0
    incomplete: int = 0  # shards still running when the wait expired
    pool_keys: list[str] = field(default_factory=list)


class ShardedReconciler:
    """Parallel per-pool reconcile shards over the dirty set.

    One instance per controller; the watch pump feeds ``handle_event``,
    the controller's event-driven passes call ``tick`` and its periodic
    full passes call ``observe_full_state`` / ``complete_full_resync``
    around the classic build/apply so the registry and ledger stay
    anchored to ground truth."""

    def __init__(
        self,
        manager,
        namespace: str,
        driver_labels: dict[str, str],
        shards: int = 4,
        fence: Optional[Callable[[], bool]] = None,
        wake: Optional[Callable[[], None]] = None,
    ) -> None:
        self.manager = manager
        self.namespace = namespace
        self.driver_labels = driver_labels
        self.shards = max(1, int(shards))
        # Liveness fence, same contract as the async workers: a
        # shard checks it immediately before building/mutating and
        # abandons (requeueing its pool) when this process no longer
        # leads.  The manager's own term fence still guards every write
        # inside the pass.
        self.fence = fence
        # Wake signal to the controller loop for marks that originate on
        # shard threads (budget-release wakeups) rather than from watch
        # events — the watch pump sets its own wake after routing.
        self.wake = wake
        self.queue = DirtySetQueue()
        self.router = DeltaRouter(manager.keys, self.queue)
        self.ledger = BudgetLedger()
        self.ledger.on_release = self._on_budget_release
        manager.budget_ledger = self.ledger
        self._pool = ThreadPoolExecutor(
            max_workers=self.shards, thread_name_prefix="reconcile-shard"
        )
        self._busy_lock = threading.Lock()
        self._busy = 0
        self._outstanding: set[Future] = set()
        self.stats: Counter = Counter()
        self._seeded = False
        # Generation-aware batch ordering: pool key → accelerator kind,
        # remembered at full resync; oldest-generation pools canary
        # first when a tick cannot drain the whole queue.
        self._pool_accel: dict[str, str] = {}
        # group id → policy pool name, for the ledger's per-pool caps.
        self._group_pool: dict[str, str] = {}
        # Plan-drift progress hook (planning/drift.py): called with each
        # TickReport that walked pools, so the drift watchdog observes
        # scoped-pass activity between full resyncs without polling the
        # queue.  Read-only consumer; exceptions must not kill the tick.
        self.progress_observer: Optional[Callable[[TickReport], None]] = None
        # Plan-guided wakeups: returns the drift watchdog's FRESH plan
        # (or None).  With a plan, a budget release re-dirties only the
        # earliest-planned waiters' pools and requeues the rest, so
        # freed budget goes to the group the plan says is next instead
        # of whichever denied pool's shard wins the race.
        self.plan_provider: Optional[Callable[[], Optional[object]]] = None
        # Materialized fleet view (matview.py): available only when the
        # manager reads through a CachedKubeClient whose informer can
        # feed store deltas.  Strictly a read-path optimization — every
        # miss falls back to the scoped build_state below, and every
        # full resync audits + reseeds it (view-is-not-authority).
        self.matview: Optional[MaterializedFleetView] = None
        informer = getattr(
            getattr(manager, "client", None), "informer", None
        )
        if informer is not None and hasattr(
            informer, "add_change_listener"
        ):
            self.matview = MaterializedFleetView(
                manager.keys,
                namespace,
                driver_labels,
                fresh_fn=informer.fresh,
                covers_pod_fn=getattr(
                    informer, "covers_pod_query", None
                ),
            )
            informer.add_change_listener(self.matview.on_store_change)

    # -- feed ----------------------------------------------------------------

    def handle_event(self, ev: Optional[WatchEvent]) -> None:
        self.router.route(ev)

    def _planned_next_waiters(self, waiter_ids: set[str]) -> set[str]:
        """The subset of ``waiter_ids`` in the fresh plan's earliest
        wave among those present; all of them when no fresh plan (or
        none of the waiters is planned — liveness over packing)."""
        if self.plan_provider is None:
            return waiter_ids
        try:
            plan = self.plan_provider()
        except Exception:
            logger.exception("plan provider failed; blanket wakeup")
            return waiter_ids
        if plan is None:
            return waiter_ids
        waves: dict[str, int] = {}
        for gid in waiter_ids:
            wave = plan.wave_of(gid)
            if wave is not None:
                waves[gid] = wave
        if not waves:
            return waiter_ids
        first = min(waves.values())
        return {gid for gid, wave in waves.items() if wave == first}

    def _on_budget_release(self, waiter_ids: set[str]) -> None:
        """Budget freed: re-dirty the pools of groups that were denied a
        claim.  Without this a fleet roll stalls after the first
        ``maxUnavailable`` batch — a pool that is merely waiting its
        turn emits no watch events, so only the (slow) full resync
        would ever retry it.

        With a fresh anchored plan the wakeup is TARGETED: only the
        planned-next wave's waiters are re-dirtied (the freed budget is
        theirs by the plan); the rest go back on the waiter list via
        ``requeue_waiters`` for the next release.  Any routing failure
        falls back to waking everything — a stale plan may cost a pool
        walk, never a stall."""
        targeted = self._planned_next_waiters(waiter_ids)
        marked = 0
        for gid in targeted:
            pool = self.router.pool_of_group(gid)
            if pool is not None:
                self.queue.mark(pool)
                marked += 1
        deferred = waiter_ids - targeted
        if marked == 0 and deferred:
            # Targeted set unroutable (pool registry raced a resync):
            # blanket-wake rather than strand the roll.
            for gid in deferred:
                pool = self.router.pool_of_group(gid)
                if pool is not None:
                    self.queue.mark(pool)
                    marked += 1
            deferred = set()
        if deferred:
            self.ledger.requeue_waiters(deferred)
            self.stats["budget_wakeups_deferred"] += len(deferred)
        if targeted is not waiter_ids:
            self.stats["budget_wakeups_targeted"] += marked
        self.stats["budget_wakeups"] += marked
        if marked and self.wake is not None:
            self.wake()

    def ready(self) -> bool:
        """Dirty ticks are meaningful only once a full resync has seeded
        the pool registry and the ledger."""
        return self._seeded

    # -- full-resync anchoring ----------------------------------------------

    def observe_full_state(
        self, state, policy, started: Optional[float] = None
    ) -> float:
        """Called with the full-resync snapshot BEFORE apply: re-seed the
        node→pool registry and re-baseline the budget ledger from ground
        truth.  Returns the resync start timestamp for
        ``complete_full_resync``.

        ``started`` must be stamped BEFORE the snapshot build began:
        only deltas marked earlier than that are provably covered by the
        snapshot.  Defaulting to now is safe only when no deltas can
        have arrived during the build (synchronous tests/benches)."""
        if started is None:
            started = time.monotonic()
        node_pool: dict[str, str] = {}
        pool_accel: dict[str, str] = {}
        group_pool: dict[str, str] = {}
        pool_for_group = getattr(self.manager, "_pool_for_group", None)
        has_policy_pools = bool(getattr(policy, "pools", None))
        for group in state.all_groups():
            accel = group_accelerator(group)
            if has_policy_pools and pool_for_group is not None:
                name = pool_for_group(group, policy)
                if name is not None:
                    group_pool[group.id] = name
            for member in group.members:
                key = pool_key_for_node(member.node, self.manager.keys)
                node_pool[member.node.name] = key
                if accel:
                    pool_accel.setdefault(key, accel)
        self.router.seed(node_pool)
        self._pool_accel = pool_accel
        self._group_pool = group_pool
        self.ledger.pool_resolver = (
            self._group_pool.get if group_pool else None
        )
        self.ledger.sync_from_state(self.manager, state, policy)
        self._seeded = True
        # Materialized-view anchor: audit the incremental rows against
        # the ground-truth state this resync just built (mismatch =
        # counter + log, never a crash), then reseed from a fresh
        # copy-on-write snapshot so the next delta window starts from
        # a provably current baseline.
        if self.matview is not None:
            mismatches = self.matview.diff_against(state)
            if mismatches:
                self.stats["matview_diff_mismatches"] += mismatches
            snapshot_fn = getattr(
                self.manager.client, "coherent_snapshot", None
            )
            snap = snapshot_fn() if callable(snapshot_fn) else None
            if snap is not None:
                self.matview.reseed(snap)
            else:
                self.matview.mark_stale()
        return started

    def complete_full_resync(self, started: float) -> None:
        """Called after the full apply: deltas queued before the resync
        began are covered by it — drop them so the next dirty tick only
        sees genuinely newer work."""
        cleared = self.queue.clear_marked_before(started)
        self.stats["full_resyncs"] += 1
        if cleared:
            self.stats["resync_coalesced"] += cleared

    # -- dirty ticks ---------------------------------------------------------

    def busy_shards(self) -> int:
        with self._busy_lock:
            return self._busy

    def tick(
        self,
        policy,
        max_pools: Optional[int] = None,
        wait_s: float = 30.0,
    ) -> TickReport:
        """Drain the dirty set onto the shard pool.  Waits up to
        ``wait_s`` for THIS batch — not a global barrier: a pool that
        outlives the wait keeps running on its shard (still serialized,
        still fenced) and the tick reports it as incomplete; meanwhile
        the queue keeps accepting deltas for other pools."""
        t0 = time.monotonic()
        report = TickReport()
        batch = self.queue.take(
            max_pools, sort_key=pool_sort_key(self._pool_accel.get)
        )
        if not batch:
            report.queue_depth_after = self.queue.depth()
            report.duration_s = time.monotonic() - t0
            return report
        report.max_queue_wait_s = max(w for _, w in batch)
        futures: dict[Future, str] = {}
        for key, _waited in batch:
            fut = self._pool.submit(self._reconcile_pool, key, policy)
            futures[fut] = key
            self._outstanding.add(fut)
        done, pending = wait(futures, timeout=wait_s)
        for fut in done:
            self._outstanding.discard(fut)
            outcome = fut.result()
            report.pool_keys.append(futures[fut])
            if outcome == "fenced":
                report.fenced += 1
            elif outcome == "error":
                report.errors += 1
                report.requeued += 1
            elif outcome == "requeued":
                report.requeued += 1
            else:
                report.pools_walked += 1
        report.incomplete = len(pending)
        # Safety net: a cleanly-exited coalescing scope leaves no pending
        # node intents in the write plan.  Flush (fence-checked inside
        # the plan) anything a crashed shard leaked so it cannot ride
        # into a later, unrelated scope's flush — and so the leak is
        # visible in stats instead of silent.
        plan = getattr(self.manager, "write_plan", None)
        if (
            plan is not None
            and not pending  # no shard still mid-scope past the wait
            and not self._outstanding
            and plan.pending_depth().get("nodes")
        ):
            try:
                leaked = plan.flush_nodes()
                if leaked:
                    self.stats["plan_leaked_intents"] += len(leaked)
            except Exception as e:  # noqa: BLE001 — best-effort sweep
                logger.warning("leaked write-plan intent flush failed: %s", e)
        report.queue_depth_after = self.queue.depth()
        report.duration_s = time.monotonic() - t0
        if self.progress_observer is not None and report.pools_walked:
            try:
                self.progress_observer(report)
            except Exception as e:  # noqa: BLE001 — observer is telemetry
                logger.warning("plan progress observer failed: %s", e)
        return report

    def _reconcile_pool(self, key: str, policy) -> str:
        with self._busy_lock:
            self._busy += 1
        try:
            if self.fence is not None and not self.fence():
                # Deposed leader: abandon without building or mutating;
                # the pool stays dirty for the successor's full resync
                # (our queue dies with the process — the SUCCESSOR's
                # resync is what covers the work).
                self.queue.done(key, requeue=True)
                self.stats["fenced"] += 1
                return "fenced"
            scope = self.router.nodes_of(key)
            if not scope:
                # Pool vanished (all nodes deleted / relabelled away).
                self.queue.done(key)
                self.stats["empty_pools"] += 1
                return "empty"
            # O(delta) fast path: materialize this pool's state from
            # the incrementally-maintained view (deep-copying only the
            # pool's own rows).  Any reason the view cannot serve —
            # unseeded, reset, stale feed, invalidated pool — returns
            # None and the classic scoped build_state runs instead.
            state = None
            if self.matview is not None:
                state = self.matview.build_pool_state(
                    key, policy, self.manager
                )
            if state is not None:
                self.stats["matview_hits"] += 1
            else:
                if self.matview is not None:
                    self.stats["matview_fallbacks"] += 1
                state = self.manager.build_state(
                    self.namespace,
                    self.driver_labels,
                    policy,
                    scope_nodes=scope,
                )
            self.manager.apply_state(state, policy, scoped=True)
            self.queue.done(key)
            self.stats["pools_reconciled"] += 1
            return "ok"
        except Exception as e:  # noqa: BLE001 — a shard crash must not
            # lose the pool: requeue and let the next tick (or the full
            # resync) retry.  The ledger self-corrects at resync if the
            # crash landed between a claim and its label write.
            logger.warning("shard reconcile of pool %s failed: %s", key, e)
            self.queue.done(key, requeue=True)
            if self.matview is not None:
                # Distrust the pool's rows after a mid-pass crash: its
                # next attempt rebuilds from ground truth.
                self.matview.invalidate_pool(key)
            self.stats["shard_errors"] += 1
            return "error"
        finally:
            with self._busy_lock:
                self._busy -= 1

    # -- lifecycle / test support -------------------------------------------

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Join outstanding shard work AND the manager's async workers —
        bench/test determinism only; the controller never blocks on
        this."""
        deadline = time.monotonic() + timeout_s
        pending = list(self._outstanding)
        if pending:
            done, not_done = wait(
                pending, timeout=max(0.0, deadline - time.monotonic())
            )
            for fut in done:
                self._outstanding.discard(fut)
            if not_done:
                return False
        remaining = max(0.1, deadline - time.monotonic())
        return self.manager.wait_for_async_work(remaining)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
