"""Global budget arbitration: the level above the per-cluster ledger.

The engine's :class:`~k8s_operator_libs_tpu_torch.upgrade.sharded.BudgetLedger`
arbitrates fleet ∧ pool inside one cluster.  A federated roll adds one
more level: the sum of every cluster's in-flight unavailability must
stay under the GLOBAL ``maxUnavailable`` no matter which cluster admits
next.  :class:`GlobalBudgetLedger` is that level — each member cluster's
``BudgetLedger`` points at it via ``parent``/``cluster_name`` and every
local admission becomes global ∧ cluster ∧ pool in a single
check-and-charge.

Fail-static contract: a partitioned cluster's engine never runs, so its
charges here are never released and never resynced away — the frozen
capacity stays debited against the global cap until the cluster heals
and re-baselines its own slice.  Releasing optimistically would let the
healthy clusters respend units that may still be down in the
unreachable region.

Locking: a cluster ledger consults this one while holding its own lock
(order: cluster → global).  This ledger never calls back into a cluster
ledger, so the order can never invert.
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Tuple

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.upgrade.sharded import LedgerError

logger = get_logger(__name__)


class GlobalBudgetLedger:
    """Atomic global ∧ per-cluster check-and-charge for federated rolls.

    Charges are keyed ``(cluster, group_id)``.  Unlike the per-cluster
    ledger this one is STRICT by construction: a double release raises
    :class:`LedgerError` — the cluster ledger below filters the engine's
    idempotent "ensure free" no-ops, so an unmatched release reaching
    this level is always a real accounting bug."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.unit = "node"
        self.max_unavailable = 0  # 0 = unlimited (unconfigured)
        self.max_parallel = 0  # 0 = unlimited
        self.total_units = 0
        # cluster → (max_unavailable_units, max_parallel); absent = only
        # bounded by the global caps (the cluster's own ledger already
        # enforces its local policy caps).
        self._cluster_caps: Dict[str, Tuple[int, int]] = {}
        # (cluster, group_id) → cost.
        self._charges: Dict[Tuple[str, str], int] = {}
        # cluster → total units it contributes to the federation (for
        # percentage scaling and status).
        self._cluster_units: Dict[str, int] = {}
        # Lifetime counters.  ``violations`` counts non-forced grants
        # that left usage above the configured cap — the invariant the
        # chaos/bench pins assert stays ZERO; forced charges past the
        # caps are legitimate (an already-unavailable group is a fact,
        # not an admission request) and are tallied separately.
        self.denials = 0
        self.violations = 0
        self.forced_over_cap = 0
        self.peak_unavailable = 0

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        total_units: int,
        max_unavailable: int,
        max_parallel: int = 0,
        unit: str = "node",
    ) -> None:
        with self._lock:
            self.total_units = total_units
            self.max_unavailable = max_unavailable
            self.max_parallel = max_parallel
            self.unit = unit

    def configure_clusters(
        self, caps: Mapping[str, Tuple[int, int]]
    ) -> None:
        """Install per-cluster ``(max_unavailable_units, max_parallel)``
        overrides.  0 max_parallel = unlimited."""
        with self._lock:
            self._cluster_caps = dict(caps)

    # -- claims --------------------------------------------------------------

    def _cluster_usage(self, cluster: str) -> Tuple[int, int]:
        """(units, parallel count) charged to ``cluster``.  Caller holds
        the lock."""
        used = 0
        count = 0
        for (c, _gid), cost in self._charges.items():
            if c == cluster:
                used += cost
                count += 1
        return used, count

    def _denied_locked(self, cluster: str, cost: int) -> bool:
        if (
            self.max_parallel > 0
            and len(self._charges) >= self.max_parallel
        ):
            return True
        used = sum(self._charges.values())
        if self.max_unavailable > 0 and used + cost > self.max_unavailable:
            return True
        caps = self._cluster_caps.get(cluster)
        if caps is not None:
            cap_units, cap_parallel = caps
            c_used, c_count = self._cluster_usage(cluster)
            if cap_parallel > 0 and c_count >= cap_parallel:
                return True
            if c_used + cost > cap_units:
                return True
        return False

    def can_claim(self, cluster: str, group_id: str, cost: int) -> bool:
        """Read-only probe (never charges)."""
        if cost < 0:
            raise LedgerError(
                f"negative charge for {cluster}/{group_id}: {cost}"
            )
        with self._lock:
            if (cluster, group_id) in self._charges:
                return True
            return not self._denied_locked(cluster, cost)

    def try_claim(
        self, cluster: str, group_id: str, cost: int, force: bool = False
    ) -> bool:
        """Atomically admit ``group_id`` of ``cluster`` at ``cost``
        units against the global ∧ cluster caps.  Idempotent per
        (cluster, group).  ``force`` charges past the caps but still
        records the charge so every other cluster's admission sees it."""
        if cost < 0:
            raise LedgerError(
                f"negative charge for {cluster}/{group_id}: {cost}"
            )
        key = (cluster, group_id)
        with self._lock:
            if key in self._charges:
                return True
            if not force and self._denied_locked(cluster, cost):
                self.denials += 1
                return False
            self._charges[key] = cost
            used = sum(self._charges.values())
            if used > self.peak_unavailable:
                self.peak_unavailable = used
            if self.max_unavailable > 0 and used > self.max_unavailable:
                if force:
                    self.forced_over_cap += 1
                else:
                    # Should be unreachable: _denied_locked gates every
                    # non-forced grant.  Counted (not raised) so the
                    # chaos/bench pins can assert it stayed zero.
                    self.violations += 1
        return True

    def release(self, cluster: str, group_id: str) -> None:
        with self._lock:
            had = self._charges.pop((cluster, group_id), None)
        if had is None:
            raise LedgerError(
                f"double release of {cluster}/{group_id}: no charge held"
            )

    def sync_cluster(
        self,
        cluster: str,
        charges: Mapping[str, int],
        total_units: int = -1,
        unit: str = "",
    ) -> None:
        """Replace ``cluster``'s slice of the charge table with the
        authoritative set its own ledger just re-derived from observed
        state.  Other clusters' charges (including a partitioned peer's
        fail-static reservations) are untouched."""
        with self._lock:
            for key in [k for k in self._charges if k[0] == cluster]:
                del self._charges[key]
            for gid, cost in charges.items():
                if cost < 0:
                    raise LedgerError(
                        f"negative charge for {cluster}/{gid}: {cost}"
                    )
                self._charges[(cluster, gid)] = cost
            if total_units >= 0:
                self._cluster_units[cluster] = total_units
            if unit:
                self.unit = unit
            used = sum(self._charges.values())
            if used > self.peak_unavailable:
                self.peak_unavailable = used

    # -- introspection -------------------------------------------------------

    def unavailable_used(self) -> int:
        with self._lock:
            return sum(self._charges.values())

    def parallel_used(self) -> int:
        with self._lock:
            return len(self._charges)

    def cluster_used(self, cluster: str) -> int:
        with self._lock:
            return self._cluster_usage(cluster)[0]

    def holds(self, cluster: str, group_id: str) -> bool:
        with self._lock:
            return (cluster, group_id) in self._charges

    def cluster_charges(self, cluster: str) -> Dict[str, int]:
        with self._lock:
            return {
                gid: cost
                for (c, gid), cost in self._charges.items()
                if c == cluster
            }

    def snapshot(self) -> dict:
        with self._lock:
            per_cluster: Dict[str, int] = {}
            for (c, _gid), cost in self._charges.items():
                per_cluster[c] = per_cluster.get(c, 0) + cost
            return {
                "unit": self.unit,
                "totalUnits": self.total_units,
                "maxUnavailable": self.max_unavailable,
                "maxParallel": self.max_parallel,
                "used": sum(self._charges.values()),
                "parallel": len(self._charges),
                "peakUnavailable": self.peak_unavailable,
                "perCluster": per_cluster,
                "clusterUnits": dict(self._cluster_units),
                "denials": self.denials,
                "violations": self.violations,
                "forcedOverCap": self.forced_over_cap,
            }
