"""Cluster membership + per-cluster health state machine.

Health is a three-state ladder — ``Reachable → Degraded → Partitioned``
— driven by the two control-plane liveness signals the stack already
maintains:

* the per-endpoint :class:`~k8s_operator_libs_tpu_torch.k8s.retry.
  CircuitBreaker` carried by the cluster's resilient client (an open
  endpoint means repeated transport failures already exhausted their
  retries), and
* lease freshness from ``k8s/leader.py`` semantics: the member
  cluster's controller Lease is read through the same client, and —
  exactly like a leader-election candidate — the registry never
  compares the holder's ``renewTime`` against its own wall clock; it
  records *when it observed* the (holder, renewTime) pair change and
  calls the lease stale only after ``lease_duration_s`` of its OWN
  clock without an observed renewal.

Escalation: every failed probe bumps a consecutive-failure streak
(``degraded_after`` failures → Degraded, ``partitioned_after`` →
Partitioned); a probe that fast-fails on an OPEN breaker escalates
straight to Partitioned — the breaker only opens after the retry tier
has already proven the endpoint down repeatedly.  Healing descends the
same ladder with hysteresis: a Partitioned cluster needs
``heal_probes`` consecutive clean probes to step down to Degraded, and
one more to be Reachable again — a flapping WAN link cannot whipsaw
the coordinator between freeze and resume.

Fail-static bookkeeping rides the member record: when the coordinator
freezes a partitioned cluster it snapshots the cluster's in-flight
budget charges into ``MemberCluster.frozen_groups`` so the global plan
and the status surface can show exactly which capacity stays reserved.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.leader import (
    LEASE_GROUP,
    LEASE_PLURAL,
    LEASE_VERSION,
)
from k8s_operator_libs_tpu_torch.k8s.retry import CircuitOpenError

logger = get_logger(__name__)


class ClusterHealth(enum.Enum):
    """Per-cluster control-plane health (NOT a node upgrade state: like
    preemption and window holds this is a *condition* — see the state
    diagram's doctrine notes)."""

    REACHABLE = "Reachable"
    DEGRADED = "Degraded"
    PARTITIONED = "Partitioned"


_LADDER = [
    ClusterHealth.REACHABLE,
    ClusterHealth.DEGRADED,
    ClusterHealth.PARTITIONED,
]


class MemberCluster:
    """One federated member: a name, a region, a (breaker-wrapped)
    client, and optionally the engine driving it."""

    def __init__(
        self,
        name: str,
        region: str,
        client,
        manager=None,
        lease_namespace: str = "",
        lease_name: str = "",
    ) -> None:
        self.name = name
        self.region = region
        self.client = client
        self.manager = manager
        # Per-cluster budget ledger (wired by the coordinator).
        self.ledger = None
        # "" = no lease to watch (single-replica member controllers).
        self.lease_namespace = lease_namespace
        self.lease_name = lease_name
        # Fail-static freeze: group_id → charged units at partition
        # time.  Non-empty only while the cluster is frozen.
        self.frozen_groups: Dict[str, int] = {}

    @property
    def breaker(self):
        return getattr(self.client, "breaker", None)


class ClusterRegistry:
    """Membership + health probing for every federated cluster."""

    def __init__(
        self,
        degraded_after: int = 1,
        partitioned_after: int = 3,
        heal_probes: int = 2,
        lease_duration_s: float = 30.0,
        epoch_clock: Callable[[], float] = time.time,
        mono_clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.degraded_after = max(1, int(degraded_after))
        self.partitioned_after = max(
            self.degraded_after, int(partitioned_after)
        )
        self.heal_probes = max(1, int(heal_probes))
        self.lease_duration_s = lease_duration_s
        self.epoch_clock = epoch_clock
        self.mono_clock = mono_clock
        self._lock = threading.Lock()
        self._members: Dict[str, MemberCluster] = {}
        self._health: Dict[str, ClusterHealth] = {}
        self._fail_streak: Dict[str, int] = {}
        self._heal_streak: Dict[str, int] = {}
        self._last_detail: Dict[str, str] = {}
        # name → ((holder, renewTime), observed_at_mono) — the
        # observer-clock lease freshness record.
        self._lease_obs: Dict[str, Tuple[Tuple[str, str], float]] = {}
        # (epoch, cluster, from, to, reason) — bounded history for the
        # status surface and the tests.
        self.transitions: List[Tuple[float, str, str, str, str]] = []
        self.stats: Dict[str, int] = {
            "probes": 0,
            "probe_failures": 0,
            "partitions": 0,
            "heals": 0,
        }

    # -- membership ----------------------------------------------------------

    def add(
        self,
        name: str,
        region: str,
        client,
        manager=None,
        lease_namespace: str = "",
        lease_name: str = "",
    ) -> MemberCluster:
        member = MemberCluster(
            name,
            region,
            client,
            manager=manager,
            lease_namespace=lease_namespace,
            lease_name=lease_name,
        )
        with self._lock:
            self._members[name] = member
            self._health[name] = ClusterHealth.REACHABLE
            self._fail_streak[name] = 0
            self._heal_streak[name] = 0
        return member

    def member(self, name: str) -> MemberCluster:
        return self._members[name]

    def members(self) -> List[MemberCluster]:
        with self._lock:
            return list(self._members.values())

    def regions(self) -> Dict[str, List[str]]:
        """region → sorted member names."""
        out: Dict[str, List[str]] = {}
        with self._lock:
            for m in self._members.values():
                out.setdefault(m.region, []).append(m.name)
        return {r: sorted(names) for r, names in out.items()}

    # -- health --------------------------------------------------------------

    def health(self, name: str) -> ClusterHealth:
        with self._lock:
            return self._health[name]

    def healths(self) -> Dict[str, ClusterHealth]:
        with self._lock:
            return dict(self._health)

    def detail(self, name: str) -> str:
        with self._lock:
            return self._last_detail.get(name, "")

    def partitioned(self) -> List[str]:
        with self._lock:
            return sorted(
                n
                for n, h in self._health.items()
                if h is ClusterHealth.PARTITIONED
            )

    def reachable(self) -> List[str]:
        with self._lock:
            return sorted(
                n
                for n, h in self._health.items()
                if h is not ClusterHealth.PARTITIONED
            )

    def _lease_fresh(self, member: MemberCluster) -> Optional[bool]:
        """True/False lease freshness on the observer's own clock, or
        None when the member has no lease configured or the read itself
        failed (the transport failure is already the probe verdict)."""
        if not member.lease_name:
            return None
        try:
            lease = member.client.get_custom_object(
                LEASE_GROUP,
                LEASE_VERSION,
                LEASE_PLURAL,
                member.lease_namespace,
                member.lease_name,
            )
        except Exception:
            return None
        spec = lease.get("spec") or {}
        pair = (
            str(spec.get("holderIdentity") or ""),
            str(spec.get("renewTime") or ""),
        )
        now = self.mono_clock()
        prev = self._lease_obs.get(member.name)
        if prev is None or prev[0] != pair:
            self._lease_obs[member.name] = (pair, now)
            return True
        duration = float(
            spec.get("leaseDurationSeconds") or self.lease_duration_s
        )
        return (now - prev[1]) <= duration

    def probe(self, name: str, detail: str = "") -> ClusterHealth:
        """One active health probe: a cheap quorum read through the
        member's (breaker-wrapped) client, plus lease freshness.  The
        read doubles as the breaker's half-open probe after an outage
        ends, so healing needs no out-of-band reset."""
        member = self._members[name]
        self.stats["probes"] += 1
        ok = True
        hard = False
        try:
            member.client.list_page("Node", limit=1)
        except CircuitOpenError as exc:
            ok = False
            hard = True  # breaker already proved the endpoint down
            detail = detail or str(exc)
        except Exception as exc:
            ok = False
            detail = detail or str(exc)
        breaker = member.breaker
        if ok and breaker is not None:
            open_eps = breaker.open_endpoints()
            # The probe endpoint answered but others are still open:
            # count the probe clean (half-open probes on the remaining
            # endpoints close them organically as traffic resumes).
            if open_eps and not detail:
                detail = f"{len(open_eps)} endpoint(s) still open"
        if ok:
            fresh = self._lease_fresh(member)
            if fresh is False:
                ok = False
                detail = detail or (
                    f"lease {member.lease_namespace}/{member.lease_name} "
                    f"stale on observer clock"
                )
        return self._step(name, ok, hard, detail)

    def observe_failure(self, name: str, detail: str = "") -> ClusterHealth:
        """Engine-pass failure feedback (e.g. apply_state raised through
        the resilient client).  A CircuitOpen detail escalates hard."""
        hard = "circuit open" in detail.lower()
        return self._step(name, False, hard, detail)

    def observe_success(self, name: str) -> ClusterHealth:
        return self._step(name, True, False, "")

    def _step(
        self, name: str, ok: bool, hard: bool, detail: str
    ) -> ClusterHealth:
        transition: Optional[Tuple[str, str, str]] = None
        with self._lock:
            cur = self._health[name]
            if ok:
                self._fail_streak[name] = 0
                self._heal_streak[name] += 1
                new = cur
                if cur is ClusterHealth.PARTITIONED:
                    if self._heal_streak[name] >= self.heal_probes:
                        new = ClusterHealth.DEGRADED
                        self._heal_streak[name] = 0
                elif cur is ClusterHealth.DEGRADED:
                    new = ClusterHealth.REACHABLE
                reason = "clean probe"
            else:
                self.stats["probe_failures"] += 1
                self._heal_streak[name] = 0
                streak = self._fail_streak[name] + 1
                if hard:
                    streak = max(streak, self.partitioned_after)
                self._fail_streak[name] = streak
                if streak >= self.partitioned_after:
                    new = ClusterHealth.PARTITIONED
                elif streak >= self.degraded_after:
                    # Never step DOWN on a failure.
                    new = (
                        ClusterHealth.DEGRADED
                        if cur is not ClusterHealth.PARTITIONED
                        else cur
                    )
                else:
                    new = cur
                reason = detail or "probe failed"
            self._last_detail[name] = detail if not ok else ""
            if new is not cur:
                self._health[name] = new
                transition = (cur.value, new.value, reason)
                if new is ClusterHealth.PARTITIONED:
                    self.stats["partitions"] += 1
                if (
                    cur is ClusterHealth.PARTITIONED
                    and new is not ClusterHealth.PARTITIONED
                ):
                    self.stats["heals"] += 1
        if transition is not None:
            self.transitions.append(
                (self.epoch_clock(), name) + transition
            )
            del self.transitions[:-256]
            logger.info(
                "cluster %s health %s -> %s (%s)",
                name,
                transition[0],
                transition[1],
                transition[2],
            )
        with self._lock:
            return self._health[name]
