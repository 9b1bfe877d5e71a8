"""The federation coordinator: a thin, restartable global brain.

One :class:`FederationCoordinator` drives N member clusters — each with
its own :class:`~k8s_operator_libs_tpu_torch.upgrade.upgrade_state.
ClusterUpgradeStateManager`, write plane, and budget ledger — through
one global roll:

* **Regional canary first.**  Only the canary region's clusters get
  engine passes until the canary completes AND its telemetry baselines
  stay clean for the configured soak (:class:`~k8s_operator_libs_tpu_torch.
  federation.canary.CanaryGate`).  A confirmed regression hard-stops
  promotion: the ``CanaryHeld`` condition (with the canary roll's trace
  id) is raised and a Warning event emitted.
* **Fail-static partitions.**  Cluster health comes from the registry's
  probe ladder; a Partitioned cluster is skipped ENTIRELY — no reads,
  no writes, its in-flight groups frozen at last-known state and its
  budget charges left reserved in the global ledger — while the healthy
  clusters' waves proceed under the global cap net of those
  reservations.  On heal the cluster resumes via the engine's own
  adoption pass (annotation-anchored, zero repeated writes).
* **Crash durability.**  Coordinator state (phase, soak-start epoch,
  hold reason/trace, adoption stamp) persists as annotations on a tiny
  federation custom object, written only on change; a restarted
  coordinator re-adopts mid-canary with the soak clock rebased via the
  same ``monotonic_from_epoch`` path the engine's progress clocks use.

Conditions follow the controller's CR-status shape (type / status /
reason / message / lastTransitionTime, with the timestamp preserved
while the status is unchanged).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, List, Optional

from k8s_operator_libs_tpu_torch.api.schema import POLICY_GROUP, POLICY_VERSION
from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.federation.canary import (
    HELD,
    PROMOTE,
    CanaryGate,
)
from k8s_operator_libs_tpu_torch.federation.ledger import GlobalBudgetLedger
from k8s_operator_libs_tpu_torch.federation.plan import (
    FederatedPlan,
    plan_federated,
)
from k8s_operator_libs_tpu_torch.federation.registry import (
    ClusterHealth,
    ClusterRegistry,
    MemberCluster,
)
from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError
from k8s_operator_libs_tpu_torch.upgrade.consts import UpgradeState
from k8s_operator_libs_tpu_torch.upgrade.durable import format_adoption_stamp
from k8s_operator_libs_tpu_torch.upgrade.sharded import BudgetLedger

logger = get_logger(__name__)

# The federation roll object: one tiny custom resource anchoring the
# coordinator's durable state as annotations (the same pattern as the
# engine's per-node progress clocks — durable, CAS-guarded, cheap).
FEDERATION_PLURAL = "tpufederationrolls"

PHASE_KEY = f"{POLICY_GROUP}/fed-phase"
SOAK_KEY = f"{POLICY_GROUP}/fed-soak-start-epoch"
HELD_REASON_KEY = f"{POLICY_GROUP}/fed-held-reason"
HELD_TRACE_KEY = f"{POLICY_GROUP}/fed-held-trace"
ADOPTED_KEY = f"{POLICY_GROUP}/fed-adopted-by"

# Coordinator phases (durable via PHASE_KEY).
PHASE_CANARY = "canary"
PHASE_SOAKING = "soaking"
PHASE_HELD = "held"
PHASE_PROMOTED = "promoted"
PHASE_DONE = "done"


def ensure_federation_kind(client) -> None:
    """Enable the federation-roll kind on clients that gate unknown
    kinds (FakeCluster / in-process apiserver).  Idempotent; a no-op
    for clients without a registry."""
    register = getattr(client, "register_custom_resource", None)
    if register is not None:
        register(POLICY_GROUP, POLICY_VERSION, FEDERATION_PLURAL)


class FederationStateStore:
    """Annotation-anchored durable state on the federation roll object.

    ``save`` is only-on-change: an unchanged annotation set issues ZERO
    writes, which is what makes coordinator re-adoption write-free."""

    def __init__(self, client, namespace: str, name: str = "global-roll"):
        self.client = client
        self.namespace = namespace
        self.name = name
        self.writes = 0

    def load(self) -> Dict[str, str]:
        try:
            obj = self.client.get_custom_object(
                POLICY_GROUP,
                POLICY_VERSION,
                FEDERATION_PLURAL,
                self.namespace,
                self.name,
            )
        except NotFoundError:
            return {}
        return dict((obj.get("metadata") or {}).get("annotations") or {})

    def save(self, updates: Dict[str, Optional[str]]) -> int:
        """Merge ``updates`` into the object's annotations (None deletes
        a key).  Creates the object on first use.  Returns the number of
        API writes issued (0 when nothing changed)."""
        try:
            obj = self.client.get_custom_object(
                POLICY_GROUP,
                POLICY_VERSION,
                FEDERATION_PLURAL,
                self.namespace,
                self.name,
            )
        except NotFoundError:
            annotations = {
                k: v for k, v in updates.items() if v is not None
            }
            self.client.create_custom_object(
                POLICY_GROUP,
                POLICY_VERSION,
                FEDERATION_PLURAL,
                self.namespace,
                {
                    "apiVersion": f"{POLICY_GROUP}/{POLICY_VERSION}",
                    "kind": "TPUFederationRoll",
                    "metadata": {
                        "name": self.name,
                        "annotations": annotations,
                    },
                },
            )
            self.writes += 1
            return 1
        meta = obj.setdefault("metadata", {})
        annotations = dict(meta.get("annotations") or {})
        changed = False
        for key, value in updates.items():
            if value is None:
                if key in annotations:
                    del annotations[key]
                    changed = True
            elif annotations.get(key) != value:
                annotations[key] = value
                changed = True
        if not changed:
            return 0
        meta["annotations"] = annotations
        self.client.update_custom_object(
            POLICY_GROUP,
            POLICY_VERSION,
            FEDERATION_PLURAL,
            self.namespace,
            obj,
        )
        self.writes += 1
        return 1


def _iso(epoch: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch))


def _parse_float_epoch(raw: Optional[str]) -> Optional[float]:
    """Like durable.parse_epoch but sub-second: the soak anchor keeps
    fractional seconds so short soaks survive restarts losslessly."""
    if not raw:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


class FederationCoordinator:
    """Drives one global roll across the registry's member clusters."""

    def __init__(
        self,
        registry: ClusterRegistry,
        policy,
        namespace: str,
        driver_labels: Dict[str, str],
        store: FederationStateStore,
        identity: str = "federation-coordinator",
        term: int = 0,
        async_wait_s: float = 10.0,
        epoch_clock: Callable[[], float] = time.time,
        mono_clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.registry = registry
        self.policy = policy
        self.namespace = namespace
        self.driver_labels = dict(driver_labels)
        self.store = store
        self.identity = identity
        self.term = term
        self.async_wait_s = async_wait_s
        self.epoch_clock = epoch_clock

        fed = getattr(policy, "federation", None)
        canary = getattr(fed, "canary", None)
        regions = sorted(registry.regions())
        self.canary_region = (
            getattr(canary, "region", "") or (regions[0] if regions else "")
        )
        self.soak_s = float(getattr(canary, "soak_second", 0) or 0)
        self._global_max_unavailable = getattr(fed, "max_unavailable", None)
        self._global_max_parallel = int(
            getattr(fed, "max_parallel_upgrades", 0) or 0
        )

        self.global_ledger = GlobalBudgetLedger()
        self.gate = CanaryGate(
            self.soak_s, mono_clock=mono_clock, epoch_clock=epoch_clock
        )
        self.phase = PHASE_CANARY
        self.stats: Counter = Counter()
        self.canary_trace_ids: Dict[str, str] = {}
        self._done: Dict[str, bool] = {}
        self._last_state: Dict[str, object] = {}
        self._frozen: set = set()
        self._conditions: Dict[str, dict] = {}
        # Wire every member's engine into the budget hierarchy: local
        # admission becomes global ∧ cluster ∧ pool.
        for member in registry.members():
            if member.manager is None:
                continue
            ledger = BudgetLedger()
            ledger.parent = self.global_ledger
            ledger.cluster_name = member.name
            member.ledger = ledger
            member.manager.budget_ledger = ledger

    # -- durable state -------------------------------------------------------

    def adopt(self, now_epoch: Optional[float] = None) -> dict:
        """Re-adopt a (possibly mid-canary) global roll after a crash or
        failover: restore phase / soak clock / hold from the durable
        store, stamp the coordinator identity (only-on-change), and run
        the engine's own adoption pass on every reachable member.  A
        restart with nothing changed issues ZERO writes."""
        anno = self.store.load()
        self.phase = anno.get(PHASE_KEY) or PHASE_CANARY
        soak_epoch = _parse_float_epoch(anno.get(SOAK_KEY))
        if soak_epoch is not None:
            self.gate.adopt_soak(soak_epoch, now_epoch=now_epoch)
        if self.phase == PHASE_HELD and self.gate.held is None:
            self.gate.held = {
                "reason": anno.get(HELD_REASON_KEY, ""),
                "trace_id": anno.get(HELD_TRACE_KEY, ""),
                "epoch": self.epoch_clock(),
                "confirmations": [],
            }
        stamp = format_adoption_stamp(self.identity, self.term)
        store_writes = self.store.save({ADOPTED_KEY: stamp})
        members: Dict[str, dict] = {}
        for member in self.registry.members():
            if member.manager is None:
                continue
            if self.registry.health(member.name) is ClusterHealth.PARTITIONED:
                continue  # fail-static: re-adopted on heal instead
            try:
                members[member.name] = self._adopt_member(member)
            except Exception as exc:
                self.registry.observe_failure(member.name, str(exc))
                self.stats["member_adopt_failures"] += 1
        self.stats["adoptions"] += 1
        return {
            "phase": self.phase,
            "soakAdopted": soak_epoch is not None,
            "storeWrites": store_writes,
            "members": members,
        }

    def _adopt_member(self, member: MemberCluster) -> dict:
        mgr = member.manager
        state = mgr.build_state(
            self.namespace, self.driver_labels, self.policy
        )
        summary = mgr.adopt(
            state, identity=self.identity, term=self.term, policy=self.policy
        )
        self._last_state[member.name] = state
        if member.ledger is not None:
            member.ledger.sync_from_state(mgr, state, self.policy)
        return summary

    # -- the tick ------------------------------------------------------------

    def tick(self, now_epoch: Optional[float] = None) -> dict:
        """One federation pass: probe health, freeze/resume on
        transitions, run engine passes on the phase's active clusters,
        and advance the canary phase machine."""
        now = self.epoch_clock() if now_epoch is None else now_epoch
        self.stats["ticks"] += 1
        summary: dict = {
            "phase": self.phase,
            "clusters": {},
            "skippedPartitioned": [],
        }
        # 1. Health probes + freeze/resume transitions.
        for member in self.registry.members():
            health = self.registry.probe(member.name)
            if (
                health is ClusterHealth.PARTITIONED
                and member.name not in self._frozen
            ):
                self._freeze(member, now)
            elif (
                health is not ClusterHealth.PARTITIONED
                and member.name in self._frozen
            ):
                self._resume(member, now)
        healths = self.registry.healths()
        # 2. Engine passes on the phase's active clusters.  A
        # partitioned cluster is skipped ENTIRELY: no reads, no writes,
        # its charges stay reserved (fail-static).
        for member in self._active_members():
            if healths[member.name] is ClusterHealth.PARTITIONED:
                summary["skippedPartitioned"].append(member.name)
                self.stats["skipped_partitioned"] += 1
                continue
            if member.manager is None:
                continue
            try:
                done = self._pass(member)
                self.registry.observe_success(member.name)
            except Exception as exc:
                self.registry.observe_failure(member.name, str(exc))
                self.stats["pass_failures"] += 1
                if (
                    self.registry.health(member.name)
                    is ClusterHealth.PARTITIONED
                    and member.name not in self._frozen
                ):
                    self._freeze(member, now)
                done = False
            self._done[member.name] = done
        # 3. Canary phase machine.
        self._advance_phase(now)
        # 4. Conditions.
        self._refresh_conditions(now)
        summary["phase"] = self.phase
        summary["clusters"] = {
            m.name: {
                "region": m.region,
                "health": healths.get(
                    m.name, ClusterHealth.REACHABLE
                ).value,
                "done": bool(self._done.get(m.name)),
                "frozenGroups": len(m.frozen_groups),
            }
            for m in self.registry.members()
        }
        summary["globalBudget"] = self.global_ledger.snapshot()
        return summary

    def _active_members(self) -> List[MemberCluster]:
        members = self.registry.members()
        if self.phase in (PHASE_CANARY, PHASE_SOAKING, PHASE_HELD):
            # Pre-promotion: only the canary region rolls.  Soak (and
            # even a hold) keeps the canary's passes running — telemetry
            # needs the engine's probe batteries, and a held canary is
            # stopped from PROMOTING, not from converging.
            return [m for m in members if m.region == self.canary_region]
        return members

    def _pass(self, member: MemberCluster) -> bool:
        mgr = member.manager
        state = mgr.build_state(
            self.namespace, self.driver_labels, self.policy
        )
        self._last_state[member.name] = state
        if member.ledger is not None:
            member.ledger.sync_from_state(mgr, state, self.policy)
        self._configure_global()
        mgr.apply_state(state, self.policy)
        mgr.wait_for_async_work(self.async_wait_s)
        rec = getattr(mgr, "trace_recorder", None)
        if rec is not None:
            tid = rec.active_trace_id()
            if tid is None:
                last = rec.last_completed()
                tid = last.trace_id if last is not None else None
            if tid:
                self.canary_trace_ids[member.name] = tid
        groups = list(state.all_groups())
        return bool(groups) and all(
            g.effective_state(mgr.keys.state_label) is UpgradeState.DONE
            for g in groups
        )

    def _configure_global(self) -> None:
        """Re-derive the global caps from the members' current totals.
        A partitioned member's last-synced total (and charges) persist —
        the federation does not shrink its denominator because a region
        went dark."""
        total = 0
        unit = "node"
        for member in self.registry.members():
            if member.ledger is not None:
                total += member.ledger.total_units
                unit = member.ledger.unit
        cap = 0
        if self._global_max_unavailable is not None and total > 0:
            cap = self._global_max_unavailable.scaled_value(
                total, round_up=True
            )
        self.global_ledger.configure(
            total, cap, max_parallel=self._global_max_parallel, unit=unit
        )

    # -- fail-static freeze / heal-time resume -------------------------------

    def _freeze(self, member: MemberCluster, now: float) -> None:
        """Partition detected: freeze the cluster at last-known state.
        Its budget charges are NOT released — the frozen capacity stays
        debited against the global cap until the cluster heals."""
        charges = (
            dict(member.ledger.snapshot().get("charges", {}))
            if member.ledger is not None
            else {}
        )
        member.frozen_groups = charges
        self._frozen.add(member.name)
        self.stats["freezes"] += 1
        self._emit_event(
            "ClusterPartitioned",
            f"cluster {member.name} (region {member.region}) partitioned: "
            f"{len(charges)} in-flight group(s) frozen fail-static, "
            f"{sum(charges.values())} budget unit(s) stay reserved",
            type_="Warning",
        )
        logger.warning(
            "cluster %s partitioned: %d group(s) frozen",
            member.name,
            len(charges),
        )

    def _resume(self, member: MemberCluster, now: float) -> None:
        """Heal detected: resume via the engine's adoption pass — the
        durable per-node record (labels, rungs, clocks, stamps) is the
        source of truth, so nothing is repeated."""
        frozen = len(member.frozen_groups)
        member.frozen_groups = {}
        self._frozen.discard(member.name)
        if member.manager is not None:
            try:
                self._adopt_member(member)
            except Exception as exc:
                self.registry.observe_failure(member.name, str(exc))
                self._frozen.add(member.name)
                self.stats["resume_failures"] += 1
                return
        self.stats["resumes"] += 1
        self._emit_event(
            "ClusterHealed",
            f"cluster {member.name} (region {member.region}) healed: "
            f"re-adopted, {frozen} frozen group(s) resumed",
        )

    # -- canary phase machine ------------------------------------------------

    def _advance_phase(self, now: float) -> None:
        if self.phase == PHASE_CANARY:
            canary_members = [
                m
                for m in self.registry.members()
                if m.region == self.canary_region
            ]
            if canary_members and all(
                self._done.get(m.name) for m in canary_members
            ):
                if self.gate.begin_soak(now_epoch=now):
                    self.phase = PHASE_SOAKING
                    self.store.save(
                        {
                            PHASE_KEY: PHASE_SOAKING,
                            SOAK_KEY: repr(
                                float(self.gate.soak_started_epoch)
                            ),
                        }
                    )
                    self._emit_event(
                        "CanarySoakStarted",
                        f"canary region {self.canary_region} complete; "
                        f"soaking health baselines for "
                        f"{self.soak_s:.0f}s",
                    )
            return
        if self.phase == PHASE_SOAKING:
            for m in self.registry.members():
                if m.region != self.canary_region or m.manager is None:
                    continue
                self.gate.observe_plane(
                    getattr(m.manager, "telemetry_plane", None),
                    trace_id=self.canary_trace_ids.get(m.name, ""),
                )
            verdict = self.gate.evaluate()
            if verdict.phase == HELD:
                self.phase = PHASE_HELD
                self.store.save(
                    {
                        PHASE_KEY: PHASE_HELD,
                        HELD_REASON_KEY: verdict.reason,
                        HELD_TRACE_KEY: verdict.trace_id,
                    }
                )
                self._emit_event(
                    "CanaryHeld",
                    f"promotion held: {verdict.reason} "
                    f"(trace {verdict.trace_id or 'unknown'})",
                    type_="Warning",
                )
                self.stats["canary_holds"] += 1
            elif verdict.phase == PROMOTE:
                self.phase = PHASE_PROMOTED
                self.store.save(
                    {
                        PHASE_KEY: PHASE_PROMOTED,
                        HELD_REASON_KEY: None,
                        HELD_TRACE_KEY: None,
                    }
                )
                self._emit_event(
                    "CanaryPromoted",
                    f"canary soak clean for {self.soak_s:.0f}s; "
                    f"promoting to remaining regions",
                )
            return
        if self.phase == PHASE_PROMOTED:
            members = [
                m for m in self.registry.members() if m.manager is not None
            ]
            reachable_done = all(
                self._done.get(m.name)
                for m in members
                if m.name not in self._frozen
            )
            if members and reachable_done and not self._frozen:
                self.phase = PHASE_DONE
                self.store.save({PHASE_KEY: PHASE_DONE})
                self._emit_event(
                    "FederatedRollComplete",
                    "all clusters converged",
                )

    # -- conditions / events / status ----------------------------------------

    def _set_condition(
        self,
        type_: str,
        status: bool,
        reason: str,
        message: str,
        now: float,
    ) -> None:
        status_str = "True" if status else "False"
        prev = self._conditions.get(type_)
        last_transition = (
            prev["lastTransitionTime"]
            if prev is not None and prev["status"] == status_str
            else _iso(now)
        )
        self._conditions[type_] = {
            "type": type_,
            "status": status_str,
            "reason": reason,
            "message": message,
            "lastTransitionTime": last_transition,
        }

    def _refresh_conditions(self, now: float) -> None:
        partitioned = self.registry.partitioned()
        if partitioned:
            frozen = sum(
                len(self.registry.member(n).frozen_groups)
                for n in partitioned
            )
            self._set_condition(
                "Partitioned",
                True,
                "ClusterPartitioned",
                f"{len(partitioned)} cluster(s) partitioned "
                f"({', '.join(partitioned)}); {frozen} group(s) frozen "
                f"fail-static, budget reserved",
                now,
            )
        else:
            self._set_condition(
                "Partitioned",
                False,
                "AllReachable",
                "every member cluster reachable",
                now,
            )
        held = self.gate.held
        if held is not None:
            self._set_condition(
                "CanaryHeld",
                True,
                "TelemetryRegression",
                f"{held['reason']} (trace "
                f"{held.get('trace_id') or 'unknown'})",
                now,
            )
        else:
            self._set_condition(
                "CanaryHeld",
                False,
                "BaselinesClean",
                f"canary soak "
                f"{'running' if self.phase == PHASE_SOAKING else 'clean'}",
                now,
            )

    def conditions(self) -> List[dict]:
        return [self._conditions[t] for t in sorted(self._conditions)]

    def _emit_event(
        self, reason: str, message: str, type_: str = "Normal"
    ) -> None:
        try:
            self.store.client.create_event(
                self.namespace,
                {
                    "metadata": {
                        "generateName": f"fed-{reason.lower()}-"
                    },
                    "type": type_,
                    "reason": reason,
                    "message": message,
                    "involvedObject": {
                        "apiVersion": f"{POLICY_GROUP}/{POLICY_VERSION}",
                        "kind": "TPUFederationRoll",
                        "name": self.store.name,
                        "namespace": self.namespace,
                    },
                    "source": {"component": "federation-coordinator"},
                },
            )
        except Exception:
            # Events are observe-only; never fail a tick over one.
            self.stats["event_drops"] += 1

    def plan(self, now: Optional[float] = None) -> FederatedPlan:
        """READ-ONLY federated projection from the last built
        snapshots (no API traffic)."""
        healths = self.registry.healths()
        entries = []
        for member in self.registry.members():
            if member.manager is None:
                continue
            health = healths[member.name]
            state = (
                None
                if health is ClusterHealth.PARTITIONED
                else self._last_state.get(member.name)
            )
            entries.append((member, state, health))
        return plan_federated(
            entries,
            self.policy,
            canary_region=self.canary_region,
            soak_s=self.soak_s,
            now=now,
        )

    def status(self) -> dict:
        """CLI / CR-status surface."""
        healths = self.registry.healths()
        verdict = self.gate.evaluate()
        return {
            "phase": self.phase,
            "canary": {
                "region": self.canary_region,
                "phase": verdict.phase,
                "soakSeconds": self.soak_s,
                "soakRemainingSeconds": round(
                    verdict.soak_remaining_s, 1
                ),
                "reason": verdict.reason,
                "traceId": verdict.trace_id,
            },
            "clusters": {
                m.name: {
                    "region": m.region,
                    "health": healths[m.name].value,
                    "done": bool(self._done.get(m.name)),
                    "frozenGroups": len(m.frozen_groups),
                }
                for m in self.registry.members()
            },
            "globalBudget": self.global_ledger.snapshot(),
            "conditions": self.conditions(),
        }
