"""Federated roll plan: the analytic planner, composed across clusters.

``plan_federated`` runs the existing READ-ONLY per-cluster planner
(:func:`~k8s_operator_libs_tpu_torch.planning.planner.plan_roll`) for every
reachable member and composes the wave schedules region-by-region: the
canary region's clusters start at offset 0 (concurrently — they are
independent control planes), every later region starts after the
previous region's slowest cluster plus the canary soak.  Like the
per-cluster planner this issues ZERO writes: it is a projection of
what the coordinator would admit, renderable from the status CLI or
CI.

Fail-static composition rule: a Partitioned cluster contributes no
waves — its in-flight groups appear as ``frozen_groups`` (budget still
reserved in the global ledger) and its pending work as ``deferred``
until the cluster heals.  The remaining clusters' schedules are
composed as usual: the reroute is emergent — healthy clusters proceed
under the global cap net of the frozen reservations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from k8s_operator_libs_tpu_torch.federation.registry import ClusterHealth
from k8s_operator_libs_tpu_torch.planning.planner import RollPlan, plan_roll


@dataclass
class ClusterRollPlan:
    """One member cluster's slice of the federated plan."""

    cluster: str
    region: str
    health: str
    # None while the cluster is partitioned (fail-static: no projection
    # is possible without a fresh snapshot, and none is needed — the
    # cluster is frozen).
    plan: Optional[RollPlan]
    start_offset_s: float = 0.0
    frozen_groups: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "cluster": self.cluster,
            "region": self.region,
            "health": self.health,
            "startOffsetSeconds": round(self.start_offset_s, 1),
            "frozenGroups": dict(self.frozen_groups),
            "plan": self.plan.to_dict() if self.plan is not None else None,
        }


@dataclass
class FederatedPlan:
    """Region-composed projection of the global roll."""

    created_epoch: float
    canary_region: str
    regions: List[str]  # rollout order: canary first
    clusters: List[ClusterRollPlan]
    soak_s: float
    projected_duration_s: float
    total_nodes: int
    pending_groups: int

    def cluster_plan(self, name: str) -> Optional[ClusterRollPlan]:
        for cp in self.clusters:
            if cp.cluster == name:
                return cp
        return None

    def to_dict(self) -> dict:
        return {
            "createdEpoch": self.created_epoch,
            "canaryRegion": self.canary_region,
            "regions": list(self.regions),
            "soakSeconds": self.soak_s,
            "projectedDurationSeconds": round(self.projected_duration_s, 1),
            "totalNodes": self.total_nodes,
            "pendingGroups": self.pending_groups,
            "clusters": [cp.to_dict() for cp in self.clusters],
        }

    def render(self) -> str:
        lines = [
            f"federated roll plan: {len(self.clusters)} cluster(s) across "
            f"{len(self.regions)} region(s), canary={self.canary_region}, "
            f"soak={self.soak_s:.0f}s, projected "
            f"{self.projected_duration_s:.0f}s",
        ]
        for region in self.regions:
            tag = " (canary)" if region == self.canary_region else ""
            lines.append(f"  region {region}{tag}:")
            for cp in self.clusters:
                if cp.region != region:
                    continue
                if cp.plan is None:
                    lines.append(
                        f"    {cp.cluster}: {cp.health} — fail-static, "
                        f"{len(cp.frozen_groups)} group(s) frozen, "
                        f"budget reserved"
                    )
                    continue
                lines.append(
                    f"    {cp.cluster}: {cp.health}, "
                    f"{cp.plan.wave_count} wave(s), "
                    f"{cp.plan.pending_groups} pending group(s), "
                    f"start +{cp.start_offset_s:.0f}s, "
                    f"duration {cp.plan.projected_duration_s:.0f}s"
                )
        return "\n".join(lines)


def plan_federated(
    entries,
    policy,
    canary_region: str,
    soak_s: float = 0.0,
    now: Optional[float] = None,
    assumptions=None,
) -> FederatedPlan:
    """Compose per-cluster plans region-by-region.

    ``entries`` is an iterable of ``(member, state, health)`` where
    ``member`` carries ``name``/``region``/``manager``/``frozen_groups``
    and ``state`` is the cluster's built snapshot (None for a
    partitioned member — its planner never runs)."""
    if now is None:
        now = time.time()
    cluster_plans: List[ClusterRollPlan] = []
    regions_seen: List[str] = []
    for member, state, health in entries:
        if member.region not in regions_seen:
            regions_seen.append(member.region)
        if health is ClusterHealth.PARTITIONED or state is None:
            cluster_plans.append(
                ClusterRollPlan(
                    cluster=member.name,
                    region=member.region,
                    health=health.value,
                    plan=None,
                    frozen_groups=dict(member.frozen_groups),
                )
            )
            continue
        rp = plan_roll(
            member.manager, state, policy, now=now, assumptions=assumptions
        )
        cluster_plans.append(
            ClusterRollPlan(
                cluster=member.name,
                region=member.region,
                health=health.value,
                plan=rp,
            )
        )
    # Rollout order: canary region first, then the rest sorted.
    ordered = [r for r in [canary_region] if r in regions_seen]
    ordered += sorted(r for r in regions_seen if r != canary_region)
    offset = 0.0
    total_nodes = 0
    pending_groups = 0
    duration = 0.0
    for idx, region in enumerate(ordered):
        region_end = offset
        for cp in cluster_plans:
            if cp.region != region:
                continue
            if cp.plan is None:
                continue
            cp.start_offset_s = offset
            end = offset + cp.plan.projected_duration_s
            region_end = max(region_end, end)
            total_nodes += cp.plan.total_nodes
            pending_groups += cp.plan.pending_groups
        duration = max(duration, region_end)
        # The canary's soak gates promotion to every later region.
        offset = region_end + (soak_s if idx == 0 else 0.0)
    return FederatedPlan(
        created_epoch=now,
        canary_region=canary_region,
        regions=ordered,
        clusters=cluster_plans,
        soak_s=soak_s,
        projected_duration_s=duration,
        total_nodes=total_nodes,
        pending_groups=pending_groups,
    )
