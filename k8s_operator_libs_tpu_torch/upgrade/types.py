"""Core state-snapshot types for the upgrade engine.

Analogues of the reference's ``NodeUpgradeState`` / ``ClusterUpgradeState``
(upgrade_state.go:38-62), extended with the slice-group view that makes the
TPU state machine ICI-aware: nodes belonging to one multi-host TPU slice
are bundled into an :class:`UpgradeGroup` that transitions atomically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.k8s.objects import DaemonSet, Node, Pod
from k8s_operator_libs_tpu_torch.topology.slices import SliceInfo
from k8s_operator_libs_tpu_torch.upgrade.consts import (
    STATE_ORDER,
    UpgradeState,
    parse_state,
)


@dataclass
class ArtifactNodeState:
    """One non-primary artifact's pod/DaemonSet pair on one node.

    Multi-artifact stacks only: the PRIMARY artifact (first in
    topological order) keeps riding the classic ``driver_pod`` /
    ``driver_daemon_set`` fields, so a size-1 DAG never allocates these.
    """

    pod: Optional[Pod] = None
    daemon_set: Optional[DaemonSet] = None


@dataclass
class NodeUpgradeState:
    """Mapping between a node, the driver pod on it, and the owning
    DaemonSet (reference upgrade_state.go:38-44)."""

    node: Node
    driver_pod: Optional[Pod] = None
    driver_daemon_set: Optional[DaemonSet] = None
    # Multi-artifact stacks: artifact name -> that artifact's pod/DS on
    # this node (primary artifact excluded — it IS driver_pod above).
    # None for single-artifact policies, by construction.
    artifacts: Optional[dict[str, "ArtifactNodeState"]] = None

    def is_orphaned_pod(self) -> bool:
        return self.driver_daemon_set is None

    def artifact_state(self, name: str) -> Optional["ArtifactNodeState"]:
        return (self.artifacts or {}).get(name)


@dataclass
class UpgradeGroup:
    """The atomic schedulable unit of the TPU state machine.

    For a multi-host TPU slice this is every host of one ICI domain — they
    cordon/drain/restart/validate together so the torus is never split.
    For a non-TPU node it is a singleton, which degenerates to exactly the
    reference's per-node semantics.
    """

    id: str
    members: list[NodeUpgradeState] = field(default_factory=list)
    slice_info: Optional[SliceInfo] = None

    @property
    def nodes(self) -> list[Node]:
        return [m.node for m in self.members]

    @property
    def node_names(self) -> list[str]:
        return [m.node.name for m in self.members]

    def size(self) -> int:
        return len(self.members)

    def is_slice(self) -> bool:
        return self.slice_info is not None

    def effective_state(self, state_label_key: str) -> UpgradeState:
        """Resolve the group's state from its members' node labels.

        Members can momentarily disagree (controller crash mid-batch).
        FAILED dominates (a slice is failed if any host is failed —
        SURVEY.md §7 'hard parts'); otherwise the EARLIEST state in the
        forward order wins, so a re-run drives every member forward
        idempotently.
        """
        # parse_state tolerates externally-written garbage label values
        # (resolved to UNKNOWN and self-healed) instead of crashing the
        # reconcile loop.
        states = [
            parse_state(m.node.labels.get(state_label_key, ""))
            for m in self.members
        ]
        # QUARANTINED dominates even FAILED: a crash mid-quarantine-batch
        # leaves the group half-parked, and the next pass must finish
        # parking it (budget release is the safety property) rather than
        # re-drive the un-flipped members through a roll on dead hardware.
        if UpgradeState.QUARANTINED in states:
            return UpgradeState.QUARANTINED
        if UpgradeState.FAILED in states:
            return UpgradeState.FAILED
        return min(states, key=lambda s: STATE_ORDER[s])


@dataclass
class ClusterUpgradeState:
    """Point-in-time snapshot of the cluster's upgrade state, grouped by
    state label (reference upgrade_state.go:51-62) and additionally by
    upgrade group."""

    # state value -> node states (reference NodeStates map)
    node_states: dict[str, list[NodeUpgradeState]] = field(default_factory=dict)
    # group effective state value -> groups (the slice-aware view)
    groups: dict[str, list[UpgradeGroup]] = field(default_factory=dict)

    def nodes_in(self, state: UpgradeState) -> list[NodeUpgradeState]:
        return self.node_states.get(state.value, [])

    def groups_in(self, state: UpgradeState) -> list[UpgradeGroup]:
        return self.groups.get(state.value, [])

    def all_groups(self) -> list[UpgradeGroup]:
        return [g for gs in self.groups.values() for g in gs]
