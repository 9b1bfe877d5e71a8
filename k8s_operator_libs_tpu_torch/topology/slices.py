"""Slice discovery from node labels, and slice-shape math.

New first-class component (SURVEY.md §2.3, §7 step 1): the reference has no
topology model — its schedulable unit is a node.  Here we read the public
GKE TPU node labels (``cloud.google.com/gke-tpu-topology``,
``gke-tpu-accelerator``, ``gke-tpu-worker-id``, ``gke-nodepool``) — or our
own fallback labels — and group nodes into ICI slices.  A multi-host slice
is one torus: cordoning or draining any host interrupts the collective for
every host, so the whole slice is the atomic upgrade unit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from k8s_operator_libs_tpu_torch.k8s.objects import Node

if TYPE_CHECKING:  # avoid a runtime cycle with the upgrade package
    from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

# GKE TPU node labels used for slice discovery (public GKE conventions).
# Canonical home is here; upgrade.consts re-exports them.
GKE_TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
GKE_TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"
GKE_TPU_WORKER_ID_LABEL = "cloud.google.com/gke-tpu-worker-id"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
# Multi-slice training on GKE runs under JobSet; slices whose nodes carry
# the same jobset back one DCN data-parallel job and must never be down
# simultaneously (BASELINE config 5).  Used as the dcn-group fallback
# when our explicit dcn-group label is absent.  JobSet names are
# namespace-scoped, so the fallback combines namespace/name when the
# namespace label is present — two teams' same-named JobSets must not be
# merged into one DCN group.
JOBSET_NAME_LABEL = "jobset.sigs.k8s.io/jobset-name"
JOBSET_NAMESPACE_LABEL = "jobset.sigs.k8s.io/jobset-namespace"


def _jobset_dcn_group(labels: dict[str, str]) -> Optional[str]:
    name = labels.get(JOBSET_NAME_LABEL)
    if not name:
        return None
    ns = labels.get(JOBSET_NAMESPACE_LABEL)
    return f"{ns}/{name}" if ns else name

# Chips per host machine by GKE accelerator type (public machine shapes:
# v4/v5p hosts carry 4 chips; v5e and v6e hosts carry up to 8 but multi-host
# pod slices use 4-chip hosts for v5e 2x4+ topologies — we use the
# conservative per-host chip count for host-count math and allow explicit
# override via SliceTopologySpec.hosts_per_slice).
ACCELERATOR_CHIPS_PER_HOST = {
    "tpu-v4-podslice": 4,
    "tpu-v5p-slice": 4,
    "tpu-v5-lite-podslice": 4,
    "tpu-v5-lite-device": 8,  # single-host v5e
    "tpu-v6e-slice": 4,
    "tpu-v7x-slice": 4,
}
DEFAULT_CHIPS_PER_HOST = 4


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse ``"2x2x4"`` into dims; empty string -> ()."""
    if not topology:
        return ()
    try:
        dims = tuple(int(d) for d in topology.split("x"))
    except ValueError as e:
        raise ValueError(f"bad TPU topology string {topology!r}") from e
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad TPU topology string {topology!r}")
    return dims


def chips_for_topology(topology: str) -> int:
    dims = parse_topology(topology)
    return math.prod(dims) if dims else 0


def hosts_for_topology(
    topology: str, accelerator: str = "", chips_per_host: int = 0
) -> int:
    """Expected host (node) count for a slice topology.

    ``chips_per_host`` > 0 overrides the accelerator table (explicit
    ``UpgradeKeys.chips_per_host_label`` on the nodes — sub-host v5e
    topologies and shapes the table doesn't know)."""
    chips = chips_for_topology(topology)
    if chips == 0:
        return 1
    per_host = chips_per_host or ACCELERATOR_CHIPS_PER_HOST.get(
        accelerator, DEFAULT_CHIPS_PER_HOST
    )
    return max(1, chips // per_host)


@dataclass
class SliceInfo:
    """Identity + shape of one ICI slice (one torus)."""

    slice_id: str
    accelerator: str = ""
    topology: str = ""
    expected_hosts: int = 1
    # Multi-slice (DCN) group this slice belongs to, if any: slices in the
    # same group back one data-parallel JobSet and must not be down
    # simultaneously (BASELINE config 5).
    dcn_group: Optional[str] = None
    # Explicit per-host chip count (chips_per_host_label); 0 = derive from
    # the accelerator table / topology.
    chips_per_host: int = 0

    @property
    def chips(self) -> int:
        return chips_for_topology(self.topology) or (
            self.expected_hosts * (self.chips_per_host or 4)
        )

    def host_chips(self) -> int:
        """Chips each host of this slice should enumerate (0 = unknown).

        Explicit override first; else the accelerator table; else derived
        from the topology's total chip count over the expected hosts."""
        if self.chips_per_host:
            return self.chips_per_host
        per_host = ACCELERATOR_CHIPS_PER_HOST.get(self.accelerator, 0)
        if per_host:
            return per_host
        total = chips_for_topology(self.topology)
        if total and self.expected_hosts:
            return max(1, total // self.expected_hosts)
        return 0

    def is_multi_host(self) -> bool:
        return self.expected_hosts > 1


def slice_info_for_node(node: Node, keys: UpgradeKeys) -> Optional[SliceInfo]:
    """Derive the slice a node belongs to from its labels, or None if the
    node carries no TPU slice identity (then it upgrades as a singleton,
    reference semantics)."""
    labels = node.labels
    accelerator = labels.get(GKE_TPU_ACCELERATOR_LABEL, "")
    topology = labels.get(GKE_TPU_TOPOLOGY_LABEL, "")
    # Slice identity: explicit slice-id label wins; else the GKE node pool
    # (a multi-host TPU node pool is exactly one slice).
    slice_id = labels.get(keys.slice_id_label) or labels.get(GKE_NODEPOOL_LABEL)
    if not slice_id or not (accelerator or topology):
        return None
    raw_cph = labels.get(keys.chips_per_host_label, "")
    chips_per_host = int(raw_cph) if raw_cph.isdigit() else 0
    return SliceInfo(
        slice_id=slice_id,
        accelerator=accelerator,
        topology=topology,
        expected_hosts=hosts_for_topology(topology, accelerator, chips_per_host),
        dcn_group=(
            labels.get(keys.dcn_group_label)
            or _jobset_dcn_group(labels)
        ),
        chips_per_host=chips_per_host,
    )


def discover_slices(
    nodes: list[Node], keys: UpgradeKeys
) -> tuple[dict[str, SliceInfo], dict[str, list[Node]]]:
    """Group nodes by slice.

    Returns (slice_id -> SliceInfo, slice_id -> member nodes).  Nodes with
    no TPU labels are not returned here — callers treat them as singleton
    groups.
    """
    infos: dict[str, SliceInfo] = {}
    members: dict[str, list[Node]] = {}
    for node in nodes:
        info = slice_info_for_node(node, keys)
        if info is None:
            continue
        infos.setdefault(info.slice_id, info)
        members.setdefault(info.slice_id, []).append(node)
    # Keep member order deterministic by worker id then name.
    def _worker_key(n: Node) -> tuple[int, str]:
        wid = n.labels.get(GKE_TPU_WORKER_ID_LABEL, "")
        return (int(wid) if wid.isdigit() else 1 << 30, n.name)

    for ns in members.values():
        ns.sort(key=_worker_key)
    return infos, members
