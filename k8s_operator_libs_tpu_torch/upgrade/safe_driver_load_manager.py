"""Safe driver load: the "hold libtpu until the slice is quiesced" handshake.

Capability parity with the reference's ``SafeDriverLoadManager``
(safe_driver_load_manager.go:28-89) and its two-step protocol
(SURVEY.md §3.5): the driver pod's init container sets a
wait-for-safe-load annotation on its node and blocks; the state manager
detects it, forces the node through the full cordon/drain pipeline, and
finally *removes the annotation* instead of restarting the pod — the init
container unblocks and the driver loads onto a quiet node.

TPU semantics: libtpu load on ANY host of a multi-host slice re-initializes
the ICI fabric for the whole slice, so the handshake is group-scoped —
a slice is "waiting for safe load" if any host is, and unblocking happens
for all waiting hosts at once, only after the entire slice is quiesced.
"""

from __future__ import annotations


from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.objects import Node
from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (
    NodeUpgradeStateProvider,
)
from k8s_operator_libs_tpu_torch.upgrade.types import UpgradeGroup
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = get_logger(__name__)


class SafeDriverLoadManager:
    def __init__(
        self,
        node_state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
    ) -> None:
        self.provider = node_state_provider
        self.keys = keys

    def is_waiting_for_safe_driver_load(self, node: Node) -> bool:
        """True if the driver pod on the node set the safe-load annotation
        (safe_driver_load_manager.go:51-53)."""
        return bool(node.annotations.get(self.keys.safe_load_annotation))

    def is_group_waiting_for_safe_driver_load(self, group: UpgradeGroup) -> bool:
        return any(
            self.is_waiting_for_safe_driver_load(n) for n in group.nodes
        )

    def unblock_loading(self, node: Node) -> None:
        """Remove the safe-load annotation so the init container proceeds
        (safe_driver_load_manager.go:57-71)."""
        if not self.is_waiting_for_safe_driver_load(node):
            return
        self.provider.change_node_upgrade_annotation(
            node, self.keys.safe_load_annotation, "null"
        )

    def unblock_group_loading(self, group: UpgradeGroup) -> None:
        """Unblock every waiting host of a quiesced slice in one batch."""
        waiting = [
            n for n in group.nodes if self.is_waiting_for_safe_driver_load(n)
        ]
        if not waiting:
            return
        logger.info(
            "unblocking safe driver load for %d host(s) in group %s",
            len(waiting),
            group.id,
        )
        self.provider.change_nodes_upgrade_annotation(
            waiting, self.keys.safe_load_annotation, "null"
        )
