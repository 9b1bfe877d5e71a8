"""Pure helpers for the elastic-roll annotation protocol.

The protocol has no dedicated API object: node annotations are the wire.
The controller (``upgrade_state.py``) and the workload agent
(:mod:`k8s_operator_libs_tpu_torch.coordination.workload`) each read the other
side's stamps from the same node objects, so every transition survives a
crash of either party — the annotations replay the conversation.

Key roles (all formatted per-provider via :class:`UpgradeKeys`):

========================  =======  ====================================
annotation                writer   meaning
========================  =======  ====================================
``elastic-workload``      job      workload id; marks the slice as
                                   coordination-capable at admission
``elastic-offer``         ctrl     epoch the exclusion offer was posted
``elastic-response``      job      ``accept`` | ``decline``
``elastic-resize-complete``  job   epoch the shrink finished
``elastic-excluded``      ctrl     ``true`` while the slice is out of
                                   the mesh (budget-exempt marker)
``elastic-rejoin-offer``  ctrl     epoch the rejoin offer was posted
``elastic-rejoin-complete``  job   epoch the regrow finished
========================  =======  ====================================
"""

from dataclasses import dataclass
from typing import Iterable, Optional

from k8s_operator_libs_tpu_torch.upgrade.consts import (
    ELASTIC_RESPONSE_ACCEPT,
    ELASTIC_RESPONSE_DECLINE,
    NULL_STRING,
    TRUE_STRING,
)
from k8s_operator_libs_tpu_torch.upgrade.durable import parse_epoch
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

# Re-exported so workload-side code never imports from upgrade.consts
# directly (keeps the coordination package the single import surface for
# job authors).
RESPONSE_ACCEPT = ELASTIC_RESPONSE_ACCEPT
RESPONSE_DECLINE = ELASTIC_RESPONSE_DECLINE


def annotation_value(node, key: str) -> str:
    """Read one annotation, treating the ``"null"`` tombstone as empty."""
    meta = getattr(node, "metadata", None)
    annotations = getattr(meta, "annotations", None) or {}
    value = annotations.get(key, "")
    if value == NULL_STRING:
        return ""
    return value


@dataclass(frozen=True)
class NegotiationView:
    """One slice's negotiation state as read from its nodes.

    Each field is the first non-empty value across the slice's nodes —
    both sides stamp every member, so a partial write (crash mid-patch)
    still yields the stamped value.
    """

    workload: str
    offer_epoch: Optional[int]
    response: str
    resize_complete_epoch: Optional[int]
    excluded: bool
    rejoin_offer_epoch: Optional[int]
    rejoin_complete_epoch: Optional[int]

    @property
    def offered(self) -> bool:
        return self.offer_epoch is not None

    @property
    def responded(self) -> bool:
        return self.response in (RESPONSE_ACCEPT, RESPONSE_DECLINE)

    @property
    def rejoin_offered(self) -> bool:
        return self.rejoin_offer_epoch is not None


def _first_value(nodes: Iterable, key: str) -> str:
    for node in nodes:
        value = annotation_value(node, key)
        if value:
            return value
    return ""


def negotiation_view(nodes: Iterable, keys: UpgradeKeys) -> NegotiationView:
    """Fold a slice's node annotations into one :class:`NegotiationView`."""
    nodes = list(nodes)
    return NegotiationView(
        workload=_first_value(nodes, keys.elastic_workload_annotation),
        offer_epoch=parse_epoch(_first_value(nodes, keys.elastic_offer_annotation)),
        response=_first_value(nodes, keys.elastic_response_annotation),
        resize_complete_epoch=parse_epoch(
            _first_value(nodes, keys.elastic_resize_complete_annotation)
        ),
        excluded=_first_value(nodes, keys.elastic_excluded_annotation) == TRUE_STRING,
        rejoin_offer_epoch=parse_epoch(
            _first_value(nodes, keys.elastic_rejoin_offer_annotation)
        ),
        rejoin_complete_epoch=parse_epoch(
            _first_value(nodes, keys.elastic_rejoin_complete_annotation)
        ),
    )
