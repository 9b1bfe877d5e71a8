"""Job-side agent for the elastic-roll negotiation protocol.

A training job that can reshape its mesh runs one
:class:`WorkloadCoordinator` (on its coordinator host, next to the training
process). The agent:

1. ``register()`` — stamps the ``elastic-workload`` annotation on every
   node of every slice it owns, which is what makes the controller
   route those slices through ``negotiate-required`` instead of
   cordoning them cold;
2. ``poll_once()`` — reads each slice's negotiation annotations, and

   - on a fresh exclusion offer: consults ``accept_policy``; on accept
     stamps ``elastic-response=accept``, drives ``runtime.exclude``,
     then stamps ``elastic-resize-complete``; on decline stamps
     ``elastic-response=decline`` and walks away (the controller falls
     back to the drain path);
   - on a rejoin offer: drives ``runtime.rejoin`` and stamps
     ``elastic-rejoin-complete``.

Crash-safety mirrors the controller's: every decision is stamped before
the next step runs, and ``runtime.exclude``/``rejoin`` are idempotent,
so replaying ``poll_once`` after a crash resumes mid-negotiation
(accept stamped but resize unfinished → the resize reruns; resize
stamped → nothing to do). A resize that raises is reported as a decline
so the controller falls back to draining rather than waiting out the
offer timeout.
"""

import logging
import time
from typing import Callable, Dict, List, Optional

from k8s_operator_libs_tpu_torch.coordination.protocol import (
    RESPONSE_ACCEPT,
    RESPONSE_DECLINE,
    NegotiationView,
    negotiation_view,
)
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = logging.getLogger(__name__)


class WorkloadCoordinator:
    def __init__(
        self,
        client,
        keys: UpgradeKeys,
        workload_id: str,
        slice_nodes: Dict[str, List[str]],
        runtime,
        accept_policy: Optional[Callable[[str], bool]] = None,
        now: Callable[[], float] = time.time,
    ):
        """``slice_nodes`` maps slice id -> node names the job occupies;
        ``runtime`` needs ``exclude(slice_id)`` / ``rejoin(slice_id)``;
        ``accept_policy`` decides per-slice whether to take an offer
        (default: accept everything)."""
        self.client = client
        self.keys = keys
        self.workload_id = workload_id
        self.slice_nodes = {s: list(n) for s, n in slice_nodes.items()}
        self.runtime = runtime
        self.accept_policy = accept_policy or (lambda slice_id: True)
        self.now = now
        # Slices this agent has finished shrinking away; used only for
        # reporting — the annotations remain the source of truth.
        self.excluded_slices: List[str] = []

    # -- annotation plumbing --

    def _nodes(self, slice_id: str) -> List:
        nodes = []
        for name in self.slice_nodes[slice_id]:
            node = self.client.get_node(name, cached=False)
            if node is not None:
                nodes.append(node)
        return nodes

    def _stamp(self, slice_id: str, key: str, value: str) -> None:
        for name in self.slice_nodes[slice_id]:
            self.client.patch_node_annotations(name, {key: value})

    def _view(self, slice_id: str) -> NegotiationView:
        return negotiation_view(self._nodes(slice_id), self.keys)

    # -- protocol steps --

    def register(self) -> None:
        for slice_id in self.slice_nodes:
            self._stamp(
                slice_id, self.keys.elastic_workload_annotation, self.workload_id
            )

    def poll_once(self) -> Dict[str, str]:
        """One negotiation sweep; returns {slice_id: action taken}."""
        actions: Dict[str, str] = {}
        for slice_id in self.slice_nodes:
            view = self._view(slice_id)
            action = self._step_slice(slice_id, view)
            if action:
                actions[slice_id] = action
        return actions

    def _step_slice(self, slice_id: str, view: NegotiationView) -> str:
        # Rejoin takes precedence: a rejoin offer means the exclusion
        # cycle is over and the controller wants the slice back.
        if view.rejoin_offered and view.rejoin_complete_epoch is None:
            self.runtime.rejoin(slice_id)
            self._stamp(
                slice_id,
                self.keys.elastic_rejoin_complete_annotation,
                str(int(self.now())),
            )
            if slice_id in self.excluded_slices:
                self.excluded_slices.remove(slice_id)
            return "rejoin-complete"

        if not view.offered or view.excluded:
            return ""
        if view.response == RESPONSE_DECLINE:
            return ""
        if view.response == RESPONSE_ACCEPT and view.resize_complete_epoch is not None:
            return ""

        if view.response != RESPONSE_ACCEPT:
            if not self.accept_policy(slice_id):
                self._stamp(
                    slice_id,
                    self.keys.elastic_response_annotation,
                    RESPONSE_DECLINE,
                )
                return "declined"
            self._stamp(
                slice_id, self.keys.elastic_response_annotation, RESPONSE_ACCEPT
            )

        # Accept stamped (now or by a pre-crash incarnation) but the
        # resize has not completed — run it.
        try:
            self.runtime.exclude(slice_id)
        except Exception:
            logger.exception("elastic resize failed for slice %s", slice_id)
            self._stamp(
                slice_id, self.keys.elastic_response_annotation, RESPONSE_DECLINE
            )
            return "resize-failed"
        self._stamp(
            slice_id,
            self.keys.elastic_resize_complete_annotation,
            str(int(self.now())),
        )
        if slice_id not in self.excluded_slices:
            self.excluded_slices.append(slice_id)
        return "resize-complete"
