"""Cordon/uncordon manager.

Capability parity with the reference's ``CordonManager``
(cordon_manager.go:33-48) plus slice-batch variants: a multi-host slice
cordons all hosts concurrently so no window exists where half a torus is
schedulable.
"""

from __future__ import annotations

from typing import Sequence

from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.drain import DrainHelper
from k8s_operator_libs_tpu_torch.k8s.objects import Node
from k8s_operator_libs_tpu_torch.upgrade.util import run_batch


class CordonManager:
    def __init__(self, client: KubeClient, max_concurrency: int = 32) -> None:
        self.client = client
        self.max_concurrency = max_concurrency

    def cordon(self, node: Node) -> None:
        DrainHelper(self.client).run_cordon_or_uncordon(node, True)

    def uncordon(self, node: Node) -> None:
        DrainHelper(self.client).run_cordon_or_uncordon(node, False)

    def _batch(self, nodes: Sequence[Node], desired: bool) -> None:
        helper = DrainHelper(self.client)
        run_batch(
            [
                (lambda n=n: helper.run_cordon_or_uncordon(n, desired))
                for n in nodes
            ],
            self.max_concurrency,
        )

    def cordon_nodes(self, nodes: Sequence[Node]) -> None:
        """Cordon every host of a slice concurrently."""
        self._batch(nodes, True)

    def uncordon_nodes(self, nodes: Sequence[Node]) -> None:
        self._batch(nodes, False)
