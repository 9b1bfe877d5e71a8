"""Per-artifact validation gates of multi-artifact upgrade stacks.

Counterpart of the gate half of ``k8s_operator_libs_tpu.artifacts``; the
DAG half is control plane and stays with the upgrade engine, whose
``artifact_gate_prober`` slot takes :class:`NetworkPathGateProber`
duck-typed.
"""

from k8s_operator_libs_tpu_torch.artifacts.gates import (
    GateResult,
    NetworkPathGateProber,
)

__all__ = ["GateResult", "NetworkPathGateProber"]
