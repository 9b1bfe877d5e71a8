"""Multi-artifact upgrade DAGs: composable driver stacks rolled under
one cordon/drain window.  See docs/multi-artifact-dags.md."""

from k8s_operator_libs_tpu_torch.artifacts.dag import (
    ArtifactDAG,
    ArtifactDAGError,
    GATE_MODES,
    GATE_NETWORK_PATH,
    GATE_NONE,
    SKEW_LOCKSTEP,
    SKEW_MODES,
    SKEW_PINNED_ORDER,
    artifact_dag_of,
    constraint_satisfied,
)
from k8s_operator_libs_tpu_torch.artifacts.gates import (
    GateResult,
    NetworkPathGateProber,
)

__all__ = [
    "ArtifactDAG",
    "ArtifactDAGError",
    "GATE_MODES",
    "GATE_NETWORK_PATH",
    "GATE_NONE",
    "GateResult",
    "NetworkPathGateProber",
    "SKEW_LOCKSTEP",
    "SKEW_MODES",
    "SKEW_PINNED_ORDER",
    "artifact_dag_of",
    "constraint_satisfied",
]
