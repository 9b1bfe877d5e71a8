"""CRD-embeddable policy types (analogue of the reference's ``api/upgrade``)."""

from k8s_operator_libs_tpu_torch.api.v1alpha1 import (  # noqa: F401
    ArtifactDAGSpec,
    ArtifactEdgeSpec,
    ArtifactSpec,
    DrainSpec,
    DriverUpgradePolicySpec,
    ElasticCoordinationSpec,
    EvictionEscalationSpec,
    FederationCanarySpec,
    FederationClusterSpec,
    FederationSpec,
    IntOrString,
    PlanningSpec,
    PodDeletionSpec,
    SliceHealthGateSpec,
    SliceQuarantineSpec,
    SliceTopologySpec,
    TPUUpgradePolicySpec,
    WaitForCompletionSpec,
)
from k8s_operator_libs_tpu_torch.api.schema import (  # noqa: F401
    crd_manifest,
    spec_schema,
    validate_object,
)
