"""Kubernetes substrate: typed object model, client interface, drain helper.

Analogue of the reference's L0 layer (client-go / controller-runtime /
kubectl-drain, SURVEY.md §1).  The reference links real Kubernetes client
libraries; this package provides:

- a typed object model for the handful of kinds the engine touches
  (Node, Pod, DaemonSet, ControllerRevision),
- a :class:`~k8s_operator_libs_tpu_torch.k8s.client.FakeCluster` — an in-memory
  apiserver with real API semantics (patches, label/field selectors,
  eviction, revision hashes, configurable cache lag and call latency).
  This is simultaneously the envtest analogue for the test tier
  (BASELINE config 1) and the simulation substrate for bench.py,
- a drain helper with kubectl-drain's filter semantics
  (k8s.io/kubectl/pkg/drain as used by reference drain_manager.go:76-95),
- a REST client shim for real clusters (gated; see rest.py).
"""

from k8s_operator_libs_tpu_torch.k8s.objects import (  # noqa: F401
    ContainerStatus,
    ControllerRevision,
    DaemonSet,
    Node,
    NodeCondition,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
)
from k8s_operator_libs_tpu_torch.k8s.client import (  # noqa: F401
    ConflictError,
    EvictionBlockedError,
    ExpiredError,
    FakeCluster,
    InvalidError,
    NotFoundError,
    ServerError,
    ThrottledError,
    WatchEvent,
)
from k8s_operator_libs_tpu_torch.k8s.faults import (  # noqa: F401
    Fault,
    FaultRule,
    FaultSchedule,
)
from k8s_operator_libs_tpu_torch.k8s.informer import (  # noqa: F401
    CachedKubeClient,
    Informer,
    InformerSnapshot,
)
from k8s_operator_libs_tpu_torch.k8s.retry import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
    ResilientClient,
    RetryPolicy,
    is_transient,
)
from k8s_operator_libs_tpu_torch.k8s.drain import DrainHelper, DrainError  # noqa: F401
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient  # noqa: F401
from k8s_operator_libs_tpu_torch.k8s.rest import (  # noqa: F401
    KubeConfig,
    RestClient,
    get_default_client,
)
from k8s_operator_libs_tpu_torch.k8s.apiserver import KubeApiServer  # noqa: F401
from k8s_operator_libs_tpu_torch.k8s.leader import (  # noqa: F401
    LeaderElector,
    ensure_lease_kind,
)
