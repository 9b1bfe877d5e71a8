"""Partition-tolerant federated control plane.

Presents N member clusters to ONE global driver roll while keeping
every failure local (Podracer's fan-out shape: many independent
per-cluster actors under a thin, restartable global brain):

* :mod:`registry` — cluster membership + per-cluster health state
  machine (Reachable → Degraded → Partitioned) driven by the existing
  per-endpoint circuit breaker and lease freshness, with fail-static
  freeze bookkeeping.
* :mod:`ledger` — :class:`GlobalBudgetLedger`, the global ∧ cluster
  level above the engine's per-cluster ``BudgetLedger`` (global ∧
  cluster ∧ pool check-and-charge).
* :mod:`plan` — :class:`FederatedPlan`: the analytic planner run per
  cluster, composed region-by-region (canary region first).
* :mod:`canary` — telemetry-gated regional canary soak
  (:class:`CanaryGate`): promotion requires the health baselines to
  stay clean for a configurable soak.
* :mod:`coordinator` — :class:`FederationCoordinator`: the restartable
  global brain.  Crash-durable via the same annotation-anchored
  adoption path as the engine (``upgrade/durable.py``).

See docs/federation.md for the topology, the failure matrix, the
canary lifecycle and the fail-static rules.
"""

from k8s_operator_libs_tpu_torch.federation.canary import (  # noqa: F401
    CanaryGate,
    CanaryVerdict,
)
from k8s_operator_libs_tpu_torch.federation.coordinator import (  # noqa: F401
    FederationCoordinator,
    FederationStateStore,
    ensure_federation_kind,
)
from k8s_operator_libs_tpu_torch.federation.ledger import (  # noqa: F401
    GlobalBudgetLedger,
)
from k8s_operator_libs_tpu_torch.federation.plan import (  # noqa: F401
    ClusterRollPlan,
    FederatedPlan,
    plan_federated,
)
from k8s_operator_libs_tpu_torch.federation.registry import (  # noqa: F401
    ClusterHealth,
    ClusterRegistry,
    MemberCluster,
)
