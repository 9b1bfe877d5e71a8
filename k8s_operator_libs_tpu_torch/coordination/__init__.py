"""Workload coordination: the elastic-roll negotiation subsystem.

The upgrade engine's side of the protocol lives in
``upgrade/upgrade_state.py`` (``process_negotiation_groups`` /
``process_rejoin_resize_groups``); this package is the WORKLOAD side —
the agent a training job runs so the operator can reshape its mesh
around a slice under maintenance instead of draining it (Tenplex-style
elasticity, PAPERS.md):

- :mod:`protocol` — annotation key semantics and pure parse helpers
  shared by both sides (the node annotations ARE the wire);
- :mod:`workload` — :class:`WorkloadCoordinator`, the job-side agent
  that registers on its slices, answers exclusion offers, drives the
  runtime's resize, and stamps completion;
- :mod:`elastic` — glue between slice identity and device indices, plus
  runtime adapters for the elastic workloads in ``workloads/``.
"""

from k8s_operator_libs_tpu_torch.coordination.protocol import (  # noqa: F401
    RESPONSE_ACCEPT,
    RESPONSE_DECLINE,
    NegotiationView,
    negotiation_view,
)
from k8s_operator_libs_tpu_torch.coordination.elastic import (  # noqa: F401
    RecordingRuntime,
    RunnerElasticRuntime,
    partition_devices,
)
from k8s_operator_libs_tpu_torch.coordination.workload import (  # noqa: F401
    WorkloadCoordinator,
)
