"""Driver-side components: the NVIDIA driver DaemonSet and its node-side
agents.

Counterpart of ``k8s_operator_libs_tpu.driver`` for GPU nodes:

- :mod:`daemonset` — spec builder + reconciler for the NVIDIA driver
  DaemonSet (OnDelete update strategy so the upgrade state machine, not
  the DS controller, rolls the pods) and the health-agent DaemonSet;
- :mod:`safe_load_init` — the init-container entrypoint that blocks the
  driver's load until the controller confirms the node is quiesced.
"""

from k8s_operator_libs_tpu_torch.driver.daemonset import (
    AgentDaemonSetSpec,
    DriverDaemonSetSpec,
    DriverSetReconciler,
    build_daemon_set,
)
from k8s_operator_libs_tpu_torch.driver.safe_load_init import (
    announce_and_wait,
)

__all__ = [
    "AgentDaemonSetSpec",
    "DriverDaemonSetSpec",
    "DriverSetReconciler",
    "announce_and_wait",
    "build_daemon_set",
]
