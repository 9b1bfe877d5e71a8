"""GPU health backend of the PyTorch/CUDA port.

Counterpart of ``k8s_operator_libs_tpu.health``:

- :mod:`probes`: the probe battery (device enumeration, tensor-core
  matmul, HBM stream, the host's all-reduce and ring collectives, the
  ring-attention deep probe, and the cross-host all-reduce over the
  ``torch.distributed`` world);
- :mod:`fused`: the battery enqueued as one body per device with one
  readback, behind a topology-keyed warm-up cache, and the network-path
  artifact gate's checks;
- :mod:`report`: the per-host :class:`HealthReport` node annotation;
- :mod:`agent`: the node-side probe agent, which joins the cross-host
  world from torchrun-style env;
- :mod:`slice_prober`: controller-side probers for the upgrade engine's
  ``ValidationManager``.
"""

from k8s_operator_libs_tpu_torch.health.fused import run_network_path_checks
from k8s_operator_libs_tpu_torch.health.probes import (
    CheckResult,
    dcn_collective_probe,
    dcn_reachability_probe,
    device_inventory,
    hbm_bandwidth_probe,
    ici_allreduce_probe,
    ici_ring_attention_probe,
    ici_ring_probe,
    matmul_probe,
    run_host_probe,
)
from k8s_operator_libs_tpu_torch.health.report import (
    HEALTH_CHECKS_ALL,
    HealthReport,
)
from k8s_operator_libs_tpu_torch.health.slice_prober import (
    LocalDeviceProber,
    NodeReportProber,
)

__all__ = [
    "CheckResult",
    "HealthReport",
    "HEALTH_CHECKS_ALL",
    "LocalDeviceProber",
    "NodeReportProber",
    "device_inventory",
    "dcn_collective_probe",
    "dcn_reachability_probe",
    "hbm_bandwidth_probe",
    "ici_allreduce_probe",
    "ici_ring_attention_probe",
    "ici_ring_probe",
    "matmul_probe",
    "run_host_probe",
    "run_network_path_checks",
]
