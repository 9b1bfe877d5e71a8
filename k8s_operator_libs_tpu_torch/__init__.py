"""PyTorch/CUDA port of tpu-operator-libs, for NVIDIA H100 GPUs.

It grows slice by slice beside the JAX package ``k8s_operator_libs_tpu``,
which stays the reference it is tested against.  It imports ``torch``,
numpy and the standard library, never ``jax`` and nothing of the JAX
package.  Ported so far: the node health battery and the report and
prober layer around it (:mod:`.health`), the cross-host all-reduce over
``torch.distributed`` included, with hand-written CUDA kernels for the
HBM stream, the verification reductions and the host's collectives (a
peer reduction and gather across the GPUs of one host); the network-path
artifact gate (:mod:`.artifacts`); and the workloads (:mod:`.workloads`):
the canary train step, on one device or sharded over the host's GPUs,
and ring attention, whose block step is a hand-written CUDA kernel
(:mod:`.kernels`).
"""

from k8s_operator_libs_tpu_torch.health import (
    HEALTH_CHECKS_ALL,
    CheckResult,
    HealthReport,
    LocalDeviceProber,
    NodeReportProber,
    run_host_probe,
)

__all__ = [
    "CheckResult",
    "HEALTH_CHECKS_ALL",
    "HealthReport",
    "LocalDeviceProber",
    "NodeReportProber",
    "run_host_probe",
]
