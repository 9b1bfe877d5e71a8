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
(:mod:`.kernels`).  It carries its own copy of the JAX package's
jax-free upgrade engine (:mod:`.upgrade`, :mod:`.k8s` with
``FakeCluster``, :mod:`.api`, :mod:`.planning`, :mod:`.obs` and the
rest), held to the reference's code by a test, and its own entry points:
:mod:`.hostenv` (a CUDA preflight in a killable child), :mod:`.entry`
(the canary's loss and a multi-member dry run) and :mod:`.bench` (a
driver roll across an HGX H100 pool with the canary's downtime as its
headline).
"""

# The health battery's names, imported on first use: importing the
# package, or its engine and guard alone, loads no torch (the CUDA
# build's libraries are resident gigabytes in a controller's process).
__all__ = [
    "CheckResult",
    "HEALTH_CHECKS_ALL",
    "HealthReport",
    "LocalDeviceProber",
    "NodeReportProber",
    "run_host_probe",
]


def __getattr__(name: str):
    if name in __all__:
        from k8s_operator_libs_tpu_torch import health

        return getattr(health, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
