"""Workloads of the PyTorch/CUDA port.

Counterpart of ``k8s_operator_libs_tpu.workloads``: the canary
transformer train step on one device and sharded over a ``("dp", "tp")``
mesh of the host's devices, with its elastic runner (:mod:`.canary`),
and ring attention
over a ring of devices (:mod:`.ring_attention`), whose block step is the
hand-written kernel K3.  The function ``ring_attention`` is not
re-exported here: the name would hide the submodule of the same name.
"""

from k8s_operator_libs_tpu_torch.workloads.canary import (
    CanaryConfig,
    CanaryRunner,
    ElasticCanaryRunner,
    Mesh,
    init_params,
    make_mesh,
    make_sharded_train_step,
    make_train_step,
    param_specs,
)
from k8s_operator_libs_tpu_torch.workloads.ring_attention import (
    ElasticRingSoak,
    full_attention_reference,
    make_ring_attention,
    ring_attention_soak,
)

__all__ = [
    "CanaryConfig",
    "CanaryRunner",
    "ElasticCanaryRunner",
    "ElasticRingSoak",
    "Mesh",
    "full_attention_reference",
    "init_params",
    "make_mesh",
    "make_ring_attention",
    "make_sharded_train_step",
    "make_train_step",
    "param_specs",
    "ring_attention_soak",
]
