"""Workloads of the PyTorch/CUDA port.

Counterpart of ``k8s_operator_libs_tpu.workloads``: the canary
transformer train step on one device (:mod:`.canary`) and ring attention
over a ring of devices (:mod:`.ring_attention`), whose block step is the
hand-written kernel K3.  The function ``ring_attention`` is not
re-exported here: the name would hide the submodule of the same name.
"""

from k8s_operator_libs_tpu_torch.workloads.canary import (
    CanaryConfig,
    CanaryRunner,
    init_params,
    make_train_step,
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
    "ElasticRingSoak",
    "full_attention_reference",
    "init_params",
    "make_ring_attention",
    "make_train_step",
    "ring_attention_soak",
]
