"""Hand-written CUDA kernels of the port, their plain versions and build.

See :mod:`.battery` for the wrappers and ``csrc/battery_kernels.cu`` for
the kernels.
"""

from k8s_operator_libs_tpu_torch.kernels.battery import (
    KERNELS,
    launch_counts,
    reset_launch_counts,
    stream_increment_,
    stream_increment_plain_,
    verify_stats,
    verify_stats_plain,
)
from k8s_operator_libs_tpu_torch.kernels.build import load_library

__all__ = [
    "KERNELS",
    "launch_counts",
    "load_library",
    "reset_launch_counts",
    "stream_increment_",
    "stream_increment_plain_",
    "verify_stats",
    "verify_stats_plain",
]
