"""Hand-written CUDA kernels of the port, their plain versions and build.

- :mod:`.battery`: K1 ``stream_increment_``, its verifying pass
  ``stream_increment_verify_`` and K2 ``verify_stats``
  (``csrc/battery_kernels.cu``);
- :mod:`.attention`: K3 ``block_attention`` and the fused ring step
  ``block_attention_merge_`` (``csrc/attention_kernels.cu``);
- :mod:`.collectives`: K4 ``peer_reduce`` and K5 ``peer_gather``
  (``csrc/collective_kernels.cu``) and the host's collectives built on
  them, ``all_reduce`` (and its persistent form ``all_reduce_init``),
  ``all_gather`` and ``ring_shift``.

``launch_counts()`` reads every kernel's launch count and
``reset_launch_counts()`` zeroes them (the fused ring step's launches
count as K3's, and on ``block_attention_merge_.launches`` as well; the
verifying pass's count as K1's, and on its own count as well).
"""

from k8s_operator_libs_tpu_torch.kernels.attention import (
    block_attention,
    block_attention_merge_,
    block_attention_merge_plain,
    block_attention_plain,
    merge_plain,
)
from k8s_operator_libs_tpu_torch.kernels.battery import (
    stream_increment_,
    stream_increment_plain_,
    stream_increment_verify_,
    stream_increment_verify_plain_,
    verify_stats,
    verify_stats_plain,
)
from k8s_operator_libs_tpu_torch.kernels.build import load_library
from k8s_operator_libs_tpu_torch.kernels.collectives import (
    all_gather,
    all_reduce,
    all_reduce_init,
    peer_gather,
    peer_gather_plain,
    peer_reduce,
    peer_reduce_plain,
    ring_shift,
)

KERNELS = (stream_increment_, stream_increment_verify_, verify_stats,
           block_attention, peer_reduce, peer_gather)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in (*KERNELS, block_attention_merge_):
        k.launches = 0


__all__ = [
    "KERNELS",
    "all_gather",
    "all_reduce",
    "all_reduce_init",
    "block_attention",
    "block_attention_merge_",
    "block_attention_merge_plain",
    "block_attention_plain",
    "launch_counts",
    "load_library",
    "merge_plain",
    "peer_gather",
    "peer_gather_plain",
    "peer_reduce",
    "peer_reduce_plain",
    "reset_launch_counts",
    "ring_shift",
    "stream_increment_",
    "stream_increment_plain_",
    "stream_increment_verify_",
    "stream_increment_verify_plain_",
    "verify_stats",
    "verify_stats_plain",
]
