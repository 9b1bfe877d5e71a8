"""TPU slice topology model.

The structural analogue of long-context/sequence parallelism in the
reference's domain (SURVEY.md §5): which hosts form one ICI domain and must
therefore move through the upgrade state machine atomically.
"""

from k8s_operator_libs_tpu_torch.topology.slices import (  # noqa: F401
    ACCELERATOR_CHIPS_PER_HOST,
    SliceInfo,
    discover_slices,
    hosts_for_topology,
    parse_topology,
)
