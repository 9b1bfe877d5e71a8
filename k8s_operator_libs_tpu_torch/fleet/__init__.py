"""Heterogeneous fleet subsystem: per-generation hardware profiles,
generation-aware roll ordering, and maintenance-window math.

Real TPU fleets run several device generations concurrently (v2 through
Trillium), each with its own peak TFLOPs, HBM bandwidth, ICI fabric,
power envelope, and failure characteristics.  This package is the layer
above ``hw.ChipSpec`` that makes the rest of the operator aware of that:

- :mod:`.profiles` — the :class:`~.profiles.GenerationProfile` registry
  (chips-per-host, expected ICI bandwidth, per-generation probe floors,
  power weight, preemptible capability);
- :mod:`.scheduler` — deterministic oldest-generation-first,
  efficiency-weighted ordering for groups and dirty pools;
- :mod:`.windows` — cron-style UTC maintenance-window membership used by
  the per-pool ``maintenanceWindow`` policy field.
"""

from k8s_operator_libs_tpu_torch.fleet.profiles import (  # noqa: F401
    GenerationProfile,
    generation_of,
    generation_profile,
    known_generations,
    register_generation,
)
from k8s_operator_libs_tpu_torch.fleet.scheduler import (  # noqa: F401
    generation_order_key,
    group_sort_key,
    order_groups,
    pool_sort_key,
)
from k8s_operator_libs_tpu_torch.fleet.windows import (  # noqa: F401
    validate_window,
    window_open,
)
