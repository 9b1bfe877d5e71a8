"""Generation-aware roll ordering.

Mixed-generation fleets want the oldest generation upgraded FIRST: it is
the cheapest canary (least valuable capacity, most battle-tested driver
path) and the first to surface a bad driver before it reaches the
flagship pools.  Among generations of equal age rank, the watt-hungrier
one goes first — its downtime is the most expensive to leave pending.

Everything here is a pure function of node labels (accelerator string →
profile), so the ordering is deterministic across controller
incarnations and trivially term-fence-safe: a deposed leader and its
successor compute the same sort key from the same observed state, and
the key never encodes wall-clock or identity.

Two consumers:

- the unsharded engine sorts ``upgrade-required`` groups with
  :func:`group_sort_key` before admission, so budget slots drain
  oldest-generation-first;
- the sharded reconciler passes :func:`pool_sort_key` (closed over its
  router's pool→accelerator memory) as the dirty-queue sort key, so
  dirty pools of older generations are reconciled first when the queue
  is deeper than one tick's batch.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from k8s_operator_libs_tpu_torch.fleet.profiles import (
    generation_profile,
    group_accelerator,
)

# Unknown generations (CPU meshes, unmapped accelerators) sort AFTER
# every known one: an unknown canary proves nothing.
_UNKNOWN_ORDER = 1 << 16


def generation_order_key(device_kind: str) -> tuple[int, float, str]:
    """Deterministic sort key for one generation: (age rank, -watts,
    name).  Lower sorts first: oldest generation, then watt-hungriest."""
    profile = generation_profile(device_kind)
    if profile is None:
        return (_UNKNOWN_ORDER, 0.0, device_kind or "")
    return (profile.order, -profile.watts_per_chip, profile.name)


def group_sort_key(group) -> tuple:
    """Sort key for an UpgradeGroup: generation key, then group id for a
    total deterministic order within a generation."""
    return generation_order_key(group_accelerator(group)) + (group.id,)


def order_groups(groups: Iterable) -> list:
    """Groups ordered oldest-generation-first (stable, deterministic)."""
    return sorted(groups, key=group_sort_key)


def packed_group_sort_key(group, cost: int) -> tuple:
    """First-fit-decreasing admission key (planning.admissionMode:
    packed), shared by the analytic packer and the live admission pass.

    The generation key stays primary — oldest-generation-first is
    inviolable, so a younger generation is only ever *tried* after
    every older group was tried (and admitted or found unchargeable).
    Within a generation, larger groups go first so smaller ones fill
    the residual budget instead of stranding it; id breaks ties for a
    total deterministic order."""
    return generation_order_key(group_accelerator(group)) + (
        -cost, group.id,
    )


def pool_sort_key(
    accelerator_of: Callable[[str], Optional[str]],
) -> Callable[[str], tuple]:
    """Build the dirty-pool sort key for the sharded reconciler.

    ``accelerator_of`` maps a pool key to the accelerator string the
    router last observed for it (None when the pool has no recorded
    generation — such pools sort last, after every known generation)."""

    def key(pool_key: str) -> tuple:
        return generation_order_key(accelerator_of(pool_key) or "") + (
            pool_key,
        )

    return key
