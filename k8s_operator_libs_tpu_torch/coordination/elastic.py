"""Glue between slice identity and elastic runtimes.

The coordinator speaks in slice ids (strings from the node topology
labels); elastic runtimes speak in device groups or slice indices. This
module holds the small adapters between the two so neither side imports
the other's vocabulary.
"""

from typing import Callable, Dict, List, Optional, Sequence


def partition_devices(devices: Sequence, n_slices: int) -> List[List]:
    """Split a flat device list into ``n_slices`` contiguous groups.

    Mirrors how a multi-slice mesh lays devices out slice-major (ICI
    within a group, DCN across groups). The device count must divide
    evenly — an uneven split would silently skew dp-shard sizes.
    """
    if n_slices <= 0:
        raise ValueError(f"n_slices must be positive, got {n_slices}")
    if len(devices) % n_slices != 0:
        raise ValueError(
            f"{len(devices)} devices do not divide into {n_slices} slices"
        )
    per = len(devices) // n_slices
    return [list(devices[i * per : (i + 1) * per]) for i in range(n_slices)]


class RecordingRuntime:
    """Fake elastic runtime for engine tests — records calls, can fail.

    ``exclude``/``rejoin`` are idempotent like the real runtimes: the
    coordinator may replay either after a crash.
    """

    def __init__(self, fail_exclude: bool = False):
        self.fail_exclude = fail_exclude
        self.excluded: List[str] = []
        self.rejoined: List[str] = []
        self.calls: List[str] = []

    def exclude(self, slice_id: str) -> None:
        self.calls.append(f"exclude:{slice_id}")
        if self.fail_exclude:
            raise RuntimeError(f"resize failed for {slice_id}")
        if slice_id not in self.excluded:
            self.excluded.append(slice_id)

    def rejoin(self, slice_id: str) -> None:
        self.calls.append(f"rejoin:{slice_id}")
        if slice_id in self.excluded:
            self.excluded.remove(slice_id)
        if slice_id not in self.rejoined:
            self.rejoined.append(slice_id)


class RunnerElasticRuntime:
    """Adapt a slice-index runner (ElasticCanaryRunner) to slice ids.

    ``slice_index_of`` maps the operator's slice id to the runner's
    slice index (position in its device partition). Unknown ids raise:
    an offer for a slice the workload does not own means registration
    and topology disagree, which must surface, not be absorbed.
    """

    def __init__(
        self,
        runner,
        slice_index_of: Dict[str, int],
        on_resize: Optional[Callable[[str, str], None]] = None,
    ):
        self.runner = runner
        self.slice_index_of = dict(slice_index_of)
        self.on_resize = on_resize

    def _index(self, slice_id: str) -> int:
        if slice_id not in self.slice_index_of:
            raise KeyError(f"slice {slice_id!r} is not part of this workload")
        return self.slice_index_of[slice_id]

    def exclude(self, slice_id: str) -> None:
        self.runner.exclude_slice(self._index(slice_id))
        if self.on_resize is not None:
            self.on_resize(slice_id, "down")

    def rejoin(self, slice_id: str) -> None:
        self.runner.rejoin_slice(self._index(slice_id))
        if self.on_resize is not None:
            self.on_resize(slice_id, "up")
