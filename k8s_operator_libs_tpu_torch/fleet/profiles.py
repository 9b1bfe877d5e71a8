"""Per-generation hardware profiles: the registry above ``hw.ChipSpec``.

Counterpart of ``k8s_operator_libs_tpu.fleet.profiles`` for H100 GPUs.
A :class:`GenerationProfile` answers the fleet-level questions the
operator asks about a generation: how many GPUs share a host, what the
NVLink fabric should sustain, where the health-probe floors sit, and the
board power used as a relative scheduling weight.

Resolution accepts anything ``hw.chip_spec`` accepts; unknown kinds
resolve to None and callers skip generation-relative behavior.

:func:`node_accelerator` and :func:`group_accelerator` are the one place
that reads a node's or an upgrade group's accelerator string: the
engine's ordering, preemption counts, planner, telemetry and metrics and
the validation gate all resolve it here, so they cannot disagree.  The
engine builds ``slice_info`` only from TPU labels, so a GPU node (which
GPU Feature Discovery labels with its product) reaches them as a group
without a slice.

:func:`node_dcn_group` and :func:`group_dcn_group` are, in the same way,
the one place that reads a node's or a group's DCN ring (the data-
parallel job whose members must never be down together): the slice's
``dcn_group`` when the group has a slice, else its first node's
``keys.dcn_group_label``, then the JobSet fallback.  The engine's
anti-affinity, the sharded budget ledger, the planner, the status rows
and the gate's ``require_dcn_check`` resolve it here, so a GPU node's
ring counts wherever a TPU slice's does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

from k8s_operator_libs_tpu_torch.hw import ChipSpec, chip_spec
from k8s_operator_libs_tpu_torch.topology.slices import (
    GKE_TPU_ACCELERATOR_LABEL,
    _jobset_dcn_group,
)

# Node labels naming a GPU host's accelerator, GPU Feature Discovery's
# first, then GKE's.
GPU_PRODUCT_LABELS = (
    "nvidia.com/gpu.product",
    "cloud.google.com/gke-accelerator",
)

# Node labels naming a GPU host's device count, in the same order.
GPU_COUNT_LABELS = (
    "nvidia.com/gpu.count",
    "cloud.google.com/gke-accelerator-count",
)

# Default floor fractions of the published peak (same values as the TPU
# profiles): sustained readings below half of spec on hardware that
# enumerates fine are the silent-degradation mode the probes exist to
# catch; interconnect floors are more conservative because collective
# bus bandwidth degrades with topology and congestion first.
HBM_FLOOR_FRACTION = 0.5
MXU_FLOOR_FRACTION = 0.5
ICI_FLOOR_FRACTION = 0.25


@dataclass(frozen=True)
class GenerationProfile:
    """One GPU generation's fleet-level operating envelope."""

    name: str
    chip: ChipSpec
    # GPUs of the standard host shape (an HGX board).
    chips_per_host: int
    # Per-GPU bandwidth of the host-wide collective's fabric, GB/s one way
    # (NVLink 4 on an HGX board, PCIe Gen5 between PCIe cards).
    ici_gbps: float
    # Approximate board power per GPU, watts (efficiency weight).
    watts_per_chip: float
    # Generation age rank for canary ordering (lower = older).
    order: int
    preemptible: bool = False
    # Per-generation probe thresholds.  0.0 = derive from the chip spec
    # with the default fractions at resolve time.
    mxu_tflops_floor: float = 0.0
    hbm_gbps_floor: float = 0.0
    ici_busbw_floor_gbps: float = 0.0
    allreduce_latency_ceiling_ms: float = field(default=2000.0)

    def hbm_floor(self, fraction: float = 0.0) -> float:
        """Effective HBM bandwidth floor, GB/s.  An explicit ``fraction``
        wins; else the profile's pinned floor; else the default fraction
        of chip spec."""
        if fraction:
            return fraction * self.chip.hbm_gbps
        if self.hbm_gbps_floor:
            return self.hbm_gbps_floor
        return HBM_FLOOR_FRACTION * self.chip.hbm_gbps

    def mxu_floor(self) -> float:
        """Tensor-core matmul throughput floor, TFLOPs."""
        if self.mxu_tflops_floor:
            return self.mxu_tflops_floor
        return MXU_FLOOR_FRACTION * self.chip.bf16_tflops

    def ici_floor(self) -> float:
        """All-reduce bus-bandwidth floor, GB/s."""
        if self.ici_busbw_floor_gbps:
            return self.ici_busbw_floor_gbps
        return ICI_FLOOR_FRACTION * self.ici_gbps


# One profile per H100 row of hw.py: 8 GPUs per host, 700 W board power
# (relative weight only).  The host-wide collective's bandwidth per GPU,
# one way, from NVIDIA's H100 data sheet: the SXM part on an HGX board
# reaches every other GPU over NVLink 4 at 900 GB/s both ways (450 one
# way); the PCIe and NVL cards reach the host's other GPUs over PCIe Gen5
# x16 at 128 GB/s both ways (64 one way), their NVLink bridges joining
# pairs only.
_H100_HOST_GBPS = (("h100 pcie", 64.0), ("h100 sxm", 450.0), ("h100 nvl", 64.0))
_BUILTIN_PROFILES: tuple[GenerationProfile, ...] = tuple(
    GenerationProfile(
        name=chip_spec(kind).name, chip=chip_spec(kind), chips_per_host=8,
        ici_gbps=gbps, watts_per_chip=700.0, order=order,
    )
    for order, (kind, gbps) in enumerate(_H100_HOST_GBPS, start=1)
)

_LOCK = threading.Lock()
_PROFILES: dict[str, GenerationProfile] = {
    p.name: p for p in _BUILTIN_PROFILES
}


def register_generation(profile: GenerationProfile) -> None:
    """Add (or replace) a generation profile.  The profile's
    ``chip.name`` should match ``profile.name`` so ``chip_spec``
    resolution finds it."""
    with _LOCK:
        _PROFILES[profile.name] = profile


def known_generations() -> list[GenerationProfile]:
    """All registered profiles, oldest generation first."""
    with _LOCK:
        return sorted(_PROFILES.values(), key=lambda p: (p.order, p.name))


def generation_profile(device_kind: str) -> Optional[GenerationProfile]:
    """Profile for a device name or GKE accelerator label, or None when
    the generation is unknown (CPU test devices)."""
    spec = chip_spec(device_kind)
    if spec is None:
        return None
    with _LOCK:
        return _PROFILES.get(spec.name)


def generation_of(device_kind: str) -> str:
    """Canonical generation name ("h100-sxm"), or "" when unknown."""
    profile = generation_profile(device_kind)
    return profile.name if profile is not None else ""


def _node_label(node, names: Sequence[str]) -> str:
    """The first of ``names`` set on the node, or ""."""
    labels = getattr(node, "labels", None) or {}
    return next((labels[n] for n in names if labels.get(n)), "")


def node_accelerator(node) -> str:
    """The accelerator a node's labels name: GKE's TPU accelerator label,
    else the GPU product (:data:`GPU_PRODUCT_LABELS`, in order), or ""."""
    return _node_label(node, (GKE_TPU_ACCELERATOR_LABEL,) + GPU_PRODUCT_LABELS)


def group_accelerator(group) -> str:
    """An upgrade group's accelerator: its slice's, else its first
    node's (:func:`node_accelerator`), or ""."""
    if group.slice_info is not None:
        return group.slice_info.accelerator or ""
    nodes = getattr(group, "nodes", None) or []
    return node_accelerator(nodes[0]) if nodes else ""


def node_dcn_group(node, keys) -> Optional[str]:
    """The DCN ring a node's labels name: ``keys.dcn_group_label``, else
    its JobSet (namespace/name when the namespace label is set), or
    None."""
    labels = getattr(node, "labels", None) or {}
    return labels.get(keys.dcn_group_label) or _jobset_dcn_group(labels)


def group_dcn_group(group, keys) -> Optional[str]:
    """An upgrade group's DCN ring: its slice's, else its first node's
    (:func:`node_dcn_group`), or None."""
    if group.slice_info is not None:
        return group.slice_info.dcn_group
    nodes = getattr(group, "nodes", None) or []
    return node_dcn_group(nodes[0], keys) if nodes else None
