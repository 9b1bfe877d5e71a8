"""Per-generation hardware profiles: the registry above ``hw.ChipSpec``.

Counterpart of ``k8s_operator_libs_tpu.fleet.profiles`` for H100 GPUs.
A :class:`GenerationProfile` answers the fleet-level questions the
operator asks about a generation: how many GPUs share a host, what the
NVLink fabric should sustain, where the health-probe floors sit, and the
board power used as a relative scheduling weight.

Resolution accepts anything ``hw.chip_spec`` accepts; unknown kinds
resolve to None and callers skip generation-relative behavior.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.hw import ChipSpec, chip_spec

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
