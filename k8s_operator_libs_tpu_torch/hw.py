"""Published NVIDIA H100 specs, for MFU math and health-floor derivation.

Counterpart of ``k8s_operator_libs_tpu.hw`` with the card's table in
place of the TPU rows.  Numbers are NVIDIA's data-sheet peaks per GPU:
dense bf16 tensor-core TFLOPS (no sparsity), HBM bandwidth and capacity.

``device_kind`` strings come from ``torch.cuda.get_device_name()`` (e.g.
``"NVIDIA H100 80GB HBM3"`` for the SXM part), from GPU Feature
Discovery's ``nvidia.com/gpu.product`` node label (``"NVIDIA-H100-PCIe"``)
or from GKE's ``cloud.google.com/gke-accelerator`` label
(``"nvidia-h100-80gb"``).  Matching is substring-based and
case-insensitive, with ``-`` and ``_`` read as spaces, so the three
spellings of one part resolve alike; unknown kinds, and ``"cpu"``, yield
None so callers skip spec-relative checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float
    hbm_gbps: float
    hbm_gib: float


_H100_SXM = ChipSpec("h100-sxm", 989.0, 3350.0, 80.0)
_H100_PCIE = ChipSpec("h100-pcie", 756.0, 2000.0, 80.0)
_H100_NVL = ChipSpec("h100-nvl", 835.0, 3900.0, 94.0)

# Substring (of the normalised kind) -> spec.  Order matters: more
# specific first.
_CHIP_SPECS: list[tuple[str, ChipSpec]] = [
    ("h100 nvl", _H100_NVL),
    ("h100 pcie", _H100_PCIE),
    ("h100 80gb hbm3", _H100_SXM),
    ("h100 sxm", _H100_SXM),
    ("h100 mega 80gb", _H100_SXM),
    ("h100 80gb", _H100_SXM),
]


def chip_spec(device_kind: str) -> Optional[ChipSpec]:
    """Spec for a CUDA device name, GPU Feature Discovery product label or
    GKE accelerator label, or None if unknown."""
    kind = (device_kind or "").lower().replace("-", " ").replace("_", " ")
    for needle, spec in _CHIP_SPECS:
        if needle in kind:
            return spec
    return None


def mfu(achieved_tflops: float, device_kind: str) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1], or None off-spec hardware."""
    spec = chip_spec(device_kind)
    if spec is None or spec.bf16_tflops <= 0:
        return None
    return achieved_tflops / spec.bf16_tflops


def default_hbm_floor_gbps(
    device_kind: str, fraction: float = 0.5
) -> float:
    """A defensible min-HBM-bandwidth floor: ``fraction`` of the card's
    spec (0.0 when the card is unknown — floor disabled)."""
    spec = chip_spec(device_kind)
    if spec is None:
        return 0.0
    return fraction * spec.hbm_gbps
