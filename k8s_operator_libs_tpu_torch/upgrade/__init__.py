"""The upgrade-engine types the health slice of the port reads and writes."""

from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys
from k8s_operator_libs_tpu_torch.upgrade.validation_manager import ProbeResult

__all__ = ["ProbeResult", "UpgradeKeys"]
