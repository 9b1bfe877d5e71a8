"""The NVIDIA driver's upgrade keys and the operator's names, in one place.

The engine's label and annotation keys come from an ``UpgradeKeys``
(driver name and domain).  The port manages the NVIDIA GPU driver, so its
keys are the GPU operator's: ``nvidia.com/gpu-driver-upgrade-state`` and
the rest.  The controller, the status CLI, the node agent, the safe-load
init container and the bench all take their keys from here, the node-side
ones through ``DRIVER_NAME`` in their pod's env, so a controller and the
agents it deploys always read and write the same annotations.
"""

from __future__ import annotations

import os
from typing import Mapping

from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

DEFAULT_DRIVER_NAME = "gpu"
KEY_DOMAIN = "nvidia.com"
# The env var naming the driver in the driver's and the agent's pods.
DRIVER_NAME_ENV = "DRIVER_NAME"
# The GPU operator's driver DaemonSet and the label its pods carry (the
# controller's and the status CLI's default selector).
DRIVER_DAEMONSET_NAME = "nvidia-driver-daemonset"
DRIVER_LABELS = {"app": DRIVER_DAEMONSET_NAME}
# The controller's Deployment, ServiceAccount, RBAC and election Lease.
CONTROLLER_NAME = "gpu-upgrade-controller"
# The ServiceAccount of the driver's and the agent's pods: both only get
# and patch their own Node.
NODE_REPORTER_NAME = "gpu-node-reporter"
# The operator's own image (this package): the controller, the agent and
# the safe-load init container run it; the driver container runs NVIDIA's
# driver image.
OPERATOR_IMAGE = "tpu-operator-libs-torch:latest"


def driver_keys(driver_name: str = DEFAULT_DRIVER_NAME) -> UpgradeKeys:
    """The upgrade keys of ``driver_name`` on the NVIDIA domain."""
    return UpgradeKeys(driver_name=driver_name, domain=KEY_DOMAIN)


def keys_from_env(env: Mapping[str, str] = os.environ) -> UpgradeKeys:
    """The keys of the driver ``DRIVER_NAME`` in ``env`` names (the
    default when unset), as a pod of the driver's or the agent's
    DaemonSet reads them."""
    return driver_keys(env.get(DRIVER_NAME_ENV, DEFAULT_DRIVER_NAME))
