"""The JAX package's ``tests/test_chaos.py`` against the port (the
engine and the HA controllers under API faults, leader failover,
crashes and preemption).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_keys`` makes its ``UpgradeKeys`` the
port controller's (``keys.driver_keys``).  The helpers it imports from
``tests/test_upgrade_state.py`` and ``tests/test_state_diagram.py`` are
those files loaded against the port the same way (their tests are not
collected here).

The mixed-generation preemption roll runs on the port's generations: the
port's profile table holds the three H100 parts, oldest first, and no TPU
generation, so its three pools' slices carry an H100 part each
(``H100_FOR_TPU``, in the TPU generations' order) and the preemption is
counted under the preempted part's generation.
"""

from tests.test_torch_control_plane import port_keys, port_module, port_tests

_P = "k8s_operator_libs_tpu_torch"
# Each TPU accelerator of the mixed-generation roll and the H100 part of
# the same rank among the port's generations (v4 < v5e < v6e as PCIe <
# SXM < NVL), as GPU Feature Discovery names them.
H100_FOR_TPU = {
    "tpu-v4-podslice": "NVIDIA-H100-PCIe",
    "tpu-v5-lite-podslice": "NVIDIA-H100-80GB-HBM3",
    "tpu-v6e-slice": "NVIDIA-H100-NVL",
}
# The generation the preempted v5e slice's part counts under.
PREEMPTED = "h100-sxm"

globals().update(port_tests(port_module(
    "test_chaos.py",
    modules={
        "tests.test_upgrade_state": port_module("test_upgrade_state.py"),
        "tests.test_state_diagram": port_module("test_state_diagram.py"),
    },
    substitutions=(
        port_keys(
            f"from {_P}.upgrade.upgrade_state import BuildStateError\n"),
        *((f'"{tpu}"{end}', f'"{gpu}"{end}')
          for tpu, gpu in H100_FOR_TPU.items() for end in (", [", "}")),
        *((f'mgr.preemptions{op}"v5e"', f'mgr.preemptions{op}"{PREEMPTED}"')
          for op in (".get(", " == {")),
    ),
)))
