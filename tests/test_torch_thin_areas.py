"""The JAX package's ``tests/test_thin_areas.py`` against the port (the
REST client's internals, the controller loop and its command line, the
metrics server's error path, the safe-load init container and the
agent's entry point).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_keys`` makes its ``UpgradeKeys`` the
port's ``driver_keys``, so the safe-load case clears the annotation the
port's init container waits on (``nvidia.com/…``, from ``DRIVER_NAME``,
unset here).  The agent's cases run on the port's CPU device
(``cpu_devices``) and inject their cluster through the port's
``k8s.get_default_client``, which the agent's ``main`` calls.
"""

from tests.test_torch_control_plane import (  # noqa: F401
    _P,
    port_cpu_devices,
    port_keys,
    port_module,
    port_tests,
)

globals().update(port_tests(port_module("test_thin_areas.py", substitutions=(
    port_keys(f"from {_P}.upgrade import UpgradeKeys\n"),
))))
