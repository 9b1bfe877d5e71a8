"""The JAX package's ``tests/test_events.py`` against the port (the
Events the controller publishes on each transition).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_keys`` makes its ``UpgradeKeys`` the
port's ``driver_keys``, the keys the port's controller writes, so its
roll reads the states the controller sets.
"""

from tests.test_torch_control_plane import _P, port_keys, port_module, port_tests

globals().update(port_tests(port_module("test_events.py", substitutions=(
    port_keys(f"from {_P}.upgrade import UpgradeKeys\n"),
))))
