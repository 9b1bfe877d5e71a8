"""The JAX package's ``tests/test_pod_manager.py`` against the port (the
pod manager's edge paths).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_pod_manager.py")))
