"""The JAX package's ``tests/test_outage_guard.py`` against the port's
test session (conftest pins this process and its children to the CPU).

``port_module`` runs the file's source as a module of its own.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_outage_guard.py")))
