"""The JAX package's ``tests/test_rollback_eviction.py`` against the
port (a failed rollback eviction, made visible and healed).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_rollback_eviction.py")))
