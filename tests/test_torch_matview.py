"""The JAX package's ``tests/test_matview.py`` against the port's
engine (the materialized fleet view behind the sharded reconcile).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; every test of it runs here unchanged.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_matview.py")))
