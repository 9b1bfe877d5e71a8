"""The JAX package's ``tests/test_write_plane.py`` against the port's
engine (the write plane: coalesced node patches, no-op suppression, conflict replay and event aggregation).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; every test of it runs here unchanged.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_write_plane.py")))
