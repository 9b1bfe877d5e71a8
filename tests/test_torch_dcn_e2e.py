"""The JAX package's ``tests/test_dcn_e2e.py`` against the port
(multi-slice (DCN) coordination end to end).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_dcn_e2e.py")))
