"""The JAX package's ``tests/test_upgrade_state.py`` against the port
(the engine's state machine, node by node and slice by slice).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_upgrade_state.py")))
