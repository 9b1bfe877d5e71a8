"""The JAX package's ``tests/test_packed_admission.py`` against the port's
engine (plan-guided packed admission against greedy id order, in the planner and in the engine).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; every test of it runs here unchanged.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_packed_admission.py")))
