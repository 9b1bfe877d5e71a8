"""The JAX package's ``tests/test_artifacts.py`` against the port's
engine (the multi-artifact stack: the artifact DAG, its skew rules, and one shared cordon and drain window a node).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; every test of it runs here unchanged.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_artifacts.py")))
