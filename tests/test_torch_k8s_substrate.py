"""The JAX package's ``tests/test_k8s_substrate.py`` against the port
(selectors, ``FakeCluster`` semantics and drain).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_k8s_substrate.py")))
