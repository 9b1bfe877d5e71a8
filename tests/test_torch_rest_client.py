"""The JAX package's ``tests/test_rest_client.py`` against the port's
``RestClient`` (its wire behaviour against an in-process stub
apiserver).

``port_module`` runs the file's source with the package prefix
rewritten; ``port_tests`` takes its ``stub_client`` fixture with its
tests, so each case gets the stub as the reference's does.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_rest_client.py")))
