"""The JAX package's ``tests/test_api_spec.py`` against the port (the
policy spec's defaults, validation, JSON round trip and deep copy).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_api_spec.py")))
