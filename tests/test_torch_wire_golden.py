"""The JAX package's ``tests/test_wire_golden.py`` against the port's
HTTP tier (``RestClient`` and ``KubeApiServer`` held to the committed
``tests/golden_wire.json``).

``port_module`` runs the file's source with the package prefix
rewritten; its module keeps the reference's ``__file__``, so it reads
the same golden file, and ``port_tests`` takes its ``wire`` fixture.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_wire_golden.py")))
