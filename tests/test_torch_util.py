"""The JAX package's ``tests/test_util.py`` against the port
(``StringSet``, ``KeyedMutex``, ``UpgradeKeys`` and events).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_util.py")))
