"""The JAX package's ``tests/test_apiserver_tier.py`` against the port
(the engine over the HTTP tier, ``KubeApiServer``).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_tests`` takes its ``tier`` fixture
(``fake`` and ``rest``).  The ``FakeProber`` it imports from
``tests/test_upgrade_state.py`` is that file loaded against the port the
same way (its tests are not collected here).
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module(
    "test_apiserver_tier.py",
    modules={
        "tests.test_upgrade_state": port_module("test_upgrade_state.py"),
    },
)))
