"""The JAX package's ``tests/test_stuck.py`` against the port
(stuck-state telemetry).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  The helpers it imports from
``tests/test_upgrade_state.py`` are that file loaded against the port
the same way (their tests are not collected here).
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module(
    "test_stuck.py",
    modules={
        "tests.test_upgrade_state": port_module("test_upgrade_state.py"),
    },
)))
