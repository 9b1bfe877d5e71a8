"""The JAX package's ``tests/test_fuzz_invariants.py`` against the port
(seeded scenario fuzzing of the engine's safety invariants).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  The helpers it imports from
``tests/test_state_diagram.py`` are that file loaded against the port
the same way (their tests are not collected here).
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module(
    "test_fuzz_invariants.py",
    modules={
        "tests.test_state_diagram": port_module("test_state_diagram.py"),
    },
)))
