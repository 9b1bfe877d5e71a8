"""The JAX package's ``tests/test_fault_tolerance.py`` against the port
(injectable API faults, classified retry and circuit breaking, degraded
mode and the recovery prober).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  The helpers it imports from
``tests/test_policy_cr.py`` and ``tests/test_rollback_eviction.py`` are
those files loaded against the port the same way (their tests are not
collected here).
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module(
    "test_fault_tolerance.py",
    modules={
        "tests.test_policy_cr": port_module("test_policy_cr.py"),
        "tests.test_rollback_eviction": port_module("test_rollback_eviction.py"),
    },
)))
