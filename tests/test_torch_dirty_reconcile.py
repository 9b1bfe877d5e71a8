"""The JAX package's ``tests/test_dirty_reconcile.py`` against the port
(the dirty-set queue, the delta router, the budget ledger, the sharded
reconciler and the controller's sharded loop).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_keys`` makes its ``KEYS`` the port
controller's (``keys.driver_keys()``).
"""

from tests.test_torch_control_plane import port_keys, port_module, port_tests

globals().update(port_tests(port_module(
    "test_dirty_reconcile.py",
    substitutions=(port_keys("    pool_key_for_node,\n)\n"),),
)))
