"""The JAX package's ``tests/test_policy_cr.py`` against the port (the
policy CRD's admission, wire and status semantics, and the controller
following a policy CR).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_keys`` makes its ``UpgradeKeys`` the
port controller's (``keys.driver_keys``).
"""

from tests.test_torch_control_plane import port_keys, port_module, port_tests

globals().update(port_tests(port_module("test_policy_cr.py", substitutions=(
    port_keys("from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys\n"),
))))
