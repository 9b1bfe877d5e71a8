"""The JAX package's ``tests/test_watch.py`` against the port (the
watch surface of ``FakeCluster`` and ``RestClient``, and the
controller's watch-driven loop over both tiers).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_keys`` makes its ``UpgradeKeys`` the
port controller's (``keys.driver_keys``), so the controller rolls the
keys the test reads.
"""

from tests.test_torch_control_plane import port_keys, port_module, port_tests

globals().update(port_tests(port_module("test_watch.py", substitutions=(
    port_keys("from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys\n"),
))))
