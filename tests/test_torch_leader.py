"""The JAX package's ``tests/test_leader.py`` against the port (the
Lease election, and the leader-elected controller's failover).

``port_module`` runs the file's source with the package prefix
rewritten.  Every elector of the file holds ``LeaderElector``'s default
Lease (``tpu-upgrade-controller``; ``k8s/leader.py`` is a plain copy),
which in the reference is also the controller's.  The port's controller
defaults to ``gpu-upgrade-controller`` (``keys.CONTROLLER_NAME``), so the
file's HA controllers are configured with the electors' Lease.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_leader.py", substitutions=(
    (
        "            publish_events=False,\n",
        "            publish_events=False,\n"
        '            lease_name="tpu-upgrade-controller",\n',
    ),
))))
