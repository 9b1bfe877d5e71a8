"""The JAX package's ``tests/test_example.py`` against the port's copy
of the consumer example, ``k8s_operator_libs_tpu_torch/examples/
consumer_operator.py`` (in ``COPIED``).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures, and its imports of ``examples.consumer_operator``
take the port's copy: the example then drives the port's manager, the
one the leader-election case counts.
"""

from k8s_operator_libs_tpu_torch.examples import consumer_operator
from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module(
    "test_example.py",
    modules={"examples.consumer_operator": consumer_operator},
)))
