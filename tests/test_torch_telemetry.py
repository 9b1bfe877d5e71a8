"""The JAX package's ``tests/test_telemetry.py`` against the port
(the telemetry plane's verdicts, its metrics and the batteries' stat
keys).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  Its battery case takes the JAX package's
``cpu_devices`` fixture; here that fixture gives the port's members
instead, the CPU 8 times, so the port's fused and unfused batteries run
their plain versions.
"""

import pytest

from k8s_operator_libs_tpu_torch.entry import members_of
from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_telemetry.py")))


@pytest.fixture
def cpu_devices():
    return members_of(8, "cpu")
