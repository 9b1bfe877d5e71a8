"""The JAX package's ``tests/test_tracing.py`` against the port's engine
(roll tracing: span trees, durable anchors, critical-path attribution,
the flight recorder).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  Its crash gauntlet imports the controller
crasher of ``tests/test_chaos.py``: that file is loaded against the port
the same way, so the crashed and rebuilt engines are the port's.
"""

from tests.test_torch_control_plane import port_module, port_tests

_chaos = port_module("test_chaos.py")
globals().update(port_tests(port_module(
    "test_tracing.py", modules={"tests.test_chaos": _chaos})))
