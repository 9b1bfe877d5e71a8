"""The JAX package's ``tests/test_informer_semantics.py`` against the
port (watch/list semantics on the ``FakeCluster`` tier and the HTTP
tier).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_tests`` takes its ``tier`` and
``small_cache_tier`` fixtures, both parametrised over ``fake`` and
``rest``, so every case runs on both of the port's tiers.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_informer_semantics.py")))
