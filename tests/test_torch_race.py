"""The JAX package's ``tests/test_race.py`` against the port (the
concurrency stress tier).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures.  ``port_tests`` takes the file's autouse fixture,
which switches threads every 10 µs for each case, with its tests, so the
port's cases run under it as the reference's do.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_race.py")))
