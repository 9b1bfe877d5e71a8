"""The JAX package's ``tests/test_drain_pdb.py`` against the port (a
PDB-blocked drain retries until its timeout, then fails attributably).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures; ``port_tests`` takes its ``cluster`` fixture.
"""

from tests.test_torch_control_plane import port_module, port_tests

globals().update(port_tests(port_module("test_drain_pdb.py")))
