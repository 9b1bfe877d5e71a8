"""The JAX package's ``tests/test_client_interface.py`` against the port
(both client tiers held to the ``KubeClient`` Protocol).

``port_module`` runs the file's source with the package prefix
rewritten.  One case departs (``DEPARTURES``): it fails on the reference
too, in ``k8s/informer.py``, which the port copies.  On Python 3.12,
``isinstance`` against the runtime-checkable ``KubeClient`` looks its
members up statically, and ``CachedKubeClient`` forwards 14 of them
through ``__getattr__``.  The port keeps parity with the reference's
informer, so the mirror pins that both packages give the same answer,
for the same members, and that the rest of the case holds.
"""

from __future__ import annotations

import inspect

from k8s_operator_libs_tpu import k8s as jk8s
from k8s_operator_libs_tpu_torch import k8s as tk8s
from tests.test_torch_control_plane import (
    departed,
    port_module,
    port_tests,
    unmirrored,
)

# Reference cases that cannot hold on the port, each with its reason and
# the port case that mirrors it.
DEPARTURES = {
    "test_cached_client_satisfies_runtime_protocol": (
        "fails on the reference as well: on Python 3.12 isinstance against "
        "the runtime-checkable KubeClient looks members up statically, and "
        "the copied CachedKubeClient (k8s/informer.py) forwards 14 of them "
        "through __getattr__",
        "test_cached_client_protocol_answer_is_the_reference_s",
    ),
}

_interface = port_module("test_client_interface.py")
globals().update(departed(port_tests(_interface), DEPARTURES))


def test_every_departure_has_its_mirror():
    assert unmirrored(DEPARTURES, globals()) == []


def _forwarded(k8s) -> list:
    """The Protocol's members that ``CachedKubeClient`` has only through
    ``__getattr__``: absent from its class, found on an instance."""
    wrapped = k8s.CachedKubeClient(k8s.FakeCluster())
    members = [m for m in vars(k8s.KubeClient)
               if callable(getattr(k8s.KubeClient, m)) and not m.startswith("_")]
    return sorted(m for m in members if not hasattr(k8s.CachedKubeClient, m)
                  and hasattr(wrapped, m))


def test_cached_client_protocol_answer_is_the_reference_s():
    """``isinstance(CachedKubeClient(...), KubeClient)`` is the same in
    both packages, over the same forwarded members; every Protocol
    member is reachable on the port's wrapper, and its ``get_node``
    keeps the Protocol's signature."""
    port = tk8s.CachedKubeClient(tk8s.FakeCluster())
    ref = jk8s.CachedKubeClient(jk8s.FakeCluster())
    assert isinstance(port, tk8s.KubeClient) == isinstance(
        ref, jk8s.KubeClient)
    assert _forwarded(tk8s) == _forwarded(jk8s)
    assert len(_forwarded(tk8s)) == 14
    assert [m for m in _interface.PROTOCOL_METHODS
            if not hasattr(port, m)] == []
    want = inspect.signature(tk8s.KubeClient.get_node)
    got = inspect.signature(tk8s.CachedKubeClient.get_node)
    assert [(p.name, p.kind, p.default) for p in want.parameters.values()
            ] == [(p.name, p.kind, p.default) for p in got.parameters.values()]
