"""Layer spans and counters: where the time goes inside a call.

``obs/trace.py``'s :class:`~.obs.trace.TraceRecorder` records a roll's
phases (cordon, drain, validation) as a causal tree; this module records
the calls below them on the hot path: the agent's battery and its parts,
the deep probe, the prober, the engine's passes and processors, the
drain workers, each API call of ``FakeCluster`` and the canary's step.
It is a leaf module (the standard library only), so that ``k8s/client.py``
and the engine can import it without importing the observability
package, which imports the engine.

Off unless a caller turns it on::

    record_layers(True)
    ...                             # the work to look at
    spans, counters = take_layers()

- **Off** (the default), a span site does one module-global check and
  returns a shared no-op context manager; :func:`count` returns at once.
  No clock is read and nothing is allocated.
- **On**, a span is a tuple ``(name, start_ns, end_ns, parent_index,
  request_id, thread_id)`` in one buffer: ``time.perf_counter_ns()``
  readings (on Linux ``time.monotonic``'s clock too, so layer spans line
  up with ``TraceRecorder``'s phases); ``parent_index`` the index of the
  span open around it on its thread, or -1; ``end_ns`` None while the
  span is open.  A span with no parent on its thread, or one opened with
  ``root=True``, opens a new ``request_id``; the others inherit their
  parent's, or take the one named by ``request=``.
- The buffer holds at most :data:`LAYER_BUFFER` spans; past it spans are
  dropped and counted as ``layers.dropped``.  Recording fails open: an
  error in it costs the span (counted as ``layers.errors``), never the
  call it wraps.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Optional

LAYER_BUFFER = 1 << 20

_on = False
_lock = threading.Lock()
_spans: list = []
_counters: dict = {}
# Bumped by take_layers: a span opened before it closes into nothing.
_generation = 0
_requests = itertools.count()
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _bump(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``; the caller holds ``_lock``."""
    _counters[name] = _counters.get(name, 0) + n


class _Span:
    __slots__ = ("name", "root", "request", "generation", "index")

    def __init__(self, name: str, root: bool,
                 request: Optional[int]) -> None:
        self.name = name
        self.root = root
        self.request = request
        self.generation = -1
        self.index = -1

    def __enter__(self) -> Optional[int]:
        try:
            stack = _stack()
            parent = stack[-1] if stack else None
            if self.request is None:
                if parent is None or self.root:
                    self.request = next(_requests)
                else:
                    self.request = parent.request
            start = time.perf_counter_ns()
            with _lock:
                self.generation = _generation
                if len(_spans) >= LAYER_BUFFER:
                    _bump("layers.dropped", 1)
                else:
                    up = (parent.index if parent is not None
                          and parent.generation == _generation else -1)
                    self.index = len(_spans)
                    _spans.append((self.name, start, None, up, self.request,
                                   threading.get_ident()))
            stack.append(self)
        except Exception:  # noqa: BLE001 — fail-open by contract
            _error()
        return self.request

    def __exit__(self, *exc) -> bool:
        try:
            end = time.perf_counter_ns()
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            with _lock:
                if self.index >= 0 and self.generation == _generation:
                    rec = _spans[self.index]
                    _spans[self.index] = rec[:2] + (end,) + rec[3:]
        except Exception:  # noqa: BLE001 — fail-open by contract
            _error()
        return False


def _error() -> None:
    try:
        with _lock:
            _bump("layers.errors", 1)
    except Exception:  # noqa: BLE001 — fail-open by contract
        pass


def layer_span(name: str, detail: Optional[str] = None, root: bool = False,
               request: Optional[int] = None):
    """A context manager recording ``name`` (``name.detail`` with a
    ``detail``) around its block when recording is on; it gives the
    span's request id (None when off).  ``root`` opens a new request id
    even under a parent; ``request`` takes the one given."""
    if not _on:
        return _NO_SPAN
    if detail is not None:
        name = f"{name}.{detail}"
    return _Span(name, root, request)


def spanned(name: str, opens: Optional[str] = None,
            joins: Optional[str] = None):
    """A decorator recording ``name`` around each call of a function or
    method when recording is on.  ``opens`` names an attribute of the
    method's object in which each call keeps the new request id it opens
    (as a root); ``joins`` one whose request id each call takes (a
    request of several calls, as an engine pass is)."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(obj, *args, **kwargs):
            if not _on:
                return fn(obj, *args, **kwargs)
            request = getattr(obj, joins, None) if joins else None
            with _Span(name, opens is not None, request) as request:
                if opens:
                    setattr(obj, opens, request)
                return fn(obj, *args, **kwargs)

        return wrapper

    return decorate


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` when recording is on."""
    if not _on:
        return
    with _lock:
        _bump(name, n)


def record_layers(on: bool) -> None:
    """Turn recording on or off; what was recorded stays until
    :func:`take_layers`."""
    global _on
    _on = bool(on)


def take_layers() -> tuple[list, dict]:
    """``(spans, counters)`` recorded since the last call, and an empty
    buffer.  A span still open keeps ``end_ns`` None and closes into
    nothing."""
    global _spans, _counters, _generation
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
        _generation += 1
    return spans, counters
