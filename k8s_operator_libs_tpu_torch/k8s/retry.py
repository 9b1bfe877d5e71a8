"""Classified retry, capped-exponential backoff, and a per-endpoint
circuit breaker for control-plane calls.

The taxonomy (client-go's retry semantics, distilled):

* **Transient** — the server may answer differently in a moment: 429
  priority-and-fairness throttling (:class:`ThrottledError`), 5xx
  (:class:`ServerError`), connection-level failures (``OSError`` /
  ``http.client.HTTPException`` / ``TimeoutError``).  Retried with
  capped exponential backoff + jitter, honoring ``Retry-After``.
* **Fatal** — retrying cannot help and the caller owns the semantics:
  404 (:class:`NotFoundError`), 409 (:class:`ConflictError` — CAS loops
  re-read, they don't blind-retry), 410 (:class:`ExpiredError` — the
  watch contract is re-list), 422 (:class:`InvalidError`), and PDB 429
  (:class:`EvictionBlockedError` — DrainHelper already retries those
  against the *drain* timeout, not the request timeout).

The :class:`CircuitBreaker` counts *consecutive transient* failures per
endpoint ("GET nodes", "PATCH pods", ...).  A definitive server answer —
even a fatal one like 404 — proves the endpoint is alive and closes the
count.  After ``failure_threshold`` consecutive transient failures the
endpoint opens: calls fast-fail with :class:`CircuitOpenError` (no
socket work, no backoff sleeps) so a reconcile tick over a dead
apiserver costs microseconds instead of minutes.  After
``reset_timeout_s`` one half-open probe is let through; success closes
the endpoint, failure re-opens it.

:class:`ResilientClient` wraps any :class:`KubeClient` (notably
``FakeCluster``) with the same retry + breaker layer ``RestClient``
applies internally, so the fake tier exercises identical policy code.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
from collections import Counter
from typing import Any, Callable, Optional

from k8s_operator_libs_tpu_torch.k8s.client import (
    ConflictError,
    EvictionBlockedError,
    ExpiredError,
    InvalidError,
    NotFoundError,
    ServerError,
    ThrottledError,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "ResilientClient",
    "RetryPolicy",
    "is_transient",
]


class CircuitOpenError(RuntimeError):
    """Fast-fail: the per-endpoint circuit is open.

    A ``RuntimeError`` so generic reconcile-level handlers (and the
    chaos tier's requeue loops) treat it like any other API failure,
    but distinguishable so the controller can surface ``Degraded``
    instead of logging a crash."""

    def __init__(self, endpoint: str, detail: str = "") -> None:
        super().__init__(
            f"circuit open for {endpoint}" + (f": {detail}" if detail else "")
        )
        self.endpoint = endpoint


def is_transient(exc: BaseException) -> bool:
    """True when a retry may succeed without the caller changing anything."""
    if isinstance(exc, CircuitOpenError):
        return False  # the whole point is NOT to keep trying
    if isinstance(exc, (ThrottledError, ServerError)):
        return True
    if isinstance(
        exc,
        (NotFoundError, ConflictError, ExpiredError, InvalidError,
         EvictionBlockedError),
    ):
        return False
    # Connection-level: resets, refused connects, socket timeouts, bad
    # status lines from a dying server.  TimeoutError is an OSError
    # subclass since 3.10 but listed for clarity.
    return isinstance(
        exc, (OSError, TimeoutError, http.client.HTTPException)
    )


class RetryPolicy:
    """Capped exponential backoff with full jitter.

    ``backoff_s(attempt)`` for attempt 1, 2, 3... grows
    ``base * 2**(attempt-1)`` up to ``max_backoff_s``; a server-provided
    ``retry_after_s`` raises the floor (never above the cap — a hostile
    or buggy Retry-After must not wedge the tick)."""

    def __init__(
        self,
        max_attempts: int = 4,
        base_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        jitter: float = 0.2,
        seed: Optional[int] = None,
    ) -> None:
        self.max_attempts = max(1, int(max_attempts))
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self._rng = random.Random(seed)

    def backoff_s(
        self, attempt: int, retry_after_s: Optional[float] = None
    ) -> float:
        base = min(
            self.max_backoff_s,
            self.base_backoff_s * (2 ** max(0, attempt - 1)),
        )
        if retry_after_s is not None and retry_after_s > 0:
            base = max(base, min(retry_after_s, self.max_backoff_s))
        if self.jitter <= 0:
            return base
        return base * (1.0 + self._rng.uniform(-self.jitter, self.jitter))


class _EndpointState:
    __slots__ = ("failures", "opened_at", "probing", "last_error")

    def __init__(self) -> None:
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.probing = False
        self.last_error = ""


class CircuitBreaker:
    """Per-endpoint consecutive-transient-failure breaker.

    Breaker state is deliberately per-process and NOT persisted across
    leader failover: a fresh leader re-learns apiserver health within
    ``failure_threshold`` calls (seconds), while an inherited open
    breaker could mask an endpoint that recovered during the handoff
    and would add a shared-write path to what is otherwise pure local
    bookkeeping (see "Crash recovery and leader handoff semantics" in
    docs/automatic-libtpu-upgrade.md)."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 15.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._states: dict[str, _EndpointState] = {}
        #: lifetime count of fast-fails, for metrics.
        self.fast_fails = 0

    def allow(self, endpoint: str) -> bool:
        """True if a call to ``endpoint`` may proceed.  While open, lets
        exactly one half-open probe through per ``reset_timeout_s``."""
        with self._lock:
            st = self._states.get(endpoint)
            if st is None or st.opened_at is None:
                return True
            if (
                not st.probing
                and self._clock() - st.opened_at >= self.reset_timeout_s
            ):
                st.probing = True
                return True
            self.fast_fails += 1
            return False

    def record_success(self, endpoint: str) -> None:
        with self._lock:
            st = self._states.get(endpoint)
            if st is not None:
                st.failures = 0
                st.opened_at = None
                st.probing = False
                st.last_error = ""

    def record_failure(self, endpoint: str, exc: BaseException) -> None:
        with self._lock:
            st = self._states.setdefault(endpoint, _EndpointState())
            st.failures += 1
            # Bounded: this string feeds stuck-detector reasons, events,
            # and the Degraded condition message.
            st.last_error = f"{type(exc).__name__}: {exc}"[:160]
            if st.failures >= self.failure_threshold:
                # (Re-)open; a failed half-open probe lands here too and
                # restarts the reset clock.
                st.opened_at = self._clock()
                st.probing = False

    def open_endpoints(self) -> dict[str, str]:
        """endpoint -> last error, for every currently-open endpoint."""
        with self._lock:
            return {
                ep: st.last_error
                for ep, st in self._states.items()
                if st.opened_at is not None
            }

    def describe_open(self) -> str:
        """Human-readable blocker reason, or '' when every circuit is
        closed.  Shaped for the stuck detector / Degraded condition."""
        open_eps = self.open_endpoints()
        if not open_eps:
            return ""
        parts = [
            f"{ep} ({err})" if err else ep
            for ep, err in sorted(open_eps.items())
        ]
        return "api circuit open: " + "; ".join(parts)


def call_with_retry(
    fn: Callable[..., Any],
    args: tuple,
    kwargs: dict,
    endpoint: str,
    policy: Optional[RetryPolicy],
    breaker: Optional[CircuitBreaker],
    stats: Optional[Counter] = None,
    retriable: Callable[[BaseException], bool] = is_transient,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Shared retry/breaker engine used by ResilientClient (and mirrored
    by RestClient._request, which additionally guards sent POSTs)."""
    if breaker is not None and not breaker.allow(endpoint):
        if stats is not None:
            stats["breaker_fast_fail"] += 1
        raise CircuitOpenError(endpoint, breaker.describe_open())
    attempt = 0
    while True:
        attempt += 1
        try:
            result = fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — classified below
            transient = retriable(exc)
            if breaker is not None:
                if transient:
                    breaker.record_failure(endpoint, exc)
                elif not isinstance(exc, CircuitOpenError):
                    # A definitive server verdict (404/409/422...) means
                    # the endpoint is alive.
                    breaker.record_success(endpoint)
            if not transient:
                raise
            if policy is None or attempt >= policy.max_attempts:
                raise
            if breaker is not None and not breaker.allow(endpoint):
                if stats is not None:
                    stats["breaker_fast_fail"] += 1
                raise CircuitOpenError(
                    endpoint, breaker.describe_open()
                ) from exc
            if stats is not None:
                stats["retries"] += 1
            sleep(
                policy.backoff_s(
                    attempt, getattr(exc, "retry_after_s", None)
                )
            )
            continue
        if breaker is not None:
            breaker.record_success(endpoint)
        return result


class ResilientClient:
    """Wraps a :class:`KubeClient` with retry + circuit breaking.

    Every public *callable* attribute of the inner client is proxied
    through :func:`call_with_retry`, keyed by method name.  Watch entry
    points are passed through untouched — streams have their own
    reconnect contract (the controller's watch pump re-lists) and must
    not be blind-retried mid-iteration.

    The fake tier raises injected faults *before* mutating the store, so
    retrying any verb (including creates) is safe here; the wire client
    applies its own stricter POST rule in ``RestClient._request``.
    """

    _PASSTHROUGH = frozenset(
        {"watch", "watch_events", "on_pod_deleted", "close"}
    )

    def __init__(
        self,
        client: Any,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
    ) -> None:
        self._inner = client
        self.retry_policy = retry_policy or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()
        self.retry_stats: Counter[str] = Counter()

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._inner, name)
        if (
            name.startswith("_")
            or name in self._PASSTHROUGH
            or not callable(attr)
        ):
            return attr

        def _resilient(*args: Any, **kwargs: Any) -> Any:
            return call_with_retry(
                attr,
                args,
                kwargs,
                endpoint=name,
                policy=self.retry_policy,
                breaker=self.breaker,
                stats=self.retry_stats,
            )

        _resilient.__name__ = name
        # Deliberately not cached: tests monkeypatch inner-client verbs
        # (e.g. wrapping patch_node_labels to record transitions), and a
        # cached wrapper would pin the stale bound method.
        return _resilient
