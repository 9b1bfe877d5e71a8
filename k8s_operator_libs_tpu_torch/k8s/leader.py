"""Lease-based leader election: run controller replicas safely.

The reference delegates HA to its consumers' controller-runtime manager
(client-go ``leaderelection`` over a ``coordination.k8s.io/v1`` Lease);
operators run 2+ replicas and only the lease holder reconciles.  This is
the same protocol, tier-agnostic: the Lease rides the custom-object
surface (``/apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}``)
both :class:`~k8s_operator_libs_tpu_torch.k8s.client.FakeCluster` and
:class:`~k8s_operator_libs_tpu_torch.k8s.rest.RestClient` serve, with
apiserver optimistic concurrency (resourceVersion CAS on update) as the
arbiter — two candidates can never both win a term.

Clock-skew robustness follows client-go: a candidate never compares the
holder's ``renewTime`` against its own wall clock.  It records *when it
observed* the (holder, renewTime) pair change and considers the lease
expired only after ``leaseDurationSeconds`` of its OWN clock without an
observed renewal.
"""

from __future__ import annotations

import math
import socket
import time
import uuid
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.client import ConflictError, NotFoundError
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient

logger = get_logger(__name__)

LEASE_GROUP = "coordination.k8s.io"
LEASE_VERSION = "v1"
LEASE_PLURAL = "leases"

_MICRO_FMT = "%Y-%m-%dT%H:%M:%S"


def default_identity() -> str:
    """hostname_uuid — unique per process, readable in `kubectl get lease`
    (the client-go convention)."""
    return f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"


def ensure_lease_kind(client) -> None:
    """Enable the Lease kind on clients that gate unknown kinds.

    ``coordination.k8s.io/v1`` is a built-in on any real apiserver; the
    FakeCluster (and the in-process KubeApiServer backed by one) serves
    only registered kinds, so test/simulation tiers install it here.
    Idempotent; a no-op for clients without a registry."""
    register = getattr(client, "register_custom_resource", None)
    if register is not None:
        register(LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL)


def _format_micro(ts: float) -> str:
    whole = time.strftime(_MICRO_FMT, time.gmtime(ts))
    return f"{whole}.{int((ts % 1) * 1e6):06d}Z"


class LeaderElector:
    """Acquire/renew a Lease; the holder runs, everyone else watches.

    One instance per candidate process.  Call :meth:`acquire_or_renew`
    once per work period (the controller does it at the top of every
    reconcile wait); act only while it returns True.  Semantics follow
    client-go's leaderelection:

    - ``lease_duration_s``: how long a term lasts after the last
      observed renewal before non-holders may take over.
    - ``renew_deadline_s``: how long the CURRENT holder keeps acting
      after its last *successful* renewal; past it the holder stands
      down even if the apiserver is unreachable (split-brain guard: it
      is shorter than lease_duration, so the holder stops before anyone
      else can start).
    - ``retry_period_s``: how often candidates retry; exposed for run
      loops.
    """

    def __init__(
        self,
        client: KubeClient,
        identity: Optional[str] = None,
        namespace: str = "kube-system",
        name: str = "tpu-upgrade-controller",
        lease_duration_s: float = 15.0,
        renew_deadline_s: float = 10.0,
        retry_period_s: float = 2.0,
        time_fn: Callable[[], float] = time.time,
        mono_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        if renew_deadline_s >= lease_duration_s:
            raise ValueError(
                "renew_deadline_s must be < lease_duration_s "
                "(the holder must stand down before a successor starts)"
            )
        self.client = client
        self.identity = identity or default_identity()
        self.namespace = namespace
        self.name = name
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.retry_period_s = retry_period_s
        # Wall clock ONLY for the formatted Lease timestamps (they are
        # documentation for kubectl and other candidates, never compared
        # against a local clock); every internal deadline/expiry
        # comparison uses the monotonic clock so an NTP step can't keep a
        # partitioned holder "leading" past its renew deadline while a
        # standby's observation window lapses (split brain).
        self._time = time_fn
        self._mono = mono_fn
        self._is_leader = False
        self._last_renew: Optional[float] = None
        # (holder, renewTime) last seen on the wire and when WE saw it —
        # expiry is judged on the observer's clock, never the holder's.
        self._observed: Optional[tuple[str, str]] = None
        self._observed_at = 0.0
        # Last persistent-error message logged (transition-logged only).
        self._last_error: Optional[str] = None
        # Fencing term: the leaseTransitions value this process wrote
        # when it last WON the lease (0 = created, N = takeover number).
        # -1 until first win.  leaseTransitions is bumped on every
        # takeover, so (identity, term) uniquely names a leadership
        # epoch — the re-adoption pass stamps it into the adoption
        # annotation and a deposed leader's stale workers can be told
        # apart from the live term's.
        self._term = -1

    # -- public surface ------------------------------------------------------

    @property
    def term(self) -> int:
        """The leaseTransitions number of this process's current (or most
        recent) leadership epoch; -1 if it never held the lease."""
        return self._term

    def is_leader(self) -> bool:
        """Held AND renewed within the deadline.  A holder that cannot
        reach the apiserver goes False here before its term expires for
        everyone else."""
        if not self._is_leader or self._last_renew is None:
            return False
        return self._mono() - self._last_renew <= self.renew_deadline_s

    def acquire_or_renew(self) -> bool:
        """One election round; True iff this process holds the lease.

        Network/API errors never raise.  For a current holder they fall
        back to the renew-deadline grace (``is_leader()``): one transient
        apiserver error must not abort in-flight work while the Lease
        still names this process; only a deadline's worth of consecutive
        failures stands it down.  For a candidate they report False."""
        try:
            result = self._try_acquire_or_renew()
            self._last_error = None
            return result
        except ConflictError:
            # A concurrent writer won this round's CAS.  A holder keeps
            # acting until its renew DEADLINE (client-go retries renewal
            # until renewDeadline — one contended write must not flap
            # leadership); the next round re-reads the lease, and a
            # genuine takeover is observed there and stands us down
            # immediately.  A candidate that never held simply lost.
            return self.is_leader()
        except NotFoundError as e:
            # Either the lease vanished mid-flight (transient — next
            # round recreates it) or the Lease surface itself is
            # missing/misconfigured (wrong namespace, kind not served),
            # in which case this repeats forever: surface it, but only
            # on transition so a persistent misconfig doesn't spam a log
            # line per retry period.
            if str(e) != self._last_error:
                logger.warning(
                    "leader election for %s/%s: %s (misconfigured "
                    "--lease-namespace or Lease kind not served? "
                    "all replicas will stay standby until this resolves)",
                    self.namespace, self.name, e,
                )
                self._last_error = str(e)
            return self.is_leader()
        except Exception as e:  # noqa: BLE001 — election must not crash the loop
            # Transient apiserver error: same deadline grace as above — a
            # single timeout must not abort an in-flight reconcile while
            # the Lease still names this process.
            logger.warning("leader election round failed: %s", e)
            return self.is_leader()

    def release(self) -> None:
        """Voluntarily end the term (clean shutdown): clear the holder so
        a successor acquires immediately instead of waiting out the
        lease.  Best-effort.  Attempted whenever this process ever held
        the lease — even if a renewal blip cleared the local flag — the
        holder check below protects a successor's term."""
        if self._last_renew is None:
            return  # never held
        self._is_leader = False
        try:
            lease = self.client.get_custom_object(
                LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
                self.namespace, self.name,
            )
            spec = lease.get("spec") or {}
            if spec.get("holderIdentity") != self.identity:
                return  # someone already took over; nothing to release
            spec["holderIdentity"] = ""
            spec["renewTime"] = _format_micro(self._time())  # wall: wire doc
            lease["spec"] = spec
            self.client.update_custom_object(
                LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
                self.namespace, lease,
            )
        except Exception as e:  # noqa: BLE001 — shutdown path, best-effort
            logger.debug("lease release failed: %s", e)

    # -- internals -----------------------------------------------------------

    def _try_acquire_or_renew(self) -> bool:
        now = self._time()  # wall — Lease spec timestamps only
        mono = self._mono()  # all expiry/deadline arithmetic
        try:
            lease = self.client.get_custom_object(
                LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
                self.namespace, self.name,
            )
        except NotFoundError:
            created = {
                "apiVersion": f"{LEASE_GROUP}/{LEASE_VERSION}",
                "kind": "Lease",
                "metadata": {"name": self.name},
                "spec": self._spec(now, acquire=now, transitions=0),
            }
            # create is the CAS here: if another candidate creates first,
            # ConflictError propagates to acquire_or_renew's handler.
            self.client.create_custom_object(
                LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL,
                self.namespace, created,
            )
            self._term = 0
            self._won(now)
            logger.info(
                "lease %s/%s acquired by %s (created)",
                self.namespace, self.name, self.identity,
            )
            return True

        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        observed = (holder, str(spec.get("renewTime") or ""))
        if observed != self._observed:
            self._observed = observed
            self._observed_at = mono

        if holder and holder != self.identity:
            duration = float(
                spec.get("leaseDurationSeconds") or self.lease_duration_s
            )
            if mono < self._observed_at + duration:
                self._is_leader = False
                return False  # someone else holds a live term
            logger.info(
                "lease %s/%s held by %s expired; taking over",
                self.namespace, self.name, holder,
            )

        renewing = holder == self.identity
        transitions = int(spec.get("leaseTransitions") or 0)
        new_transitions = transitions if renewing else transitions + 1
        lease["spec"] = self._spec(
            now,
            acquire=(
                _parse_micro(spec.get("acquireTime"), now)
                if renewing
                else now
            ),
            transitions=new_transitions,
        )
        # update carries the fetched resourceVersion: a concurrent writer
        # bumps it and this PUT conflicts — exactly one winner per term.
        self.client.update_custom_object(
            LEASE_GROUP, LEASE_VERSION, LEASE_PLURAL, self.namespace, lease
        )
        became = not self._is_leader
        self._term = new_transitions
        self._won(now)
        if became and not renewing:
            logger.info(
                "lease %s/%s acquired by %s (takeover)",
                self.namespace, self.name, self.identity,
            )
        return True

    def _won(self, now: float) -> None:
        self._is_leader = True
        self._last_renew = self._mono()
        self._observed = (self.identity, _format_micro(now))
        self._observed_at = self._mono()

    def _spec(self, now: float, acquire: float, transitions: int) -> dict:
        return {
            "holderIdentity": self.identity,
            # ceil, never truncate: a fractional duration must not
            # advertise a SHORTER term than the renew_deadline guard
            # validated against (and a sub-second one must not advertise
            # 0, which observers read as "unset" and replace with their
            # own configured duration).
            "leaseDurationSeconds": max(1, math.ceil(self.lease_duration_s)),
            "acquireTime": _format_micro(acquire),
            "renewTime": _format_micro(now),
            "leaseTransitions": transitions,
        }


def _parse_micro(raw, fallback: float) -> float:
    """RFC3339 (with or without fractional seconds) → epoch seconds."""
    if not raw:
        return fallback
    raw = str(raw).rstrip("Z")
    frac = 0.0
    if "." in raw:
        raw, _, frac_s = raw.partition(".")
        try:
            frac = float("0." + frac_s)
        except ValueError:
            frac = 0.0
    try:
        import calendar

        return calendar.timegm(time.strptime(raw, _MICRO_FMT)) + frac
    except ValueError:
        return fallback
