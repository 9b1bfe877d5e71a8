"""Concurrency primitives, key builders and event helpers.

Capability parity with the reference's ``pkg/upgrade/util.go``:
``StringSet`` (thread-safe set, util.go:26-66), ``KeyedMutex`` (per-key lock,
util.go:69-85), the driver-name-parameterized label/annotation key builders
(util.go:97-139) and event helpers (util.go:141-153).

Per SURVEY.md §5 we avoid the reference's mutable package-global
``DriverName`` as the primary API: keys live on an injectable
:class:`UpgradeKeys` value object.  A module-level default instance plus
:func:`set_driver_name` is kept for drop-in parity with the reference's
``upgrade.SetDriverName`` call-shape.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Callable

from k8s_operator_libs_tpu_torch.upgrade import consts as C


class StringSet:
    """Thread-safe set of strings (reference util.go:26-66).

    Used by the drain/pod managers to deduplicate in-flight async work
    across reconcile passes.
    """

    def __init__(self) -> None:
        self._items: set[str] = set()
        self._mu = threading.Lock()

    def add(self, item: str) -> None:
        with self._mu:
            self._items.add(item)

    def try_add(self, item: str) -> bool:
        """Atomically add; False when already present (claim semantics —
        lets schedulers dedupe in-flight work without a check-then-act
        race)."""
        with self._mu:
            if item in self._items:
                return False
            self._items.add(item)
            return True

    def remove(self, item: str) -> None:
        with self._mu:
            self._items.discard(item)

    def has(self, item: str) -> bool:
        with self._mu:
            return item in self._items

    def clear(self) -> None:
        with self._mu:
            self._items.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._items)


class KeyedMutex:
    """Per-key mutual exclusion (reference util.go:69-85).

    ``lock(key)`` returns a context manager so call sites read::

        with mutex.lock(node_name):
            ...
    """

    def __init__(self) -> None:
        self._locks: dict[str, threading.Lock] = {}
        self._guard = threading.Lock()

    def lock(self, key: str) -> threading.Lock:
        with self._guard:
            lk = self._locks.get(key)
            if lk is None:
                lk = threading.Lock()
                self._locks[key] = lk
        return lk


@dataclass(frozen=True)
class UpgradeKeys:
    """All label/annotation keys for one managed driver.

    Analogue of reference util.go:97-139, but immutable and injectable
    instead of reading a mutable package global.
    """

    driver_name: str = "libtpu"
    domain: str = C.KEY_DOMAIN_DEFAULT

    def _fmt(self, fmt: str) -> str:
        return fmt.format(domain=self.domain, driver=self.driver_name)

    @property
    def state_label(self) -> str:
        return self._fmt(C.UPGRADE_STATE_LABEL_KEY_FMT)

    @property
    def skip_label(self) -> str:
        return self._fmt(C.UPGRADE_SKIP_NODE_LABEL_KEY_FMT)

    @property
    def safe_load_annotation(self) -> str:
        return self._fmt(C.UPGRADE_WAIT_FOR_SAFE_DRIVER_LOAD_ANNOTATION_KEY_FMT)

    @property
    def initial_state_annotation(self) -> str:
        return self._fmt(C.UPGRADE_INITIAL_STATE_ANNOTATION_KEY_FMT)

    @property
    def pod_completion_start_time_annotation(self) -> str:
        return self._fmt(
            C.UPGRADE_WAIT_FOR_POD_COMPLETION_START_TIME_ANNOTATION_KEY_FMT
        )

    @property
    def validation_start_time_annotation(self) -> str:
        return self._fmt(C.UPGRADE_VALIDATION_START_TIME_ANNOTATION_KEY_FMT)

    @property
    def upgrade_requested_annotation(self) -> str:
        return self._fmt(C.UPGRADE_REQUESTED_ANNOTATION_KEY_FMT)

    @property
    def quarantine_prior_state_annotation(self) -> str:
        return self._fmt(C.UPGRADE_QUARANTINE_PRIOR_STATE_ANNOTATION_KEY_FMT)

    @property
    def quarantine_ready_since_annotation(self) -> str:
        return self._fmt(C.UPGRADE_QUARANTINE_READY_SINCE_ANNOTATION_KEY_FMT)

    @property
    def quarantine_cycle_count_annotation(self) -> str:
        return self._fmt(C.UPGRADE_QUARANTINE_CYCLE_COUNT_ANNOTATION_KEY_FMT)

    @property
    def elastic_workload_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_WORKLOAD_ANNOTATION_KEY_FMT)

    @property
    def elastic_offer_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_OFFER_ANNOTATION_KEY_FMT)

    @property
    def elastic_response_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_RESPONSE_ANNOTATION_KEY_FMT)

    @property
    def elastic_resize_complete_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_RESIZE_COMPLETE_ANNOTATION_KEY_FMT)

    @property
    def elastic_excluded_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_EXCLUDED_ANNOTATION_KEY_FMT)

    @property
    def elastic_rejoin_offer_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_REJOIN_OFFER_ANNOTATION_KEY_FMT)

    @property
    def elastic_rejoin_complete_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ELASTIC_REJOIN_COMPLETE_ANNOTATION_KEY_FMT)

    @property
    def preempted_since_annotation(self) -> str:
        return self._fmt(C.UPGRADE_PREEMPTED_SINCE_ANNOTATION_KEY_FMT)

    @property
    def window_wait_annotation(self) -> str:
        return self._fmt(C.UPGRADE_WINDOW_WAIT_ANNOTATION_KEY_FMT)

    @property
    def eviction_rung_annotation(self) -> str:
        return self._fmt(C.UPGRADE_EVICTION_RUNG_ANNOTATION_KEY_FMT)

    @property
    def eviction_rung_since_annotation(self) -> str:
        return self._fmt(C.UPGRADE_EVICTION_RUNG_SINCE_ANNOTATION_KEY_FMT)

    @property
    def rollback_attempts_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ROLLBACK_ATTEMPTS_ANNOTATION_KEY_FMT)

    @property
    def rollback_last_attempt_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ROLLBACK_LAST_ATTEMPT_ANNOTATION_KEY_FMT)

    @property
    def recovery_probe_since_annotation(self) -> str:
        return self._fmt(C.UPGRADE_RECOVERY_PROBE_SINCE_ANNOTATION_KEY_FMT)

    @property
    def adopted_by_annotation(self) -> str:
        return self._fmt(C.UPGRADE_ADOPTED_BY_ANNOTATION_KEY_FMT)

    @property
    def trace_annotation(self) -> str:
        return self._fmt(C.UPGRADE_TRACE_ANNOTATION_KEY_FMT)

    @property
    def telemetry_history_annotation(self) -> str:
        return self._fmt(C.UPGRADE_TELEMETRY_HISTORY_ANNOTATION_KEY_FMT)

    @property
    def slice_id_label(self) -> str:
        return self._fmt(C.SLICE_ID_LABEL_KEY_FMT)

    @property
    def dcn_group_label(self) -> str:
        return self._fmt(C.DCN_GROUP_LABEL_KEY_FMT)

    @property
    def chips_per_host_label(self) -> str:
        return self._fmt(C.CHIPS_PER_HOST_LABEL_KEY_FMT)

    @property
    def health_report_annotation(self) -> str:
        return self._fmt(C.HEALTH_REPORT_ANNOTATION_KEY_FMT)

    @property
    def event_reason(self) -> str:
        # Reference util.go:136-139: "<DRIVER>DriverUpgrade".
        return f"{self.driver_name.upper()}DriverUpgrade"


# Module-level default keys, mirroring the reference's SetDriverName +
# GetUpgradeStateLabelKey call-shape for drop-in parity.
default_keys = UpgradeKeys()


def set_driver_name(driver: str) -> None:
    """Set the driver name on the module-default :class:`UpgradeKeys`."""
    global default_keys
    default_keys = replace(default_keys, driver_name=driver)


def get_upgrade_state_label_key() -> str:
    return default_keys.state_label


# --- shared concurrency helpers --------------------------------------------


def group_clock_start(provider, group, key: str, now: int):
    """Shared start-time clock for group waits (wait-for-jobs and
    validation timeouts).

    Returns the clock anchor once EVERY member carries the start-time
    annotation; otherwise stamps the missing members with ``now`` and
    returns None — the clock is evaluated from the next pass (the batch
    write refreshes node objects in place, so a stamped-count guard
    after writing would never fire).

    The anchor is the NEWEST stamp: members are stamped together, so
    legitimate stamps are ~equal, and an ancient outlier (a crash
    artifact from a previous cycle whose "null" cleanup didn't land)
    must not fail the group instantly on re-entry.  Tradeoff, same as
    the reference's per-node semantics (pod_manager.go:334-371): a
    member that persistently LOSES its annotation mid-wait restarts the
    clock — the stuck-state detector attributes the resulting long
    dwell."""
    unstamped = [n for n in group.nodes if key not in n.annotations]
    if unstamped:
        provider.change_nodes_upgrade_annotation(unstamped, key, str(now))
        return None
    return max(int(n.annotations[key]) for n in group.nodes)


def run_batch(tasks: list[Callable[[], None]], max_workers: int = 32) -> None:
    """Run callables concurrently; after all complete, raise the first error.

    The batch fan-out used for slice-wide operations (state-label flips,
    cordons, pod restarts): everything is attempted even if one member
    fails, so a partially-written slice is maximally advanced and the next
    idempotent pass re-drives the stragglers.
    """
    tasks = list(tasks)
    if not tasks:
        return
    if len(tasks) == 1:
        tasks[0]()
        return
    errors: list[Exception] = []
    with ThreadPoolExecutor(max_workers=min(max_workers, len(tasks))) as pool:
        futures = [pool.submit(t) for t in tasks]
        for fut in futures:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
    if errors:
        raise errors[0]


class WorkerTracker:
    """Tracks async actor threads (drain/eviction workers) so tests and
    bench can join them; the deadline applies to the whole set."""

    def __init__(self) -> None:
        self._workers: list[threading.Thread] = []
        self._lock = threading.Lock()

    def spawn(self, target: Callable[[], None], name: str) -> None:
        worker = threading.Thread(target=target, name=name, daemon=True)
        with self._lock:
            self._workers.append(worker)
        worker.start()

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            workers = list(self._workers)
        ok = True
        for w in workers:
            w.join(max(0.0, deadline - time.monotonic()))
            ok = ok and not w.is_alive()
        with self._lock:
            self._workers = [w for w in self._workers if w.is_alive()]
        return ok


# --- events ---------------------------------------------------------------

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"


@dataclass
class Event:
    """One recorded event (analogue of a corev1.Event)."""

    object_name: str
    event_type: str
    reason: str
    message: str


class EventRecorder:
    """Minimal event recorder interface.

    Reference util.go:141-153 wraps client-go's ``record.EventRecorder``;
    here the in-memory recorder is both the production default (events
    surface through logs/metrics) and the test capture buffer (analogue of
    ``record.NewFakeRecorder``, upgrade_suit_test.go:63).
    """

    def __init__(self, capacity: int = 1000) -> None:
        self.events: list[Event] = []
        self._capacity = capacity
        self._mu = threading.Lock()

    def eventf(
        self, object_name: str, event_type: str, reason: str, message: str
    ) -> None:
        with self._mu:
            if len(self.events) < self._capacity:
                self.events.append(Event(object_name, event_type, reason, message))

    def drain(self) -> list[Event]:
        with self._mu:
            out = self.events
            self.events = []
            return out


def log_event(
    recorder: EventRecorder | None,
    object_name: str,
    event_type: str,
    reason: str,
    message: str,
) -> None:
    """Record an event if a recorder is configured (util.go:141-153)."""
    if recorder is not None:
        recorder.eventf(object_name, event_type, reason, message)
