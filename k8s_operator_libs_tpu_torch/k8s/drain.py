"""Drain helper: cordon/uncordon + filtered pod eviction.

Behavioral analogue of ``k8s.io/kubectl/pkg/drain`` as the reference uses it
(drain_manager.go:76-95, pod_manager.go:139-160, cordon_manager.go:39-48):

- ``run_cordon_or_uncordon`` flips ``spec.unschedulable``;
- ``get_pods_for_deletion`` applies kubectl's standard filters — skip
  DaemonSet-owned pods when ``ignore_all_daemon_sets`` (the driver itself is
  a DaemonSet pod, drain_manager.go:80-81), skip mirror pods, error on
  emptyDir pods unless ``delete_empty_dir_data``, error on unreplicated
  (orphaned) pods unless ``force`` — plus caller-supplied additional
  filters (the PodManager's custom deletion filter, pod_manager.go:141-147);
- ``delete_or_evict_pods`` evicts through the Eviction API and waits for
  the pods to disappear, honoring the timeout.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

from k8s_operator_libs_tpu_torch.k8s.client import (
    EvictionBlockedError,
    NotFoundError,
    ThrottledError,
)
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.k8s.objects import Node, Pod
from k8s_operator_libs_tpu_torch.layers import count, layer_span, spanned


class DrainError(RuntimeError):
    pass


class FencedError(RuntimeError):
    """Raised by an async drain worker whose leader lost the lease.

    A deposed leader's orphaned workers must stop acting the moment the
    fence trips — the new leader has re-adopted their in-flight work from
    the persisted record, and a late write from the old term would race
    it.  Callers treat this as "abandon quietly", never as a drain
    failure (the slice must NOT flip to upgrade-failed because leadership
    moved)."""


# Ladder rungs, in escalation order.
RUNG_EVICT = "evict"
RUNG_DELETE = "delete"
RUNG_FORCE_DELETE = "force_delete"
ALL_RUNGS = (RUNG_EVICT, RUNG_DELETE, RUNG_FORCE_DELETE)


@dataclass
class EscalationConfig:
    """Runtime knobs for the eviction escalation ladder.

    Disabled by default: a drain then behaves exactly as kubectl's —
    evict and wait, stalling forever on a PDB or a stuck finalizer until
    the overall drain timeout.  Enabled, a pod that outlives a rung's
    timeout escalates evict → delete (bypasses the PDB, honors
    finalizers) → force-delete (grace 0, bypasses finalizers too).  The
    force rung is separately opt-in: on a TPU slice it is only safe when
    the kubelet is actually gone, since a force-deleted pod's containers
    may still be running and holding the ICI domain.
    """

    enable: bool = False
    evict_timeout_s: float = 30.0
    delete_timeout_s: float = 30.0
    allow_force_delete: bool = False
    # PDB-aware hold: a pod whose evictions are being rejected by a
    # PodDisruptionBudget (429s) holds at the evict rung for this long
    # PAST evict_timeout_s before climbing to delete — the budget
    # releasing is plausibly imminent (a sibling pod terminating frees
    # disruptionsAllowed), so keep asking instead of timing out blind.
    # 0 disables the hold (legacy behavior: escalate on the raw timeout).
    pdb_grace_s: float = 0.0


class EscalationStats:
    """Thread-safe per-rung counters.

    DrainHelper instances are per-call ephemerals; the upgrade manager
    owns one stats object and threads it through every construction
    site, so counters survive across drains and surface in metrics.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._rungs: Counter[str] = Counter()

    def record(self, rung: str) -> None:
        with self._mu:
            self._rungs[rung] += 1

    def get(self, rung: str) -> int:
        with self._mu:
            return self._rungs[rung]

    def snapshot(self) -> dict[str, int]:
        with self._mu:
            return dict(self._rungs)


def escalation_from_spec(spec) -> Optional[EscalationConfig]:
    """Build an :class:`EscalationConfig` from an EvictionEscalationSpec.

    Duck-typed (attribute access) so this layer stays independent of the
    api package; ``None`` in, ``None`` out."""
    if spec is None:
        return None
    return EscalationConfig(
        enable=bool(spec.enable),
        evict_timeout_s=float(spec.evict_timeout_second),
        delete_timeout_s=float(spec.delete_timeout_second),
        allow_force_delete=bool(spec.allow_force_delete),
        pdb_grace_s=float(getattr(spec, "pdb_grace_second", 0) or 0),
    )


# An additional filter returns (delete: bool, skip_reason: str | None).
PodFilter = Callable[[Pod], bool]


@dataclass
class PodDeleteList:
    """Result of get_pods_for_deletion (drain.PodDeleteList analogue)."""

    _pods: list[Pod] = field(default_factory=list)
    _warnings: list[str] = field(default_factory=list)

    def pods(self) -> list[Pod]:
        return self._pods

    def warnings(self) -> list[str]:
        return self._warnings


class DrainHelper:
    """Drain configuration + operations (drain.Helper analogue)."""

    def __init__(
        self,
        client: KubeClient,
        force: bool = False,
        ignore_all_daemon_sets: bool = True,
        delete_empty_dir_data: bool = False,
        timeout_s: float = 0.0,  # 0 = infinite
        pod_selector: str = "",
        additional_filters: Optional[list[PodFilter]] = None,
        on_pod_deleted: Optional[Callable[[Pod, bool], None]] = None,
        poll_interval_s: float = 1.0,
        eviction_retry_interval_s: Optional[float] = None,
        escalation: Optional[EscalationConfig] = None,
        escalation_stats: Optional[EscalationStats] = None,
        fence: Optional[Callable[[], bool]] = None,
        rung_store=None,
        trace_hook: Optional[Callable[[str, str], None]] = None,
    ) -> None:
        self.client = client
        self.force = force
        self.ignore_all_daemon_sets = ignore_all_daemon_sets
        self.delete_empty_dir_data = delete_empty_dir_data
        self.timeout_s = timeout_s
        self.pod_selector = pod_selector
        self.additional_filters = additional_filters or []
        self.on_pod_deleted = on_pod_deleted
        # Default 1 s matches the apiserver-facing cadence kubectl uses;
        # tests override down to keep suites fast.
        self.poll_interval_s = poll_interval_s
        # PDB-blocked evictions back off harder than plain deletion polls
        # (kubectl waits ~5 s between eviction retries); scaling from the
        # poll interval keeps test overrides proportionally fast.
        self.eviction_retry_interval_s = (
            eviction_retry_interval_s
            if eviction_retry_interval_s is not None
            else 5.0 * poll_interval_s
        )
        self.escalation = escalation
        self.escalation_stats = escalation_stats
        # Leadership fence: checked before every mutating round.  False
        # aborts the drain with FencedError — a deposed leader's worker
        # must not evict/delete after handoff.
        self.fence = fence
        # Durable ladder clocks: an object with
        # load(node) -> (rung, epoch)|None, save(node, rung, epoch),
        # clear(node) — backed by node annotations upstream so a restarted
        # controller resumes each node's ladder at its persisted rung with
        # the original entry time, not back at rung 0.
        self.rung_store = rung_store
        # Observe-only rung tap: called as trace_hook(node_name, rung) on
        # every rung entry (initial, resumed, escalated).  Failures are
        # swallowed — tracing must never stall an eviction.
        self.trace_hook = trace_hook

    def _trace_rung(self, node_name: str, rung: str) -> None:
        if self.trace_hook is None or not node_name:
            return
        try:
            self.trace_hook(node_name, rung)
        except Exception:
            pass  # observe-only

    # -- cordon ------------------------------------------------------------

    def run_cordon_or_uncordon(self, node: Node, desired: bool) -> None:
        """Set node.spec.unschedulable = desired (idempotent)."""
        self.client.set_node_unschedulable(node.name, desired)
        node.spec.unschedulable = desired

    # -- pod selection -----------------------------------------------------

    def get_pods_for_deletion(
        self, node_name: str
    ) -> tuple[PodDeleteList, list[str]]:
        """Apply kubectl-drain's filter chain to the node's pods.

        Returns (deletable list incl. warnings, errors).  A pod failing a
        fatal filter produces an error and is excluded, matching the
        reference's "cannot delete all required pods" handling
        (pod_manager.go:196-204).
        """
        pods = self.client.list_pods(
            namespace="", label_selector=self.pod_selector, node_name=node_name
        )
        deletable: list[Pod] = []
        warnings: list[str] = []
        errors: list[str] = []
        for pod in pods:
            # Additional (caller) filters first: a skip here is silent,
            # mirroring drain.MakePodDeleteStatusSkip (pod_manager.go:141-147).
            if any(not f(pod) for f in self.additional_filters):
                continue
            if pod.is_mirror_pod():
                continue
            if pod.is_daemonset_pod():
                if self.ignore_all_daemon_sets:
                    warnings.append(f"ignoring DaemonSet-managed pod {pod.name}")
                    continue
                errors.append(f"cannot delete DaemonSet-managed pod {pod.name}")
                continue
            if pod.uses_empty_dir() and not self.delete_empty_dir_data:
                errors.append(
                    f"cannot delete pod {pod.name} with local storage (emptyDir)"
                )
                continue
            if pod.is_orphaned() and not self.force:
                errors.append(
                    f"cannot delete pod {pod.name} not managed by a controller"
                )
                continue
            deletable.append(pod)
        return PodDeleteList(deletable, warnings), errors

    # -- eviction ----------------------------------------------------------

    def delete_or_evict_pods(self, pods: list[Pod]) -> None:
        """Evict pods and wait until they are gone (or timeout).

        An eviction rejected by a PodDisruptionBudget (HTTP 429 →
        :class:`EvictionBlockedError`) is retried until the drain timeout,
        matching kubectl drain's behavior — a temporarily-blocked PDB must
        stall the drain, not crash the reconcile.

        With an enabled :class:`EscalationConfig`, a pod that outlives a
        rung's timeout climbs the ladder instead of stalling forever:
        evict → delete (bypasses the PDB, honors finalizers) →
        force-delete (grace 0, bypasses finalizers; only if
        ``allow_force_delete``).  Rung clocks restart on escalation."""
        deadline = (
            time.monotonic() + self.timeout_s if self.timeout_s > 0 else None
        )
        esc = self.escalation
        by_key = {(p.namespace, p.name): p for p in pods}
        pending = set(by_key)  # pods not yet confirmed gone
        issued = set()  # pods whose current rung's API call succeeded
        pdb_blocked = set()  # pods whose last eviction hit a PDB 429
        now = time.monotonic()
        now_epoch = int(time.time())
        node_of = {
            key: (getattr(p.spec, "node_name", "") or "")
            for key, p in by_key.items()
        }
        # Durable ladder resume: a node whose annotation records a rung
        # beyond evict re-enters the ladder AT that rung with the original
        # entry time (epoch→monotonic rebased), so a controller restart
        # mid-escalation continues the countdown instead of restarting it.
        store = (
            self.rung_store
            if (self.rung_store is not None and esc is not None and esc.enable)
            else None
        )
        persisted_by_node: dict[str, Optional[tuple[str, int]]] = {}
        if store is not None:
            for node in sorted({n for n in node_of.values() if n}):
                persisted_by_node[node] = store.load(node)
        rung = {}
        rung_since = {}
        resumed = set()
        for key in by_key:
            persisted = persisted_by_node.get(node_of[key])
            if persisted is not None:
                r, since_epoch = persisted
                if r == RUNG_FORCE_DELETE and not esc.allow_force_delete:
                    r = RUNG_DELETE
                if r in ALL_RUNGS:
                    rung[key] = r
                    rung_since[key] = now - max(0, now_epoch - since_epoch)
                    resumed.add(key)
                    continue
            rung[key] = RUNG_EVICT
            rung_since[key] = now
        for key in by_key:
            self._trace_rung(node_of[key], rung[key])
        if self.escalation_stats is not None:
            for key in by_key:
                if key not in resumed:
                    self.escalation_stats.record(RUNG_EVICT)
        if store is not None:
            for node in sorted(
                {node_of[k] for k in by_key if k not in resumed and node_of[k]}
            ):
                if persisted_by_node.get(node) is None:
                    store.save(node, RUNG_EVICT, now_epoch)
        while True:
            if self.fence is not None and not self.fence():
                raise FencedError(
                    "drain abandoned: leadership lost mid-eviction"
                )
            backoff_s = 0.0
            # Escalate pods that outlived their rung's budget — whether
            # the rung's call keeps failing (PDB 429s) or it succeeded
            # but the pod never vanished (finalizer holds it
            # Terminating): both need the next rung, so the clock runs
            # from rung entry, not from call success.
            if esc is not None and esc.enable:
                now = time.monotonic()
                for key in sorted(pending):
                    overdue = now - rung_since[key]
                    if (
                        rung[key] == RUNG_EVICT
                        and overdue > esc.evict_timeout_s
                    ):
                        # PDB-aware hold: the pod's evictions are being
                        # rejected by a disruption budget.  Releasing is
                        # plausibly imminent (a sibling terminating frees
                        # disruptionsAllowed), so keep retrying evictions
                        # for the grace window before escalating to a
                        # PDB-bypassing delete.
                        if (
                            key in pdb_blocked
                            and esc.pdb_grace_s > 0
                            and overdue
                            <= esc.evict_timeout_s + esc.pdb_grace_s
                        ):
                            continue
                        rung[key] = RUNG_DELETE
                    elif (
                        rung[key] == RUNG_DELETE
                        and esc.allow_force_delete
                        and overdue > esc.delete_timeout_s
                    ):
                        rung[key] = RUNG_FORCE_DELETE
                    else:
                        continue
                    rung_since[key] = now
                    issued.discard(key)
                    self._trace_rung(node_of[key], rung[key])
                    if self.escalation_stats is not None:
                        self.escalation_stats.record(rung[key])
                    if store is not None and node_of[key]:
                        store.save(node_of[key], rung[key], int(time.time()))
            for key in sorted(pending - issued):
                ns, name = key
                try:
                    if rung[key] == RUNG_EVICT:
                        self.client.evict_pod(ns, name)
                    elif rung[key] == RUNG_DELETE:
                        self.client.delete_pod(ns, name)
                    else:
                        self.client.delete_pod(
                            ns, name, grace_period_seconds=0
                        )
                except NotFoundError:
                    issued.add(key)  # already gone
                    continue
                except EvictionBlockedError:
                    # PDB: retry next round, but back off — re-POSTing a
                    # blocked eviction every poll hammers the apiserver for
                    # no benefit (the PDB won't release that fast).
                    pdb_blocked.add(key)
                    backoff_s = max(backoff_s, self.eviction_retry_interval_s)
                    continue
                except ThrottledError as e:
                    # Apiserver asked us to back off; stop hammering it
                    # with the rest of this round and honor Retry-After
                    # (without shrinking a PDB backoff already owed).
                    backoff_s = max(
                        backoff_s, e.retry_after_s, self.poll_interval_s
                    )
                    break
                issued.add(key)
                count("drain.evictions")
                pdb_blocked.discard(key)
                if self.on_pod_deleted is not None:
                    self.on_pod_deleted(by_key[key], True)
            # Wait for evicted pods to vanish (kubectl waits for deletion).
            gone = set()
            for ns, name in pending & issued:
                try:
                    self.client.get_pod(ns, name)
                except NotFoundError:
                    gone.add((ns, name))
                except ThrottledError:
                    break  # back off this round; deadline still applies
            pending -= gone
            if store is not None and gone:
                # A node whose tracked pods are all gone is done with the
                # ladder: drop its persisted rung so the NEXT drain cycle
                # starts fresh at evict instead of inheriting this one's
                # escalation.
                remaining_nodes = {node_of[k] for k in pending}
                for node in sorted(
                    {node_of[k] for k in gone if node_of[k]}
                    - remaining_nodes
                ):
                    store.clear(node)
            if not pending:
                return
            if deadline is not None and time.monotonic() > deadline:
                blocked = sorted(pending - issued)
                waiting = sorted(pending & issued)
                detail = []
                if blocked:
                    detail.append(f"evictions blocked by PDB: {blocked}")
                if waiting:
                    detail.append(f"pods not yet deleted: {waiting}")
                raise DrainError(
                    "timed out draining: " + "; ".join(detail)
                )
            sleep_s = max(self.poll_interval_s, backoff_s)
            if deadline is not None:
                sleep_s = min(sleep_s, max(0.0, deadline - time.monotonic()))
            with layer_span("drain.poll_sleep"):
                time.sleep(sleep_s)

    @spanned("drain.node")
    def run_node_drain(self, node_name: str) -> None:
        """Full drain: select pods, error if any fatal filter fired, evict.

        Analogue of drain.RunNodeDrain (drain_manager.go:120).
        """
        delete_list, errors = self.get_pods_for_deletion(node_name)
        if errors:
            raise DrainError("; ".join(errors))
        self.delete_or_evict_pods(delete_list.pods())
