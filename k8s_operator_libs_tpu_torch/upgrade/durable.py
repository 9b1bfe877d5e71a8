"""Durable in-flight progress clocks (crash-safe controller state).

The label mailbox makes the *state machine* stateless between passes,
but the fault-tolerance layers accumulated controller-process memory around it: eviction
ladder rungs and their entry clocks, rollback attempt counts and backoff
anchors, recovery-probe dedupe timestamps.  All of it evaporated on a
controller crash or leader handoff, silently resetting escalation
ladders and double-spending disruption budget under the new leader.

This module externalizes those clocks into node annotations written
through the same idempotent patch path as everything else:

- :class:`AnnotationRungStore` — per-node eviction-ladder rung + entry
  epoch, plugged into :class:`~k8s_operator_libs_tpu_torch.k8s.drain.DrainHelper`
  so a fresh controller resumes each ladder AT its persisted rung;
- epoch annotation read/write helpers shared by the rollback-backoff and
  recovery-probe persistence in the validation/upgrade managers;
- the adoption fencing stamp ("<identity>@<term>") the re-adoption pass
  writes on leader acquisition.

All writes here are best-effort: losing a clock write degrades to the
pre-crash-safety behavior (ladder restarts at evict), it must never fail
the drain or the reconcile pass itself.
"""

from __future__ import annotations

import time
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.drain import ALL_RUNGS
from k8s_operator_libs_tpu_torch.k8s.interface import KubeClient
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = get_logger(__name__)


def parse_epoch(value: Optional[str]) -> Optional[int]:
    """Parse an epoch-seconds annotation value; garbage reads as absent."""
    if not value:
        return None
    try:
        return int(value)
    except ValueError:
        return None


def parse_int(value: Optional[str], default: int = 0) -> int:
    try:
        return int(value) if value else default
    except ValueError:
        return default


def monotonic_from_epoch(epoch: int, now_epoch: Optional[int] = None) -> float:
    """Rebase a persisted wall-clock anchor onto this process's monotonic
    clock, preserving elapsed time (clamped so a skewed future stamp can
    not produce a negative elapsed)."""
    if now_epoch is None:
        now_epoch = int(time.time())
    return time.monotonic() - max(0, now_epoch - epoch)


class AnnotationRungStore:
    """Node-annotation persistence for the eviction escalation ladder.

    One record per node (the ladder's unit of work in every call site:
    node drains and slice evictions both group pods by host): the highest
    rung reached and the epoch it was entered.  Multiple workload pods on
    one host share the record — resume uses the max rung, which is the
    conservative direction (never *restarts* an escalation the old
    leader already committed to).
    """

    def __init__(
        self, client: KubeClient, keys: UpgradeKeys, plan=None
    ) -> None:
        self.client = client
        self.keys = keys
        # Optional write plane (k8s/writeplan.py): when wired, rung
        # clocks stage as plan intents — worker-thread durable-clock
        # patches get the same coalescing, no-op suppression, flow
        # control, and fence-at-flush as engine writes instead of
        # bypassing them with raw patches.
        self.plan = plan

    def load(self, node_name: str) -> Optional[tuple[str, int]]:
        try:
            node = self.client.get_node(node_name, cached=False)
        except Exception:
            return None
        rung = node.annotations.get(self.keys.eviction_rung_annotation)
        since = parse_epoch(
            node.annotations.get(self.keys.eviction_rung_since_annotation)
        )
        if rung not in ALL_RUNGS or since is None:
            return None
        return rung, since

    def _write(self, node_name: str, patch: dict) -> None:
        if self.plan is not None:
            self.plan.write_node(node_name, annotations=patch)
        else:
            self.client.patch_node_annotations(node_name, patch)

    def save(self, node_name: str, rung: str, epoch: int) -> None:
        try:
            self._write(
                node_name,
                {
                    self.keys.eviction_rung_annotation: rung,
                    self.keys.eviction_rung_since_annotation: str(epoch),
                },
            )
        except Exception as e:  # best-effort: never fail the drain
            logger.debug("rung save for %s failed: %s", node_name, e)

    def clear(self, node_name: str) -> None:
        try:
            self._write(
                node_name,
                {
                    self.keys.eviction_rung_annotation: None,
                    self.keys.eviction_rung_since_annotation: None,
                },
            )
        except Exception as e:
            logger.debug("rung clear for %s failed: %s", node_name, e)


def make_term_fence(client: KubeClient, keys: UpgradeKeys, term_source):
    """Term-comparison fence on top of the liveness fence.

    The liveness fence (lease renew deadline) leaves a theoretical
    window: a deposed leader's in-flight worker can act between its last
    successful renewal and the deadline, racing the successor.  The
    successor's adoption pass stamps every in-flight group's nodes with
    ``<identity>@<term>`` — so a worker that QUORUM-reads the stamp and
    finds a term HIGHER than its own knows, without waiting out any
    clock, that it has been deposed.

    Returns a callable ``fence(nodes) -> bool``: False means a
    higher-term leader has adopted at least one of the nodes and the
    worker must abandon quietly.  Checked once at worker ENTRY and at
    group barriers — not inside polling loops — so the quorum reads it
    costs stay off the steady-state hot path.  Fail-open on read errors
    (the liveness fence and idempotent passes remain the backstop; a
    fence that fails closed would wedge workers on API blips)."""

    def fence(nodes) -> bool:
        try:
            my_term = int(term_source())
        except Exception:
            return True
        for node in nodes:
            name = getattr(node, "name", node)
            try:
                live = client.get_node(name, cached=False)
            except Exception:
                continue
            stamp = parse_adoption_stamp(
                live.annotations.get(keys.adopted_by_annotation)
            )
            if stamp is not None and stamp[1] > my_term:
                logger.warning(
                    "term fence: node %s adopted by %s@%d > own term %d; "
                    "abandoning",
                    name,
                    stamp[0],
                    stamp[1],
                    my_term,
                )
                return False
        return True

    return fence


def format_adoption_stamp(identity: str, term: int) -> str:
    return f"{identity}@{term}"


def parse_adoption_stamp(value: Optional[str]) -> Optional[tuple[str, int]]:
    """Parse "<identity>@<term>"; identity may itself contain '@'."""
    if not value:
        return None
    ident, sep, term = value.rpartition("@")
    if not sep:
        return None
    parsed = parse_epoch(term)
    if parsed is None:
        return None
    return ident, parsed
