"""The typed client boundary: the verb surface the framework consumes.

The reference programs against client-go's ``client.Client`` interface
(upgrade_state.go:104-120); this is the analogue.  ``KubeClient`` is the
single source of truth for what a cluster client must provide — the
engine, sub-managers, controller, drain helper, leader elector, health
agent, and status CLI are all annotated against it, and BOTH
implementations are pinned to it two ways:

- statically: CI runs mypy over the package (``make typecheck``), so a
  drift between an annotation and an implementation is a build failure;
- at runtime: ``tests/test_client_interface.py`` asserts every method
  exists on ``FakeCluster`` AND ``RestClient`` with identical
  signatures, which catches wire-tier drift even in environments
  without a type checker (the engine was once typed against the
  fake, and RestClient rode on duck typing).

Methods intentionally NOT here (test/bench knobs of the simulation
substrate only): ``create_node``, ``create_pod``, ``update_pod``,
``set_node_ready``, ``set_eviction_blocked``, ``on_pod_deleted``,
``create_controller_revision``, ``add_daemon_set_revision``,
``fault_injector`` — production code must never call them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Protocol, Sequence, runtime_checkable

from k8s_operator_libs_tpu_torch.k8s.client import WatchEvent
from k8s_operator_libs_tpu_torch.k8s.objects import (
    ControllerRevision,
    DaemonSet,
    Node,
    Pod,
)


@runtime_checkable
class KubeClient(Protocol):
    """Everything the upgrade framework asks of a Kubernetes client."""

    # -- nodes --------------------------------------------------------------

    def get_node(
        self,
        name: str,
        cached: bool = True,
        max_staleness_s: Optional[float] = None,
    ) -> Node:
        """Read a node; ``cached=False`` is a quorum read.

        ``max_staleness_s`` bounds how stale a ``cached=True`` read may
        be: when the serving cache cannot prove it is within the bound,
        the implementation upgrades the call to a quorum read.  Callers
        whose result feeds a MUTATING decision (cordon, drain, fence
        checks) should pass a bound so a lagging cache can never drive
        an action off ancient state; pure convergence polls (the
        write-then-poll cache waits) leave it None."""
        ...

    def list_nodes(self, label_selector: str = "") -> list[Node]:
        ...

    def patch_node_labels(
        self, name: str, patch: dict[str, Optional[str]]
    ) -> Node:
        """Strategic-merge patch of ``metadata.labels`` (None deletes)."""
        ...

    def patch_node_annotations(
        self, name: str, patch: dict[str, Optional[str]]
    ) -> Node:
        """Merge patch of ``metadata.annotations`` (None deletes)."""
        ...

    def patch_node_metadata(
        self,
        name: str,
        labels: Optional[dict[str, Optional[str]]] = None,
        annotations: Optional[dict[str, Optional[str]]] = None,
        field_manager: Optional[str] = None,
    ) -> Node:
        """Combined labels+annotations patch in ONE API round trip (None
        values delete).  The write-coalescing fast path: a slice
        transition that flips the state label and stamps several durable
        clocks costs one patch per node instead of one per key-group.
        ``field_manager`` names the writer (the server-side-apply idiom)
        so apiserver audit/conflict attribution sees the write plane as
        one manager."""
        ...

    def set_node_unschedulable(
        self, name: str, unschedulable: bool
    ) -> Node:
        ...

    # -- pods ---------------------------------------------------------------

    def get_pod(self, namespace: str, name: str) -> Pod:
        ...

    def list_pods(
        self,
        namespace: str = "",
        label_selector: str = "",
        node_name: Optional[str] = None,
        match_labels: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        ...

    def delete_pod(
        self,
        namespace: str,
        name: str,
        grace_period_seconds: Optional[int] = None,
    ) -> None:
        """Delete a pod.  ``grace_period_seconds=0`` force-deletes:
        finalizers are bypassed and the object is removed immediately —
        the last rung of the eviction escalation ladder."""
        ...

    def evict_pod(self, namespace: str, name: str) -> None:
        """policy/v1 Eviction (PDB-aware; 429 → EvictionBlockedError)."""
        ...

    # -- daemonsets + revisions --------------------------------------------

    def create_daemon_set(self, ds: DaemonSet) -> DaemonSet:
        ...

    def update_daemon_set(self, ds: DaemonSet) -> DaemonSet:
        ...

    def get_daemon_set(self, namespace: str, name: str) -> DaemonSet:
        ...

    def list_daemon_sets(
        self,
        namespace: str = "",
        match_labels: Optional[dict[str, str]] = None,
    ) -> list[DaemonSet]:
        ...

    def list_controller_revisions(
        self, namespace: str = "", label_selector: str = ""
    ) -> list[ControllerRevision]:
        ...

    # -- events -------------------------------------------------------------

    def create_event(self, namespace: str, event: dict) -> dict:
        ...

    def list_events(
        self, namespace: str = "", involved_name: str = ""
    ) -> list[dict]:
        ...

    # -- custom resources ---------------------------------------------------

    def create_custom_object(
        self, group: str, version: str, plural: str, namespace: str,
        obj: dict,
    ) -> dict:
        ...

    def get_custom_object(
        self, group: str, version: str, plural: str, namespace: str,
        name: str,
    ) -> dict:
        ...

    def update_custom_object(
        self, group: str, version: str, plural: str, namespace: str,
        obj: dict,
    ) -> dict:
        ...

    def update_custom_object_status(
        self, group: str, version: str, plural: str, namespace: str,
        obj: dict,
    ) -> dict:
        ...

    def delete_custom_object(
        self, group: str, version: str, plural: str, namespace: str,
        name: str,
    ) -> None:
        ...

    def list_custom_objects(
        self, group: str, version: str, plural: str, namespace: str = ""
    ) -> list[dict]:
        ...

    # -- chunked lists + watch ---------------------------------------------

    def list_page(
        self,
        kind: str,
        namespace: str = "",
        label_selector: str = "",
        limit: Optional[int] = None,
        continue_: Optional[str] = None,
    ) -> dict:
        """``{"items", "resourceVersion", "continue"}``; expired continue
        token raises ExpiredError (410)."""
        ...

    def watch_events(
        self,
        kinds: Optional[Sequence[str]] = None,
        since_rv: Optional[int] = None,
        bookmarks: bool = False,
    ) -> Iterator[Optional[WatchEvent]]:
        """Change feed with None heartbeats; ``since_rv`` resumes with
        replay or raises ExpiredError (410); ``bookmarks`` opts into
        BOOKMARK resume-point advances on idle streams."""
        ...
