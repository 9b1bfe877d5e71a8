"""Typed object model for the Kubernetes kinds the upgrade engine touches.

The reference (Go) uses k8s.io/api types; the engine only ever reads/writes
a narrow slice of them (SURVEY.md §3): Node labels/annotations/unschedulable/
conditions, Pod phase/readiness/owner/revision-hash, DaemonSet selector +
desired count, ControllerRevision name/revision.  This module models exactly
that slice as plain dataclasses.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    """Owner reference (only UID/kind/name are consulted by the engine)."""

    name: str
    uid: str
    kind: str = "DaemonSet"
    controller: bool = True


@dataclass
class ObjectMeta:
    name: str
    namespace: str = ""
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)
    # Non-empty finalizers hold a deleted object in Terminating (deletion
    # timestamp set, object still served) until they are removed or the
    # delete is forced with grace period 0 — the stuck-Terminating pod
    # shape the eviction escalation ladder exists to clear.
    finalizers: list[str] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    creation_timestamp: float = field(default_factory=time.time)
    resource_version: int = 1


@dataclass
class NodeCondition:
    type: str  # e.g. "Ready"
    status: str  # "True" | "False" | "Unknown"


@dataclass
class NodeSpec:
    unschedulable: bool = False


@dataclass
class NodeStatus:
    conditions: list[NodeCondition] = field(
        default_factory=lambda: [NodeCondition("Ready", "True")]
    )


@dataclass
class Node:
    metadata: ObjectMeta
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def labels(self) -> dict[str, str]:
        return self.metadata.labels

    @property
    def annotations(self) -> dict[str, str]:
        return self.metadata.annotations

    def is_ready(self) -> bool:
        """True unless a Ready condition exists with status != True
        (reference upgrade_state.go:986-993)."""
        for cond in self.status.conditions:
            if cond.type == "Ready" and cond.status != "True":
                return False
        return True


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class ContainerStatus:
    name: str = "main"
    ready: bool = True
    restart_count: int = 0


@dataclass
class Volume:
    name: str = "vol"
    empty_dir: bool = False


@dataclass
class PodSpec:
    node_name: str = ""
    volumes: list[Volume] = field(default_factory=list)


@dataclass
class PodStatus:
    phase: str = PodPhase.RUNNING
    container_statuses: list[ContainerStatus] = field(
        default_factory=lambda: [ContainerStatus()]
    )
    init_container_statuses: list[ContainerStatus] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def labels(self) -> dict[str, str]:
        return self.metadata.labels

    def is_orphaned(self) -> bool:
        """Pod with no owner references (reference upgrade_state.go:353-355)."""
        return len(self.metadata.owner_references) == 0

    def is_terminating(self) -> bool:
        return self.metadata.deletion_timestamp is not None

    def is_daemonset_pod(self) -> bool:
        return any(o.kind == "DaemonSet" for o in self.metadata.owner_references)

    def is_mirror_pod(self) -> bool:
        return "kubernetes.io/config.mirror" in self.metadata.annotations

    def uses_empty_dir(self) -> bool:
        return any(v.empty_dir for v in self.spec.volumes)

    def all_containers_ready(self) -> bool:
        statuses = self.status.container_statuses
        return len(statuses) > 0 and all(c.ready for c in statuses)


@dataclass
class LabelSelectorSpec:
    match_labels: dict[str, str] = field(default_factory=dict)


@dataclass
class PodTemplateSpec:
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    # Raw podSpec JSON (containers, initContainers, volumes, nodeSelector,
    # tolerations...).  The engine never inspects it; the driver-DaemonSet
    # reconciler builds it and the REST client serializes it verbatim.
    pod_spec: dict = field(default_factory=dict)


@dataclass
class DaemonSetSpec:
    selector: LabelSelectorSpec = field(default_factory=LabelSelectorSpec)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    # "OnDelete" (driver DS: the upgrade state machine rolls pods
    # slice-atomically, the DS controller must never split a torus) or
    # "RollingUpdate" (agent DS: pods must restart on template change so
    # DRIVER_REVISION re-pins).
    update_strategy: str = "OnDelete"


@dataclass
class DaemonSetStatus:
    desired_number_scheduled: int = 0


@dataclass
class DaemonSet:
    metadata: ObjectMeta
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ControllerRevision:
    """History entry for a DaemonSet template; its name is
    ``<ds-name>-<hash>`` and the newest ``revision`` wins
    (reference pod_manager.go:94-121)."""

    metadata: ObjectMeta
    revision: int = 1


def deep_copy(obj):
    """DeepCopy analogue for any object in this model."""
    return copy.deepcopy(obj)


# ---------------------------------------------------------------------------
# Frozen object graphs — one shared copy per watch event.
#
# The watch fan-out used to hand every subscriber its own deepcopy of every
# event object, built while holding the cluster-global lock.  Instead the
# store's single ingest copy is frozen in place (recursively, containers and
# dataclasses alike) and SHARED across all watchers: reads are unrestricted,
# any mutation raises FrozenObjectError, and ``deep_copy`` on a frozen graph
# thaws it back to plain mutable classes — so the one consumer that needs a
# private mutable copy (the informer's RV-guarded ingest) pays for exactly
# one copy, outside the cluster lock, instead of one per subscriber.
# ---------------------------------------------------------------------------


class FrozenObjectError(TypeError):
    """Raised on any attempt to mutate a shared (frozen) watch-event object."""


def _frozen_raise(self, *args, **kwargs):
    raise FrozenObjectError(
        "shared watch-event object is frozen; deep_copy() it before mutating"
    )


class FrozenDict(dict):
    """dict that raises on mutation; deep_copy() thaws to a plain dict."""

    __slots__ = ()

    __setitem__ = _frozen_raise
    __delitem__ = _frozen_raise
    clear = _frozen_raise
    pop = _frozen_raise
    popitem = _frozen_raise
    setdefault = _frozen_raise
    update = _frozen_raise
    __ior__ = _frozen_raise

    def __deepcopy__(self, memo):
        out: dict = {}
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def __copy__(self):
        return dict(self)

    def __reduce__(self):
        return (dict, (dict(self),))


class FrozenList(list):
    """list that raises on mutation; deep_copy() thaws to a plain list."""

    __slots__ = ()

    __setitem__ = _frozen_raise
    __delitem__ = _frozen_raise
    __iadd__ = _frozen_raise
    __imul__ = _frozen_raise
    append = _frozen_raise
    extend = _frozen_raise
    insert = _frozen_raise
    pop = _frozen_raise
    remove = _frozen_raise
    clear = _frozen_raise
    sort = _frozen_raise
    reverse = _frozen_raise

    def __deepcopy__(self, memo):
        out: list = []
        memo[id(self)] = out
        for v in self:
            out.append(copy.deepcopy(v, memo))
        return out

    def __copy__(self):
        return list(self)

    def __reduce__(self):
        return (list, (list(self),))


_FROZEN_CLASSES: dict[type, type] = {}


def _frozen_deepcopy(self, memo):
    """Thaw: reconstruct the plain base class, deep-copying every field."""
    base = type(self)._frozen_base_
    out = base.__new__(base)
    memo[id(self)] = out
    for name, value in vars(self).items():
        object.__setattr__(out, name, copy.deepcopy(value, memo))
    return out


def _frozen_eq(self, other):
    """Field-wise equality tolerant of plain-vs-frozen class mismatch."""
    base = type(self)._frozen_base_
    if not isinstance(other, base):
        return NotImplemented
    for f in dataclasses.fields(base):
        if getattr(self, f.name) != getattr(other, f.name):
            return False
    return True


def _frozen_class_for(cls: type) -> type:
    frozen = _FROZEN_CLASSES.get(cls)
    if frozen is None:
        frozen = type(
            "Frozen" + cls.__name__,
            (cls,),
            {
                "_frozen_base_": cls,
                "__setattr__": _frozen_raise,
                "__delattr__": _frozen_raise,
                "__deepcopy__": _frozen_deepcopy,
                "__eq__": _frozen_eq,
                "__hash__": None,
            },
        )
        _FROZEN_CLASSES[cls] = frozen
    return frozen


def is_frozen(obj) -> bool:
    """True if ``obj`` is a frozen (shared, immutable) watch-event object."""
    return isinstance(obj, (FrozenDict, FrozenList)) or (
        getattr(type(obj), "_frozen_base_", None) is not None
    )


def freeze(obj, _memo=None):
    """Recursively freeze an object graph IN PLACE and return it.

    Dataclass instances keep their identity (their ``__class__`` is swapped
    to a mutation-raising subclass); plain dict/list containers are replaced
    with Frozen variants.  Idempotent, cycle-safe, and cheap relative to a
    deepcopy: no object payloads are copied.
    """
    if _memo is None:
        _memo = {}
    oid = id(obj)
    if oid in _memo:
        return _memo[oid]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if getattr(type(obj), "_frozen_base_", None) is not None:
            return obj
        _memo[oid] = obj
        for name, value in list(vars(obj).items()):
            fv = freeze(value, _memo)
            if fv is not value:
                object.__setattr__(obj, name, fv)
        obj.__class__ = _frozen_class_for(type(obj))
        return obj
    if isinstance(obj, (FrozenDict, FrozenList)):
        return obj
    if type(obj) is dict:
        fd = FrozenDict()
        _memo[oid] = fd
        for k, v in obj.items():
            dict.__setitem__(fd, k, freeze(v, _memo))
        return fd
    if type(obj) is list:
        fl = FrozenList()
        _memo[oid] = fl
        for v in obj:
            list.append(fl, freeze(v, _memo))
        return fl
    return obj
