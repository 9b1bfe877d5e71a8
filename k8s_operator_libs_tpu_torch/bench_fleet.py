"""The port's fleets: the JAX package's test fixtures, then GPU nodes as
GPU Feature Discovery labels them.

The first part is ``tests/fixtures.py`` with the package prefix
rewritten (``tests/test_torch_control_plane.py`` holds it to that file's
code), so the port's bench and guard build the reference's fleets
without importing ``tests/``: ``ClusterFixture`` (DaemonSets, TPU-sliced
nodes, driver and workload pods, the DaemonSet controller's recreate
hook), ``make_node`` and the reference's ``DRIVER_LABELS`` and
``NAMESPACE``.

The second part is the port's own: :class:`GpuFleet`, a
``ClusterFixture`` that also builds HGX H100 nodes labelled as GPU
Feature Discovery labels them (``nvidia.com/gpu.product``,
``nvidia.com/gpu.count`` 8) and in no slice, so the engine makes each
node its own upgrade group and its own dirty-set pool, and the GPU
operator's driver DaemonSet.
"""

from __future__ import annotations

import itertools
from typing import Optional

from k8s_operator_libs_tpu_torch.k8s import (
    ContainerStatus,
    DaemonSet,
    FakeCluster,
    Node,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
)
from k8s_operator_libs_tpu_torch.k8s.objects import (
    DaemonSetSpec,
    DaemonSetStatus,
    LabelSelectorSpec,
    PodSpec,
    PodStatus,
    PodTemplateSpec,
)
from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys, UpgradeState
from k8s_operator_libs_tpu_torch.upgrade import consts as C

_seq = itertools.count(1)

DRIVER_LABELS = {"app": "libtpu-driver"}
NAMESPACE = "driver-ns"


class ClusterFixture:
    """Builds driver DaemonSets, nodes (plain or TPU-sliced) and pods."""

    def __init__(
        self,
        client: FakeCluster,
        keys: Optional[UpgradeKeys] = None,
        namespace: str = NAMESPACE,
    ) -> None:
        self.client = client
        self.keys = keys or UpgradeKeys()
        self.namespace = namespace
        # Per-DaemonSet recreate-hook state (see auto_recreate_driver_pods).
        self._recreate_state: dict = {}

    # -- daemonsets ----------------------------------------------------------

    def daemon_set(
        self,
        name: str = "libtpu",
        hash_suffix: str = "hash-1",
        revision: int = 1,
        labels: Optional[dict] = None,
        namespace: Optional[str] = None,
    ) -> DaemonSet:
        labels = dict(labels if labels is not None else DRIVER_LABELS)
        ds = DaemonSet(
            metadata=ObjectMeta(
                name=name,
                namespace=namespace or self.namespace,
                labels=dict(labels),
            ),
            spec=DaemonSetSpec(
                selector=LabelSelectorSpec(dict(labels)),
                template=PodTemplateSpec(labels=dict(labels)),
            ),
            status=DaemonSetStatus(desired_number_scheduled=0),
        )
        self.client.create_daemon_set(ds)
        self.client.add_daemon_set_revision(ds, hash_suffix, revision)
        return ds

    def bump_daemon_set_template(
        self, ds: DaemonSet, hash_suffix: str, revision: int
    ) -> None:
        """Record a new template revision (rolling-update trigger)."""
        self.client.add_daemon_set_revision(ds, hash_suffix, revision)

    # -- nodes ---------------------------------------------------------------

    def node(
        self,
        name: Optional[str] = None,
        state: Optional[UpgradeState] = None,
        unschedulable: bool = False,
        ready: bool = True,
        annotations: Optional[dict] = None,
        labels: Optional[dict] = None,
    ) -> Node:
        name = name or f"node-{next(_seq)}"
        node_labels = dict(labels or {})
        if state is not None and state != UpgradeState.UNKNOWN:
            node_labels[self.keys.state_label] = state.value
        node = Node(
            metadata=ObjectMeta(
                name=name, labels=node_labels, annotations=dict(annotations or {})
            )
        )
        node.spec.unschedulable = unschedulable
        if not ready:
            node.status.conditions[0].status = "False"
        self.client.create_node(node)
        return node

    def tpu_node(
        self,
        slice_id: str,
        worker_id: int,
        name: Optional[str] = None,
        accelerator: str = "tpu-v5p-slice",
        topology: str = "2x2x4",
        state: Optional[UpgradeState] = None,
        dcn_group: Optional[str] = None,
        chips_per_host: int = 0,
        **kwargs,
    ) -> Node:
        """A node belonging to a (possibly multi-host) TPU slice, carrying
        the GKE TPU labels slice discovery reads."""
        labels = {
            C.GKE_TPU_ACCELERATOR_LABEL: accelerator,
            C.GKE_TPU_TOPOLOGY_LABEL: topology,
            C.GKE_TPU_WORKER_ID_LABEL: str(worker_id),
            C.GKE_NODEPOOL_LABEL: slice_id,
        }
        if dcn_group:
            labels[self.keys.dcn_group_label] = dcn_group
        if chips_per_host:
            labels[self.keys.chips_per_host_label] = str(chips_per_host)
        labels.update(kwargs.pop("labels", {}))
        return self.node(
            name=name or f"{slice_id}-w{worker_id}", state=state,
            labels=labels, **kwargs,
        )

    # v5p topologies by host count (4 chips per host).
    _TOPOLOGY_FOR_HOSTS = {1: "2x2x1", 2: "2x2x2", 4: "2x2x4", 8: "2x4x4",
                           16: "4x4x4"}

    def tpu_slice(
        self,
        slice_id: str,
        hosts: int = 4,
        state: Optional[UpgradeState] = None,
        topology: Optional[str] = None,
        **kwargs,
    ) -> list[Node]:
        if topology is None:
            topology = self._TOPOLOGY_FOR_HOSTS[hosts]
        return [
            self.tpu_node(slice_id, i, state=state, topology=topology, **kwargs)
            for i in range(hosts)
        ]

    # -- pods ----------------------------------------------------------------

    def driver_pod(
        self,
        node: Node,
        ds: Optional[DaemonSet],
        hash_suffix: str = "hash-1",
        phase: str = PodPhase.RUNNING,
        ready: bool = True,
        restart_count: int = 0,
        terminating: bool = False,
        name: Optional[str] = None,
    ) -> Pod:
        """Driver pod owned by the DaemonSet (or orphaned if ds is None),
        carrying the controller-revision-hash label the outdated-detector
        compares (pod_manager.go:87-92).  Pod labels follow the owning
        DaemonSet's selector (custom consumer labels included)."""
        labels = dict(
            ds.spec.selector.match_labels if ds is not None else DRIVER_LABELS
        )
        labels["controller-revision-hash"] = hash_suffix
        meta = ObjectMeta(
            name=name or f"driver-{node.name}",
            namespace=ds.namespace if ds is not None else self.namespace,
            labels=labels,
        )
        if ds is not None:
            meta.owner_references = [
                OwnerReference(name=ds.name, uid=ds.metadata.uid, kind="DaemonSet")
            ]
        if terminating:
            meta.deletion_timestamp = 1.0
        pod = Pod(
            metadata=meta,
            spec=PodSpec(node_name=node.name),
            status=PodStatus(
                phase=phase,
                container_statuses=[
                    ContainerStatus(ready=ready, restart_count=restart_count)
                ],
            ),
        )
        self.client.create_pod(pod)
        if ds is not None:
            ds.status.desired_number_scheduled += 1
            self.client.update_daemon_set(ds)
        return pod

    def workload_pod(
        self,
        node: Node,
        name: Optional[str] = None,
        labels: Optional[dict] = None,
        phase: str = PodPhase.RUNNING,
        owned: bool = True,
        namespace: str = "default",
    ) -> Pod:
        meta = ObjectMeta(
            name=name or f"wl-{node.name}-{next(_seq)}",
            namespace=namespace,
            labels=dict(labels or {}),
        )
        if owned:
            meta.owner_references = [
                OwnerReference(name="job", uid="job-1", kind="Job")
            ]
        pod = Pod(
            metadata=meta,
            spec=PodSpec(node_name=node.name),
            status=PodStatus(phase=phase),
        )
        self.client.create_pod(pod)
        return pod

    # -- behaviors -----------------------------------------------------------

    def auto_recreate_driver_pods(
        self, ds: DaemonSet, hash_suffix: str, ready: bool = True
    ) -> None:
        """Emulate the DaemonSet controller: when a driver pod dies, recreate
        it from the current template (new revision hash).

        Calling again for the same DaemonSet (a second template bump,
        multi-revision scenarios) UPDATES the recreate hash instead of
        stacking a second hook — two live hooks would race to recreate
        the pod at different revisions."""
        state = self._recreate_state.setdefault(
            ds.metadata.uid, {"registered": False}
        )
        state["hash"] = hash_suffix
        state["ready"] = ready
        if state["registered"]:
            return
        state["registered"] = True

        def hook(pod: Pod) -> None:
            hash_suffix = state["hash"]
            ready = state["ready"]
            selector = ds.spec.selector.match_labels
            if not all(pod.labels.get(k) == v for k, v in selector.items()):
                return
            if not pod.metadata.owner_references:
                return
            if pod.metadata.owner_references[0].uid != ds.metadata.uid:
                return
            labels = dict(selector)
            labels["controller-revision-hash"] = hash_suffix
            new_pod = Pod(
                metadata=ObjectMeta(
                    name=pod.name,
                    namespace=pod.namespace,
                    labels=labels,
                    owner_references=list(pod.metadata.owner_references),
                ),
                spec=PodSpec(node_name=pod.spec.node_name),
                status=PodStatus(
                    phase=PodPhase.RUNNING,
                    container_statuses=[ContainerStatus(ready=ready)],
                ),
            )
            self.client.create_pod(new_pod)

        self.client.on_pod_deleted(hook)


def state_of(client: FakeCluster, keys: UpgradeKeys, node_name: str) -> str:
    return client.get_node(node_name).labels.get(keys.state_label, "")


def make_node(
    name: str,
    labels: Optional[dict] = None,
    annotations: Optional[dict] = None,
) -> Node:
    """A standalone Node object (not registered in any cluster) for tests
    that exercise pure logic over node metadata."""
    return Node(
        metadata=ObjectMeta(
            name=name,
            labels=dict(labels or {}),
            annotations=dict(annotations or {}),
        )
    )


# -- the port's own part: GPU Feature Discovery-labelled HGX H100 nodes ----

from k8s_operator_libs_tpu_torch.fleet.profiles import (  # noqa: E402
    GPU_COUNT_LABELS,
    GPU_PRODUCT_LABELS,
    generation_of,
)
from k8s_operator_libs_tpu_torch.keys import (  # noqa: E402
    DRIVER_DAEMONSET_NAME,
    DRIVER_LABELS as GPU_DRIVER_LABELS,
)

GPUS_PER_NODE = 8
# The GPU operator's namespace.
GPU_NAMESPACE = "gpu-operator"
# GPU Feature Discovery's product label of each H100 generation of
# fleet/profiles.py, oldest first.
GFD_PRODUCTS = {
    generation_of(product): product
    for product in (
        "NVIDIA-H100-PCIe", "NVIDIA-H100-80GB-HBM3", "NVIDIA-H100-NVL",
    )
}
SXM = GFD_PRODUCTS["h100-sxm"]


class GpuFleet(ClusterFixture):
    """A ``ClusterFixture`` that also builds GFD-labelled HGX H100 nodes,
    each in no slice, and the GPU operator's driver DaemonSet."""

    def gpu_node(
        self,
        name: str,
        product: str = SXM,
        state: Optional[UpgradeState] = None,
        labels: Optional[dict] = None,
    ) -> Node:
        """An HGX H100 node as GPU Feature Discovery labels it, with
        ``labels`` besides (a DCN ring, say)."""
        return self.node(name=name, state=state, labels={
            GPU_PRODUCT_LABELS[0]: product,
            GPU_COUNT_LABELS[0]: str(GPUS_PER_NODE),
            **(labels or {}),
        })

    def gpu_nodes(
        self,
        prefix: str,
        count: int,
        state: Optional[UpgradeState] = None,
        product: str = SXM,
    ) -> list[Node]:
        """``count`` GFD-labelled nodes named as ``tpu_slice`` names a
        slice's hosts (``<prefix>-w<i>``), each its own group."""
        return [self.gpu_node(f"{prefix}-w{i}", product, state)
                for i in range(count)]

    def driver_daemon_set(self, hash_suffix: str, revision: int) -> DaemonSet:
        """The GPU operator's driver DaemonSet
        (``nvidia-driver-daemonset``) in this fixture's namespace."""
        return self.daemon_set(DRIVER_DAEMONSET_NAME, hash_suffix, revision,
                               labels=GPU_DRIVER_LABELS)
