"""The cluster a cell runs against: the port's ``FakeCluster`` filled with
GPU Feature Discovery-labelled HGX H100 nodes, the GPU operator's driver
DaemonSet and its pods, built from a configuration file.

The objects are the port's own API types; the building is the
benchmark's, so that a change to the port's fixtures cannot move the
yardstick.
"""

from __future__ import annotations

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
from k8s_operator_libs_tpu_torch.keys import (
    DRIVER_DAEMONSET_NAME,
    DRIVER_LABELS,
    driver_keys,
)

KEYS = driver_keys()
NAMESPACE = "gpu-operator"
REVISION_LABEL = "controller-revision-hash"


class Fleet:
    """Nodes, the driver DaemonSet and pods on one ``FakeCluster``."""

    def __init__(self, api: dict) -> None:
        self.cluster = FakeCluster(api_latency_s=api["latency_s"],
                                   cache_lag_s=api["cache_lag_s"])
        self.ds: DaemonSet | None = None
        self._recreate_hash = ""

    def driver_daemon_set(self, revision_hash: str) -> DaemonSet:
        labels = dict(DRIVER_LABELS)
        ds = DaemonSet(
            metadata=ObjectMeta(name=DRIVER_DAEMONSET_NAME,
                                namespace=NAMESPACE, labels=dict(labels)),
            spec=DaemonSetSpec(selector=LabelSelectorSpec(dict(labels)),
                               template=PodTemplateSpec(labels=dict(labels))),
            status=DaemonSetStatus(desired_number_scheduled=0),
        )
        self.cluster.create_daemon_set(ds)
        self.cluster.add_daemon_set_revision(ds, revision_hash, 1)
        self.ds = ds
        return ds

    def bump(self, revision_hash: str, revision: int) -> None:
        """A new driver template: the rolling-update trigger.  Driver
        pods deleted from now on come back at ``revision_hash``."""
        self.cluster.add_daemon_set_revision(self.ds, revision_hash, revision)
        self._recreate_hash = revision_hash

    def gpu_node(self, name: str, labels: dict) -> Node:
        node = Node(metadata=ObjectMeta(name=name, labels=dict(labels)))
        self.cluster.create_node(node)
        return node

    def driver_pod(self, node: Node, revision_hash: str) -> Pod:
        ds = self.ds
        labels = dict(ds.spec.selector.match_labels)
        labels[REVISION_LABEL] = revision_hash
        pod = Pod(
            metadata=ObjectMeta(
                name=f"driver-{node.name}", namespace=NAMESPACE,
                labels=labels,
                owner_references=[OwnerReference(
                    name=ds.name, uid=ds.metadata.uid, kind="DaemonSet")],
            ),
            spec=PodSpec(node_name=node.name),
            status=PodStatus(phase=PodPhase.RUNNING,
                             container_statuses=[ContainerStatus(ready=True)]),
        )
        self.cluster.create_pod(pod)
        ds.status.desired_number_scheduled += 1
        self.cluster.update_daemon_set(ds)
        return pod

    def recreate_driver_pods(self) -> None:
        """The DaemonSet controller: a deleted driver pod comes back on its
        node from the newest template."""
        ds = self.ds

        def hook(pod: Pod) -> None:
            refs = pod.metadata.owner_references
            if not refs or refs[0].uid != ds.metadata.uid:
                return
            labels = dict(ds.spec.selector.match_labels)
            labels[REVISION_LABEL] = self._recreate_hash
            self.cluster.create_pod(Pod(
                metadata=ObjectMeta(name=pod.name, namespace=pod.namespace,
                                    labels=labels,
                                    owner_references=list(refs)),
                spec=PodSpec(node_name=pod.spec.node_name),
                status=PodStatus(
                    phase=PodPhase.RUNNING,
                    container_statuses=[ContainerStatus(ready=True)]),
            ))

        self.cluster.on_pod_deleted(hook)

    def workload_pod(self, node_name: str, name: str) -> Pod:
        """A training job's pod on ``node_name`` (owned by a Job)."""
        pod = Pod(
            metadata=ObjectMeta(
                name=name, namespace="default", labels={"app": "canary"},
                owner_references=[OwnerReference(name="canary", uid="job-1",
                                                 kind="Job")]),
            spec=PodSpec(node_name=node_name),
            status=PodStatus(phase=PodPhase.RUNNING),
        )
        self.cluster.create_pod(pod)
        return pod

    def driver_revisions(self) -> dict:
        """Each node's driver pod revision, read in one list call (a node
        whose pod is gone is missing)."""
        return {pod.spec.node_name: pod.labels.get(REVISION_LABEL, "")
                for pod in self.cluster.list_pods(NAMESPACE)}

    def driver_revision_on(self, node_name: str) -> str:
        """The revision of the driver pod now on ``node_name`` ("" when it
        is gone)."""
        return self.driver_revisions().get(node_name, "")
