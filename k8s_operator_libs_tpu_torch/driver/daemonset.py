"""NVIDIA driver DaemonSet and health-agent DaemonSet: spec builder +
reconciler.

Counterpart of ``k8s_operator_libs_tpu.driver.daemonset`` for GPU nodes.
The controller *owns* the driver DaemonSet — building a deterministic
spec for the driver pod and reconciling the live object toward it — and
the health-agent DaemonSet whose reports gate every node's return.

Design points (the reference's):

- **OnDelete update strategy**: when the template changes, the DS
  controller records a new ControllerRevision but does NOT restart pods;
  the upgrade state machine detects outdated pods via revision hashes
  and rolls them node-atomically.
- **Template hashing**: the reconciler annotates the DaemonSet with a
  content hash of the desired template; drift (image bump, env change)
  is detected by hash comparison, so reconcile is cheap and idempotent.
- **Safe-load init container**: optional; runs
  ``python -m k8s_operator_libs_tpu_torch.driver.safe_load_init``, which
  holds the driver's load until the controller has quiesced the node.

What is the GPU's: the pods tolerate the ``nvidia.com/gpu`` taint GPU
nodes carry, select nodes on GPU Feature Discovery's product label, mount
the driver root ``/run/nvidia``, and the agent runs the port's agent with
``DRIVER_NAME`` in its env (so its reports land under the controller's
keys) and sees every GPU through ``NVIDIA_VISIBLE_DEVICES=all``.  The
agent requests no ``nvidia.com/gpu`` resource: that would take the node's
GPUs away from the workloads it is there to guard.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.fleet.profiles import GPU_PRODUCT_LABELS
from k8s_operator_libs_tpu_torch.k8s.client import NotFoundError
from k8s_operator_libs_tpu_torch.k8s.objects import (
    DaemonSet,
    DaemonSetSpec,
    LabelSelectorSpec,
    ObjectMeta,
    PodTemplateSpec,
)
from k8s_operator_libs_tpu_torch.keys import (
    DEFAULT_DRIVER_NAME,
    DRIVER_DAEMONSET_NAME,
    DRIVER_NAME_ENV,
    KEY_DOMAIN,
    NODE_REPORTER_NAME,
    OPERATOR_IMAGE,
)

logger = get_logger(__name__)

TEMPLATE_HASH_ANNOTATION = f"{KEY_DOMAIN}/driver-template-hash"
# The taint GPU nodes carry (the GPU operator's and GKE's).
GPU_TAINT = "nvidia.com/gpu"
# The driver container's root on the host, where the driver installs and
# the container toolkit finds it.
DRIVER_ROOT = "/run/nvidia"
AGENT_MODULE = "k8s_operator_libs_tpu_torch.health.agent"


@dataclass
class DriverDaemonSetSpec:
    """Desired state of the NVIDIA driver DaemonSet."""

    name: str = DRIVER_DAEMONSET_NAME
    namespace: str = "kube-system"
    # The driver container's image, tagged with ``version``.
    image: str = "nvcr.io/nvidia/driver"
    version: str = "latest"
    tools_image: str = OPERATOR_IMAGE
    driver_name: str = DEFAULT_DRIVER_NAME
    # Schedule onto every GPU node by default; set to a GPU Feature
    # Discovery product (say "NVIDIA-H100-80GB-HBM3") to restrict it.
    accelerator: Optional[str] = None
    safe_load: bool = True
    env: dict[str, str] = field(default_factory=dict)
    extra_labels: dict[str, str] = field(default_factory=dict)
    # ServiceAccount the pods run under.  Both pod kinds talk to the
    # apiserver (the safe-load init container sets/polls its node
    # annotation; the agent publishes health reports), so on an RBAC
    # cluster the default SA would 403.  The port's manifests create
    # this account bound to the node-reporter ClusterRole.
    service_account: str = NODE_REPORTER_NAME

    @property
    def selector_labels(self) -> dict[str, str]:
        """The IMMUTABLE pod selector: the DaemonSet's name, as the GPU
        operator labels its driver pods (the controller's default
        selector).  The apiserver rejects any spec.selector change for
        the DaemonSet's lifetime, so extra_labels must never leak in."""
        return {"app": self.name}

    @property
    def labels(self) -> dict[str, str]:
        return {
            **self.selector_labels,
            "app.kubernetes.io/managed-by": "tpu-operator-libs",
            **self.extra_labels,
        }

    def pod_spec(self) -> dict:
        return _pod_spec(self)

    # DaemonSet rolling semantics: the driver DS is OnDelete — the
    # upgrade state machine rolls its pods node-atomically.
    update_strategy = "OnDelete"


def _base_pod(spec: DriverDaemonSetSpec) -> tuple[dict, list]:
    """Shared GPU-host pod skeleton + env list: priority, host network,
    the nvidia.com/gpu taint toleration, survival of the cordon the
    upgrade itself performs, NODE_NAME downward API, DRIVER_NAME,
    optional product pinning.  Both the driver and agent pods build on
    this — a taint or env fix must land in exactly one place."""
    env = [{"name": k, "value": v} for k, v in sorted(spec.env.items())]
    env.append(
        {
            "name": "NODE_NAME",
            "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}},
        }
    )
    env.append({"name": DRIVER_NAME_ENV, "value": spec.driver_name})
    pod: dict = {
        "priorityClassName": "system-node-critical",
        "serviceAccountName": spec.service_account,
        "hostNetwork": True,
        "tolerations": [
            # GPU nodes carry the nvidia.com/gpu taint; driver and agent
            # must land there anyway — and must also survive the cordon
            # their own upgrade performs.
            {"key": GPU_TAINT, "operator": "Exists"},
            {"key": "node.kubernetes.io/unschedulable",
             "operator": "Exists", "effect": "NoSchedule"},
        ],
    }
    if spec.accelerator:
        pod["nodeSelector"] = {GPU_PRODUCT_LABELS[0]: spec.accelerator}
    return pod, env


def _pod_spec(spec: DriverDaemonSetSpec) -> dict:
    """Raw podSpec JSON for the driver pod (serialized verbatim by the
    REST client)."""
    pod, env = _base_pod(spec)
    pod["containers"] = [
        {
            "name": "nvidia-driver-ctr",
            "image": f"{spec.image}:{spec.version}",
            "env": env,
            "securityContext": {"privileged": True},
            "volumeMounts": [
                {"name": "run-nvidia", "mountPath": DRIVER_ROOT,
                 "mountPropagation": "Bidirectional"},
            ],
        }
    ]
    pod["volumes"] = [
        {"name": "run-nvidia",
         "hostPath": {"path": DRIVER_ROOT, "type": "DirectoryOrCreate"}},
    ]
    if spec.safe_load:
        pod["initContainers"] = [
            {
                "name": "safe-load",
                "image": spec.tools_image,
                "command": [
                    "python",
                    "-m",
                    "k8s_operator_libs_tpu_torch.driver.safe_load_init",
                ],
                "env": env,
            }
        ]
    return pod


def template_hash(spec: DriverDaemonSetSpec) -> str:
    """Content hash of everything that defines the pod template."""
    blob = json.dumps(
        {"pod": spec.pod_spec(), "labels": spec.labels},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_daemon_set(spec: DriverDaemonSetSpec) -> DaemonSet:
    return DaemonSet(
        metadata=ObjectMeta(
            name=spec.name,
            namespace=spec.namespace,
            labels=spec.labels,
            annotations={TEMPLATE_HASH_ANNOTATION: template_hash(spec)},
        ),
        spec=DaemonSetSpec(
            selector=LabelSelectorSpec(dict(spec.selector_labels)),
            template=PodTemplateSpec(
                labels=dict(spec.labels),
                pod_spec=spec.pod_spec(),
            ),
            update_strategy=spec.update_strategy,
        ),
    )


@dataclass
class AgentDaemonSetSpec(DriverDaemonSetSpec):
    """Desired state of the per-host health-probe-agent DaemonSet.

    One agent pod per GPU host (``health.agent``): it probes the host's
    GPUs and publishes per-host HealthReport annotations the validation
    gate aggregates.  ``driver_revision`` is stamped into the pod env:
    when the controller observes a new driver ControllerRevision it
    re-reconciles this spec, the template hash changes, and the agents
    restart probing under — and reporting — the new revision (reports
    pinned to the old revision can never validate the new driver)."""

    name: str = "nvidia-health-agent"
    probe_interval_s: float = 30.0
    deep: bool = False
    driver_revision: str = ""
    # "host[:port]" peer endpoints across the DCN; when set the agents
    # run the dcn_reachability check (SliceHealthGateSpec.dcn_check gates
    # on it).
    dcn_peers: tuple[str, ...] = ()
    # This pool's DCN group name plus every group expected in the
    # cross-host torch.distributed world; when both are set the agents
    # run the dcn_collective check, a cross-host all-reduce.
    dcn_group: str = ""
    dcn_expected_groups: tuple[str, ...] = ()

    # RollingUpdate is the point: a template change (new DRIVER_REVISION)
    # must restart the agent pods, or they would keep publishing reports
    # pinned to the old revision and the gate could never pass.  Agent
    # restarts don't touch the workloads — only the driver DS is OnDelete.
    update_strategy = "RollingUpdate"

    def pod_spec(self) -> dict:
        pod, env = _base_pod(self)
        env += [
            {"name": "DRIVER_REVISION", "value": self.driver_revision},
            {
                "name": "HEALTH_PROBE_INTERVAL_S",
                "value": str(self.probe_interval_s),
            },
            # Every GPU of the host, without a resource request.
            {"name": "NVIDIA_VISIBLE_DEVICES", "value": "all"},
        ]
        if self.deep:
            env.append({"name": "HEALTH_DEEP_PROBE", "value": "1"})
        if self.dcn_peers:
            env.append(
                {"name": "HEALTH_DCN_PEERS", "value": ",".join(self.dcn_peers)}
            )
        if self.dcn_group:
            env.append(
                {"name": "HEALTH_DCN_GROUP", "value": self.dcn_group}
            )
        if self.dcn_expected_groups:
            env.append(
                {
                    "name": "HEALTH_DCN_GROUPS",
                    "value": ",".join(self.dcn_expected_groups),
                }
            )
        pod["containers"] = [
            {
                "name": "health-agent",
                "image": self.tools_image,
                "command": ["python", "-m", AGENT_MODULE],
                "env": env,
                # Device access for the probe battery.
                "securityContext": {"privileged": True},
            }
        ]
        return pod


class DriverSetReconciler:
    """Idempotently drive the live DaemonSet toward the desired spec."""

    def __init__(self, client, spec: DriverDaemonSetSpec) -> None:
        self.client = client
        self.spec = spec

    def reconcile(self) -> str:
        """Returns one of "created" | "updated" | "unchanged"."""
        desired = build_daemon_set(self.spec)
        want_hash = desired.metadata.annotations[TEMPLATE_HASH_ANNOTATION]
        try:
            live = self.client.get_daemon_set(
                self.spec.namespace, self.spec.name
            )
        except NotFoundError:
            self.client.create_daemon_set(desired)
            logger.info(
                "created driver DaemonSet %s/%s (template %s)",
                self.spec.namespace,
                self.spec.name,
                want_hash,
            )
            return "created"
        live_hash = live.metadata.annotations.get(TEMPLATE_HASH_ANNOTATION)
        if live_hash == want_hash:
            return "unchanged"
        # Preserve identity/metadata the apiserver owns, and NEVER rewrite
        # spec.selector — it is immutable for the DaemonSet's lifetime and
        # a changed selector would 422 every reconcile forever.
        live.metadata.labels = desired.metadata.labels
        live.metadata.annotations[TEMPLATE_HASH_ANNOTATION] = want_hash
        desired.spec.selector = live.spec.selector
        live.spec = desired.spec
        self.client.update_daemon_set(live)
        logger.info(
            "updated driver DaemonSet %s/%s: template %s -> %s "
            "(OnDelete: pods roll via the upgrade state machine)",
            self.spec.namespace,
            self.spec.name,
            live_hash,
            want_hash,
        )
        return "updated"
