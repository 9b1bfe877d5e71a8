"""Deployment manifests for the controller and probe agents.

Counterpart of ``k8s_operator_libs_tpu.manifests`` for the port: the
ServiceAccounts, RBAC scoped to exactly the verbs the engine issues on
the wire (pinned by tests/test_torch_manifests.py, which records a full
rolling upgrade through RestClient and asserts every observed verb is
granted and every granted verb observed), and the controller Deployment,
which runs the port's controller.  The CRD is the reference's
(``config/crd/``): the port's ``api.schema`` keeps its group and kind.

    python -m k8s_operator_libs_tpu_torch.manifests          # (re)write
    python -m k8s_operator_libs_tpu_torch.manifests --check  # exit 1 if stale

render ``deploy/controller.yaml`` beside this module.
"""

from __future__ import annotations

from typing import Any, Optional

from k8s_operator_libs_tpu_torch.api.schema import POLICY_GROUP, POLICY_PLURAL
from k8s_operator_libs_tpu_torch.keys import (
    CONTROLLER_NAME,
    NODE_REPORTER_NAME,
    OPERATOR_IMAGE,
)

# NODE_REPORTER_NAME is shared by the driver pods (safe-load init
# container sets/polls its node annotation) and the health-agent pods
# (publish report annotations): both only ever get/patch their own Node.
# DriverDaemonSetSpec defaults its pods onto this ServiceAccount.
DEFAULT_IMAGE = OPERATOR_IMAGE

# The controller's API surface.  Every (group, resource, verb) the engine
# can issue; see RestClient methods and _stat_key kinds.
CONTROLLER_RBAC_RULES: list[dict[str, Any]] = [
    # BuildState reads + cordon/uncordon + state-label/annotation writes.
    {"apiGroups": [""], "resources": ["nodes"], "verbs": ["get", "list", "patch"]},
    # Pod snapshots, wait-for-jobs checks, driver-pod restarts.
    {"apiGroups": [""], "resources": ["pods"], "verbs": ["get", "list", "delete"]},
    # Drain + workload eviction go through the Eviction subresource.
    {"apiGroups": [""], "resources": ["pods/eviction"], "verbs": ["create"]},
    # Transition/failure events (kubectl describe node shows them).
    {"apiGroups": [""], "resources": ["events"], "verbs": ["create"]},
    # Driver/agent DaemonSet reconciliation.
    {
        "apiGroups": ["apps"],
        "resources": ["daemonsets"],
        "verbs": ["get", "list", "create", "update"],
    },
    # The outdated-pod detector reads ControllerRevisions.
    {
        "apiGroups": ["apps"],
        "resources": ["controllerrevisions"],
        "verbs": ["get", "list"],
    },
    # Policy-as-CR mode: read the spec, publish counters to status.
    {
        "apiGroups": [POLICY_GROUP],
        "resources": [POLICY_PLURAL],
        "verbs": ["get", "list"],
    },
    {
        "apiGroups": [POLICY_GROUP],
        "resources": [f"{POLICY_PLURAL}/status"],
        "verbs": ["update"],
    },
]

# Namespaced (Role, not ClusterRole): leader election touches exactly one
# Lease in the install namespace — a cluster-wide lease grant would let a
# compromised controller pod rewrite kube-node-lease heartbeats or hijack
# other components' elections.
CONTROLLER_NAMESPACED_RULES: list[dict[str, Any]] = [
    {
        "apiGroups": ["coordination.k8s.io"],
        "resources": ["leases"],
        "verbs": ["get", "create", "update"],
    },
]

# Driver safe-load init containers and per-host agents only read their
# own Node and patch annotations on it.
NODE_REPORTER_RBAC_RULES: list[dict[str, Any]] = [
    {"apiGroups": [""], "resources": ["nodes"], "verbs": ["get", "patch"]},
]


def _service_account(name: str, namespace: str) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {"name": name, "namespace": namespace},
    }


def _cluster_role(name: str, rules: list[dict]) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": {"name": name},
        "rules": rules,
    }


def _role(name: str, namespace: str, rules: list[dict]) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "Role",
        "metadata": {"name": name, "namespace": namespace},
        "rules": rules,
    }


def _role_binding(name: str, sa: str, namespace: str) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {"name": name, "namespace": namespace},
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "Role",
            "name": name,
        },
        "subjects": [
            {
                "kind": "ServiceAccount",
                "name": sa,
                "namespace": namespace,
            }
        ],
    }


def _cluster_role_binding(name: str, sa: str, namespace: str) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {"name": name},
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": name,
        },
        "subjects": [
            {
                "kind": "ServiceAccount",
                "name": sa,
                "namespace": namespace,
            }
        ],
    }


def controller_deployment(
    namespace: str,
    image: str,
    policy_cr: Optional[str] = None,
) -> dict:
    """Two-replica controller Deployment under leader election.

    All state lives in cluster labels and passes are idempotent, so even
    concurrent controllers only race benignly (chaos tier) — but the
    Lease keeps exactly one replica reconciling while the standby buys
    fast failover (clean shutdown releases the lease; a crash hands over
    after the term lapses)."""
    args = [
        "--namespace",
        namespace,
        "--manage-daemonset",
        "--manage-agent",
        "--metrics-port",
        "8081",
        "--leader-elect",
    ]
    if policy_cr:
        args += ["--policy-cr", policy_cr]
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": CONTROLLER_NAME,
            "namespace": namespace,
            "labels": {"app": CONTROLLER_NAME},
        },
        "spec": {
            "replicas": 2,
            "selector": {"matchLabels": {"app": CONTROLLER_NAME}},
            "template": {
                "metadata": {"labels": {"app": CONTROLLER_NAME}},
                "spec": {
                    "serviceAccountName": CONTROLLER_NAME,
                    "containers": [
                        {
                            "name": "controller",
                            "image": image,
                            "command": [
                                "python",
                                "-m",
                                "k8s_operator_libs_tpu_torch.controller",
                            ],
                            "args": args,
                            "ports": [
                                {"name": "metrics", "containerPort": 8081}
                            ],
                            "resources": {
                                "requests": {
                                    "cpu": "100m",
                                    "memory": "256Mi",
                                },
                                "limits": {"memory": "1Gi"},
                            },
                        }
                    ],
                },
            },
        },
    }


def controller_manifests(
    namespace: str = "kube-system",
    image: str = DEFAULT_IMAGE,
    policy_cr: Optional[str] = None,
) -> list[dict]:
    """Everything `kubectl apply` needs besides the CRD (config/crd/)."""
    return [
        _service_account(CONTROLLER_NAME, namespace),
        _cluster_role(CONTROLLER_NAME, CONTROLLER_RBAC_RULES),
        _cluster_role_binding(CONTROLLER_NAME, CONTROLLER_NAME, namespace),
        _role(CONTROLLER_NAME, namespace, CONTROLLER_NAMESPACED_RULES),
        _role_binding(CONTROLLER_NAME, CONTROLLER_NAME, namespace),
        _service_account(NODE_REPORTER_NAME, namespace),
        _cluster_role(NODE_REPORTER_NAME, NODE_REPORTER_RBAC_RULES),
        _cluster_role_binding(
            NODE_REPORTER_NAME, NODE_REPORTER_NAME, namespace
        ),
        controller_deployment(namespace, image, policy_cr),
    ]


# -- verb-coverage helpers (used by tests and gen tooling) -------------------

# RestClient._stat_key kind -> (apiGroup, resource).
_KIND_TO_RESOURCE = {
    "nodes": ("", "nodes"),
    "pods": ("", "pods"),
    "eviction": ("", "pods/eviction"),
    "events": ("", "events"),
    "daemonsets": ("apps", "daemonsets"),
    "controllerrevisions": ("apps", "controllerrevisions"),
    POLICY_PLURAL: (POLICY_GROUP, POLICY_PLURAL),
    f"{POLICY_PLURAL}/status": (POLICY_GROUP, f"{POLICY_PLURAL}/status"),
    "leases": ("coordination.k8s.io", "leases"),
}

_METHOD_TO_VERBS = {
    # A GET is a get or a list; RBAC needs whichever was used — we map to
    # both alternatives and accept either grant.
    "GET": ("get", "list"),
    "PATCH": ("patch",),
    "DELETE": ("delete",),
    "POST": ("create",),
    "PUT": ("update",),
}


def required_grants(stat_keys) -> set[tuple[str, str, tuple[str, ...]]]:
    """Map RestClient.stats keys ("GET nodes") to (group, resource,
    acceptable-verbs) requirements."""
    out = set()
    for key in stat_keys:
        method, _, kind = key.partition(" ")
        resource = _KIND_TO_RESOURCE.get(kind)
        verbs = _METHOD_TO_VERBS.get(method)
        if resource is None or verbs is None:
            raise ValueError(f"unmapped stat key {key!r}")
        out.add((resource[0], resource[1], verbs))
    return out


def rule_grants(rules: list[dict]) -> set[tuple[str, str, str]]:
    return {
        (group, resource, verb)
        for rule in rules
        for group in rule["apiGroups"]
        for resource in rule["resources"]
        for verb in rule["verbs"]
    }


def uncovered(stat_keys, rules: list[dict]) -> list[str]:
    """Requirements from observed traffic that no rule grants."""
    granted = rule_grants(rules)
    missing = []
    for group, resource, verbs in sorted(required_grants(stat_keys)):
        if not any((group, resource, v) in granted for v in verbs):
            missing.append(f"{group or 'core'}/{resource}: needs one of {verbs}")
    return missing


if __name__ == "__main__":
    from k8s_operator_libs_tpu_torch.manifests_cli import main

    raise SystemExit(main())
