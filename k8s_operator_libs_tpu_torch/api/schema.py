"""CRD schema generation: the controller-gen analogue.

The reference generates its CRD machinery with controller-gen (deepcopy in
``api/upgrade/v1alpha1/zz_generated.deepcopy.go:29``, driven by ``make
generate``, reference ``Makefile:60-66``) and relies on kubebuilder markers
(``api/upgrade/v1alpha1/upgrade_spec.go:27-110``) for defaults/validation,
which consumer operators compile into CRD OpenAPI schemas.  Here the spec
types are dataclasses, so the same artifacts are *derived* instead of
template-generated:

- :func:`spec_schema` introspects a ``_SpecBase`` dataclass into an
  OpenAPI v3 **structural schema** (types from annotations, defaults from
  field defaults, descriptions from the ``#`` comments above each field —
  the moral equivalent of controller-gen reading Go doc comments, and the
  validation markers from :data:`_CONSTRAINTS`).
- :func:`crd_manifest` wraps it into a full
  ``apiextensions.k8s.io/v1 CustomResourceDefinition`` for
  ``TPUUpgradePolicy`` (written to ``config/crd/`` by ``tools/gen_crd.py``,
  checked for drift in CI like the reference's go-check job,
  ``.github/workflows/ci.yaml:33-41``).
- :func:`validate_object` is a miniature structural-schema validator so
  the controller rejects a malformed policy file with apiserver-style
  messages instead of silently dropping unknown fields.
"""

from __future__ import annotations

import inspect
import re
from dataclasses import MISSING, fields
from typing import Any, Union, get_args, get_origin, get_type_hints

from k8s_operator_libs_tpu_torch.api.v1alpha1 import (
    IntOrString,
    PlanningSpec,
    SliceTopologySpec,
    TPUUpgradePolicySpec,
    _SpecBase,
    _camel,
    _JSON_NAME_OVERRIDES,
)
from k8s_operator_libs_tpu_torch.artifacts.dag import GATE_MODES, SKEW_MODES

# ---------------------------------------------------------------------------
# Validation markers — the kubebuilder-marker analogue, keyed by
# (dataclass name, python field name).  Kept here, next to the generator,
# so the CRD and the runtime validator can never disagree.
# ---------------------------------------------------------------------------

_CONSTRAINTS: dict[tuple[str, str], dict[str, Any]] = {
    # Reference upgrade_spec.go:33-38 (+kubebuilder:validation:Minimum=0).
    ("DriverUpgradePolicySpec", "max_parallel_upgrades"): {"minimum": 0},
    ("TPUUpgradePolicySpec", "max_parallel_upgrades"): {"minimum": 0},
    ("WaitForCompletionSpec", "timeout_second"): {"minimum": 0},
    ("PodDeletionSpec", "timeout_second"): {"minimum": 0},
    ("DrainSpec", "timeout_second"): {"minimum": 0},
    ("TPUUpgradePolicySpec", "unavailability_unit"): {
        "enum": list(TPUUpgradePolicySpec.UNAVAILABILITY_UNITS)
    },
    ("TPUUpgradePolicySpec", "stuck_threshold_second"): {"minimum": 0},
    # Derived from the runtime rule so the CRD can't drift from validate()
    # (empty string = unset is also admitted).
    ("SliceTopologySpec", "topology"): {
        "pattern": SliceTopologySpec._TOPOLOGY_RE.pattern + "|^$"
    },
    ("SliceTopologySpec", "hosts_per_slice"): {"minimum": 0},
    ("SliceHealthGateSpec", "all_reduce_timeout_second"): {"minimum": 0},
    ("SliceHealthGateSpec", "timeout_second"): {"minimum": 0},
    ("SliceHealthGateSpec", "min_reformation_fraction"): {
        "minimum": 0.0,
        "maximum": 1.0,
    },
    ("EvictionEscalationSpec", "evict_timeout_second"): {"minimum": 0},
    ("EvictionEscalationSpec", "delete_timeout_second"): {"minimum": 0},
    ("SliceQuarantineSpec", "ready_dwell_second"): {"minimum": 0},
    ("ElasticCoordinationSpec", "offer_timeout_second"): {"minimum": 0},
    ("ElasticCoordinationSpec", "rejoin_timeout_second"): {"minimum": 0},
    ("PoolSpec", "name"): {"pattern": "^.+$"},
    ("PoolSpec", "max_parallel_upgrades"): {"minimum": 0},
    ("PlanningSpec", "drift_threshold_second"): {"minimum": 0},
    ("PlanningSpec", "replan_interval_second"): {"minimum": 0},
    ("PlanningSpec", "max_replans"): {"minimum": 0},
    ("PlanningSpec", "admission_mode"): {
        "enum": list(PlanningSpec.ADMISSION_MODES)
    },
    ("FederationClusterSpec", "name"): {"pattern": "^.+$"},
    ("FederationClusterSpec", "region"): {"pattern": "^.+$"},
    ("FederationCanarySpec", "region"): {"pattern": "^.+$"},
    ("FederationCanarySpec", "soak_second"): {"minimum": 0},
    ("FederationSpec", "max_parallel_upgrades"): {"minimum": 0},
    ("FederationSpec", "degraded_after_probes"): {"minimum": 1},
    ("FederationSpec", "partitioned_after_probes"): {"minimum": 1},
    ("FederationSpec", "heal_probes"): {"minimum": 1},
    ("FederationSpec", "lease_duration_second"): {"minimum": 0},
    ("ArtifactSpec", "name"): {"pattern": "^[a-z0-9]([a-z0-9.-]*[a-z0-9])?$"},
    ("ArtifactSpec", "gate"): {"enum": list(GATE_MODES)},
    ("ArtifactEdgeSpec", "before"): {"pattern": "^.+$"},
    ("ArtifactEdgeSpec", "after"): {"pattern": "^.+$"},
    ("ArtifactEdgeSpec", "skew"): {"enum": list(SKEW_MODES)},
}


# ---------------------------------------------------------------------------
# Field descriptions from source comments
# ---------------------------------------------------------------------------

_FIELD_DEF_RE = re.compile(r"^\s+(\w+)\s*:\s*[^=#]+(?:=.*)?$")


def _field_comments(cls: type) -> dict[str, str]:
    """Collect the ``#`` comment block directly above each field definition,
    walking the MRO so inherited fields keep their descriptions."""
    out: dict[str, str] = {}
    for klass in reversed(cls.__mro__):
        if not hasattr(klass, "__dataclass_fields__"):
            continue
        try:
            src = inspect.getsource(klass)
        except (OSError, TypeError):  # pragma: no cover - source unavailable
            continue
        pending: list[str] = []
        for line in src.splitlines():
            stripped = line.strip()
            if stripped.startswith("#"):
                pending.append(stripped.lstrip("#").strip())
                continue
            m = _FIELD_DEF_RE.match(line)
            if m and m.group(1) in klass.__dataclass_fields__:
                if pending:
                    out[m.group(1)] = " ".join(pending)
            pending = []
    return out


def _doc_first_paragraph(cls: type) -> str:
    doc = inspect.getdoc(cls) or ""
    return doc.split("\n\n")[0].replace("\n", " ").strip()


# ---------------------------------------------------------------------------
# Schema generation
# ---------------------------------------------------------------------------


def _unwrap_optional(hint: Any) -> Any:
    if get_origin(hint) is Union:
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return hint


def _default_json(value: Any) -> Any:
    if isinstance(value, _SpecBase):
        return value.to_dict()
    if isinstance(value, IntOrString):
        return value.value
    return value


def spec_schema(cls: type = TPUUpgradePolicySpec) -> dict[str, Any]:
    """OpenAPI v3 structural schema for a ``_SpecBase`` dataclass."""
    hints = get_type_hints(cls)
    comments = _field_comments(cls)
    props: dict[str, Any] = {}
    for f in fields(cls):
        hint = _unwrap_optional(hints[f.name])
        key = _JSON_NAME_OVERRIDES.get(f.name, _camel(f.name))
        origin = get_origin(hint)
        if origin is list:
            (item_hint,) = get_args(hint)
            if isinstance(item_hint, type) and issubclass(
                item_hint, _SpecBase
            ):
                items = spec_schema(item_hint)
            elif item_hint is str:
                items = {"type": "string"}
            else:  # pragma: no cover - no such list item types today
                raise TypeError(
                    f"{cls.__name__}.{f.name}: unmapped list item "
                    f"type {item_hint!r}"
                )
            sub = {"type": "array", "items": items}
        elif origin is dict:
            # Only string->string maps appear today (node selectors).
            sub = {
                "type": "object",
                "additionalProperties": {"type": "string"},
            }
        elif isinstance(hint, type) and issubclass(hint, _SpecBase):
            sub = spec_schema(hint)
        elif hint is IntOrString:
            # apiextensions IntOrString marker (reference
            # upgrade_spec.go:39-45 uses apimachinery intstr).
            sub = {"x-kubernetes-int-or-string": True}
        elif hint is bool:
            sub = {"type": "boolean"}
        elif hint is int:
            sub = {"type": "integer"}
        elif hint is float:
            sub = {"type": "number"}
        elif hint is str:
            sub = {"type": "string"}
        else:  # pragma: no cover - no such field types today
            raise TypeError(f"{cls.__name__}.{f.name}: unmapped type {hint!r}")
        sub.update(_CONSTRAINTS.get((cls.__name__, f.name), {}))
        if f.name in comments:
            sub.setdefault("description", comments[f.name])
        default: Any = MISSING
        if f.default is not MISSING:
            default = f.default
        elif f.default_factory is not MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        if default is not MISSING and default is not None:
            sub["default"] = _default_json(default)
        props[key] = sub
    schema: dict[str, Any] = {"type": "object", "properties": props}
    desc = _doc_first_paragraph(cls)
    if desc:
        schema["description"] = desc
    return schema


POLICY_GROUP = "upgrade.tpu.google.com"
POLICY_VERSION = "v1alpha1"
POLICY_PLURAL = "tpuupgradepolicies"
POLICY_KIND = "TPUUpgradePolicy"


def crd_manifest(
    group: str = POLICY_GROUP,
    kind: str = POLICY_KIND,
    plural: str = POLICY_PLURAL,
    version: str = POLICY_VERSION,
    spec_cls: type = TPUUpgradePolicySpec,
) -> dict[str, Any]:
    """Full CustomResourceDefinition manifest embedding the policy schema."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": plural,
                "singular": kind.lower(),
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": version,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    # `kubectl get tpuupgradepolicy` shows roll progress
                    # from the status the controller publishes.
                    "additionalPrinterColumns": [
                        {
                            "name": "Auto",
                            "type": "boolean",
                            "jsonPath": ".spec.autoUpgrade",
                        },
                        {
                            "name": "Done",
                            "type": "integer",
                            "jsonPath": ".status.upgradesDone",
                        },
                        {
                            "name": "In-Progress",
                            "type": "integer",
                            "jsonPath": ".status.upgradesInProgress",
                        },
                        {
                            "name": "Failed",
                            "type": "integer",
                            "jsonPath": ".status.upgradesFailed",
                        },
                        {
                            "name": "Age",
                            "type": "date",
                            "jsonPath": ".metadata.creationTimestamp",
                        },
                    ],
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "apiVersion": {"type": "string"},
                                "kind": {"type": "string"},
                                "metadata": {"type": "object"},
                                "spec": spec_schema(spec_cls),
                                "status": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields": True,
                                },
                            },
                        }
                    },
                }
            ],
        },
    }


def register_policy_crd(cluster) -> None:
    """Install the TPUUpgradePolicy CRD on a cluster/store (the runtime
    analogue of ``kubectl apply -f config/crd/``): enables the CR routes
    and wires the generated schema in as the admission validator, so an
    invalid CR is rejected 422 with field paths."""
    schema = spec_schema(TPUUpgradePolicySpec)

    def _validate(obj: dict) -> list[str]:
        return validate_object(obj.get("spec") or {}, schema)

    cluster.register_custom_resource(
        POLICY_GROUP, POLICY_VERSION, POLICY_PLURAL, validator=_validate
    )


# ---------------------------------------------------------------------------
# Miniature structural-schema validator
# ---------------------------------------------------------------------------


def validate_object(
    obj: Any, schema: dict[str, Any], path: str = "spec"
) -> list[str]:
    """Validate ``obj`` against a schema produced above.

    Returns apiserver-style error strings (empty list = valid).  Stricter
    than apiserver pruning on one point: unknown fields are *errors*, not
    silently dropped — a typoed key in a local policy file should fail
    loudly (``from_dict`` tolerates unknowns for wire compatibility,
    v1alpha1.py:119).
    """
    errors: list[str] = []
    if schema.get("x-kubernetes-int-or-string"):
        if not isinstance(obj, (int, str)) or isinstance(obj, bool):
            errors.append(f"{path}: must be an integer or a string")
        return errors
    typ = schema.get("type")
    if typ == "array":
        if not isinstance(obj, list):
            return [f"{path}: must be an array, got {type(obj).__name__}"]
        items = schema.get("items", {})
        for i, item in enumerate(obj):
            errors.extend(validate_object(item, items, f"{path}[{i}]"))
        return errors
    if typ == "object":
        if not isinstance(obj, dict):
            return [f"{path}: must be an object, got {type(obj).__name__}"]
        if schema.get("x-kubernetes-preserve-unknown-fields"):
            return errors
        extra = schema.get("additionalProperties")
        if extra is not None and "properties" not in schema:
            # Map type (e.g. a node selector): every value validates
            # against the additionalProperties schema, any key admitted.
            for key, val in obj.items():
                errors.extend(validate_object(val, extra, f"{path}.{key}"))
            return errors
        props = schema.get("properties", {})
        for key, val in obj.items():
            sub = props.get(key)
            if sub is None:
                errors.append(f'{path}.{key}: unknown field "{key}"')
            elif val is not None:
                errors.extend(validate_object(val, sub, f"{path}.{key}"))
        return errors
    if typ == "boolean" and not isinstance(obj, bool):
        return [f"{path}: must be a boolean, got {type(obj).__name__}"]
    if typ == "integer" and (isinstance(obj, bool) or not isinstance(obj, int)):
        return [f"{path}: must be an integer, got {type(obj).__name__}"]
    if typ == "number" and (
        isinstance(obj, bool) or not isinstance(obj, (int, float))
    ):
        return [f"{path}: must be a number, got {type(obj).__name__}"]
    if typ == "string" and not isinstance(obj, str):
        return [f"{path}: must be a string, got {type(obj).__name__}"]
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(
            f"{path}: unsupported value {obj!r}, expected one of "
            + ", ".join(repr(e) for e in schema["enum"])
        )
    if "pattern" in schema and isinstance(obj, str):
        if not re.match(schema["pattern"], obj):
            errors.append(
                f"{path}: {obj!r} does not match pattern {schema['pattern']!r}"
            )
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            errors.append(
                f"{path}: must be greater than or equal to {schema['minimum']}"
            )
        if "maximum" in schema and obj > schema["maximum"]:
            errors.append(
                f"{path}: must be less than or equal to {schema['maximum']}"
            )
    return errors
