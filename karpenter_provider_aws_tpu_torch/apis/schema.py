"""Machine-readable schemas for the API wire format + validation.

The analog of the reference's checked-in, CEL-validated CRDs
(reference pkg/apis/crds/karpenter.sh_nodepools.yaml:338-401 —
per-requirement ``minValues``, label-domain restrictions, operator
enums; :55-100 — disruption-budget node-count/duration patterns;
pkg/apis/v1beta1/ec2nodeclass.go:321-330 — inline CEL like
"role XOR instanceProfile"). Three artifacts come from ONE source of
truth here:

1. ``SCHEMAS[kind]`` — JSON Schema (2020-12) over the apis/serde wire
   dicts, with patterns/enums/bounds lifted from the reference CRDs.
2. ``CROSS_FIELD_RULES[kind]`` — the x-kubernetes-validations analog:
   (message, predicate) pairs for rules JSON Schema cannot express
   (CEL in the reference). Each carries its CEL-style text so the
   generated CRD documents the same contract machine-readably.
3. ``crd_document(kind)`` — a CRD-style YAML document embedding (1) as
   ``openAPIV3Schema`` and (2) as ``x-kubernetes-validations``;
   tools/gen_crds.py checks these into deploy/crds/.

``validate(kind, spec)`` runs both layers and returns error strings —
the apiserver admission chain (kube/client.py install_admission) runs it
BEFORE the semantic webhooks, so no invalid object crosses the seam.

The JSON Schema layer is this module's own validator (``Validator``),
not the ``jsonschema`` package: it covers exactly the Draft 2020-12
keywords ``SCHEMAS`` use (``KEYWORDS``) and raises on a schema that uses
any other, so a schema that grows cannot pass unchecked. Its errors are
``jsonschema`` 4.26's: the same messages, paths and order.
"""

from __future__ import annotations

import numbers
import re
from collections import deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

# patterns lifted from the reference CRDs
LABEL_KEY_PATTERN = (r"^([a-z0-9]([-a-z0-9]*[a-z0-9])?"
                     r"(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*(\/))?"
                     r"([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$")
LABEL_VALUE_PATTERN = r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$"
BUDGET_NODES_PATTERN = r"^((100|[0-9]{1,2})%|[0-9]+)$"       # nodepools.yaml:96
QUANTITY_PATTERN = r"^[0-9]+(\.[0-9]+)?(m|k|Ki|Mi|Gi|Ti|M|G|T)?$"

_REQUIREMENT = {
    "type": "object",
    "properties": {
        "key": {"type": "string", "maxLength": 316,
                "pattern": LABEL_KEY_PATTERN},
        "operator": {"type": "string",
                     "enum": ["In", "NotIn", "Exists", "DoesNotExist",
                              "Gt", "Lt"]},
        "values": {"type": "array",
                   "items": {"type": "string", "maxLength": 63,
                             "pattern": LABEL_VALUE_PATTERN}},
        # ALPHA in the reference; 1..50 (nodepools.yaml:363-368)
        "minValues": {"type": ["integer", "null"],
                      "minimum": 1, "maximum": 50},
    },
    "required": ["key", "operator"],
    "additionalProperties": False,
}

_TAINT = {
    "type": "object",
    "properties": {
        "key": {"type": "string", "pattern": LABEL_KEY_PATTERN},
        "value": {"type": "string"},
        "effect": {"type": "string",
                   "enum": ["NoSchedule", "PreferNoSchedule", "NoExecute"]},
    },
    "required": ["key", "effect"],
    "additionalProperties": False,
}

_BUDGET = {
    "type": "object",
    "properties": {
        "nodes": {"type": "string", "pattern": BUDGET_NODES_PATTERN},
        "schedule": {"type": ["string", "null"]},
        # deviation from the reference CRD (nodepools.yaml:83 Go-duration
        # strings): OUR wire format carries canonical seconds — numeric,
        # like every other duration on this wire (consolidateAfter,
        # expireAfter). The x-kubernetes-validations budget rule still
        # enforces schedule↔duration pairing.
        "duration": {"type": ["number", "null"], "exclusiveMinimum": 0},
        "reasons": {"type": "array",
                    "items": {"type": "string",
                              "enum": ["Underutilized", "Empty", "Drifted",
                                       "Expired"]}},
    },
    "additionalProperties": False,
}

NODEPOOL_SCHEMA = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "properties": {
        "name": {"type": "string", "minLength": 1, "maxLength": 63},
        "weight": {"type": "integer", "minimum": 0, "maximum": 100},
        "labels": {"type": "object",
                   "propertyNames": {"pattern": LABEL_KEY_PATTERN,
                                     "maxLength": 316},
                   "additionalProperties": {"type": "string",
                                            "maxLength": 63,
                                            "pattern": LABEL_VALUE_PATTERN}},
        "annotations": {"type": "object",
                        "additionalProperties": {"type": "string"}},
        "requirements": {"type": "array", "items": _REQUIREMENT,
                         "maxItems": 30},             # nodepools.yaml:391
        "taints": {"type": "array", "items": _TAINT},
        "startupTaints": {"type": "array", "items": _TAINT},
        # serde stringifies limits on the wire; bare integers are also
        # accepted (hand-built specs). Fractional NUMBERS are not — write
        # "1.5" as a quantity string — which makes the CRD projection to
        # x-kubernetes-int-or-string exact, not just approximate.
        "limits": {"type": "object",
                   "additionalProperties": {
                       "anyOf": [
                           {"type": "integer", "minimum": 0},
                           {"type": "string",
                            "pattern": QUANTITY_PATTERN}]}},
        "disruption": {
            "type": "object",
            "properties": {
                "consolidationPolicy": {
                    "type": "string",
                    "enum": ["WhenUnderutilized", "WhenEmpty"]},
                "consolidateAfter": {"type": ["number", "string", "null"]},
                "expireAfter": {"type": ["number", "string", "null"]},
                "budgets": {"type": "array", "items": _BUDGET,
                            "maxItems": 50},
            },
            "additionalProperties": False,
        },
        "nodeClassRef": {"type": "string", "minLength": 1},
        "kubelet": {
            "type": ["object", "null"],
            "properties": {
                "maxPods": {"type": ["integer", "null"],
                            "minimum": 1, "maximum": 110},
                "clusterDNS": {"type": ["string", "null"]},
            },
            "additionalProperties": False,
        },
        # LEGACY location of controller-owned live usage: current servers
        # keep status.resources in the envelope's status sub-map
        # (spec/status split, kube/apiserver.py), and admission
        # normalization strips this key from any applied spec — it is
        # accepted here only so old exported YAML still applies cleanly
        "statusResources": {"type": "object",
                            "additionalProperties": {
                                "type": "string",
                                "pattern": QUANTITY_PATTERN}},
    },
    "required": ["name"],
    "additionalProperties": False,
}

_SELECTOR_TERM = {
    "type": "object",
    "properties": {
        "tags": {"type": "array",
                 "items": {"type": "array",
                           "prefixItems": [{"type": "string"},
                                           {"type": "string"}],
                           "minItems": 2, "maxItems": 2}},
        "id": {"type": ["string", "null"]},
        "name": {"type": ["string", "null"]},
    },
    "additionalProperties": False,
}

NODECLASS_SCHEMA = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "properties": {
        "name": {"type": "string", "minLength": 1, "maxLength": 63},
        "amiFamily": {"type": "string",
                      "enum": ["AL2", "AL2023", "Bottlerocket", "Ubuntu",
                               "Windows", "Custom"]},
        "subnetSelectorTerms": {"type": "array", "items": _SELECTOR_TERM,
                                "maxItems": 30},
        "securityGroupSelectorTerms": {"type": "array",
                                       "items": _SELECTOR_TERM,
                                       "maxItems": 30},
        "amiSelectorTerms": {"type": "array", "items": _SELECTOR_TERM,
                             "maxItems": 30},
        "userData": {"type": ["string", "null"]},
        "role": {"type": ["string", "null"]},
        "instanceProfile": {"type": ["string", "null"]},
        "tags": {"type": "object",
                 "additionalProperties": {"type": "string"}},
        "blockDeviceMappings": {
            "type": "array", "maxItems": 50,
            "items": {
                "type": "object",
                "properties": {
                    "device_name": {"type": "string"},
                    "root_volume": {"type": "boolean"},
                    "volume_size_mib": {"type": "number",
                                        "exclusiveMinimum": 0},
                },
                "additionalProperties": True,
            }},
        "instanceStorePolicy": {"type": ["string", "null"],
                                "enum": ["RAID0", None]},
        "metadataOptions": {
            "type": "object",
            "properties": {
                "httpEndpoint": {"type": "string",
                                 "enum": ["enabled", "disabled"]},
                "httpProtocolIPv6": {"type": "string",
                                     "enum": ["enabled", "disabled"]},
                "httpPutResponseHopLimit": {"type": "integer",
                                            "minimum": 1, "maximum": 64},
                "httpTokens": {"type": "string",
                               "enum": ["required", "optional"]},
            },
            "additionalProperties": False,
        },
        "detailedMonitoring": {"type": "boolean"},
        "associatePublicIP": {"type": ["boolean", "null"]},
        "annotations": {"type": "object",
                        "additionalProperties": {"type": "string"}},
        # status (controller-owned; accepted on the wire like a CRD's)
        "statusSubnets": {"type": "array",
                          "items": {"type": "object"}},
        "statusSecurityGroups": {"type": "array",
                                 "items": {"type": "object"}},
        "statusAMIs": {"type": "array", "items": {"type": "object"}},
        "statusInstanceProfile": {"type": ["string", "null"]},
        "statusConditions": {"type": "object",
                             "additionalProperties": {"type": "boolean"}},
    },
    "required": ["name"],
    "additionalProperties": False,
}

NODECLAIM_SCHEMA = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "properties": {
        "name": {"type": "string", "minLength": 1, "maxLength": 63},
        "nodePool": {"type": "string"},
        "requirements": {"type": "array", "items": _REQUIREMENT,
                         "maxItems": 100},
        "resourceRequests": {"type": "object",
                             "additionalProperties": {
                                 "type": ["string", "number"]}},
        "labels": {"type": "object",
                   "additionalProperties": {"type": "string"}},
        "annotations": {"type": "object",
                        "additionalProperties": {"type": "string"}},
        "taints": {"type": "array", "items": _TAINT},
        "nodeClassRef": {"type": "string"},
        "phase": {"type": "string",
                  "enum": ["Pending", "Launched", "Registered",
                           "Initialized", "Terminating", "Terminated"]},
        "maxPods": {"type": ["integer", "null"], "minimum": 1},
        "clusterDNS": {"type": ["string", "null"]},
        "providerID": {"type": ["string", "null"]},
        "internalIP": {"type": ["string", "null"]},
        "instanceType": {"type": ["string", "null"]},
        "zone": {"type": ["string", "null"]},
        "capacityType": {"type": ["string", "null"],
                         "enum": ["on-demand", "spot", None]},
        "imageID": {"type": ["string", "null"]},
        "capacity": {"type": "object",
                     "additionalProperties": {"type": "number"}},
        "allocatable": {"type": "object",
                        "additionalProperties": {"type": "number"}},
        "createdAt": {"type": "number"},
        "launchedAt": {"type": ["number", "null"]},
        "registeredAt": {"type": ["number", "null"]},
        "initializedAt": {"type": ["number", "null"]},
        "deletionTimestamp": {"type": ["number", "null"]},
    },
    "required": ["name", "nodePool"],
    "additionalProperties": False,
}

SCHEMAS: Dict[str, dict] = {
    "nodepools": NODEPOOL_SCHEMA,
    "nodeclasses": NODECLASS_SCHEMA,
    "nodeclaims": NODECLAIM_SCHEMA,
}


# ---------------------------------------------------------------------------
# Cross-field rules — the x-kubernetes-validations (CEL) analog.
# Each: (cel_text, message, predicate(spec) -> bool[valid]).
# ---------------------------------------------------------------------------


def _rule_in_has_values(spec: Mapping) -> bool:
    return all(r.get("values") for r in spec.get("requirements", ())
               if r.get("operator") == "In")


def _rule_gt_lt_single_int(spec: Mapping) -> bool:
    for r in spec.get("requirements", ()):
        if r.get("operator") in ("Gt", "Lt"):
            vals = r.get("values", ())
            if len(vals) != 1:
                return False
            try:
                if int(vals[0]) < 0:
                    return False
            except (TypeError, ValueError):
                return False
    return True


def _rule_min_values_coverage(spec: Mapping) -> bool:
    return all(len(r.get("values", ())) >= r["minValues"]
               for r in spec.get("requirements", ())
               if r.get("operator") == "In" and r.get("minValues"))


def _rule_exists_no_values(spec: Mapping) -> bool:
    return all(not r.get("values")
               for r in spec.get("requirements", ())
               if r.get("operator") in ("Exists", "DoesNotExist"))


def _rule_role_xor_profile(spec: Mapping) -> bool:
    return bool(spec.get("role")) != bool(spec.get("instanceProfile"))


def _rule_schedule_requires_duration(spec: Mapping) -> bool:
    return all(not b.get("schedule") or b.get("duration")
               for b in spec.get("disruption", {}).get("budgets", ()))


CROSS_FIELD_RULES: Dict[str, List[Tuple[str, str, Callable]]] = {
    "nodepools": [
        ("!has(self.requirements) || self.requirements.all(x, "
         "x.operator == 'In' ? x.values.size() != 0 : true)",
         "requirements with operator 'In' must have a value defined",
         _rule_in_has_values),
        ("!has(self.requirements) || self.requirements.all(x, "
         "(x.operator == 'Gt' || "
         "x.operator == 'Lt') ? (x.values.size() == 1 && "
         "int(x.values[0]) >= 0) : true)",
         "requirements operator 'Gt' or 'Lt' must have a single positive "
         "integer value",
         _rule_gt_lt_single_int),
        ("!has(self.requirements) || self.requirements.all(x, "
         "(x.operator == 'In' && "
         "has(x.minValues)) ? x.values.size() >= x.minValues : true)",
         "requirements with 'minValues' must have at least that many "
         "values specified in the 'values' field",
         _rule_min_values_coverage),
        ("!has(self.requirements) || self.requirements.all(x, "
         "(x.operator == 'Exists' || "
         "x.operator == 'DoesNotExist') ? x.values.size() == 0 : true)",
         "requirements with operator 'Exists' or 'DoesNotExist' must not "
         "have values",
         _rule_exists_no_values),
        ("!has(self.disruption) || !has(self.disruption.budgets) || "
         "self.disruption.budgets.all(b, has(b.schedule) ? "
         "has(b.duration) : true)",
         "budgets with a schedule must set a duration",
         _rule_schedule_requires_duration),
    ],
    "nodeclasses": [
        ("(has(self.role) && !has(self.instanceProfile)) || "
         "(!has(self.role) && has(self.instanceProfile))",
         "exactly one of role or instanceProfile is required",
         _rule_role_xor_profile),
    ],
    "nodeclaims": [
        ("!has(self.requirements) || self.requirements.all(x, "
         "x.operator == 'In' ? x.values.size() != 0 : true)",
         "requirements with operator 'In' must have a value defined",
         _rule_in_has_values),
    ],
}


# ---------------------------------------------------------------------------
# Validation entrypoint
# ---------------------------------------------------------------------------

# the Draft 2020-12 keywords the validator knows; a schema using any
# other raises SchemaError when its validator is built
KEYWORDS = frozenset((
    "$schema", "type", "properties", "required", "additionalProperties",
    "enum", "anyOf", "items", "prefixItems", "minItems", "maxItems",
    "minLength", "maxLength", "pattern", "propertyNames", "minimum",
    "maximum", "exclusiveMinimum"))


class SchemaError(ValueError):
    """A schema uses a keyword outside ``KEYWORDS``."""


def _is_type(instance, name: str) -> bool:
    if name == "object":
        return isinstance(instance, dict)
    if name == "array":
        return isinstance(instance, list)
    if name == "string":
        return isinstance(instance, str)
    if name == "boolean":
        return isinstance(instance, bool)
    if name == "null":
        return instance is None
    if name == "integer":
        # Draft 6 on: a float with no fractional part is an integer
        if isinstance(instance, float):
            return instance.is_integer()
        return isinstance(instance, int) and not isinstance(instance, bool)
    if name == "number":
        return (isinstance(instance, numbers.Number)
                and not isinstance(instance, bool))
    raise SchemaError(f"unknown type {name!r}")


def _unbool(x, true=object(), false=object()):
    if x is True:
        return true
    if x is False:
        return false
    return x


def _equal(a, b) -> bool:
    """JSON equality: True is not 1 and False is not 0, at any depth."""
    if a is b:
        return True
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return _unbool(a) == _unbool(b)


def _check_keywords(schema, where: str = "#") -> None:
    """Raise SchemaError on any keyword outside KEYWORDS, at any depth."""
    if isinstance(schema, bool):
        return
    if not isinstance(schema, dict):
        raise SchemaError(f"{where}: a schema must be an object or a boolean")
    for k, v in schema.items():
        if k not in KEYWORDS:
            raise SchemaError(f"{where}: keyword {k!r} is not supported by "
                              f"this validator (supported: {sorted(KEYWORDS)})")
        if k == "properties":
            for name, sub in v.items():
                _check_keywords(sub, f"{where}/properties/{name}")
        elif k in ("additionalProperties", "items", "propertyNames"):
            _check_keywords(v, f"{where}/{k}")
        elif k in ("anyOf", "prefixItems"):
            for i, sub in enumerate(v):
                _check_keywords(sub, f"{where}/{k}/{i}")


class Validator:
    """Draft 2020-12 validation over ``KEYWORDS``. ``iter_errors`` yields
    (path, message) pairs in ``jsonschema``'s order: a schema's keywords
    in their order in the schema, each keyword's errors in the order that
    package reports them."""

    def __init__(self, schema):
        _check_keywords(schema)
        self.schema = schema

    def iter_errors(self, instance):
        return self._descend(instance, self.schema)

    def _descend(self, instance, schema):
        if schema is True:
            return
        if schema is False:
            yield deque(), f"False schema does not allow {instance!r}"
            return
        for k, v in schema.items():
            yield from getattr(self, "_kw_" + k.lstrip("$"))(v, instance,
                                                             schema)

    def _child(self, instance, schema, path):
        for p, msg in self._descend(instance, schema):
            p.appendleft(path)
            yield p, msg

    def _kw_schema(self, v, instance, schema):
        return ()

    def _kw_type(self, types, instance, schema):
        types = types if isinstance(types, list) else [types]
        if not any(_is_type(instance, t) for t in types):
            yield deque(), (f"{instance!r} is not of type "
                            + ", ".join(repr(t) for t in types))

    def _kw_properties(self, properties, instance, schema):
        if not isinstance(instance, dict):
            return
        for name, sub in properties.items():
            if name in instance:
                yield from self._child(instance[name], sub, name)

    def _kw_required(self, required, instance, schema):
        if not isinstance(instance, dict):
            return
        for name in required:
            if name not in instance:
                yield deque(), f"{name!r} is a required property"

    def _kw_additionalProperties(self, ap, instance, schema):
        if not isinstance(instance, dict):
            return
        known = schema.get("properties", {})
        # a set, as jsonschema builds it: the errors of an object-valued
        # additionalProperties come in that set's iteration order
        extras = set(p for p in instance if p not in known)
        if isinstance(ap, dict):
            for extra in extras:
                yield from self._child(instance[extra], ap, extra)
        elif not ap and extras:
            names = sorted(extras, key=str)
            verb = "was" if len(names) == 1 else "were"
            yield deque(), ("Additional properties are not allowed ("
                            + ", ".join(repr(n) for n in names)
                            + f" {verb} unexpected)")

    def _kw_enum(self, enums, instance, schema):
        if all(not _equal(e, instance) for e in enums):
            yield deque(), f"{instance!r} is not one of {enums!r}"

    def _kw_anyOf(self, branches, instance, schema):
        for sub in branches:
            if next(self._descend(instance, sub), None) is None:
                return
        yield deque(), (f"{instance!r} is not valid under any of the given "
                        "schemas")

    def _kw_items(self, items, instance, schema):
        if not isinstance(instance, list):
            return
        prefix = len(schema.get("prefixItems", []))
        extra = len(instance) - prefix
        if extra <= 0:
            return
        if items is False:
            rest = instance[prefix:] if extra != 1 else instance[prefix]
            item = "items" if prefix != 1 else "item"
            yield deque(), (f"Expected at most {prefix} {item} but found "
                            f"{extra} extra: {rest!r}")
            return
        for i in range(prefix, len(instance)):
            yield from self._child(instance[i], items, i)

    def _kw_prefixItems(self, prefix, instance, schema):
        if not isinstance(instance, list):
            return
        for (i, item), sub in zip(enumerate(instance), prefix):
            yield from self._child(item, sub, i)

    def _kw_minItems(self, n, instance, schema):
        if isinstance(instance, list) and len(instance) < n:
            msg = "should be non-empty" if n == 1 else "is too short"
            yield deque(), f"{instance!r} {msg}"

    def _kw_maxItems(self, n, instance, schema):
        if isinstance(instance, list) and len(instance) > n:
            msg = "is expected to be empty" if n == 0 else "is too long"
            yield deque(), f"{instance!r} {msg}"

    def _kw_minLength(self, n, instance, schema):
        if isinstance(instance, str) and len(instance) < n:
            msg = "should be non-empty" if n == 1 else "is too short"
            yield deque(), f"{instance!r} {msg}"

    def _kw_maxLength(self, n, instance, schema):
        if isinstance(instance, str) and len(instance) > n:
            msg = "is expected to be empty" if n == 0 else "is too long"
            yield deque(), f"{instance!r} {msg}"

    def _kw_pattern(self, pattern, instance, schema):
        if isinstance(instance, str) and not re.search(pattern, instance):
            yield deque(), f"{instance!r} does not match {pattern!r}"

    def _kw_propertyNames(self, sub, instance, schema):
        if not isinstance(instance, dict):
            return
        for name in instance:
            yield from self._descend(name, sub)

    def _kw_minimum(self, bound, instance, schema):
        if _is_type(instance, "number") and instance < bound:
            yield deque(), (f"{instance!r} is less than the minimum of "
                            f"{bound!r}")

    def _kw_maximum(self, bound, instance, schema):
        if _is_type(instance, "number") and instance > bound:
            yield deque(), (f"{instance!r} is greater than the maximum of "
                            f"{bound!r}")

    def _kw_exclusiveMinimum(self, bound, instance, schema):
        if _is_type(instance, "number") and instance <= bound:
            yield deque(), (f"{instance!r} is less than or equal to the "
                            f"minimum of {bound!r}")


_validators: Dict[str, Validator] = {}


def validate(kind: str, spec: Mapping) -> List[str]:
    """Schema + cross-field validation; returns error strings (empty =
    valid). The apiserver admission chain runs this before the semantic
    webhooks so nothing structurally invalid crosses the API seam."""
    schema = SCHEMAS.get(kind)
    if schema is None:
        return []
    v = _validators.get(kind)
    if v is None:
        v = Validator(schema)
        _validators[kind] = v
    errs = [f"{'.'.join(str(p) for p in path) or '<root>'}: {message}"
            for path, message in v.iter_errors(dict(spec))]
    if errs:
        return errs   # cross-field rules assume structural validity
    for _cel, message, pred in CROSS_FIELD_RULES.get(kind, ()):
        try:
            if not pred(spec):
                errs.append(message)
        except Exception as e:
            errs.append(f"{message} (rule error: {e})")
    return errs


# ---------------------------------------------------------------------------
# CRD document generation (tools/gen_crds.py → deploy/crds/)
# ---------------------------------------------------------------------------

_KIND_META = {
    "nodepools": ("NodePool", "karpenter.tpu", "nodepools", "np"),
    "nodeclasses": ("TPUNodeClass", "karpenter.tpu", "nodeclasses", "tnc"),
    "nodeclaims": ("NodeClaim", "karpenter.tpu", "nodeclaims", "nc"),
}


def _to_structural(node):
    """JSON-Schema 2020-12 → Kubernetes *structural* schema: apiextensions
    v1 forbids type arrays (use ``nullable: true``), ``prefixItems``,
    ``propertyNames``, ``anyOf`` at value positions, and null enum
    members. Validation still runs the richer 2020-12 form; this lossy
    projection only shapes the deployable artifact."""
    if isinstance(node, list):
        return [_to_structural(x) for x in node]
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        if k == "propertyNames":
            continue   # inexpressible structurally; admission enforces it
        if k == "prefixItems":
            # tuple form -> plain item schema (bounds stay via min/maxItems)
            merged = {}
            for sub in v:
                merged.update(_to_structural(sub))
            out["items"] = merged
            continue
        if k == "anyOf":
            branches = [_to_structural(b) for b in v]
            types = {b.get("type") for b in branches}
            if types <= {"number", "integer", "string"} and len(types) > 1:
                # the k8s-native projection of a number-or-quantity-string
                # union (the reference CRDs use the same marker for
                # IntOrString fields)
                out["x-kubernetes-int-or-string"] = True
            elif branches:
                # otherwise keep the FIRST branch (schemas list the
                # widest branch first); admission still enforces the
                # full union
                out.update(branches[0])
            continue
        out[k] = _to_structural(v)
    t = out.get("type")
    if isinstance(t, list):
        non_null = [x for x in t if x != "null"]
        out["type"] = non_null[0] if non_null else "string"
        if "null" in t:
            out["nullable"] = True
    if isinstance(out.get("enum"), list) and None in out["enum"]:
        out["enum"] = [x for x in out["enum"] if x is not None]
        out["nullable"] = True
    if "exclusiveMinimum" in out and isinstance(out["exclusiveMinimum"],
                                                (int, float)):
        # draft-2020 numeric form -> OpenAPI v3 boolean form
        out["minimum"] = out.pop("exclusiveMinimum")
        out["exclusiveMinimum"] = True
    return out


def crd_document(kind: str) -> dict:
    """A CustomResourceDefinition-style document for the kind: the wire
    schema as openAPIV3Schema plus the cross-field rules as
    x-kubernetes-validations — byte-stable for check-in (reference checks
    in pkg/apis/crds/*.yaml the same way)."""
    kind_name, group, plural, short = _KIND_META[kind]
    schema = _to_structural(
        {k: v for k, v in SCHEMAS[kind].items() if k != "$schema"})
    schema["x-kubernetes-validations"] = [
        {"message": message, "rule": cel}
        for cel, message, _ in CROSS_FIELD_RULES.get(kind, ())]
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": {"kind": kind_name, "plural": plural,
                      "shortNames": [short]},
            "scope": "Cluster",
            "versions": [{
                "name": "v1",
                "served": True,
                "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {"spec": schema},
                    "required": ["spec"],
                }},
            }],
        },
    }
