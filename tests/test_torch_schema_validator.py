"""The port's own Draft 2020-12 validator against ``jsonschema``, on the
CPU.

The port validates the wire schema (``apis/schema.py``) without the
``jsonschema`` package, which the machine with the card does not have.
Its error lists must be ``jsonschema``'s exactly, in order, since
admission returns them as 422 causes. They are compared on

- every spec the JAX package's ``tests/test_schema.py`` validates (its
  tests run with the JAX package's ``schema.validate`` recording what it
  is given), and
- 500 specs per kind made from a numpy seed by mutating valid, rich
  specs: wrong types, missing required fields, out-of-range numbers,
  strings that are empty, too long or off their pattern, extra
  properties, arrays emptied or grown past their bounds.

Both the bare validator (``Validator.iter_errors``) and the whole
``validate`` (the cross-field rules after the schema) are compared.
A schema keyword outside the 18 the validator knows raises.
"""

import copy

import jsonschema
import numpy as np
import pytest

import test_torch_cases as cases
import test_torch_replay as replay
from karpenter_provider_aws_tpu.apis import schema as jax_schema
from karpenter_provider_aws_tpu_torch.apis import schema as port_schema

KINDS = ("nodepools", "nodeclasses", "nodeclaims")
N_MUTANTS = 500
SEED = 8


def _jsonschema_errors(kind, spec):
    v = jsonschema.Draft202012Validator(jax_schema.SCHEMAS[kind])
    return [f"{'.'.join(str(p) for p in e.path) or '<root>'}: {e.message}"
            for e in v.iter_errors(dict(spec))]


def _port_errors(kind, spec):
    v = port_schema.Validator(port_schema.SCHEMAS[kind])
    return [f"{'.'.join(str(p) for p in path) or '<root>'}: {msg}"
            for path, msg in v.iter_errors(dict(spec))]


def _agree(kind, spec):
    want = _jsonschema_errors(kind, spec)
    assert _port_errors(kind, spec) == want, (kind, spec)
    assert port_schema.validate(kind, spec) == jax_schema.validate(kind, spec)
    return want


def test_schemas_are_the_jax_packages():
    assert port_schema.SCHEMAS == jax_schema.SCHEMAS
    assert [(c, m) for k in KINDS
            for c, m, _ in port_schema.CROSS_FIELD_RULES[k]] \
        == [(c, m) for k in KINDS
            for c, m, _ in jax_schema.CROSS_FIELD_RULES[k]]


# ---- every spec test_schema.py validates ----

def _recorded_specs():
    """(kind, spec) for every call of the JAX package's
    ``schema.validate`` made by the tests of test_schema.py (admission
    through the apiserver included)."""
    module = replay.load("test_schema.py", cases.JAX_PKG)
    seen = []
    orig = jax_schema.validate

    def recording(kind, spec):
        seen.append((kind, copy.deepcopy(dict(spec))))
        return orig(kind, spec)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_schema, "validate", recording)
        for test_id in replay.jax_tests("test_schema.py"):
            _, clsname, meth = test_id.split("::")
            if meth == "test_checked_in_crds_are_current":
                continue   # runs tools/gen_crds.py in a subprocess
            getattr(getattr(module, clsname)(), meth)()
    return seen


def test_every_spec_of_test_schema_gives_jsonschemas_errors():
    specs = _recorded_specs()
    assert len(specs) >= 20
    assert {k for k, _ in specs} >= set(KINDS)
    errors = [_agree(kind, spec) for kind, spec in specs if kind in KINDS]
    assert sum(1 for e in errors if e) >= 8


# ---- seeded mutants of valid specs ----

def _valid_specs():
    from karpenter_provider_aws_tpu_torch.apis import (
        NodePool, Requirement, Taint, TaintEffect, serde)
    from karpenter_provider_aws_tpu_torch.apis import Operator as ReqOp
    from karpenter_provider_aws_tpu_torch.apis import wellknown as wk
    from karpenter_provider_aws_tpu_torch.apis.objects import (
        DisruptionBudget, KubeletSpec, MetadataOptions, NodeClaim,
        NodeClaimPhase, NodeClass, NodeClassSelectorTerm, NodePoolDisruption)
    pool = NodePool(
        name="rich", weight=50, labels={"team": "a", "x.io/tier": "gold"},
        requirements=[
            Requirement(wk.LABEL_CAPACITY_TYPE, ReqOp.IN, ("spot", "on-demand")),
            Requirement("karpenter.tpu/instance-cpu", ReqOp.GT, ("4",)),
            Requirement(wk.LABEL_INSTANCE_TYPE, ReqOp.IN,
                        ("m5.large", "m5.xlarge", "c5.large"), min_values=2)],
        taints=[Taint(key="dedicated", value="gpu",
                      effect=TaintEffect.NO_SCHEDULE)],
        limits={"cpu": "1000", "memory": "1000Gi"},
        disruption=NodePoolDisruption(budgets=[
            DisruptionBudget(nodes="10%"),
            DisruptionBudget(nodes="5", schedule="0 9 * * 1-5",
                             duration=8 * 3600.0)]),
        kubelet=KubeletSpec(max_pods=58))
    nc = NodeClass(
        name="rich", role="r", tags={"team": "a"},
        subnet_selector_terms=[NodeClassSelectorTerm(tags=(("env", "prod"),))],
        security_group_selector_terms=[NodeClassSelectorTerm(id="sg-1")],
        block_device_mappings=[{"device_name": "/dev/xvda",
                                "root_volume": True, "volume_size_mib": 20480}],
        metadata_options=MetadataOptions())
    claim = NodeClaim(
        name="c1", node_pool="default", provider_id="aws:///z/i-1",
        instance_type="m5.large", zone="us-west-2a", capacity_type="spot",
        phase=NodeClaimPhase.LAUNCHED, labels={"a": "b"},
        capacity={"cpu": 2000.0}, allocatable={"cpu": 1930.0})
    return {"nodepools": serde.nodepool_to_dict(pool),
            "nodeclasses": serde.nodeclass_to_dict(nc),
            "nodeclaims": serde.nodeclaim_to_dict(claim)}


_WRONG = [0, 7, -3, 1.5, 2.0, "s", "", True, False, None, [], ["a"], {},
          {"k": "v"}, 10 ** 6, -0.5]
_STRINGS = ["", "x" * 64, "x" * 320, "BAD KEY", "-lead", "trail-", "a/b/c",
            "ok", "10Q", "101%", "1.5Gi", "In", "Spot", "@daily", "é"]
_NUMBERS = [0, -1, 1, 50, 51, 64, 65, 100, 101, 110, 111, 0.0, -0.1, 0.5,
            1e9, 2 ** 40]


def _paths(node, path=()):
    yield path
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _paths(v, path + (i,))


def _parent(spec, path):
    node = spec
    for p in path[:-1]:
        node = node[p]
    return node


def _mutate(spec, rng):
    paths = list(_paths(spec))[1:]
    path = paths[rng.integers(len(paths))]
    parent, key = _parent(spec, path), path[-1]
    cur = parent[key]
    op = rng.integers(8)
    if op == 0:                                  # a wrong type
        parent[key] = copy.deepcopy(_WRONG[rng.integers(len(_WRONG))])
    elif op == 1 and isinstance(parent, dict):   # a field goes missing
        del parent[key]
    elif op == 1:
        parent.pop(key)
    elif op == 2:                                # an extra property
        target = cur if isinstance(cur, dict) else (
            parent if isinstance(parent, dict) else spec)
        target[["extra", "Zeta", "aa", "b c"][rng.integers(4)]] = \
            _WRONG[rng.integers(len(_WRONG))]
    elif op == 3:                                # a string off its bounds
        parent[key] = _STRINGS[rng.integers(len(_STRINGS))]
    elif op == 4:                                # a number off its range
        parent[key] = _NUMBERS[rng.integers(len(_NUMBERS))]
    elif op == 5 and isinstance(cur, list):      # an array emptied or grown
        if rng.integers(2) and cur:
            parent[key] = cur * int(rng.integers(20, 60))
        else:
            parent[key] = []
    elif op == 5:
        parent[key] = [copy.deepcopy(cur)] * int(rng.integers(0, 3))
    elif op == 6 and isinstance(cur, dict):      # a key off its pattern
        cur[_STRINGS[rng.integers(len(_STRINGS))]] = \
            _STRINGS[rng.integers(len(_STRINGS))]
    elif rng.integers(2):                        # a required field goes
        spec.pop(["name", "nodePool"][rng.integers(2)], None)
    else:                                        # or is empty
        spec[["name", "nodeClassRef"][rng.integers(2)]] = ""


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_mutants_give_jsonschemas_errors(kind):
    """500 mutants of a valid spec of the kind (1-3 mutations each, from
    a numpy seed): the port's errors equal jsonschema's, exact and in
    order; most mutants are invalid, and every error message kind the
    schemas can raise shows up across the three kinds."""
    base = _valid_specs()[kind]
    assert _agree(kind, base) == []
    assert port_schema.validate(kind, base) == []
    rng = np.random.default_rng([SEED, KINDS.index(kind)])
    invalid = 0
    for _ in range(N_MUTANTS):
        spec = copy.deepcopy(base)
        for _ in range(int(rng.integers(1, 4))):
            _mutate(spec, rng)
        invalid += bool(_agree(kind, spec))
    assert invalid >= N_MUTANTS // 2


def test_mutants_reach_every_message():
    """Across the seeded mutants of the three kinds, every message the
    18 keywords can raise on these schemas appears at least once, so no
    keyword's wording goes unchecked."""
    rng = np.random.default_rng(SEED)
    bases = _valid_specs()
    seen = set()
    for kind in KINDS:
        for _ in range(N_MUTANTS):
            spec = copy.deepcopy(bases[kind])
            for _ in range(int(rng.integers(1, 4))):
                _mutate(spec, rng)
            for e in _port_errors(kind, spec):
                seen.add(next((w for w in (
                    "is not of type", "is a required property",
                    "Additional properties are not allowed", "is not one of",
                    "is not valid under any of the given schemas",
                    "should be non-empty", "is too long", "is too short",
                    "does not match", "is less than the minimum",
                    "is greater than the maximum",
                    "is less than or equal to the minimum") if w in e), e))
    assert seen >= {
        "is not of type", "is a required property",
        "Additional properties are not allowed", "is not one of",
        "is not valid under any of the given schemas", "should be non-empty",
        "is too long", "is too short", "does not match",
        "is less than the minimum", "is greater than the maximum",
        "is less than or equal to the minimum"}, seen


# ---- the keyword set ----

def _keywords(schema, out):
    if not isinstance(schema, dict):
        return out
    for k, v in schema.items():
        out.add(k)
        if k == "properties":
            for sub in v.values():
                _keywords(sub, out)
        elif k in ("additionalProperties", "items", "propertyNames"):
            _keywords(v, out)
        elif k in ("anyOf", "prefixItems"):
            for sub in v:
                _keywords(sub, out)
    return out


def test_the_schemas_use_exactly_the_18_keywords():
    used = set()
    for kind in KINDS:
        _keywords(jax_schema.SCHEMAS[kind], used)
    assert used == port_schema.KEYWORDS and len(used) == 18


@pytest.mark.parametrize("schema", [
    {"type": "object", "minProperties": 1},
    {"properties": {"a": {"type": "string", "format": "email"}}},
    {"items": {"oneOf": [{"type": "string"}]}},
    {"anyOf": [{"const": 1}]},
    {"additionalProperties": {"multipleOf": 2}},
    {"$ref": "#/$defs/x"},
])
def test_a_keyword_outside_the_18_raises(schema):
    with pytest.raises(port_schema.SchemaError, match="not supported"):
        port_schema.Validator(schema)


def test_an_unknown_kind_validates_to_nothing():
    assert port_schema.validate("pods", {"anything": 1}) \
        == jax_schema.validate("pods", {"anything": 1}) == []
