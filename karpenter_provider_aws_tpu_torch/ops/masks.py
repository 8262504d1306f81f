"""Requirements → boolean masks over the lattice axes.

This is the row/column predicate encoding of the constraint matrix: the
reference evaluates `Requirements.Compatible` per pod per instance type in a
Go hot loop (reference pkg/cloudprovider/cloudprovider.go:246-251); here a
requirement set compiles once per *deduplicated pod group* into

- ``type_mask [T]``  over instance types (categorical vocab-id membership +
  numeric interval tests),
- ``zone_mask [Z]``  over availability zones,
- ``cap_mask  [C]``  over capacity types,

which the device kernel then combines with offering availability. Because
groups are deduplicated (50k pods collapse to a handful of distinct
requirement signatures), this compilation is host-side numpy — the O(pods x
types) work the reference burns per scheduling pass simply disappears.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from ..apis import wellknown as wk
from ..apis.requirements import Constraint, Requirements, _num
from ..lattice.tensors import Lattice

# keys that live on dedicated axes rather than the type axis
# structural keys resolved off the type lattice: offering axes, bin/pool
# identity, and the pool-level OS (the AMI family's, not the type's)
_AXIS_KEYS = frozenset({wk.LABEL_ZONE, wk.LABEL_CAPACITY_TYPE,
                        wk.LABEL_NODEPOOL, wk.LABEL_HOSTNAME, wk.LABEL_OS})

_CAT_KEY_INDEX = {k: i for i, k in enumerate(wk.DEVICE_CATEGORICAL_KEYS)}
_NUM_KEY_INDEX = {k: i for i, k in enumerate(wk.DEVICE_NUMERIC_KEYS)}


@dataclass
class CompiledMasks:
    type_mask: np.ndarray  # [T] bool
    zone_mask: np.ndarray  # [Z] bool
    cap_mask: np.ndarray   # [C] bool

    def any_feasible(self, available: np.ndarray) -> bool:
        """Any offering (t,z,c) compatible and available?"""
        m = (self.type_mask[:, None, None] & self.zone_mask[None, :, None]
             & self.cap_mask[None, None, :] & available)
        return bool(m.any())


def _categorical_mask(lattice: Lattice, key: str, c: Constraint) -> np.ndarray:
    ids = lattice.cat_ids[_CAT_KEY_INDEX[key]]  # [T], 0 = undefined
    vocab = lattice.cat_vocab[key]
    allowed = np.zeros((len(vocab) + 1,), dtype=bool)
    allowed[0] = c.allows_absent
    for value, vid in vocab.items():
        allowed[vid] = c.matches(value)
    return allowed[ids]


def _numeric_mask(lattice: Lattice, key: str, c: Constraint) -> np.ndarray:
    vals = lattice.num_vals[_NUM_KEY_INDEX[key]]  # [T], NaN = undefined
    defined = ~np.isnan(vals)
    ok = defined.copy()
    if c.gt is not None:
        ok &= vals > c.gt
    if c.lt is not None:
        ok &= vals < c.lt
    if c.include is not None:
        inc = {f for f in (_num(v) for v in c.include) if f is not None}
        ok &= np.isin(vals, list(inc)) if inc else False
    if c.exclude:
        exc = {f for f in (_num(v) for v in c.exclude) if f is not None}
        if exc:
            ok &= ~np.isin(vals, list(exc))
    return np.where(defined, ok, c.allows_absent)


def compile_masks(reqs: Requirements, lattice: Lattice,
                  extra_labels: Optional[Mapping[str, str]] = None,
                  skip_unresolved_custom: bool = False) -> CompiledMasks:
    """Compile a requirement set against the lattice.

    ``extra_labels`` are labels the eventual node carries beyond its
    instance-type labels (NodePool template labels, e.g. custom team labels)
    — a constraint on such a key resolves to a scalar and either passes or
    zeroes the whole mask.

    ``skip_unresolved_custom`` leaves constraints on unknown custom keys to
    the caller (build_problem resolves them exactly per NodePool via
    ``_custom_keys_ok``) instead of zeroing the mask.
    """
    T, Z, C = lattice.T, lattice.Z, lattice.C
    type_mask = np.ones((T,), dtype=bool)
    zone_mask = np.ones((Z,), dtype=bool)
    cap_mask = np.ones((C,), dtype=bool)
    extra = dict(extra_labels or {})

    for key in reqs.keys():
        c = reqs.get(key)
        if key == wk.LABEL_ZONE:
            zone_mask &= np.array([c.matches(z) for z in lattice.zones], dtype=bool)
        elif key == wk.LABEL_CAPACITY_TYPE:
            cap_mask &= np.array([c.matches(ct) for ct in lattice.capacity_types], dtype=bool)
        elif key in (wk.LABEL_NODEPOOL, wk.LABEL_HOSTNAME):
            continue  # dedicated structural axes (bin identity / pool choice)
        elif key == wk.LABEL_OS:
            # the OS comes from the pool's AMI family, not the instance
            # type (any EC2 type runs either OS): enforced pool-vs-pod via
            # the requirements algebra in build_problem, with an implicit
            # linux default on pools that don't constrain it
            continue
        elif key == wk.LABEL_REGION:
            region = lattice.labels[0].get(wk.LABEL_REGION, "") if lattice.labels else ""
            if not c.matches(region):
                type_mask[:] = False
        elif key in _CAT_KEY_INDEX:
            # lattice-modeled keys: per-type truth always wins; a template
            # label must never shadow real hardware attributes
            type_mask &= _categorical_mask(lattice, key, c)
        elif key in _NUM_KEY_INDEX:
            type_mask &= _numeric_mask(lattice, key, c)
        elif key in extra:
            if not c.matches(extra[key]):
                type_mask[:] = False
        else:
            # custom key undefined on instance types and not provided by the
            # node template: satisfiable only if the constraint tolerates
            # absence (matches Requirements.intersects semantics)
            if not skip_unresolved_custom and not c.allows_absent:
                type_mask[:] = False
    return CompiledMasks(type_mask=type_mask, zone_mask=zone_mask, cap_mask=cap_mask)
