"""Label-requirement algebra.

Host-side equivalent of the core scheduling requirements algebra the
reference uses pervasively (reference pkg/cloudprovider/cloudprovider.go:
246-251 `Requirements.Compatible`, CRD karpenter.sh_nodepools.yaml:338-401
for operators + minValues): label constraints with operators
In / NotIn / Exists / DoesNotExist / Gt / Lt, intersected per key.

Each key's constraint normalizes to:
  (allows_absent, include-set | universe, exclude-set, numeric interval)
which makes intersection and emptiness checks exact and cheap. The device
mask compiler (ops/masks.py) lowers the same normal form to boolean tensors
over the instance-type axis.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from . import wellknown


class Operator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


@dataclass(frozen=True)
class Requirement:
    """One NodeSelectorRequirement (+ optional minValues, CRD nodepools.yaml:338-401)."""

    key: str
    operator: Operator
    values: Tuple[str, ...] = ()
    min_values: Optional[int] = None

    def __post_init__(self):
        op = Operator(self.operator)
        object.__setattr__(self, "operator", op)
        object.__setattr__(self, "values", tuple(str(v) for v in self.values))
        if op in (Operator.EXISTS, Operator.DOES_NOT_EXIST) and self.values:
            raise ValueError(f"{op.value} takes no values (key={self.key})")
        if op in (Operator.GT, Operator.LT):
            if len(self.values) != 1:
                raise ValueError(f"{op.value} takes exactly one value (key={self.key})")
            # k8s NodeSelectorRequirement Gt/Lt compare integers (the
            # reference inherits this); Constraint.is_empty relies on it
            try:
                int(self.values[0])
            except ValueError:
                raise ValueError(
                    f"{op.value} requires an integer value (key={self.key}, got {self.values[0]!r})"
                ) from None
        if op == Operator.IN and not self.values:
            raise ValueError(f"In with empty values matches nothing (key={self.key})")


def _num(v: str) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


@dataclass
class Constraint:
    """Normalized allowed-value set for a single key."""

    allows_absent: bool = True
    include: Optional[frozenset] = None  # None = universe
    exclude: frozenset = frozenset()
    gt: Optional[float] = None  # value must be > gt
    lt: Optional[float] = None  # value must be < lt

    @staticmethod
    def universe() -> "Constraint":
        return Constraint()

    @staticmethod
    def from_requirement(r: Requirement) -> "Constraint":
        if r.operator == Operator.IN:
            return Constraint(allows_absent=False, include=frozenset(r.values))
        if r.operator == Operator.NOT_IN:
            return Constraint(allows_absent=True, exclude=frozenset(r.values))
        if r.operator == Operator.EXISTS:
            return Constraint(allows_absent=False)
        if r.operator == Operator.DOES_NOT_EXIST:
            return Constraint(allows_absent=True, include=frozenset())
        if r.operator == Operator.GT:
            return Constraint(allows_absent=False, gt=float(r.values[0]))
        if r.operator == Operator.LT:
            return Constraint(allows_absent=False, lt=float(r.values[0]))
        raise ValueError(r.operator)

    def intersect(self, other: "Constraint") -> "Constraint":
        if self.include is None:
            include = other.include
        elif other.include is None:
            include = self.include
        else:
            include = self.include & other.include
        gt = self.gt if other.gt is None else (other.gt if self.gt is None else max(self.gt, other.gt))
        lt = self.lt if other.lt is None else (other.lt if self.lt is None else min(self.lt, other.lt))
        return Constraint(
            allows_absent=self.allows_absent and other.allows_absent,
            include=include,
            exclude=self.exclude | other.exclude,
            gt=gt,
            lt=lt,
        )

    def matches(self, value: str) -> bool:
        """Does a present label value satisfy this constraint?"""
        if value in self.exclude:
            return False
        if self.include is not None and value not in self.include:
            return False
        if self.gt is not None or self.lt is not None:
            n = _num(value)
            if n is None:
                return False
            if self.gt is not None and not (n > self.gt):
                return False
            if self.lt is not None and not (n < self.lt):
                return False
        return True

    def is_empty(self) -> bool:
        """No present value can satisfy (absence may still be allowed)."""
        if self.include is not None:
            return not any(self.matches(v) for v in self.include)
        if self.gt is not None and self.lt is not None:
            # label numerics are integers in practice (reference Gt/Lt semantics)
            return self.lt <= self.gt + 1
        return False

    def intersects(self, other: "Constraint") -> bool:
        """Could any label state (a value, or absence) satisfy both?"""
        both = self.intersect(other)
        if both.allows_absent:
            return True
        return not both.is_empty()


def _requirements_from_node_selector(node_selector: Mapping[str, str]) -> List[Requirement]:
    return [Requirement(k, Operator.IN, (v,)) for k, v in node_selector.items()]


class Requirements:
    """A per-key intersection of requirements, mirroring the core algebra.

    - ``satisfied_by(labels)``: k8s nodeAffinity semantics against a concrete
      label set (In/Exists/Gt/Lt fail on absent key; NotIn/DoesNotExist pass).
    - ``intersects(other)``: Karpenter `Compatible` — per shared key the
      allowed sets must overlap; a key constrained on only one side is fine.
    """

    def __init__(self, reqs: Iterable[Requirement] = ()):  # noqa: D107
        self._constraints: Dict[str, Constraint] = {}
        self._reqs: List[Requirement] = []
        for r in reqs:
            self.add(r)

    @staticmethod
    def from_node_selector(node_selector: Mapping[str, str]) -> "Requirements":
        return Requirements(_requirements_from_node_selector(node_selector))

    @staticmethod
    def from_labels(labels: Mapping[str, str]) -> "Requirements":
        """Labels as requirements (each label pins its key, like NodePool template labels)."""
        return Requirements.from_node_selector(labels)

    def add(self, r: Requirement) -> "Requirements":
        c = Constraint.from_requirement(r)
        prev = self._constraints.get(r.key)
        self._constraints[r.key] = c if prev is None else prev.intersect(c)
        self._reqs.append(r)
        return self

    def merge(self, other: "Requirements") -> "Requirements":
        out = Requirements()
        for r in self._reqs:
            out.add(r)
        for r in other._reqs:
            out.add(r)
        return out

    @property
    def requirements(self) -> Sequence[Requirement]:
        return tuple(self._reqs)

    def keys(self):
        return self._constraints.keys()

    def get(self, key: str) -> Constraint:
        return self._constraints.get(key, Constraint.universe())

    def satisfied_by(self, labels: Mapping[str, str]) -> bool:
        for key, c in self._constraints.items():
            if key in labels:
                if not c.matches(labels[key]):
                    return False
            else:
                if not c.allows_absent:
                    return False
        return True

    def compatible_with(self, other: "Requirements", *,
                        allow_undefined_well_known: bool = True) -> bool:
        """DIRECTIONAL Compatible (reference cloudprovider.go:248 semantics):
        these requirements, evaluated against a node/pool described by
        ``other``. Shared keys must overlap; a key only WE constrain with an
        existence-requiring operator fails unless well-known (the lattice
        always defines well-known keys). Keys only ``other`` defines (e.g.
        NodePool template labels) are values the node will carry — they are
        never demands on us, which is what the symmetric ``intersects``
        would wrongly make them."""
        for key, c in self._constraints.items():
            if key in other._constraints:
                if not c.intersects(other._constraints[key]):
                    return False
            elif not c.allows_absent:
                if not (allow_undefined_well_known and key in wellknown.WELL_KNOWN_KEYS):
                    return False
        return True

    def intersects(self, other: "Requirements", *, allow_undefined_well_known: bool = True) -> bool:
        for key in set(self._constraints) & set(other._constraints):
            if not self._constraints[key].intersects(other._constraints[key]):
                return False
        # Reference semantics (cloudprovider.go:248 Compatible with
        # AllowUndefinedWellKnownLabels): an existence-requiring constraint on
        # a key the other side does not define is incompatible unless the key
        # is well-known (well-known keys are always defined by the lattice).
        for a, b in ((self, other), (other, self)):
            for key, c in a._constraints.items():
                if key in b._constraints or c.allows_absent:
                    continue
                if not (allow_undefined_well_known and key in wellknown.WELL_KNOWN_KEYS):
                    return False
        return True

    def min_values_satisfied(self, key_to_present_values: Mapping[str, Iterable[str]]) -> bool:
        """Per-requirement minValues check against the values actually present
        in a candidate instance-type set (reference instance.go:86-89 skips
        exotic-type filtering when minValues present; the core enforces the
        floor)."""
        for r in self._reqs:
            if r.min_values is None:
                continue
            c = self._constraints[r.key]
            present = key_to_present_values.get(r.key, ())
            n = len({v for v in present if c.matches(v)})
            if n < r.min_values:
                return False
        return True

    def __repr__(self):
        parts = ", ".join(f"{r.key} {r.operator.value} {list(r.values)}" for r in self._reqs)
        return f"Requirements({parts})"
