"""Kubernetes resource-quantity parsing.

Mirrors the semantics the reference gets from apimachinery's
``resource.Quantity`` (used pervasively, e.g. reference
pkg/providers/instancetype/types.go for capacity/overhead math), implemented
from scratch: plain numbers, decimal SI suffixes (k, M, G, T, P, E, m for
milli) and binary suffixes (Ki, Mi, Gi, Ti, Pi, Ei).

Internal canonical units for the solver's resource vectors (chosen so float32
device tensors stay exact for realistic magnitudes):

- cpu:                millicores   (``parse_cpu_millis``)
- memory / storage:   MiB          (``parse_mem_mib``)
- counted resources:  plain counts
"""

from __future__ import annotations

import re

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18, "m": 1e-3, "": 1.0}

_QTY_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)\s*$")


def parse_quantity(s: "str | int | float") -> float:
    """Parse a k8s-style quantity string to a float in base units."""
    if isinstance(s, (int, float)):
        return float(s)
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    num, suffix = m.groups()
    value = float(num)
    if suffix in _BINARY:
        return value * _BINARY[suffix]
    if suffix in _DECIMAL:
        return value * _DECIMAL[suffix]
    raise ValueError(f"invalid quantity suffix: {s!r}")


def parse_cpu_millis(s: "str | int | float") -> float:
    """CPU quantity -> millicores. '1' -> 1000, '100m' -> 100, '2.5' -> 2500."""
    return parse_quantity(s) * 1000.0


def parse_mem_mib(s: "str | int | float") -> float:
    """Memory/storage quantity -> MiB. '1Gi' -> 1024, '512Mi' -> 512, 1073741824 -> 1024."""
    return parse_quantity(s) / float(2**20)


def format_quantity(v: float) -> str:
    """Best-effort human format (for logs/events only — not round-trippable)."""
    for suffix, mult in (("Ei", 2**60), ("Pi", 2**50), ("Ti", 2**40), ("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
        if v >= mult and (v / mult) == int(v / mult):
            return f"{int(v / mult)}{suffix}"
    if v == int(v):
        return str(int(v))
    return str(v)
