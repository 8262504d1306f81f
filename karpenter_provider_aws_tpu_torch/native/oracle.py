"""ctypes wrapper for the native FFD referee (``ffd.cc`` beside this
file, a copy of the repo's ``native/ffd.cc``).

Same per-pod sequential semantics as solver/oracle.py (the reference's Go
scheduler loop) over the full feature surface — new-node packing,
existing bins with bound-pod seeds, per-pool allocatable ceilings, and
hostname affinity classes; only strict custom keys over unknown-pool
nodes stay Python-side. Runs the 50k-pod x 700-type benchmark configs in
about a second, so full-scale cost parity (BASELINE.md <=2% envelope) is
asserted against the native referee on every bench run for all five
configs, not only on small regression fixtures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import ctypes
import numpy as np

from ..solver.problem import Problem
from .build import ensure_built


@dataclass
class NativeOraclePlan:
    num_new_nodes: int
    new_node_cost: float
    leftover: int
    chosen: List[Tuple[int, int, int]]   # (type, zone, captype) per NEW bin
    e_npods: Optional[np.ndarray] = None  # [E] pods ADDED per existing bin


def _c(a: np.ndarray, dtype):
    a = np.ascontiguousarray(a, dtype=dtype)
    return a, a.ctypes.data_as(ctypes.c_void_p)


def native_ffd_pack(problem: Problem, max_bins: int = 200_000) -> Optional[NativeOraclePlan]:
    """Run the native referee; None if the toolchain/library is
    unavailable or the problem uses strict custom keys over unknown-pool
    nodes (the one remaining Python-only scope) — callers fall back to
    the Python oracle. Existing (fixed) bins, per-pool allocatable
    ceilings, and hostname affinity classes (pm/po symmetry, presence
    needs, spread-class caps, single-bin co-location, bound-pod seeds)
    are all in native scope."""
    lib = ensure_built()
    if lib is None:
        return None
    if problem.strict_custom.any() and problem.E > 0 \
            and (problem.e_np < 0).any():
        # unknown-pool existing bins cannot be verified against custom-key
        # selectors; the Python oracle holds that logic. With no
        # unknown-pool bins the strictness resolves entirely through the
        # np masks, which are native scope.
        return None
    lat = problem.lattice
    G = problem.G
    from ..apis.resources import R

    holders = []

    def arr(a, dtype):
        h, p = _c(a, dtype)
        holders.append(h)
        return p

    out_cost = ctypes.c_float(0.0)
    out_leftover = ctypes.c_int64(0)
    chosen_t = np.zeros((max_bins,), np.int32)
    chosen_z = np.zeros((max_bins,), np.int32)
    chosen_c = np.zeros((max_bins,), np.int32)
    E = problem.E
    e_npods = np.zeros((max(E, 1),), np.int32)

    A = problem.A
    n = lib.ffd_pack(
        lat.T, lat.Z, lat.C, R, G, max(problem.NP, 1), E, A,
        arr(lat.alloc, np.float32),
        arr(lat.available, np.uint8),
        arr(np.nan_to_num(lat.price, posinf=3.4e38), np.float32),
        arr(problem.req, np.float32),
        arr(problem.count, np.int32),
        arr(problem.g_type, np.uint8),
        arr(problem.g_zone, np.uint8),
        arr(problem.g_cap, np.uint8),
        arr(problem.g_np, np.uint8),
        arr(problem.max_per_bin, np.int32),
        arr(problem.g_spread, np.int32),
        arr(problem.single_bin, np.uint8),
        arr(problem.g_match, np.uint8),
        arr(problem.g_owner, np.uint8),
        arr(problem.g_need, np.uint8),
        arr(problem.np_type, np.uint8),
        arr(problem.np_zone, np.uint8),
        arr(problem.np_cap, np.uint8),
        arr(problem.ds_overhead, np.float32),
        # +inf ceilings pass through as f32 max (no ceiling)
        arr(np.nan_to_num(problem.np_alloc_cap, posinf=3.4e38), np.float32),
        arr(problem.e_used, np.float32),
        arr(np.nan_to_num(problem.e_alloc, posinf=3.4e38), np.float32),
        arr(problem.e_type, np.int32),
        arr(problem.e_zone, np.int32),
        arr(problem.e_cap, np.int32),
        arr(problem.e_np, np.int32),
        arr(problem.e_pm, np.int32),
        arr(problem.e_po, np.uint8),
        ctypes.c_int(max_bins),
        ctypes.byref(out_cost),
        ctypes.byref(out_leftover),
        arr(chosen_t, np.int32),
        arr(chosen_z, np.int32),
        arr(chosen_c, np.int32),
        arr(e_npods, np.int32),
    )
    if n < 0:
        return None
    chosen = [(int(chosen_t[i]), int(chosen_z[i]), int(chosen_c[i]))
              for i in range(min(n, max_bins))]
    return NativeOraclePlan(num_new_nodes=n, new_node_cost=float(out_cost.value),
                            leftover=int(out_leftover.value), chosen=chosen,
                            e_npods=e_npods[:E] if E else None)
