"""Holds a plan, or a what-if probe's verdict, to the deployment's guarantees.

A *problem* is plain data that the benchmark hands to both sides:

- ``shapes``: per pod shape, ``req`` (the five ``catalog.AXES`` in exact
  integer units: millicores, MiB, pods, GPUs, Neuron devices) and
  ``requirements`` (``(key, op, values)`` of its node selector);
- ``pools``: ``name``, ``weight`` and ``requirements`` of each NodePool;
- ``pods_by_shape``: the pending pods' names, per shape;
- ``existing``: the nodes that stand (``name``, ``pool``, ``type``,
  ``zone``, ``capacity_type``, and ``used``, the requests already bound
  there).

A *plan* has ``new_nodes`` (``pool``, ``type``, ``zone``,
``capacity_type``, ``price``, ``pods``, and the node's flexible offering:
``feasible_types``, ``feasible_zones``, ``feasible_capacity_types``, the
sets a launch may fall through to), ``existing_assignments`` (node name
-> pending pods placed there), ``unschedulable`` (pod name -> reason) and
``new_node_cost``.

``check_plan`` counts what breaks a guarantee, by kind; every count must
be 0. Each new node must launch at the cheapest available offering of
its own flexible sets, and every type and capacity type in those sets
must hold the node's pods and meet its pool's and its pods' requirements.
``check_verdict`` does the same for one batched what-if verdict.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from . import catalog as rc
from . import ffd

NUMBERS = ("pods_misplaced", "nodes_over_allocatable", "selector_breaks",
           "offering_breaks", "cheapest_breaks", "flexible_breaks", "cost_breaks")


class _Shapes:
    def __init__(self, cat: rc.Catalog, problem: Dict):
        shapes = problem["shapes"]
        self.req = np.array([s["req"] for s in shapes], np.int64).reshape(-1, len(rc.AXES))
        self.types = np.array([rc.requirement_mask(cat, s["requirements"]) for s in shapes]
                              ).reshape(len(shapes), cat.T)
        self.caps = np.array([rc.capacity_type_mask(s["requirements"]) for s in shapes]
                             ).reshape(len(shapes), len(rc.CAPACITY_TYPES))
        self.of = {n: s for s, names in enumerate(problem["pods_by_shape"]) for n in names}


def _alone_fits(cat: rc.Catalog, problem: Dict, sh: _Shapes, s: int) -> bool:
    """Can a new node of some pool hold one pod of shape ``s`` alone?"""
    for p in problem["pools"]:
        types = rc.requirement_mask(cat, p["requirements"]) & sh.types[s]
        caps = rc.capacity_type_mask(p["requirements"]) & sh.caps[s]
        offered = (cat.available & caps[None, None, :]).any(axis=(1, 2))
        if ((cat.alloc >= sh.req[s]).all(axis=1) & types & offered).any():
            return True
    return False


def _flexible(cat: rc.Catalog, sh: _Shapes, pool, node: Dict, tzc: tuple,
              counts: np.ndarray, out: Dict[str, int]) -> None:
    """A new node's flexible sets: each type and capacity type in them
    holds the node's pods and meets every requirement, and the node
    launches at the cheapest available offering of the sets, which its
    own choice lies in (one break per node for each)."""
    ts = [cat.index.get(n, -1) for n in node.get("feasible_types", ())]
    zs = [cat.zones.index(z) if z in cat.zones else -1 for z in node.get("feasible_zones", ())]
    cs = [rc.CAPACITY_TYPES.index(c) if c in rc.CAPACITY_TYPES else -1
          for c in node.get("feasible_capacity_types", ())]
    if min(ts + zs + cs, default=-1) < 0 or not (ts and zs and cs):
        out["flexible_breaks"] += 1
        out["cheapest_breaks"] += 1
        return
    reqs = [] if pool is None else list(pool["requirements"])
    types = rc.requirement_mask(cat, reqs) & sh.types[counts > 0].all(axis=0)
    caps = rc.capacity_type_mask(reqs) & sh.caps[counts > 0].all(axis=0)
    types &= (cat.alloc >= counts @ sh.req).all(axis=1)
    out["flexible_breaks"] += int(not (types[ts].all() and caps[cs].all()))
    cells = cat.available[np.ix_(ts, zs, cs)]
    t, z, c = tzc
    inside = t in ts and z in zs and c in cs
    low = cat.price[np.ix_(ts, zs, cs)][cells].min(initial=np.inf)
    out["cheapest_breaks"] += int(not inside or np.float32(node["price"]) != low)


def check_plan(cat: rc.Catalog, problem: Dict, plan: Dict) -> Dict[str, int]:
    sh = _Shapes(cat, problem)
    out = dict.fromkeys(NUMBERS, 0)
    seen: Counter = Counter()
    pools = {p["name"]: p for p in problem["pools"]}
    existing = {b["name"]: b for b in problem.get("existing", [])}

    def shapes_of(pods: List[str]) -> np.ndarray:
        known = [sh.of[n] for n in pods if n in sh.of]
        return np.bincount(np.array(known, np.int64), minlength=len(sh.req))

    def hold(t: int, c: int, used: np.ndarray, counts: np.ndarray) -> None:
        load = used + counts @ sh.req
        out["nodes_over_allocatable"] += int((load > cat.alloc[t]).any())
        bad = counts > 0
        bad &= ~(sh.types[:, t] & sh.caps[:, c])
        out["selector_breaks"] += int(counts[bad].sum())

    total = 0.0
    for node in plan["new_nodes"]:
        seen.update(node["pods"])
        t = cat.index.get(node["type"])
        z = cat.zones.index(node["zone"]) if node["zone"] in cat.zones else None
        c = (rc.CAPACITY_TYPES.index(node["capacity_type"])
             if node["capacity_type"] in rc.CAPACITY_TYPES else None)
        total += float(node["price"])
        if t is None or z is None or c is None or not cat.available[t, z, c]:
            out["offering_breaks"] += 1
            continue
        if np.float32(node["price"]) != cat.price[t, z, c]:
            out["offering_breaks"] += 1
        pool = pools.get(node["pool"])
        if (pool is None or not rc.requirement_mask(cat, pool["requirements"])[t]
                or not rc.capacity_type_mask(pool["requirements"])[c]):
            out["selector_breaks"] += 1
        counts = shapes_of(node["pods"])
        hold(t, c, np.zeros(len(rc.AXES), np.int64), counts)
        _flexible(cat, sh, pool, node, (t, z, c), counts, out)
    for name, pods in plan["existing_assignments"].items():
        seen.update(pods)
        b = existing.get(name)
        if b is None:
            out["pods_misplaced"] += len(pods)
            continue
        hold(cat.index[b["type"]], rc.CAPACITY_TYPES.index(b["capacity_type"]),
             np.asarray(b["used"], np.int64), shapes_of(pods))
    seen.update(list(plan["unschedulable"]))
    for name in plan["unschedulable"]:
        s = sh.of.get(name)
        if s is not None and _alone_fits(cat, problem, sh, s):
            out["pods_misplaced"] += 1
    out["pods_misplaced"] += sum(1 for n in sh.of if seen[n] != 1)
    out["pods_misplaced"] += sum(1 for n in seen if n not in sh.of)
    # a sum of float32 prices in float64 is exact at these sizes, in any order
    out["cost_breaks"] += int(total != float(plan["new_node_cost"]))
    return out


def check_verdict(cat: rc.Catalog, problem: Dict, verdict: Dict,
                  removed_price: float, tally: Optional[Counter] = None) -> int:
    """Breaks in one what-if probe verdict (``feasible``, ``n_new``,
    ``new_cost``, ``new_cap_type``, ``flex``, ``removed_price``) for the
    removal whose what-if is ``problem``.

    Where the evictees share one shape, first-fit into the standing nodes
    places as many as any placement can, so whether they fit with no new
    node is exact, and so is how many are left for new nodes; a new node
    holds at most the pool's best single-type fit, which bounds ``n_new``
    from below. A lone new node holding the ``left`` pods launches at the
    cheapest offering of one of the types that hold them, at that
    offering's capacity type; where its ``flex`` (the count of types it may
    launch as) is the count of all such types, it may launch as any of
    them, and its cost is the cheapest of all their offerings. ``tally``
    counts the lone new nodes held so (``lone_new_node``) and those held
    to the cheapest of all (``lone_every_type``)."""
    breaks = int(np.float64(verdict["removed_price"]) != removed_price)
    ref = ffd.pack(cat, problem)
    placed_all = not ref["unschedulable"]
    if verdict["feasible"] != placed_all:
        return breaks + 1
    if not placed_all:
        return breaks
    shapes = [i for i, names in enumerate(problem["pods_by_shape"]) if names]
    if len(shapes) == 1 and (verdict["n_new"] == 0) != (not ref["new_nodes"]):
        return breaks + 1
    if verdict["n_new"] == 0:
        return breaks + int(verdict["new_cost"] != 0)
    if len(shapes) != 1:
        return breaks + int(verdict["n_new"] == 1 and not np.isin(
            np.float32(verdict["new_cost"]), cat.price[cat.available]).any())
    shape = problem["shapes"][shapes[0]]
    req = np.asarray(shape["req"], np.int64)
    left = sum(len(n["pods"]) for n in ref["new_nodes"])
    best = max(int(ffd._fits(cat.alloc, 0, req).max()), 1)
    if verdict["n_new"] < -(-left // best):
        return breaks + 1
    if verdict["n_new"] != 1:
        return breaks
    pool = next(p for p in problem["pools"] if p["name"] == ref["new_nodes"][0]["pool"])
    reqs = list(pool["requirements"]) + list(shape["requirements"])
    types = rc.requirement_mask(cat, reqs) & (cat.alloc >= left * req).all(axis=1)
    cells = (cat.available & types[:, None, None]
             & rc.capacity_type_mask(reqs)[None, None, :])
    per_type = np.where(cells, cat.price, np.inf).min(axis=(1, 2))
    got = np.float32(verdict["new_cost"])
    kinds = per_type == got
    every = verdict["flex"] == int(np.isfinite(per_type).sum())
    if tally is not None:
        tally.update(lone_new_node=1, lone_every_type=int(every))
    if not kinds.any() or (every and got != per_type.min()):
        return breaks + 1
    at = {rc.CAPACITY_TYPES[c] for c in np.nonzero(
        (cells & kinds[:, None, None] & (cat.price == got)).any(axis=(0, 1)))[0]}
    return breaks + int(verdict["new_cap_type"] not in at)
