"""A plain first-fit-decreasing packer, in NumPy and exact integers.

Karpenter's documented scheduling loop (designs/bin-packing.md): pods
sorted by size, largest first (cpu, then memory); each pod goes into the
first node, in the order the nodes were opened, that can still hold it
together with what it holds; a pod no open node takes opens a new node
from the highest-weight NodePool whose types can hold it; every new node
is launched at the cheapest offering of the types that still hold its
contents. Existing nodes come first, keep their type and are not priced.

Pods of one shape (the same requests and the same requirements) are
identical, so the loop runs over shapes: a node that refuses one pod of a
shape refuses the rest, and the first-fit of a shape's pods is a running
sum over the nodes. That gives the same plan as the loop over pods.

A new node starts with every type of its pool that the shape allows and
that has an offering: the plain loop caps no node's size. ``alloc`` may
replace the catalog's allocatable ([T,5]); the control passes the raw
capacity there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import catalog as rc


def shape_order(shapes) -> List[int]:
    """Largest first: cpu, then memory, then the other axes; ties by the
    shapes' requirements, so that the order in which shapes arrive does
    not change the plan."""
    return sorted(range(len(shapes)),
                  key=lambda s: (tuple(-int(v) for v in shapes[s]["req"]),
                                 sorted(repr(r) for r in shapes[s]["requirements"])))


def _fits(alloc: np.ndarray, head_from: np.ndarray, req: np.ndarray) -> np.ndarray:
    """[...,T] how many pods of ``req`` fit into ``alloc - head_from``."""
    pos = req > 0
    head = alloc - head_from                               # [...,T,R]
    per = head[..., pos] // req[pos]
    return np.clip(per.min(axis=-1), 0, None)


def pack(cat: rc.Catalog, problem: Dict, alloc: Optional[np.ndarray] = None) -> Dict:
    """Plan ``problem`` (see ``check.py`` for its keys). Returns the plan:
    ``new_nodes`` (pool, type, zone, capacity_type, price, pods, and the
    flexible sets: every type the node's contents allow, cheapest first,
    and the zones and capacity types they are offered in),
    ``existing_assignments`` (node name -> pods), ``unschedulable``
    (pod name -> reason) and ``new_node_cost``."""
    alloc = cat.alloc if alloc is None else alloc
    shapes, pools = problem["shapes"], problem["pools"]
    T, Z, C = cat.available.shape
    pools = sorted(pools, key=lambda p: (-p["weight"], p["name"]))
    pool_t = [rc.requirement_mask(cat, p["requirements"]) for p in pools]
    pool_c = [rc.capacity_type_mask(p["requirements"]) for p in pools]
    ex = problem.get("existing", [])
    nb = len(ex)
    cum = np.zeros((nb, len(rc.AXES)), np.int64)
    tmask = np.zeros((nb, T), bool)
    zmask = np.zeros((nb, Z), bool)
    cmask = np.zeros((nb, C), bool)
    for i, b in enumerate(ex):
        cum[i] = b["used"]
        tmask[i, cat.index[b["type"]]] = True
        zmask[i, cat.zones.index(b["zone"])] = True
        cmask[i, rc.CAPACITY_TYPES.index(b["capacity_type"])] = True
    fixed = np.ones(nb, bool)
    pool_of = [b.get("pool") for b in ex]
    contents: List[List[str]] = [[] for _ in range(nb)]
    unschedulable: Dict[str, str] = {}
    by_shape = problem["pods_by_shape"]

    for s in shape_order(shapes):
        names = by_shape[s]
        if not names:
            continue
        req = np.asarray(shapes[s]["req"], np.int64)
        st = rc.requirement_mask(cat, shapes[s]["requirements"])
        sc = rc.capacity_type_mask(shapes[s]["requirements"])
        n, done = len(names), 0
        if len(cum):
            tm = tmask & st[None, :]
            cm = cmask & sc[None, :]
            reach = np.ones_like(tm)
            free = ~fixed
            if free.any():
                reach[free] = (cat.available[None] & zmask[free][:, None, :, None]
                               & cm[free][:, None, None, :]).any(axis=(2, 3))
            valid = tm & reach
            rows, cols = np.nonzero(valid)
            fit = np.zeros(len(cum), np.int64)
            np.maximum.at(fit, rows, _fits(alloc[cols], cum[rows], req))
            prior = np.cumsum(fit) - fit
            take = np.clip(n - prior, 0, fit)
            for b in np.nonzero(take)[0]:
                k = int(take[b])
                contents[b].extend(names[done:done + k])
                done += k
                cum[b] += k * req
                keep = np.nonzero(valid[b])[0]
                tmask[b] = False
                tmask[b, keep] = (alloc[keep] >= cum[b]).all(axis=1)
                cmask[b] = cm[b]
        rem = n - done
        if rem == 0:
            continue
        for pi, p in enumerate(pools):
            c_ok = pool_c[pi] & sc
            reach = (cat.available & c_ok[None, None, :]).any(axis=(1, 2))
            types = pool_t[pi] & st & reach
            n_per = int(np.where(types, _fits(alloc, 0, req), 0).max(initial=0))
            if n_per >= 1:
                break
        else:
            for name in names[done:]:
                unschedulable[name] = "no NodePool type holds the pod"
            continue
        new = -(-rem // n_per)
        counts = np.full(new, n_per, np.int64)
        counts[-1] = rem - n_per * (new - 1)
        add_cum = counts[:, None] * req[None, :]
        cum = np.concatenate([cum, add_cum])
        tmask = np.concatenate([tmask, types[None, :]
                                & (alloc[None, :, :] >= add_cum[:, None, :]).all(axis=2)])
        zmask = np.concatenate([zmask, np.ones((new, Z), bool)])
        cmask = np.concatenate([cmask, np.repeat(c_ok[None, :], new, axis=0)])
        fixed = np.concatenate([fixed, np.zeros(new, bool)])
        for k in counts:
            contents.append(list(names[done:done + int(k)]))
            pool_of.append(p["name"])
            done += int(k)

    new_nodes, cost = [], 0.0
    for b in range(nb, len(cum)):
        allowed = (tmask[b][:, None, None] & zmask[b][None, :, None]
                   & cmask[b][None, None, :] & cat.available)
        p = np.where(allowed, cat.price, np.inf)
        i = int(np.argmin(p))
        t, z, c = np.unravel_index(i, (T, Z, C))
        types = np.nonzero(allowed.any(axis=(1, 2)))[0]
        types = types[np.argsort(p[types].min(axis=(1, 2)), kind="stable")]
        new_nodes.append({"pool": pool_of[b], "type": cat.names[t],
                          "zone": cat.zones[z], "capacity_type": rc.CAPACITY_TYPES[c],
                          "price": float(p.flat[i]), "pods": contents[b],
                          "feasible_types": [cat.names[k] for k in types],
                          "feasible_zones": [cat.zones[k] for k in
                                             np.nonzero(allowed.any(axis=(0, 2)))[0]],
                          "feasible_capacity_types": [rc.CAPACITY_TYPES[k] for k in
                                                      np.nonzero(allowed.any(axis=(0, 1)))[0]]})
        cost += float(p.flat[i])
    return {"new_nodes": new_nodes,
            "existing_assignments": {ex[b]["name"]: contents[b]
                                     for b in range(nb) if contents[b]},
            "unschedulable": unschedulable, "new_node_cost": cost}
