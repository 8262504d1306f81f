"""Consolidation evaluations over a standing fleet, back to back.

Set-up stands the configuration's fleet up in the port's consolidation
stack (``workloads.ConsolidationStack``: cluster mirror, cloud, provisioner
and disruption controller with its ``ConsolidationEngine``), every pod
bound, and steps the clock past ``consolidate_after``.

A step is one evaluation, as the disruption controller's consolidation
pass makes it, with nothing executed:

1. a seeded churn moves ``churn_share`` of the pods to other nodes (each
   from a node holding two or more, to one holding at most
   ``max_target_pods``), so the engine's verdict cache is cleared and the
   fleet keeps every node;
2. the probe sets, from the benchmark's own copy of the controller's
   ladder: the candidates cheapest to disrupt first (fewest pods, then
   claim name), every prefix of ``prefix_probes`` evenly spaced lengths
   from 2 to all, and ``single_probes`` single candidates from a window
   that moves on by as many each step;
3. ``ConsolidationEngine.probe`` on those sets (one batched dispatch);
4. one exact what-if, ``Solver.solve_relaxed``, of the best set the
   verdicts admit by the controller's criterion: the largest admitted
   prefix, else the first admitted single.

A step fails where a verdict came from the host fallback or the cache, or
the what-if left the device path, or anything raised. After the window
every verdict and every what-if plan is held to the plain reference,
replaying the churn on the plain fleet.
"""

from __future__ import annotations

import traceback
from collections import Counter
from typing import Dict, List

import numpy as np

SAVINGS_EPS = 1e-4          # the controller's CONSOLIDATION_SAVINGS_EPS
SPOT_TO_SPOT_MIN_TYPES = 15


def setup(env: Dict) -> Dict:
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.apis.objects import NodePoolDisruption
    from karpenter_provider_aws_tpu_torch.lattice import build_lattice
    from karpenter_provider_aws_tpu_torch.lattice.realdata import load_catalog
    from karpenter_provider_aws_tpu_torch.solver.problem import ExistingBin
    from karpenter_provider_aws_tpu_torch.solver.solve import Solver
    from . import port

    cfg, traffic = env["cfg"], env["traffic"]
    fleet = env["gen"].draw(cfg, np.random.default_rng(env["seed"]))
    catalog = env["base"] / "reference" / "catalog.json"
    lattice = build_lattice(load_catalog(catalog, require_price=True),
                            zones=tuple(cfg["zones"]))
    solver = Solver(lattice, device=env["device"])
    p = cfg["pool"]
    pool = port.pools({"pools": fleet["pools"]}, disruption=NodePoolDisruption(
        consolidation_policy=p["consolidation_policy"],
        consolidate_after=float(p["consolidate_after_s"])))
    stack = workloads.ConsolidationStack(
        lattice, pool, solver,
        spot_to_spot_consolidation=bool(cfg["spot_to_spot_consolidation"]))
    pods = port.pods({"shapes": [fleet["shape"]],
                      "pods_by_shape": [[n for names in fleet["pods"] for n in names]]})
    existing = [ExistingBin(name=n["name"], node_pool=n["pool"], instance_type=n["type"],
                            zone=n["zone"], capacity_type=n["capacity_type"],
                            used=np.zeros_like(lattice.alloc[lattice.name_to_idx[n["type"]]]))
                for n in fleet["nodes"]]
    workloads.seed_fleet(stack, existing, pods)
    stack.clock.step(float(p["consolidate_after_s"]) + 1.0)

    cluster = stack.cluster
    node_index = {cluster.pods[names[0]].node_name: i
                  for i, names in enumerate(fleet["pods"])}
    state = {"env": env, "fleet": fleet, "stack": stack, "solver": solver,
             "engine": stack.disruption.engine, "pools": pool,
             "node_index": node_index, "node_name": {i: n for n, i in node_index.items()},
             "on_node": [list(names) for names in fleet["pods"]],
             "churn_rng": np.random.default_rng([env["seed"], 1]),
             "moves": [], "cur": None}

    probe_batch = solver.probe_batch

    def timed_probe_batch(problems):
        with env["spans"]("probe_batch", state["cur"]):
            return probe_batch(problems)
    solver.probe_batch = timed_probe_batch
    for i in range(int(traffic["warmup_steps"])):
        step(state, -1 - i)
    return state


def _churn(state: Dict) -> List[tuple]:
    """Moves (pod, from node, to node), plain node indices."""
    traffic, rng, on = state["env"]["traffic"], state["churn_rng"], state["on_node"]
    n = max(1, int(round(traffic["churn_share"] * sum(len(p) for p in on))))
    moves = []
    while len(moves) < n:
        src, dst = (int(x) for x in rng.integers(len(on), size=2))
        if src == dst or len(on[src]) < 2 or len(on[dst]) >= traffic["max_target_pods"]:
            continue
        pod = on[src].pop(int(rng.integers(len(on[src]))))
        on[dst].append(pod)
        moves.append((pod, src, dst))
    return moves


def _admitted(v, removed) -> bool:
    """The controller's consolidation criterion on a verdict."""
    pr = v.probe
    if not pr.feasible or pr.n_new > 1 or pr.new_cost >= v.removed_price - SAVINGS_EPS:
        return False
    if (pr.n_new == 1 and pr.new_cap_type == "spot"
            and any(c.capacity_type == "spot" for c in removed)):
        return pr.flex >= SPOT_TO_SPOT_MIN_TYPES
    return True


def _what_if(state: Dict, removed, node_by_claim, by_node):
    from karpenter_provider_aws_tpu_torch.lattice.tensors import masked_view_versioned
    stack, solver = state["stack"], state["solver"]
    cluster = stack.cluster
    lattice = masked_view_versioned(solver.lattice, stack.unavailable)
    removed_nodes = {node_by_claim[c.name].name for c in removed}
    names = {c.name for c in removed}
    pods = [p for c in removed for p in by_node.get(node_by_claim[c.name].name, ())]
    existing = [b for b in cluster.existing_bins(lattice)
                if b.name not in removed_nodes and b.name not in names]
    bound = [bp for bp in cluster.bound_pods() if bp.node_name not in removed_nodes]
    pvcs, storage_classes = cluster.volume_state()
    return solver.solve_relaxed(pods, state["pools"], lattice, existing=existing,
                                daemonset_pods=cluster.daemonset_pods(), bound_pods=bound,
                                pvcs=pvcs, storage_classes=storage_classes)


def step(state: Dict, i: int) -> Dict:
    env, traffic = state["env"], state["env"]["traffic"]
    spans, cluster = env["spans"], state["stack"].cluster
    rec: Dict = {"i": i}
    state["cur"] = rec
    try:
        with spans("evaluation", rec):
            with spans("churn", rec):
                moves = _churn(state)
                for pod, _, dst in moves:
                    cluster.bind_pod(pod, state["node_name"][dst])
            state["moves"].append(moves)
            rec["moves_upto"] = len(state["moves"])
            node_by_claim = cluster.nodes_by_claim()
            by_node = cluster.pods_by_node(include_daemonsets=False)
            cost = {c.name: len(by_node.get(node_by_claim[c.name].name, ()))
                    for c in cluster.snapshot_claims() if c.name in node_by_claim}
            cands = sorted((c for c in cluster.snapshot_claims() if c.name in cost),
                           key=lambda c: (cost[c.name], c.name))
            K = len(cands)
            ks = sorted({int(round(k)) for k in
                         np.linspace(2, K, min(K - 1, traffic["prefix_probes"]))})
            S = traffic["single_probes"]
            start = (max(i, 0) * S) % K
            singles = (cands[start:] + cands[:start])[:S]
            sets = [cands[:k] for k in ks] + [[c] for c in singles]
            with spans("probe", rec):
                verdicts = state["engine"].probe(sets, node_by_claim=node_by_claim,
                                                 by_node=by_node)
            chosen = next((j for j in range(len(ks) - 1, -1, -1)
                           if _admitted(verdicts[j], sets[j])), None)
            if chosen is None:
                chosen = next((j for j in range(len(ks), len(sets))
                               if _admitted(verdicts[j], sets[j])), None)
            plan = None
            if chosen is not None:
                with spans("exact_whatif", rec):
                    plan = _what_if(state, sets[chosen], node_by_claim, by_node)
    except Exception:                 # counted, and the window goes on
        print(f"evaluation {i} raised:", file=env["log"])
        traceback.print_exc(file=env["log"])
        rec["failed"] = True
        return rec
    idx = state["node_index"]
    rec["whatif_build_ms"] = rec["probe"] - rec.get("probe_batch", 0.0)
    rec["sets"] = [[idx[node_by_claim[c.name].name] for c in s] for s in sets]
    rec["verdicts"] = [(v.probe, v.removed_price) for v in verdicts]
    rec["chosen"], rec["plan"] = chosen, plan
    rec["failed"] = (any(v.host or v.cached for v in verdicts)
                     or (plan is not None and plan.solver_path != "device"))
    return rec


def release(state: Dict) -> None:
    import torch
    for k in ("stack", "solver", "engine"):
        state.pop(k, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: Dict, records: List[Dict]) -> Dict:
    from ..reference import catalog as rc, check as rcheck
    from . import port

    cfg, fleet = state["env"]["cfg"], state["fleet"]
    cat = rc.load(cfg["zones"], cfg["local_zones"])
    shape = fleet["shape"]
    req = np.asarray(shape["req"], np.int64)
    nodes = fleet["nodes"]
    node_price = []
    for n in nodes:
        p = cat.price[cat.index[n["type"]], cat.zones.index(n["zone"]),
                      rc.CAPACITY_TYPES.index(n["capacity_type"])]
        node_price.append(float(p) if np.isfinite(p) else 0.0)
    on = [list(names) for names in fleet["pods"]]
    applied = 0
    numbers = dict.fromkeys(("answers_missing",) + rcheck.NUMBERS + ("verdict_breaks",), 0)
    numbers["answers_missing"] = sum(1 for r in records if "sets" not in r)
    tally: Counter = Counter()
    for rec in sorted((r for r in records if "sets" in r), key=lambda r: r["moves_upto"]):
        while applied < rec["moves_upto"]:
            for pod, src, dst in state["moves"][applied]:
                on[src].remove(pod)
                on[dst].append(pod)
            applied += 1

        def problem(removed):
            gone = set(removed)
            return {"shapes": [shape], "pools": fleet["pools"],
                    "pods_by_shape": [[p for r in removed for p in on[r]]],
                    "existing": [{"name": state["node_name"][j], "pool": n["pool"],
                                  "type": n["type"], "zone": n["zone"],
                                  "capacity_type": n["capacity_type"],
                                  "used": req * len(on[j])}
                                 for j, n in enumerate(nodes) if j not in gone]}
        for removed, (probe, removed_price) in zip(rec["sets"], rec["verdicts"]):
            prob = problem(removed)
            numbers["verdict_breaks"] += rcheck.check_verdict(
                cat, prob, port.plain_verdict(probe, removed_price, cat, prob),
                sum(node_price[j] for j in removed), tally)
            tally["verdicts"] += 1
        if rec["plan"] is not None:
            removed = rec["sets"][rec["chosen"]]
            prob = problem(removed)
            got = port.plain_plan(rec["plan"], cat, prob)
            tally.update(what_ifs=1, what_if_new_nodes=len(got["new_nodes"]))
            for k, v in rcheck.check_plan(cat, prob, got).items():
                numbers[k] += v
    print(f"checked: {dict(sorted(tally.items()))}", file=state["env"]["log"])
    return {"numbers": numbers}
