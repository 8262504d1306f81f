"""Back-to-back provisioning waves: ``build_problem`` then ``Solver.solve``.

The traffic names the waves by ``draws``: each is drawn by the
configuration's generator from its own fixed draw, so every seed plans the
same pods and the same work. The run's seed orders them: which wave comes
first, the order in which each wave's shapes arrive (a shape's pods arrive
together, as a deployment's do), and the pods' names, so two runs never
plan a pod of the same name. The window cycles through the
waves, and no wave follows itself while there are two or more.

A step is one wave, timed from its pending pods to its ``NodePlan`` on the
host. A step that raises, or whose plan left the device path
(``solver_path != "device"``), counts as failed.

Every plan is held to the plain reference: each step keeps a digest of its
plan, and the first plan of each digest of a wave, which after the window
is checked in full (``reference/check.py``); each wave is planned once by
the reference FFD for ``cost_vs_ffd``, each wave weighing alike.
"""

from __future__ import annotations

import traceback
from typing import Dict, List

import numpy as np


def setup(env: Dict) -> Dict:
    from karpenter_provider_aws_tpu_torch.lattice import build_lattice
    from karpenter_provider_aws_tpu_torch.lattice.realdata import load_catalog
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem
    from karpenter_provider_aws_tpu_torch.solver.solve import Solver
    from . import port

    cfg, traffic = env["cfg"], env["traffic"]
    rng = np.random.default_rng(env["seed"])
    salt = f"{int(rng.integers(1 << 32)):08x}"
    order = rng.permutation(len(traffic["draws"]))
    waves = []
    for k in order:
        d = traffic["draws"][k]
        plain = env["gen"].draw(cfg, np.random.default_rng(d), f"{salt}w{d}-")
        # the shapes' pods arrive one shape after another, in the seed's order
        perm = rng.permutation(len(plain["shapes"]))
        plain = {**plain, "shapes": [plain["shapes"][i] for i in perm],
                 "pods_by_shape": [plain["pods_by_shape"][i] for i in perm]}
        waves.append({"draw": d, "plain": plain, "pods": port.pods(plain),
                      "pools": port.pools(plain)})
    catalog = env["base"] / "reference" / "catalog.json"
    lattice = build_lattice(load_catalog(catalog, require_price=True),
                            zones=tuple(cfg["zones"]))
    state = {"env": env, "waves": waves, "lattice": lattice, "kept": {},
             "solver": Solver(lattice, device=env["device"]),
             "build_problem": build_problem}
    for i in range(int(traffic["warmup_rounds"]) * len(waves)):
        step(state, i)
    state["kept"].clear()
    return state


def step(state: Dict, i: int) -> Dict:
    spans = state["env"]["spans"]
    w = i % len(state["waves"])
    wave = state["waves"][w]
    rec: Dict = {"w": w}
    try:
        with spans("wave", rec):
            with spans("build_problem", rec):
                problem = state["build_problem"](wave["pods"], wave["pools"],
                                                 state["lattice"])
            with spans("solve", rec):
                plan = state["solver"].solve(problem)
    except Exception:                 # counted, and the window goes on
        print(f"wave {i} raised:", file=state["env"]["log"])
        traceback.print_exc(file=state["env"]["log"])
        rec["failed"] = True
        return rec
    # the plan is kept only where it is the first of its wave to read so:
    # a window's worth of 50k-pod plans would load the collector
    key = (w, hash(_key(plan)))
    state["kept"].setdefault(key, plan)
    st = plan.stage_ms
    rec.update(key=key, cost=plan.new_node_cost, failed=plan.solver_path != "device",
               staging_ms=st.get("build", 0.0) + st.get("upload", 0.0),
               scan_issue_ms=st.get("compute", 0.0),
               decode_ms=st.get("download", 0.0) + st.get("decode", 0.0))
    return rec


def release(state: Dict) -> None:
    import torch
    state.pop("solver", None)
    state.pop("lattice", None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _key(plan) -> tuple:
    return (tuple((n.node_pool, n.instance_type, n.zone, n.capacity_type,
                   n.price_per_hour, tuple(n.pods)) for n in plan.new_nodes),
            tuple(sorted(plan.unschedulable)), plan.new_node_cost)


def check(state: Dict, records: List[Dict]) -> Dict:
    from ..reference import catalog as rc, check as rcheck, ffd
    from . import port

    cfg = state["env"]["cfg"]
    cat = rc.load(cfg["zones"], cfg["local_zones"])
    numbers = dict.fromkeys(("answers_missing",) + rcheck.NUMBERS, 0)
    numbers["answers_missing"] = sum(1 for r in records if "key" not in r)
    new_nodes = 0
    for (w, _), plan in state["kept"].items():
        plain = state["waves"][w]["plain"]
        got = port.plain_plan(plan, cat, plain)
        new_nodes += len(got["new_nodes"])
        for k, v in rcheck.check_plan(cat, plain, got).items():
            numbers[k] += v
    print(f"checked: {len(state['kept'])} plans, {new_nodes} new nodes",
          file=state["env"]["log"])
    # $/hr per wave: the mean of its plans' over the reference FFD's
    costs: Dict[int, List[float]] = {}
    for r in records:
        if "key" in r:
            costs.setdefault(r["key"][0], []).append(r["cost"])
    port_sum = sum(sum(c) / len(c) for c in costs.values())
    ref_sum = sum(ffd.pack(cat, state["waves"][w]["plain"])["new_node_cost"] for w in costs)
    return {"numbers": numbers, "plans_checked": len(state["kept"]),
            "cost_vs_ffd": port_sum / ref_sum if ref_sum > 0 else None}
