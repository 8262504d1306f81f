"""Reconcile passes over a standing backlog, back to back, as a provisioner's
single reconcile loop runs them.

Set-up draws the configuration's backlog and standing nodes
(``configs/<config>.py Backlog``; its warm-up passes and the window's
first ``COST_PASSES`` churn alike on every seed), makes a cold full build through
``IncrementalProblemBuilder.build``, one ``Solver.solve`` and a priming
``Solver.solve_delta``, then the traffic's warm-up passes.

A step is one pass, timed from the churn to the ``NodePlan`` on the host:

1. the seeded churn (``Backlog.churn``): pods leave and arrive (copies of
   set-up's template pods, ``_arrivals``), standing nodes gain ``used``;
   a no-churn pass changes nothing;
2. ``IncrementalProblemBuilder.build`` with the pass's ``DirtySet`` and
   the touched pods, as the provisioner hands them over;
3. ``Solver.solve_delta`` where the build was incremental, ``Solver.solve``
   where it fell back to a full build.

The state keeps the last pass's problem (``state["problem"]``), which a
test solves again from scratch to compare the plans.

A step that raises, or whose plan left the device path
(``solver_path != "device"``), counts as failed. A full build or a
microloop abort is no failure: the step records it (``micro``,
``aborted``), with what the pass added to the solver's ``pipeline_stats``
and ``link_stats`` and its plan's ``stage_ms``, which the cell's per-layer
metrics read over the whole window.

Every step keeps the containers of the pod names its plan accounts for
(``plan_names``), and the check, replaying the passes from the seed,
holds each pass's names to the pass's pods. The plans of a fixed set of passes, chosen
by index alone (``kept``), are checked in full against each pass's plain
problem (``reference/check.py``), and the first ``COST_PASSES`` of the
window are planned by the reference FFD for ``cost_vs_ffd``.
"""

from __future__ import annotations

import copy
import time
import traceback
from itertools import chain
from typing import Dict, List

import numpy as np

from . import port

COST_PASSES = 16            # the window's first passes, kept and priced by the FFD
KEEP_EVERY = 32             # and every 32nd pass after them


def kept(i: int, traced: bool) -> bool:
    """Whether pass ``i`` of the window keeps its whole plan for the check."""
    return traced or 0 <= i < COST_PASSES or (i > COST_PASSES and i % KEEP_EVERY == 0)


def bin_used(used) -> np.ndarray:
    """A standing node's plain ``used`` (exact integers on ``port.AXES``) as
    ``ExistingBin.used``: float32 on the lattice's resource axes, in its
    units (millicores, MiB, counts), which hold such integers exactly."""
    from karpenter_provider_aws_tpu_torch.apis.resources import RESOURCE_AXES
    out = np.zeros(len(RESOURCE_AXES), np.float32)
    for k, axis in enumerate(port.AXES):
        out[RESOURCE_AXES.index(axis)] = used[k]
    return out


def _reference_catalog(cfg: Dict):
    from ..reference import catalog as rc
    return rc.load(cfg["zones"], cfg["local_zones"])


def _backlog(env: Dict, cat):
    """The run's backlog: its warm-up and the window's first ``COST_PASSES``
    passes churn by the traffic's fixed draw, so ``cost_vs_ffd`` prices the
    same problems on every seed."""
    fixed = int(env["traffic"]["warmup_passes"]) + COST_PASSES
    return env["gen"].Backlog(env["cfg"], env["traffic"], cat, env["seed"], fixed_passes=fixed)


def setup(env: Dict) -> Dict:
    from karpenter_provider_aws_tpu_torch.lattice import build_lattice
    from karpenter_provider_aws_tpu_torch.lattice.realdata import load_catalog
    from karpenter_provider_aws_tpu_torch.solver.incremental import IncrementalProblemBuilder
    from karpenter_provider_aws_tpu_torch.solver.problem import ExistingBin
    from karpenter_provider_aws_tpu_torch.solver.solve import Solver
    from karpenter_provider_aws_tpu_torch.state.cluster import DirtySet

    cfg, traffic = env["cfg"], env["traffic"]
    backlog = _backlog(env, _reference_catalog(cfg))
    plain = backlog.problem()
    lattice = build_lattice(load_catalog(env["base"] / "reference" / "catalog.json",
                                         require_price=True), zones=tuple(cfg["zones"]))
    bins = [ExistingBin(name=b["name"], node_pool=b["pool"], instance_type=b["type"],
                        zone=b["zone"], capacity_type=b["capacity_type"],
                        used=bin_used(b["used"])) for b in plain["existing"]]
    state = {"env": env, "backlog": backlog, "lattice": lattice,
             "pods": {p.name: p for p in port.pods(plain)}, "pools": port.pools(plain),
             "templates": port.pods({"shapes": backlog.shapes,
                                     "pods_by_shape": [[""] for _ in backlog.shapes]}),
             "bins": bins, "solver": Solver(lattice, device=env["device"]),
             "builder": IncrementalProblemBuilder()}
    res = state["builder"].build(list(state["pods"].values()), state["pools"], lattice,
                                 existing=list(bins), dirty=DirtySet(since=-1, rev=0, full=True))
    state["solver"].solve(res.problem)
    state["solver"].solve_delta(res.problem)
    state["problem"] = res.problem
    for w in range(int(traffic["warmup_passes"])):
        step(state, -1 - w)
    return state


def _arrivals(state: Dict, added) -> List:
    """The pass's arrivals as the program's pods: each a copy of its shape's
    template pod, made in set-up, under its new name. An informer hands the
    provisioner finished pods, so the window times no pod's construction.
    The arrivals of one shape share fresh containers, as ``port.pods``
    builds one shape's pods."""
    backlog, templates = state["backlog"], state["templates"]
    fields: Dict[int, Dict] = {}
    out = []
    for serial, s in added:
        f = fields.get(s)
        if f is None:
            f = fields[s] = {k: copy.copy(v) for k, v in vars(templates[s]).items()}
        pod = object.__new__(type(templates[s]))
        vars(pod).update(f, name=backlog.name(serial))
        out.append(pod)
    return out


def _churn(state: Dict) -> tuple:
    """The backlog's next pass, applied to the program's pods and nodes:
    the touched pods as ``ClusterState.touched_pods`` classifies them, and
    whether the standing nodes changed."""
    backlog, pods, bins = state["backlog"], state["pods"], state["bins"]
    ch = backlog.churn()
    touched = {}
    for serial in ch["gone"]:
        name = backlog.name(serial)
        del pods[name]
        touched[name] = ("gone", None)
    for p in _arrivals(state, ch["added"]):
        pods[p.name] = p
        touched[p.name] = ("pending", p)
    for b in ch["bumped"]:
        # a new array: the last build's bins keep what they were built from
        bins[b].used = bin_used(backlog.used[b])
    return touched, bool(ch["bumped"])


def _counts(solver) -> Dict[str, int]:
    """What the solver's own stats have counted so far: passes the
    microloop served and passes that left it, plan fetches made and
    skipped, and bytes uploaded to the card."""
    stats = solver.pipeline_stats
    return {"micro": stats["micro_solves"], "aborted": stats["micro_aborts"],
            "fetched": stats["micro_fetches"], "skipped": stats["micro_skipped_syncs"],
            "upload_bytes": solver.link_stats["upload_bytes"]}


def plan_names(plan) -> List:
    """The plan's own containers of the pods it accounts for (on new nodes,
    on standing nodes, unschedulable): kept for the check, which reads the
    names after the window, so a step gathers O(nodes) references and
    copies or hashes no name. Each plan's decode makes them anew."""
    return ([n.pods for n in plan.new_nodes] + list(plan.existing_assignments.values())
            + [plan.unschedulable])


def step(state: Dict, i: int) -> Dict:
    from karpenter_provider_aws_tpu_torch.state.cluster import DirtySet
    env = state["env"]
    spans, solver, builder = env["spans"], state["solver"], state["builder"]
    rec: Dict = {"i": i, "p": state["backlog"].passes}
    was = _counts(solver)
    try:
        with spans("wave", rec):
            with spans("churn", rec):
                touched, bins_moved = _churn(state)
            dirty = DirtySet(since=builder.rev, rev=builder.rev + 1, pods=set(touched),
                             bins=bins_moved)
            with spans("build", rec):
                res = builder.build(list(state["pods"].values()), state["pools"],
                                    state["lattice"], existing=lambda: list(state["bins"]),
                                    dirty=dirty, touched=touched)
            with spans("solve", rec):
                if res.incremental:
                    plan = solver.solve_delta(res.problem, dirty_groups=res.dirty_groups)
                else:
                    plan = solver.solve(res.problem)
    except Exception:                 # counted, and the window goes on
        print(f"pass {i} raised:", file=env["log"])
        traceback.print_exc(file=env["log"])
        rec["failed"] = True
        return rec
    state["problem"] = res.problem
    st = plan.stage_ms
    rec.update({k: v - was[k] for k, v in _counts(solver).items()},
               cost=plan.new_node_cost, failed=plan.solver_path != "device",
               incremental=res.incremental, reason=res.reason,
               staging_ms=st.get("build", 0.0) + st.get("upload", 0.0),
               scan_issue_ms=st.get("compute", 0.0),
               decode_ms=st.get("download", 0.0) + st.get("decode", 0.0))
    rec["names"] = plan_names(plan)
    if kept(i, spans.tracing):
        rec["plan"] = plan
    return rec


def release(state: Dict) -> None:
    import torch
    for k in ("solver", "builder", "lattice", "pods", "templates", "bins", "problem"):
        state.pop(k, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: Dict, records: List[Dict]) -> Dict:
    from ..reference import check as rcheck, ffd

    t0 = time.perf_counter()
    env = state["env"]
    cfg = env["cfg"]
    cat = _reference_catalog(cfg)
    numbers = dict.fromkeys(("answers_missing",) + rcheck.NUMBERS, 0)
    done = sorted((r for r in records if "names" in r), key=lambda r: r["p"])
    numbers["answers_missing"] = len(records) - len(done)
    # the passes again from the seed, with no plan in the loop
    replay = _backlog(env, cat)
    names = set(map(replay.name, replay.serial.tolist()))
    plans = new_nodes = 0
    port_cost = ref_cost = 0.0
    for r in done:
        while replay.passes <= r["p"]:
            ch = replay.churn()
            names.difference_update(map(replay.name, ch["gone"]))
            names.update(replay.name(serial) for serial, _ in ch["added"])
        got = set(chain.from_iterable(r["names"]))
        placed = sum(map(len, r["names"]))
        if placed != len(got) or got != names:   # names not the pass's, and repeats
            numbers["pods_misplaced"] += len(got ^ names) + placed - len(got)
        priced = 0 <= r["i"] < COST_PASSES
        if "plan" not in r and not priced:
            continue
        plain = replay.problem()
        if "plan" in r:
            got = port.plain_plan(r["plan"], cat, plain)
            plans += 1
            new_nodes += len(got["new_nodes"])
            for k, v in rcheck.check_plan(cat, plain, got).items():
                numbers[k] += v
        if priced:
            port_cost += r["cost"]
            ref_cost += ffd.pack(cat, plain)["new_node_cost"]
    print(f"checked: {len(done)} passes counted, {plans} plans ({new_nodes} new nodes) "
          f"in full, in {time.perf_counter() - t0:.3f} s", file=env["log"])
    return {"numbers": numbers, "plans_checked": plans,
            "cost_vs_ffd": port_cost / ref_cost if ref_cost > 0 else None}
