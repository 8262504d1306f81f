#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (karpenter_provider_aws_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the package's CUDA source (csrc/offering_argmin.cu) with nvcc,
   printing ptxas's registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   on every case of ``ops/offering_cases.py`` (the main path's shapes,
   ties, all-infeasible bins, unaligned rows, T of 1 to 6000, ZC of 1 to
   130, uint8 masks, sparse and dense bins); indices and finite values
   must be exactly equal;
4. main path: the north-star wave (50k pods x the real 759-type catalog,
   3 NodePools) through ``solve_relaxed`` on ``cuda``, twice: the
   sequential ``Solver(lattice, pipeline=False)`` and the default,
   pipelined ``Solver(lattice)``. For each, kernel launch counts are
   zeroed just before one solve and read just after; the plan must place
   every pod, cost within 1.02x of the port's own FFD oracle, and equal
   the port's CPU plan node by node. Then each path's e2e p50 over 12
   solves, the two paths in turns, and its median stage times;
5. steady state: cfg10 (20k pods in 24 shapes, 120 partly used existing
   nodes) through the microloop harness of ``bench.py``'s
   ``run_microloop_config`` with this package's objects: a cold full
   build, ``solve`` and a priming ``solve_delta``, then 12 passes of
   about 1.5 % pods leaving and 1.5 % arriving (every 4th pass churns
   nothing), each an incremental build plus ``solve_delta``. Every pass
   is refereed twice: equal to a sequential Solver's plan of the same
   problem, and the same node multiset at the same cost as a solve of a
   scratch ``build_problem``. The phase fails unless every pass rode the
   microloop with no abort, the 3 no-churn passes skipped their fetch, no
   pass paid more than 2 link legs, and every pass launched the kernel;
6. provisioner: the provisioning controller end to end on the card
   (``workloads.ProvisionerStack``: ``ClusterState``, ``FakeCloud``,
   ``CloudProvider``, ``Provisioner`` with the delta path on, and the
   ``LifecycleController``, all on one ``FakeClock``). (a) The cfg5 wave
   as pending pods through one ``provision_once``: not degraded, on the
   device path, 0 unschedulable pods and 0 launch failures, every pod
   nominated to a launched claim, the kernel launched, and the plan equal
   to the port's CPU plan node by node; then registration binds every
   pod. (b) cfg10's 20k pods provisioned from empty and registered, then
   12 passes of cfg10's churn rate (about 1.5 % of the bound pods leave
   and as many arrive, every 4th pass nothing) and 12 passes of the delta
   smoke's small churn, each with batch-window polls, ``provision_once``
   and registration, each churned pass refereed by a scratch
   ``build_problem`` of the same cluster solved on a sequential Solver
   (pod by pod where the pass rebuilt in full, by pod shape where it rode
   the delta path), and each churned pass's own kernel inputs, captured
   during the pass, held exactly against the plain version.
   The phase fails on a degraded pass, a launch failure, a referee
   mismatch, a churned pass that did not launch the kernel, a microloop
   abort, no delta solve or incremental build, or a pod left pending;
7. consolidation: cfg4's fleet (``workloads.config4_fleet_stack``: 500
   under-utilized nodes of the real catalog's three cheapest
   general-purpose types, half spot, 1,500 pods bound 3 per node) in a
   ``workloads.ConsolidationStack`` on the card, through 8 ``run_once``
   passes (provisioning, lifecycle, disruption with its batched probes,
   termination), each printing its probe dispatch's K, G and B, wall and
   device span (CUDA events), the host build of the what-if problems, the
   exact what-if solves, the referee, the nodes removed and the fleet's
   $/hr. The phase fails on a host fallback, a degraded plan, an accepted
   removal the host-FFD referee did not pass, a pass that raised the
   fleet's $/hr, a probe dispatch or an exact what-if that did not launch
   the kernel exactly once, or a pod pending at the end; every kernel
   call of every pass is held exactly against the plain version, every
   probe of the first dispatch is re-run alone (K=1) and must equal its
   batched row, and the largest prefix and one single must equal a CPU
   Solver's probe. One dispatch is re-run under the profiler for the
   device's idle share;
8. kernel timing: the kernel and its plain version at cfg5's and cfg10's
   own inputs (captured in a solve of each), at the first consolidation
   pass's probe dispatch (K x B rows in one call) and at the dense largest
   bin bucket (B=8192), and the card's launch floor (a one-element
   in-place add), each the median of 100 device times from CUDA events,
   queued behind a device sleep so that no host gap is timed.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX and nothing of the JAX package, and checks that at the end.
"""

import json
import os
import statistics
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SOLVES = 12
SMALL_PASSES = 12
CONSOLIDATION_PASSES = 8


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


_PHASE = {}


def _phase(name: str) -> None:
    """Start the next phase; print the wall seconds of the one before."""
    now = time.perf_counter()
    if _PHASE:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t']:.1f} s", flush=True)
        _PHASE.setdefault("seconds", {})[_PHASE["name"]] = now - _PHASE["t"]
    _PHASE.update(name=name, t=now)
    if name:
        print(f"== {name}", flush=True)


def _kernel_cases(dev):
    """(name, tmask, zcmask, price) on the card for cheapest_offering:
    every case of ``ops/offering_cases.py``, made from numpy seeds."""
    from karpenter_provider_aws_tpu_torch.measure import on_device
    from karpenter_provider_aws_tpu_torch.ops import offering_cases
    for name, make in offering_cases.kernel_cases().items():
        yield (name,) + on_device(make(), dev)


def _node_rows(plan):
    return [(n.node_pool, n.instance_type, n.zone, n.capacity_type,
             sorted(n.pods)) for n in plan.new_nodes]


def _same_plan(a, b) -> bool:
    return (_node_rows(a) == _node_rows(b)
            and a.existing_assignments == b.existing_assignments
            and a.unschedulable == b.unschedulable
            and a.new_node_cost == b.new_node_cost)


def _node_multiset(plan):
    return sorted((n.instance_type, n.zone, len(n.pods)) for n in plan.new_nodes)


def _steady_state(torch, workloads, lattice, oa):
    """Phase 5: cfg10 under the microloop harness; returns its numbers and
    the last pass's problem."""
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    pods, pools, shapes = workloads.config10_steady_state()
    churn = workloads.SteadyStateChurn(lattice, pods, shapes)
    solver = Solver(lattice)
    referee = Solver(lattice, pipeline=False)
    rebuild = Solver(lattice)
    if solver.device.type != "cuda" or referee.device.type != "cuda":
        raise AssertionError("cfg10: a Solver is not on the card")
    passes = workloads.STEADY_PASSES
    rows, stages, rebuild_ms, launches_per_pass = [], {}, [], []
    pre = pre_link = None
    oa.LAUNCHES = 0
    for pass_i, res, plan, ms, legs in workloads.steady_state_passes(
            solver, lattice, pools, churn, passes):
        torch.cuda.synchronize()
        launched = oa.LAUNCHES
        if pass_i < 0:
            print(f"cold: full build ({res.problem.G} groups, {res.problem.E} "
                  f"existing bins), solve and priming solve_delta "
                  f"{ms:.1f} ms", flush=True)
            pre = dict(solver.pipeline_stats)
            pre_link = dict(solver.link_stats)
        else:
            launches_per_pass.append(launched)
            for k, v in plan.stage_ms.items():
                stages.setdefault(k, []).append(v)
        # referee 1: the same problem through the sequential path
        same = referee.solve(res.problem)
        # referee 2: a scratch build of the same cluster, fully rebuilt
        t = time.perf_counter()
        scratch = rebuild.solve(build_problem(churn.pods, pools, lattice,
                                              existing=list(churn.existing)))
        full_ms = (time.perf_counter() - t) * 1e3
        placed = sum(len(n.pods) for n in plan.new_nodes) + sum(
            len(v) for v in plan.existing_assignments.values())
        ok_same = _same_plan(plan, same)
        ok_scratch = (_node_multiset(plan) == _node_multiset(scratch)
                      and abs(plan.new_node_cost - scratch.new_node_cost) <= 1e-6)
        if pass_i >= 0:
            rebuild_ms.append(full_ms)
            rows.append({"pass": pass_i, "ms": ms, "legs": legs,
                         "incremental": res.incremental,
                         "dirty_groups": len(res.dirty_groups),
                         "launches": launched, "full_rebuild_ms": full_ms})
            print(f"pass {pass_i}: {ms:.3f} ms, legs {legs}, incremental "
                  f"{res.incremental} ({len(res.dirty_groups)} dirty groups), "
                  f"{launched} launch(es), {len(plan.new_nodes)} new nodes, "
                  f"{placed}/{len(churn.pods)} pods placed; full rebuild "
                  f"{full_ms:.3f} ms; == sequential {ok_same}, "
                  f"== scratch {ok_scratch}", flush=True)
        if not (ok_same and ok_scratch):
            raise AssertionError(f"cfg10 pass {pass_i}: the plan differs from "
                                 f"a referee (same problem {ok_same}, "
                                 f"scratch build {ok_scratch})")
        if plan.unschedulable or placed != len(churn.pods):
            raise AssertionError(f"cfg10 pass {pass_i}: placed {placed}/"
                                 f"{len(churn.pods)}, "
                                 f"{len(plan.unschedulable)} unschedulable")
        oa.LAUNCHES = 0
    st = solver.pipeline_stats
    d = {k: st[k] - pre[k] for k in ("micro_solves", "micro_aborts",
                                     "micro_skipped_syncs", "micro_fetches",
                                     "delta_solves")}
    legs = [r["legs"] for r in rows]
    incremental = sum(r["incremental"] for r in rows)
    nochurn = passes // workloads.STEADY_NOCHURN_EVERY
    upload = solver.link_stats["upload_bytes"] - pre_link["upload_bytes"]
    fetch = solver.link_stats["fetch_bytes"] - pre_link["fetch_bytes"]
    pass_ms = [r["ms"] for r in rows]
    out = {
        "pods": len(churn.pods), "existing_nodes": len(churn.existing),
        "groups": res.problem.G, "passes": passes,
        "pass_p50_ms": statistics.median(pass_ms), "pass_min_ms": min(pass_ms),
        "pass_max_ms": max(pass_ms),
        "full_rebuild_p50_ms": statistics.median(rebuild_ms),
        "upload_bytes_per_pass": upload / passes,
        "fetch_bytes_per_pass": fetch / passes,
        "legs_per_pass": legs, "launches_per_pass": launches_per_pass,
        "stage_p50_ms": {k: statistics.median(v) for k, v in stages.items()},
        **d,
    }
    print(f"cfg10: pass p50 {out['pass_p50_ms']:.3f} ms (min "
          f"{out['pass_min_ms']:.3f}, max {out['pass_max_ms']:.3f}) over "
          f"{passes} passes; full rebuild p50 {out['full_rebuild_p50_ms']:.3f} "
          f"ms; upload {upload / passes:.1f} B/pass, fetch {fetch / passes:.1f} "
          f"B/pass; legs {legs}; launches {launches_per_pass}; compute p50 "
          f"{out['stage_p50_ms'].get('compute', 0.0):.3f} ms, download p50 "
          f"{out['stage_p50_ms'].get('download', 0.0):.3f} ms; {d}", flush=True)
    if incremental != passes or d["micro_solves"] != incremental:
        raise AssertionError(f"cfg10: {incremental} incremental builds, "
                             f"{d['micro_solves']} microloop passes of {passes}")
    if d["micro_aborts"] != 0:
        raise AssertionError(f"cfg10: {d['micro_aborts']} microloop aborts")
    if d["micro_skipped_syncs"] != nochurn:
        raise AssertionError(f"cfg10: {d['micro_skipped_syncs']} skipped "
                             f"fetches, expected {nochurn}")
    if max(legs) > 2:
        raise AssertionError(f"cfg10: a pass paid more than 2 legs: {legs}")
    if min(launches_per_pass) < 1:
        raise AssertionError(f"cfg10: a pass never launched the kernel: "
                             f"{launches_per_pass}")
    return out, res.problem


def _split(stack, result, wall_ms):
    """A pass's wall time split: the problem build, the solve (its
    ``solve_seconds``, whose stages are in ``stage_ms``), the launch loop,
    and the rest (explain, limits, bookkeeping)."""
    t = stack.timing
    solve_ms = (result.plan.solve_seconds * 1e3
                if result.plan is not None else 0.0)
    build = t.get("build", 0.0)
    loop = t.get("launch_loop", 0.0)
    return {"wall_ms": wall_ms, "build_ms": build, "solve_ms": solve_ms,
            "stage_ms": (dict(result.plan.stage_ms)
                         if result.plan is not None else {}),
            "launch_loop_ms": loop, "create_ms": t.get("create", 0.0),
            "rest_ms": wall_ms - build - solve_ms - loop}


def _fmt_split(d):
    return (f"wall {d['wall_ms']:.3f} ms = build {d['build_ms']:.3f} + solve "
            f"{d['solve_ms']:.3f} (stages "
            f"{ {k: round(v, 3) for k, v in d['stage_ms'].items()} }) + launch "
            f"loop {d['launch_loop_ms']:.3f} (CloudProvider.create "
            f"{d['create_ms']:.3f}) + rest {d['rest_ms']:.3f}")


def _check_pass(name, result):
    """No fallback may hide the card: a degraded pass, a launch failure or
    an unschedulable pod fails the phase."""
    if result.degraded:
        raise AssertionError(f"{name}: degraded pass ({result.degraded_reason})")
    if result.launch_failures:
        raise AssertionError(f"{name}: {result.launch_failures} launch failures")
    if result.pods_unschedulable:
        raise AssertionError(f"{name}: {result.pods_unschedulable} "
                             f"unschedulable pods")
    if result.plan is not None and result.plan.solver_path != "device":
        raise AssertionError(f"{name}: solver path {result.plan.solver_path}")


def _registered(name, stack, n_pods):
    c = stack.cluster
    phases = c.pod_phase_counts()
    unregistered = [k for k, cl in c.claims.items()
                    if cl.phase.value != "Initialized"]
    if unregistered or len(c.nodes) != len(c.claims):
        raise AssertionError(f"{name}: {len(unregistered)} claims did not "
                             f"register ({len(c.nodes)} nodes, "
                             f"{len(c.claims)} claims)")
    if phases["bound"] != n_pods or c.pending_pods():
        raise AssertionError(f"{name}: {phases} after registration, "
                             f"expected {n_pods} bound")


def _provisioner(torch, workloads, lattice, oa, cpu_plan):
    """Phase 6: the provisioning controller on the card."""
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.solver import Solver

    out, launches = {}, {}
    max_err = 0.0
    # (a) the cfg5 wave
    pods, pools, existing = workloads.config5_full_scale()
    if existing:
        raise AssertionError("cfg5 has no existing nodes to mirror")
    stack = workloads.ProvisionerStack(lattice, pools, Solver(lattice))
    if stack.solver.device.type != "cuda":
        raise AssertionError("provisioner: the Solver is not on the card")
    for p in pods:
        stack.cluster.add_pod(p)
    oa.LAUNCHES = 0
    result, wall = stack.provision()
    torch.cuda.synchronize()
    launches["provisioner_cfg5"] = oa.LAUNCHES
    _check_pass("cfg5 wave", result)
    plan = result.plan
    phases = stack.cluster.pod_phase_counts()
    launched_claims = all(c.phase.value == "Launched"
                          for c in stack.cluster.claims.values())
    split = _split(stack, result, wall)
    print(f"cfg5 wave: {len(result.created_claims)} claims, {result.launched} "
          f"launched, {result.pods_scheduled} pods scheduled, "
          f"{launches['provisioner_cfg5']} kernel launch(es); {_fmt_split(split)}",
          flush=True)
    if launches["provisioner_cfg5"] < 1:
        raise AssertionError("cfg5 wave: the kernel never launched")
    if (result.launched != len(result.created_claims) or not launched_claims
            or phases["nominated"] != len(pods) or result.pods_scheduled != len(pods)):
        raise AssertionError(f"cfg5 wave: {phases}, {result.launched} of "
                             f"{len(result.created_claims)} claims launched")
    if _node_rows(plan) != _node_rows(cpu_plan) \
            or plan.existing_assignments != cpu_plan.existing_assignments:
        raise AssertionError("cfg5 wave: the provisioner's plan differs from "
                             "the CPU plan")
    print(f"cfg5 wave: plan == cpu plan, node by node ({len(plan.new_nodes)} "
          f"nodes, ${plan.new_node_cost:.2f}/hr)", flush=True)
    reg_ms = stack.register()
    _registered("cfg5 wave", stack, len(pods))
    print(f"cfg5 wave: registration of {len(stack.cluster.nodes)} nodes bound "
          f"{len(pods)} pods in {reg_ms:.3f} ms", flush=True)
    out["cfg5_wave"] = {**split, "claims": len(result.created_claims),
                        "registration_ms": reg_ms,
                        "launches": launches["provisioner_cfg5"]}

    # (b) cfg10 through the provisioner
    pods, pools, shapes = workloads.config10_steady_state()
    solver = Solver(lattice)
    stack = workloads.ProvisionerStack(lattice, pools, solver)
    for p in pods:
        stack.cluster.add_pod(p)
    oa.LAUNCHES = 0
    result, wall = stack.provision()
    torch.cuda.synchronize()
    first_launches = oa.LAUNCHES
    _check_pass("cfg10 first wave", result)
    split = _split(stack, result, wall)
    reg_ms = stack.register()
    _registered("cfg10 first wave", stack, len(pods))
    print(f"cfg10 first wave: {len(result.created_claims)} claims, "
          f"{first_launches} kernel launch(es); {_fmt_split(split)}; "
          f"registration {reg_ms:.3f} ms", flush=True)
    out["cfg10_first_wave"] = {**split, "claims": len(result.created_claims),
                               "registration_ms": reg_ms}
    referee = Solver(lattice, pipeline=False)
    builder = stack.provisioner.inc_builder
    rows = []
    launches["provisioner_cfg10"] = 0
    for stage, churn, passes in (
            ("rate", workloads.ProvisionerChurn(shapes), workloads.STEADY_PASSES),
            ("small", workloads.SmallChurn(shapes), SMALL_PASSES)):
        for k in range(passes):
            gone, added, nochurn = churn.churn(stack.cluster, k)
            for _ in range(2):
                stack.provisioner.batch_ready()
                stack.clock.step(0.6)
            ref = None
            if not nochurn:
                ref = referee.solve(workloads.referee_problem(stack))
            pre_link = dict(solver.link_stats)
            pre_stats = dict(solver.pipeline_stats)
            pre_inc = builder.incremental_builds
            oa.LAUNCHES = 0
            if nochurn:
                result, wall = stack.provision()
            else:
                (result, wall), inputs = measure.captured_main_path_inputs(
                    stack.provision)
            torch.cuda.synchronize()
            launched = oa.LAUNCHES
            launches["provisioner_cfg10"] += launched
            _check_pass(f"cfg10 {stage} pass {k}", result)
            full = builder.incremental_builds == pre_inc
            same = None
            if ref is not None:
                same = all(
                    workloads.plan_digest(result.plan, stack.cluster.pods, exact)
                    == workloads.plan_digest(ref, stack.cluster.pods, exact)
                    for exact in ((False, True) if full else (False,)))
                # the referee ran the same kernel: hold the pass's own
                # kernel inputs against the plain version too
                max_err = max(max_err, measure.check_exact(
                    f"cfg10 {stage} pass {k} inputs", oa.cheapest_offering(*inputs),
                    oa.cheapest_offering_ref(*inputs)))
            split = _split(stack, result, wall)
            reg_ms = stack.register()
            row = {"stage": stage, "pass": k, "nochurn": nochurn,
                   "arrived": len(added), "left": len(gone),
                   "incremental": not full,
                   "reason": builder.last_reason,
                   "delta": solver.pipeline_stats["delta_solves"]
                   - pre_stats["delta_solves"],
                   "launches": launched, "registration_ms": reg_ms,
                   "legs": sum(solver.link_stats[d + "_legs"]
                               - pre_link[d + "_legs"] for d in ("upload", "fetch")),
                   "bytes": sum(solver.link_stats[d + "_bytes"]
                                - pre_link[d + "_bytes"] for d in ("upload", "fetch")),
                   "claims": len(result.created_claims), **split}
            rows.append(row)
            print(f"cfg10 {stage} pass {k}: -{len(gone)} +{len(added)} pods, "
                  f"incremental {row['incremental']} "
                  f"({row['reason'] or 'delta'}), delta {row['delta']}, "
                  f"{launched} launch(es), {row['claims']} claims, legs "
                  f"{row['legs']}, {row['bytes']} B; {_fmt_split(split)}; "
                  f"registration {reg_ms:.3f} ms; == scratch referee {same}",
                  flush=True)
            if same is False:
                raise AssertionError(f"cfg10 {stage} pass {k}: the plan differs "
                                     f"from the scratch referee")
            if not nochurn and launched < 1:
                raise AssertionError(f"cfg10 {stage} pass {k}: the kernel "
                                     f"never launched")
    st = solver.pipeline_stats
    co = stack.provisioner.stats()
    churned = [r for r in rows if not r["nochurn"]]
    walls = [r["wall_ms"] for r in churned]
    summary = {
        "passes": len(rows), "churned": len(churned),
        "pass_p50_ms": statistics.median(walls), "pass_min_ms": min(walls),
        "pass_max_ms": max(walls),
        "delta_solves": st["delta_solves"], "micro_solves": st["micro_solves"],
        "micro_aborts": st["micro_aborts"],
        "incremental_builds": builder.incremental_builds,
        "full_builds": builder.full_builds,
        "journal_ticks": co["journal_ticks"], "journal_takes": co["journal_takes"],
        "journal_take_fallbacks": co["journal_take_fallbacks"],
        "launches": launches["provisioner_cfg10"],
    }
    for stage in ("rate", "small"):
        sel = [r for r in churned if r["stage"] == stage]
        summary[stage] = {k: statistics.median([r[k] for r in sel]) for k in (
            "wall_ms", "build_ms", "solve_ms", "launch_loop_ms", "rest_ms",
            "registration_ms", "legs", "bytes")}
        summary[stage]["wall_min_ms"] = min(r["wall_ms"] for r in sel)
        summary[stage]["wall_max_ms"] = max(r["wall_ms"] for r in sel)
        summary[stage]["incremental"] = sum(r["incremental"] for r in sel)
        summary[stage]["reasons"] = sorted({r["reason"] for r in sel})
        print(f"cfg10 {stage} churn, p50 over {len(sel)} churned passes: "
              f"{ {k: (round(v, 3) if isinstance(v, float) else v) for k, v in summary[stage].items()} }",
              flush=True)
    print(f"cfg10 through the provisioner: pass p50 {summary['pass_p50_ms']:.3f} ms "
          f"(min {summary['pass_min_ms']:.3f}, max {summary['pass_max_ms']:.3f}); "
          f"delta_solves {st['delta_solves']}, incremental_builds "
          f"{builder.incremental_builds}, full_builds {builder.full_builds}, "
          f"micro_aborts {st['micro_aborts']}; journal ticks {co['journal_ticks']}, "
          f"takes {co['journal_takes']}, fallbacks {co['journal_take_fallbacks']}",
          flush=True)
    if st["delta_solves"] < 1 or builder.incremental_builds < 1:
        raise AssertionError(f"cfg10: the delta path never ran (last builder "
                             f"reason {builder.last_reason!r})")
    if st["micro_aborts"]:
        raise AssertionError(f"cfg10: {st['micro_aborts']} microloop aborts")
    if stack.cluster.pending_pods():
        raise AssertionError(f"cfg10: {len(stack.cluster.pending_pods())} pods "
                             f"left pending")
    print(f"cfg10: each churned pass's own kernel inputs matched the plain "
          f"version exactly ({len(churned)} passes)", flush=True)
    out["cfg10"] = {**summary, "rows": rows}
    out["max_abs_err"] = max_err
    return out, launches


def _consolidation(torch, workloads, lattice, oa):
    """Phase 7: cfg4's fleet (500 under-utilized nodes) through the
    consolidation stack on the card; returns its numbers, its launches and
    the first probe dispatch's kernel inputs."""
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.ops import binpack
    from karpenter_provider_aws_tpu_torch.solver import Solver

    solver = Solver(lattice)
    if solver.device.type != "cuda":
        raise AssertionError("consolidation: the Solver is not on the card")
    t = time.perf_counter()
    stack = workloads.config4_fleet_stack(lattice, solver)
    seed_ms = (time.perf_counter() - t) * 1e3
    ctrl, eng = stack.disruption, stack.disruption.engine
    cost0, unpriced = stack.fleet_cost()
    print(f"cfg4 fleet: {len(stack.cluster.nodes)} nodes, "
          f"{stack.cluster.pod_phase_counts()['bound']} pods bound, "
          f"${cost0:.4f}/hr over the priced offerings ({unpriced} nodes on "
          f"offerings the catalog does not price), seeded in {seed_ms:.1f} ms",
          flush=True)
    n_nodes = len(stack.cluster.nodes)
    n_pods = stack.cluster.pod_phase_counts()["bound"]
    if (n_nodes != len(stack.cluster.claims) or n_pods != 3 * n_nodes
            or stack.cluster.pending_pods()):
        raise AssertionError("cfg4: the fleet did not seed")

    # per-pass records, filled by wrappers around the stack's own objects
    rec = {}
    orig_probe = solver.probe_batch
    orig_pack = binpack.pack_probe_fused
    orig_what_if = ctrl._what_if
    orig_referee = eng.referee
    orig_build = eng._whatif_problem
    orig_accept = eng.note_accept
    orig_provision = stack.provisioner.provision_once

    def probe_batch(problems):
        before = oa.LAUNCHES
        t = time.perf_counter()
        out = orig_probe(problems)
        lp = solver.last_probe
        rec["dispatches"].append({
            "K": lp["K"], "padded": lp["padded"], "G": lp["G"], "B": lp["B"],
            "wall_ms": (time.perf_counter() - t) * 1e3,
            "launches": oa.LAUNCHES - before,
            "problems": list(problems), "summary": lp["summary"]})
        return out

    def pack_probe_fused(*a, **kw):
        # CUDA events around the batched pack's launches: the span from the
        # card reaching the first to finishing the last
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        out = orig_pack(*a, **kw)
        ev1.record()
        rec["pack_events"].append((ev0, ev1))
        return out

    def what_if(removed):
        before = oa.LAUNCHES
        t = time.perf_counter()
        plan, price = orig_what_if(removed)
        rec["what_ifs"].append({"ms": (time.perf_counter() - t) * 1e3,
                                "launches": oa.LAUNCHES - before,
                                "degraded": plan.degraded,
                                "path": plan.solver_path})
        return plan, price

    def referee(removed, plan, **kw):
        rec["in_referee"] = True
        t = time.perf_counter()
        try:
            ok, ratio = orig_referee(removed, plan, **kw)
        finally:
            rec["in_referee"] = False
        rec["referee"].append({"ms": (time.perf_counter() - t) * 1e3,
                               "claims": sorted(c.name for c in removed),
                               "ok": ok, "ratio": ratio})
        return ok, ratio

    def whatif_problem(*a, **kw):
        t = time.perf_counter()
        out = orig_build(*a, **kw)
        if not rec["in_referee"]:
            rec["build_ms"] += (time.perf_counter() - t) * 1e3
        return out

    def note_accept(removed, savings):
        rec["accepted"].append((sorted(c.name for c in removed), savings))
        return orig_accept(removed, savings)

    def provision_once():
        t = time.perf_counter()
        result = orig_provision()
        rec["ms"]["provision"] += (time.perf_counter() - t) * 1e3
        rec["provisions"].append(result)
        return result

    def timed(name, fn):
        def run():
            t = time.perf_counter()
            try:
                return fn()
            finally:
                rec["ms"][name] += (time.perf_counter() - t) * 1e3
        return run

    orig_reconciles = {name: getattr(stack, name).reconcile
                       for name in ("lifecycle", "disruption", "termination")}

    solver.probe_batch = probe_batch
    binpack.pack_probe_fused = pack_probe_fused
    ctrl._what_if = what_if
    eng.referee = referee
    eng._whatif_problem = whatif_problem
    eng.note_accept = note_accept
    stack.provisioner.provision_once = provision_once
    for name, fn in orig_reconciles.items():
        getattr(stack, name).reconcile = timed(name, fn)

    def poll_batch():
        # the provisioner's batch window closes on the clock, as between
        # the Operator's passes
        for _ in range(2):
            stack.provisioner.batch_ready()
            stack.clock.step(0.6)

    rows, launches_per_pass, max_err = [], [], 0.0
    first = None
    stack.clock.step(workloads.CFG4_CONSOLIDATE_AFTER + 1.0)
    try:
        for k in range(CONSOLIDATION_PASSES):
            rec.update(dispatches=[], pack_events=[], what_ifs=[], referee=[],
                       accepted=[], provisions=[], build_ms=0.0,
                       in_referee=False,
                       ms=dict.fromkeys(("provision", "lifecycle", "disruption",
                                         "termination"), 0.0))
            poll_batch()
            before_cost, _ = stack.fleet_cost()
            claims_before = set(stack.cluster.claims)
            in_flight_before = list(ctrl._in_flight)
            counters_before = dict(eng.counters)
            oa.LAUNCHES = 0
            t = time.perf_counter()
            _, inputs = measure.captured_kernel_inputs(stack.run_once)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            launched = oa.LAUNCHES
            launches_per_pass.append(launched)
            stack.clock.step(stack.registration_delay + 0.1)
            after_cost, _ = stack.fleet_cost()
            for i, inp in enumerate(inputs):
                max_err = max(max_err, measure.check_exact(
                    f"cfg4 pass {k} kernel call {i} inputs",
                    oa.cheapest_offering(*inp), oa.cheapest_offering_ref(*inp)))
            new_actions = [a for a in ctrl._in_flight if a not in in_flight_before]
            disp = rec["dispatches"]
            dev_ms = [e0.elapsed_time(e1) for e0, e1 in rec["pack_events"]]
            row = {
                "pass": k, "wall_ms": wall_ms, "launches": launched,
                "kernel_calls_checked": len(inputs),
                "dispatches": [{kk: d[kk] for kk in ("K", "padded", "G", "B",
                                                     "wall_ms", "launches")}
                               for d in disp],
                "pack_device_span_ms": dev_ms,
                "build_ms": rec["build_ms"],
                "what_ifs": [(w["ms"], w["launches"]) for w in rec["what_ifs"]],
                "referee_ms": [r["ms"] for r in rec["referee"]],
                "accepted": [(len(c), s) for c, s in rec["accepted"]],
                "removed": len(claims_before - set(stack.cluster.claims)),
                "decided": sum(len(a.claims) for a in new_actions),
                "replacements": sum(len(a.replacements) for a in new_actions),
                "controller_ms": dict(rec["ms"]),
                "cost_before": before_cost, "cost_after": after_cost,
                "pending_after": len(stack.cluster.pending_pods()),
                "host_fallbacks": eng.counters["host_fallbacks"]
                - counters_before["host_fallbacks"],
            }
            rows.append(row)
            print(f"cfg4 pass {k}: "
                  + "; ".join(f"K={d['K']} (padded {d['padded']}) G={d['G']} "
                              f"B={d['B']}, dispatch wall {d['wall_ms']:.3f} ms, "
                              f"{d['launches']} launch(es)" for d in row["dispatches"])
                  + f"; pack device span {[round(x, 3) for x in dev_ms]} ms; "
                  f"host build of the what-if problems {rec['build_ms']:.3f} ms; "
                  f"exact what-ifs {[round(w[0], 3) for w in row['what_ifs']]} ms "
                  f"({[w[1] for w in row['what_ifs']]} launches); referee "
                  f"{[round(x, 3) for x in row['referee_ms']]} ms; decided to "
                  f"remove {row['decided']} nodes with {row['replacements']} "
                  f"replacement(s), {row['removed']} terminated; fleet "
                  f"${before_cost:.4f}/hr -> ${after_cost:.4f}/hr; "
                  f"{row['pending_after']} pods pending; pass wall "
                  f"{wall_ms:.3f} ms (controllers "
                  f"{ {n: round(v, 3) for n, v in rec['ms'].items()} } ms); "
                  f"{launched} kernel launch(es), "
                  f"{len(inputs)} kernel calls' inputs exact", flush=True)
            # the phase's gates
            if row["host_fallbacks"]:
                raise AssertionError(f"cfg4 pass {k}: {row['host_fallbacks']} "
                                     f"host fallbacks")
            for d in row["dispatches"]:
                if d["launches"] != 1:
                    raise AssertionError(f"cfg4 pass {k}: a probe dispatch "
                                         f"launched the kernel {d['launches']} times")
            for w in rec["what_ifs"]:
                if w["launches"] != 1 or w["degraded"] or w["path"] != "device":
                    raise AssertionError(f"cfg4 pass {k}: an exact what-if "
                                         f"launched {w['launches']} times "
                                         f"(degraded {w['degraded']}, {w['path']})")
            for res in rec["provisions"]:
                _check_pass(f"cfg4 pass {k} provisioning", res)
            passed = [r["claims"] for r in rec["referee"] if r["ok"]]
            for names, _ in rec["accepted"]:
                if names not in passed:
                    raise AssertionError(f"cfg4 pass {k}: an accepted removal "
                                         f"({len(names)} nodes) was not refereed")
            if after_cost > before_cost:
                raise AssertionError(f"cfg4 pass {k}: fleet $/hr went up, "
                                     f"{before_cost} -> {after_cost}")
            if k == 0:
                if not rec["accepted"]:
                    raise AssertionError("cfg4: the first pass consolidated nothing")
                if len(disp) != 1:
                    raise AssertionError(f"cfg4: the first pass made {len(disp)} "
                                         f"probe dispatches")
                first = disp[0]
                first["inputs"] = next(
                    inp for inp in inputs
                    if inp[0].shape[0] == first["padded"] * first["B"])
    finally:
        solver.probe_batch = orig_probe
        binpack.pack_probe_fused = orig_pack
        ctrl._what_if = orig_what_if
        eng.referee = orig_referee
        eng._whatif_problem = orig_build
        eng.note_accept = orig_accept
        stack.provisioner.provision_once = orig_provision
        for name, fn in orig_reconciles.items():
            getattr(stack, name).reconcile = fn

    # the evictees of the last pass's terminations take their pass
    poll_batch()
    if stack.cluster.pending_pods():
        result = stack.provisioner.provision_once()
        _check_pass("cfg4 final provisioning", result)
        stack.register()
    end_cost, _ = stack.fleet_cost()
    if stack.cluster.pending_pods():
        raise AssertionError(f"cfg4: {len(stack.cluster.pending_pods())} pods "
                             f"left pending at the end")
    if end_cost > rows[-1]["cost_after"]:
        raise AssertionError("cfg4: the final provisioning raised the fleet $/hr")

    # batched against unbatched on the card: every probe of the first
    # dispatch alone
    cols = binpack.ProbeSummary._fields
    ci = cols.index("new_cost")

    def same_row(a, b):
        counts = all(a[j] == b[j] for j in range(len(cols)) if j != ci)
        return counts and (a[ci] == b[ci]
                           or abs(a[ci] - b[ci]) <= 1e-6 * abs(b[ci]))

    summ = first["summary"]
    for i, p in enumerate(first["problems"]):
        orig_probe([p])
        if not same_row(solver.last_probe["summary"][0], summ[i]):
            raise AssertionError(f"cfg4: probe {i} of the first dispatch alone "
                                 f"{solver.last_probe['summary'][0]} != batched "
                                 f"{summ[i]}")
    print(f"cfg4: each of the first dispatch's {len(first['problems'])} probes "
          f"alone (K=1) equals its batched row", flush=True)
    # card against CPU: the largest prefix and one single (the first pass's
    # dispatch holds every prefix, largest last, then the singles)
    n_prefix = len(first["problems"]) - ctrl.MAX_SINGLE_PROBES
    picks = {"largest prefix": n_prefix - 1, "first single": n_prefix}
    cpu = Solver(lattice, device="cpu")
    for name, i in picks.items():
        t = time.perf_counter()
        cpu.probe_batch([first["problems"][i]])
        got = cpu.last_probe["summary"][0]
        if not same_row(summ[i], got):
            raise AssertionError(f"cfg4: the {name} probe on the card {summ[i]} "
                                 f"!= on the CPU {got}")
        print(f"cfg4: the {name} probe (E={first['problems'][i].E}, "
              f"{int(first['problems'][i].count.sum())} pods) on the card == on "
              f"the CPU ({(time.perf_counter() - t):.1f} s on the CPU): "
              f"{dict(zip(cols, summ[i].tolist()))}", flush=True)
    # the device's busy time in one dispatch of the first pass's problems
    wall_ms, dev_ms, n_kernels = measure.profiled_device_ms(
        lambda: orig_probe(first["problems"]))
    print(f"cfg4: one probe dispatch of {len(first['problems'])} probes under "
          f"the profiler: wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms "
          f"({n_kernels} kernels), idle share {1.0 - dev_ms / wall_ms:.3f}",
          flush=True)

    st = eng.stats()
    out = {
        "nodes": n_nodes, "pods": n_pods, "seed_ms": seed_ms,
        "fleet_cost_start": cost0, "fleet_cost_end": end_cost,
        "unpriced_nodes": unpriced, "nodes_end": len(stack.cluster.nodes),
        "passes": rows, "engine": st,
        "first_dispatch": {k: first[k] for k in ("K", "padded", "G", "B",
                                                 "wall_ms", "launches")},
        "profiled_dispatch": {"wall_ms": wall_ms, "device_ms": dev_ms,
                              "kernels": n_kernels,
                              "idle_share": 1.0 - dev_ms / wall_ms},
        "max_abs_err": max_err,
    }
    print(f"cfg4: {CONSOLIDATION_PASSES} passes, {st['accepted']:.0f} removals "
          f"accepted, {st['nodes_consolidated']:.0f} nodes consolidated, "
          f"${cost0:.4f}/hr -> ${end_cost:.4f}/hr, {len(stack.cluster.nodes)} "
          f"nodes; referee {st['referee_checks']:.0f} checks, "
          f"{st['referee_rejects']:.0f} rejects; host fallbacks "
          f"{st['host_fallbacks']:.0f}; launches per pass {launches_per_pass}",
          flush=True)
    return out, sum(launches_per_pass), launches_per_pass, first["inputs"]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return _fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        import karpenter_provider_aws_tpu_torch as port
    except ImportError as e:
        return _fail(f"the port package is not next to chip_smoke.py: {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        return _fail(f"imported the port from {port.__file__}, not from {HERE}")
    try:
        return _run(torch)
    except Exception:
        traceback.print_exc()
        return _fail("a phase failed (traceback above)")


def _run(torch) -> int:
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.ops import cuda_build, offering_cases
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    # ---- 1. card
    _phase("card")
    print(f"nvidia-smi: {measure.card_line()}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda")

    # ---- 2. build
    _phase("build")
    t = time.perf_counter()
    path = cuda_build.build("offering_argmin")
    build_s = time.perf_counter() - t
    print(f"built offering_argmin -> {os.path.relpath(path, HERE)}")
    for line in cuda_build.BUILD_LOGS.get("offering_argmin", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    print(f"build seconds: {build_s:.3f}", flush=True)

    # ---- 3. kernels against their plain versions
    _phase("kernels")
    max_err = 0.0
    for name, tm, zc, pr in _kernel_cases(dev):
        err = measure.check_exact(name, oa.cheapest_offering(tm, zc, pr),
                             oa.cheapest_offering_ref(tm, zc, pr))
        max_err = max(max_err, err)
        print(f"cheapest_offering {name}: B={tm.shape[0]} T={tm.shape[1]} "
              f"ZC={zc.shape[1]} exact match", flush=True)

    # ---- 4. main path at full width, sequential and pipelined
    _phase("main path: cfg5 (50k pods x real catalog), sequential and pipelined")
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config5_full_scale()
    print(f"lattice T={lattice.T} Z={lattice.Z} C={lattice.C}; "
          f"{len(pods)} pods, {len(pools)} pools", flush=True)
    problem = build_problem(pods, pools, lattice, existing=existing)
    t = time.perf_counter()
    oracle = ffd_oracle(problem)
    print(f"ffd oracle: {oracle.num_new_nodes} nodes, "
          f"${oracle.new_node_cost:.2f}/hr ({time.perf_counter() - t:.1f} s)",
          flush=True)
    t = time.perf_counter()
    cpu_plan = Solver(lattice, device="cpu").solve_relaxed(
        pods, pools, existing=existing)
    print(f"cpu plan: {len(cpu_plan.new_nodes)} nodes "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    launches = {}
    solvers = {}
    for path, pipelined in (("cfg5_sequential", False), ("cfg5_pipelined", True)):
        solver = Solver(lattice) if pipelined else Solver(lattice, pipeline=False)
        if solver.device.type != "cuda" or solver.pipeline is not pipelined:
            raise AssertionError(f"{path}: Solver on {solver.device}, "
                                 f"pipeline={solver.pipeline}")
        oa.LAUNCHES = 0
        t = time.perf_counter()
        plan = solver.solve_relaxed(pods, pools, existing=existing)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
        launches[path] = oa.LAUNCHES
        print(f"{path}: kernel launches in one solve: {launches[path]}")
        if launches[path] <= 0:
            raise AssertionError(f"{path}: the kernel never launched")
        placed = sum(len(n.pods) for n in plan.new_nodes) + sum(
            len(v) for v in plan.existing_assignments.values())
        ratio = plan.new_node_cost / oracle.new_node_cost
        print(f"{path}: {len(plan.new_nodes)} nodes, ${plan.new_node_cost:.2f}/hr, "
              f"{placed} pods placed, {len(plan.unschedulable)} unschedulable, "
              f"cost ratio to the oracle {ratio:.6f}, pipelined={plan.pipelined}, "
              f"cold solve {cold_s * 1e3:.1f} ms", flush=True)
        if plan.unschedulable or placed != len(pods) or len(pods) != 50000:
            raise AssertionError(f"{path}: placed {placed}/{len(pods)}, "
                                 f"{len(plan.unschedulable)} unschedulable")
        if not ratio <= 1.02:
            raise AssertionError(f"{path}: cost ratio {ratio} above 1.02")
        if plan.pipelined is not pipelined:
            raise AssertionError(f"{path}: plan.pipelined={plan.pipelined}")
        if _node_rows(plan) != _node_rows(cpu_plan) \
                or plan.existing_assignments != cpu_plan.existing_assignments:
            raise AssertionError(f"{path}: the card's plan differs from the CPU plan")
        print(f"{path}: card plan == cpu plan, node by node", flush=True)
        solvers[path] = solver

    # e2e of both paths in turns (sequential, pipelined, then pipelined,
    # sequential, ...), so that the host's drift falls on both alike
    e2e = {path: [] for path in solvers}
    stages = {path: {} for path in solvers}
    for i in range(SOLVES):
        for path in (list(solvers) if i % 2 == 0 else list(solvers)[::-1]):
            t = time.perf_counter()
            p = solvers[path].solve_relaxed(pods, pools, existing=existing)
            torch.cuda.synchronize()
            e2e[path].append((time.perf_counter() - t) * 1e3)
            for k, v in p.stage_ms.items():
                stages[path].setdefault(k, []).append(v)
            if _node_rows(p) != _node_rows(cpu_plan):
                raise AssertionError(f"{path}: a repeated solve changed the plan")
    cfg5 = {}
    for path, ms in e2e.items():
        cfg5[path] = {"e2e_p50_ms": statistics.median(ms), "e2e_ms": ms,
                      "stage_p50_ms": {k: statistics.median(v)
                                       for k, v in stages[path].items()}}
        print(f"{path}: e2e p50 {statistics.median(ms):.3f} ms over {SOLVES} "
              f"solves (min {min(ms):.3f}, max {max(ms):.3f}); stage p50 ms "
              f"{ {k: round(v, 3) for k, v in cfg5[path]['stage_p50_ms'].items()} }",
              flush=True)
    wins = sum(a < b for a, b in zip(e2e["cfg5_pipelined"], e2e["cfg5_sequential"]))
    print(f"pipelined faster than sequential in {wins} of {SOLVES} turns; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    print("(pipelined stages: compute is the host's issue time, download "
          "holds the wait for the card)", flush=True)

    # ---- 5. steady state
    _phase(f"steady state: cfg10 (20k pods, 120 nodes, "
           f"{workloads.STEADY_PASSES} passes)")
    steady, steady_problem = _steady_state(torch, workloads, lattice, oa)
    launches["cfg10_steady_state"] = sum(steady["launches_per_pass"])

    # ---- 6. the provisioning controller
    _phase("provisioner: the cfg5 wave and cfg10 through provision_once")
    prov, prov_launches = _provisioner(torch, workloads, lattice, oa, cpu_plan)
    launches.update(prov_launches)
    max_err = max(max_err, prov["max_abs_err"])

    # ---- 7. consolidation: cfg4's fleet
    _phase("consolidation: cfg4 (500 under-utilized nodes x real catalog)")
    consol, launches["cfg4_consolidation"], consol_per_pass, probe_inputs = \
        _consolidation(torch, workloads, lattice, oa)
    max_err = max(max_err, consol["max_abs_err"])

    # ---- 8. kernel times: the main paths' own inputs, the dense largest
    # bucket, the launch floor
    _phase("kernel timing")
    solver = Solver(lattice)
    _, cfg5_inputs = measure.captured_main_path_inputs(
        lambda: solver.solve_relaxed(pods, pools, existing=existing))
    _, cfg10_inputs = measure.captured_main_path_inputs(
        lambda: Solver(lattice, pipeline=False).solve(steady_problem))
    timed = {}
    for name, (tm, zc, pr) in (
            ("cfg5", cfg5_inputs), ("cfg10", cfg10_inputs),
            ("cfg4_probe", probe_inputs),
            ("dense", measure.on_device(offering_cases.dense_case(), dev))):
        max_err = max(max_err, measure.check_exact(
            f"{name} inputs", oa.cheapest_offering(tm, zc, pr),
            oa.cheapest_offering_ref(tm, zc, pr)))
        ms, waited_k = measure.device_times_ms(lambda: oa.cheapest_offering(tm, zc, pr))
        plain_ms, waited_p = measure.device_times_ms(
            lambda: oa.cheapest_offering_ref(tm, zc, pr))
        bound_ms, bound_by, nbytes, n_ops = measure.bound(tm, zc, pr)
        B, T = tm.shape
        ZC = zc.shape[1]
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "shape": {"B": B, "T": T, "ZC": ZC}}
        print(f"cheapest_offering, {name} B={B} T={T} ZC={ZC}: kernel {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms (median of 100 device times; host waited "
              f"{waited_k * 1e3:.1f} / {waited_p * 1e3:.1f} ms after enqueue); "
              f"bound {bound_ms * 1e3:.4f} us by {bound_by} ({nbytes} bytes, "
              f"{n_ops} compares)", flush=True)
    floor_ms = measure.launch_floor_ms(dev)
    print(f"launch floor (one-element in-place add): {floor_ms:.6f} ms", flush=True)

    # ---- nothing of JAX was loaded
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "karpenter_provider_aws_tpu"
                    or m.startswith("karpenter_provider_aws_tpu."))
    if leaked:
        raise AssertionError(f"modules of JAX or the JAX package loaded: {leaked[:5]}")

    _phase("")
    print(json.dumps({"kernels": [{
        "name": "cheapest_offering", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/offering_argmin.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/offering_argmin.py:92",
        "launches": launches["provisioner_cfg5"], "max_abs_err": max_err,
        **timed["cfg5"], "library_ms": None,
        "launches_by_path": launches, "launch_floor_ms": floor_ms,
        "cfg10": {**timed["cfg10"], "launches": launches["cfg10_steady_state"],
                  "launches_per_pass": steady["launches_per_pass"]},
        "cfg4_probe": {**timed["cfg4_probe"],
                       "launches": launches["cfg4_consolidation"],
                       "launches_per_pass": consol_per_pass,
                       "launches_per_probe_dispatch": 1},
        "dense": timed["dense"],
    }], "cfg5": cfg5, "cfg10": {k: v for k, v in steady.items()
                                if k != "launches_per_pass"},
        "consolidation": consol,
        "provisioner": {"cfg5_wave": prov["cfg5_wave"],
                        "cfg10_first_wave": prov["cfg10_first_wave"],
                        "cfg10": {k: v for k, v in prov["cfg10"].items()
                                  if k != "rows"}},
        "phase_seconds": _PHASE["seconds"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
