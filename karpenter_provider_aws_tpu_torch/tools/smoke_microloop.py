"""CI smoke for the device-resident reconcile microloop (ci.sh gate), for
this package (the counterpart of the repository's
``tools/smoke_microloop.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_microloop [--device cuda]

Boots a real Operator on a FORCED 8-shard mesh (``Options(mesh="8")``,
the shards batched on the Solver's ``--device``, as the sharded smoke
does), drives a seed wave plus small-churn reconcile passes, and asserts
the microloop actually carries the steady state end to end:

1. ENGAGED: every delta pass rode the microloop (``micro_solves`` ==
   ``delta_solves`` > 0) — a microloop silently aborting to the
   standard ladder every pass would otherwise read as a vacuous green;
2. LEG BOUND: on every delta pass the link legs recorded by the
   solver's accounting stay within the bound — ≤2 (one dirty upload,
   one conditional plan fetch) on passes without a tail-bin merge, ≤4
   when the mesh merge refinement re-ran (the reference's bound);
3. SKIPPED SYNCS: passes whose pending set did not change produce an
   unchanged plan, and the changed-plan fingerprint suppresses the
   plan fetch (``micro_skipped_syncs`` > 0; a stuck unschedulable pod
   keeps the problem non-empty across those passes);
4. PARITY: on sampled churn passes the microloop-produced plan matches
   a SINGLE-DEVICE full-rebuild referee solve of the same cluster
   inputs byte-exactly (canonical plan JSON, not just cost).

Fast by design: small-family lattice, ~100 pods.
"""

from __future__ import annotations

import json
import random

from . import gate

MESH_DEVICES = 8
CHURN_PASSES = 10
NOCHURN_PASSES = 3
LEGS_BOUND = 2
LEGS_BOUND_MERGE = 4


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod, serde
    from ..cloud import FakeCloud
    from ..operator import Operator, Options
    from ..solver import Solver, build_problem
    from ..utils.clock import FakeClock

    clock = FakeClock()
    lattice = gate.small_lattice()
    op = Operator(options=Options(registration_delay=1.0,
                                  mesh=str(MESH_DEVICES)),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  device=device)
    # single-device full-rebuild referee
    referee = Solver(lattice, device=device)
    rng = random.Random(14)
    shapes = [{"cpu": "250m", "memory": "512Mi"},
              {"cpu": "500m", "memory": "1Gi"},
              {"cpu": "1", "memory": "2Gi"}]
    failures = []

    def canon(plan) -> str:
        return json.dumps(serde.plan_semantic_dict(plan), sort_keys=True)

    # full pass: a 48-pod wave, settle to capacity
    for i in range(48):
        op.cluster.add_pod(Pod(name=f"seed-{i}",
                               requests=shapes[i % len(shapes)]))
    op.settle(max_rounds=30)
    if op.cluster.pending_pods():
        failures.append(f"seed wave did not settle: "
                        f"{len(op.cluster.pending_pods())} pending")

    solver = op.solver
    serial = 0
    parity_checked = 0
    delta_pass_legs = []
    for pass_i in range(CHURN_PASSES):
        for _ in range(rng.randint(2, 4)):
            serial += 1
            op.cluster.add_pod(Pod(name=f"churn-{serial}",
                                   requests=shapes[serial % len(shapes)]))
        bound = [p.name for p in op.cluster.snapshot_pods()
                 if p.node_name is not None]
        for name in rng.sample(bound, min(len(bound), rng.randint(1, 2))):
            op.cluster.delete_pod(name)

        referee_problem = None
        if pass_i % 4 == 3:
            referee_problem = build_problem(
                op.cluster.pending_pods(), list(op.node_pools.values()),
                solver.lattice,
                existing=op.cluster.existing_bins(solver.lattice),
                daemonset_pods=op.cluster.daemonset_pods(),
                bound_pods=op.cluster.bound_pods())
        pre = dict(solver.pipeline_stats)
        result = op.provisioner.provision_once()
        post = solver.pipeline_stats
        if post["delta_solves"] > pre["delta_solves"] \
                and post["micro_solves"] > pre["micro_solves"]:
            legs = post["micro_last_legs"]
            merged = post["micro_merge_solves"] > pre["micro_merge_solves"]
            # a merge bin-table regrow retry re-stages and re-fetches:
            # +2 accounted legs per regrow, excused from the bound
            regrows = (post["micro_merge_regrows"]
                       - pre["micro_merge_regrows"])
            bound_now = (LEGS_BOUND_MERGE if merged else LEGS_BOUND) \
                + 2 * regrows
            delta_pass_legs.append(legs)
            if legs > bound_now:
                failures.append(
                    f"pass {pass_i}: {legs} link legs exceeds the "
                    f"{'merge ' if merged else ''}bound {bound_now}")
        if referee_problem is not None and result.plan is not None \
                and result.plan.solver_path == "device":
            # builder-level parity (multiset + cost — pod ordering
            # inside groups may differ between the incremental and the
            # scratch build; byte identity is asserted same-problem
            # below)
            ref = referee.solve(referee_problem)
            plan = result.plan
            got = sorted((n.instance_type, n.zone, len(n.pods))
                         for n in plan.new_nodes)
            want = sorted((n.instance_type, n.zone, len(n.pods))
                          for n in ref.new_nodes)
            if got != want:
                failures.append(
                    f"pass {pass_i}: microloop plan diverged from the "
                    f"single-device full-rebuild referee "
                    f"({got} vs {want})")
            if abs(plan.new_node_cost - ref.new_node_cost) > 1e-6:
                failures.append(
                    f"pass {pass_i}: cost {plan.new_node_cost} != "
                    f"referee {ref.new_node_cost}")
            parity_checked += 1
        op.settle(max_rounds=10)

    # byte-exact parity, same problem: the mesh microloop's plan of a
    # scratch-built problem must equal the single-device full-staging
    # referee's byte for byte — the microloop changes bytes moved,
    # never the answer
    pending = op.cluster.pending_pods()
    if not pending:
        serial += 1
        op.cluster.add_pod(Pod(name=f"churn-{serial}",
                               requests=shapes[0]))
        pending = op.cluster.pending_pods()
    byte_prob = build_problem(
        pending, list(op.node_pools.values()), solver.lattice,
        existing=op.cluster.existing_bins(solver.lattice),
        daemonset_pods=op.cluster.daemonset_pods(),
        bound_pods=op.cluster.bound_pods())
    if canon(solver.solve_delta(byte_prob)) != canon(referee.solve(byte_prob)):
        failures.append("mesh microloop plan is not byte-identical to "
                        "the single-device referee on the same problem")

    # skipped-sync stanza: one impossible pod keeps the problem alive
    # and IDENTICAL across passes — the fingerprint must suppress the
    # plan fetch on the repeat passes
    op.cluster.add_pod(Pod(name="impossible",
                           requests={"cpu": "4000", "memory": "64Ti"}))
    pre_skip = solver.pipeline_stats["micro_skipped_syncs"]
    for _ in range(1 + NOCHURN_PASSES):
        op.provisioner.provision_once()
    skipped = solver.pipeline_stats["micro_skipped_syncs"] - pre_skip
    if skipped < 1:
        failures.append(
            f"fingerprint never suppressed a plan fetch across "
            f"{NOCHURN_PASSES} unchanged passes (skipped={skipped})")

    st = solver.stats()
    if st.get("mesh_devices", 0) != MESH_DEVICES:
        failures.append(f"planned mesh did not reach the solver: "
                        f"{st.get('mesh_devices')}")
    if st.get("delta_solves", 0) == 0:
        failures.append("delta path never engaged (delta_solves=0) — "
                        "last gate reason: "
                        f"{op.provisioner.inc_builder.last_reason!r}")
    if st.get("micro_solves", 0) == 0:
        failures.append("microloop never engaged (micro_solves=0)")
    if st.get("micro_solves", 0) != st.get("delta_solves", 1):
        failures.append(
            f"microloop did not carry every delta pass "
            f"(micro_solves={st.get('micro_solves')} != "
            f"delta_solves={st.get('delta_solves')}; "
            f"aborts={st.get('micro_aborts')})")
    if not delta_pass_legs:
        failures.append("no delta pass recorded link legs (harness bug)")
    if parity_checked == 0:
        failures.append("no parity pass executed (harness bug)")
    if st.get("overlapped_admission", 0) == 0:
        failures.append("admission bookkeeping never overlapped the "
                        "in-flight dispatch")
    # the journal coalescer fed the passes (provisioner stats surface)
    pstats = op.provisioner.stats()
    if pstats.get("journal_takes", 0) == 0:
        failures.append("journal coalescer never fed a pass")

    gate.report("microloop", device, st["device"], failures)
    if failures:
        print("microloop smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"microloop smoke: OK (micro_solves={st['micro_solves']}, "
          f"delta_solves={st['delta_solves']}, "
          f"legs_per_delta_pass={delta_pass_legs}, "
          f"skipped_syncs={skipped}, "
          f"merge_solves={st['micro_merge_solves']}, "
          f"merge_skips={st['micro_merge_skips']}, "
          f"overlapped={st['overlapped_admission']}, "
          f"parity passes={parity_checked})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
