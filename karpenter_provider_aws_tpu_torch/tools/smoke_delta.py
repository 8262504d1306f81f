"""CI smoke for the steady-state delta-solve path (ci.sh churn gate), for
this package (the counterpart of the repository's ``tools/smoke_delta.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_delta [--device cuda]

Boots a real Operator (direct mode, FakeClock, its Solver on ``--device``),
drives one full provisioning pass, then 20 small-churn reconcile passes —
a few pods arrive and a few bind away each pass, the exact steady-state
shape the incremental builder + delta solve exist for — and asserts:

1. the delta path ENGAGED: ``karpenter_solver_delta_solves_total`` /
   ``Solver.pipeline_stats["delta_solves"]`` moved past zero, and the
   builder took the incremental path for churn passes (a delta gate
   silently failing open to full rebuilds would otherwise read as a
   vacuous green),
2. parity: on sampled churn passes the provisioner's plan matches a
   from-scratch ``build_problem`` + ``solve`` referee of the SAME
   cluster inputs — identical new-node multiset and cost,
3. the cluster converges (every churned pod scheduled or bound).

Fast by design: small-family lattice, ~120 pods — seconds, not a soak.
"""

from __future__ import annotations

import random

from . import gate


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..cloud import FakeCloud
    from ..operator import Operator, Options
    from ..solver import build_problem
    from ..utils.clock import FakeClock

    clock = FakeClock()
    lattice = gate.small_lattice()
    op = Operator(options=Options(registration_delay=1.0), lattice=lattice,
                  cloud=FakeCloud(clock), clock=clock, device=device)
    rng = random.Random(7)
    shapes = [{"cpu": "250m", "memory": "512Mi"},
              {"cpu": "500m", "memory": "1Gi"},
              {"cpu": "1", "memory": "2Gi"}]
    failures = []

    # full pass: a 60-pod wave, settle to capacity
    for i in range(60):
        op.cluster.add_pod(Pod(name=f"seed-{i}",
                               requests=shapes[i % len(shapes)]))
    op.settle(max_rounds=30)
    if op.cluster.pending_pods():
        failures.append(f"seed wave did not settle: "
                        f"{len(op.cluster.pending_pods())} pending")

    serial = 0
    parity_checked = 0
    for pass_i in range(20):
        # small churn: 2-4 new pods arrive; 1-2 bound pods leave
        for _ in range(rng.randint(2, 4)):
            serial += 1
            op.cluster.add_pod(Pod(name=f"churn-{serial}",
                                   requests=shapes[serial % len(shapes)]))
        bound = [p.name for p in op.cluster.snapshot_pods()
                 if p.node_name is not None]
        for name in rng.sample(bound, min(len(bound), rng.randint(1, 2))):
            op.cluster.delete_pod(name)

        referee_inputs = None
        if pass_i % 5 == 4:
            # capture the referee problem BEFORE the pass mutates state
            pending = op.cluster.pending_pods()
            referee_inputs = build_problem(
                pending, list(op.node_pools.values()), op.solver.lattice,
                existing=op.cluster.existing_bins(op.solver.lattice),
                daemonset_pods=op.cluster.daemonset_pods(),
                bound_pods=op.cluster.bound_pods())
        result = op.provisioner.provision_once()
        if referee_inputs is not None and result.plan is not None:
            ref = op.solver.solve(referee_inputs)
            plan = result.plan
            got = sorted((n.instance_type, n.zone, len(n.pods))
                         for n in plan.new_nodes)
            want = sorted((n.instance_type, n.zone, len(n.pods))
                          for n in ref.new_nodes)
            if got != want:
                failures.append(
                    f"pass {pass_i}: plan diverged from full-rebuild "
                    f"referee ({got} vs {want})")
            if abs(plan.new_node_cost - ref.new_node_cost) > 1e-6:
                failures.append(
                    f"pass {pass_i}: cost {plan.new_node_cost} != "
                    f"referee {ref.new_node_cost}")
            parity_checked += 1
        # let launches register so later passes see the new capacity
        op.settle(max_rounds=10)

    deltas = op.solver.pipeline_stats.get("delta_solves", 0)
    inc = op.provisioner.inc_builder.incremental_builds
    if deltas == 0:
        failures.append("delta-solve path never engaged (delta_solves=0) — "
                        f"last gate reason: "
                        f"{op.provisioner.inc_builder.last_reason!r}")
    if inc == 0:
        failures.append("incremental builder never took the delta path")
    if parity_checked == 0:
        failures.append("no parity pass executed (harness bug)")
    gate.report("delta", device, op.solver.stats()["device"], failures)
    if failures:
        print("delta smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"delta smoke: OK (delta_solves={deltas}, "
          f"incremental_builds={inc}, "
          f"parity passes={parity_checked}, "
          f"resident_problem_hits="
          f"{op.solver.pipeline_stats['resident_problem_hits']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
