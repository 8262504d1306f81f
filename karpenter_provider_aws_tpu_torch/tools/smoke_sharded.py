"""CI smoke for the mesh-promoted sharded production path (ci.sh gate), for
this package (the counterpart of the repository's ``tools/smoke_sharded.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_sharded [--device cuda]

Boots a real Operator on a FORCED 8-shard mesh (``Options(mesh="8")``:
``parallel/mesh.py plan_mesh`` plans ``SolverMesh(shards=8)``, its shards
packed as one batched pass on the Solver's ``--device`` on one card, one
shard per card on several (parallel/ranks.py); the reference
forces an 8-device virtual CPU mesh instead — ``auto`` stays
single-device here as there), drives a seed wave plus small-churn
reconcile passes, and asserts the promotion actually holds end to end:

1. the mesh ENGAGED: the operator's planned mesh reaches the solver
   (``stats()["mesh_devices"] > 1``) and sharded solves carried passes
   (``mesh_solves`` > 0) — a mesh silently falling back to the
   single-device path would otherwise read as a vacuous green;
2. the DELTA path composes with the mesh: steady-state churn passes ride
   ``solve_delta`` on the mesh (``delta_solves`` > 0). (Resident-entry
   HIT evidence lives in the bench's delta-on-mesh row, not here: this
   smoke's fused buffers fit ONE delta block, and a 1-block change
   legitimately re-uploads whole — the >half-changed heuristic);
3. parity: on sampled churn passes the mesh-produced plan matches a
   SINGLE-DEVICE referee solve of the same cluster inputs — identical
   new-node multiset and cost (the ≤2% envelope holds exactly here:
   small waves fully dissolve into the merge refinement);
4. the surfaces report: the shard-imbalance stat is sane and the claim
   provenance annotation carries the mesh device count.

Fast by design: small-family lattice, ~100 pods.
"""

from __future__ import annotations

import random

from . import gate

MESH_DEVICES = 8
CHURN_PASSES = 12


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..apis import wellknown as wk
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
    # the single-device referee: its OWN solver so the comparison can
    # never ride the mesh it referees
    referee = Solver(lattice, device=device)
    rng = random.Random(12)
    shapes = [{"cpu": "250m", "memory": "512Mi"},
              {"cpu": "500m", "memory": "1Gi"},
              {"cpu": "1", "memory": "2Gi"}]
    failures = []

    if op.solver.mesh_devices != MESH_DEVICES:
        failures.append(f"planned mesh did not reach the solver: "
                        f"mesh_devices={op.solver.mesh_devices}")

    # full pass: a 48-pod wave, settle to capacity
    for i in range(48):
        op.cluster.add_pod(Pod(name=f"seed-{i}",
                               requests=shapes[i % len(shapes)]))
    op.settle(max_rounds=30)
    if op.cluster.pending_pods():
        failures.append(f"seed wave did not settle: "
                        f"{len(op.cluster.pending_pods())} pending")

    serial = 0
    parity_checked = 0
    for pass_i in range(CHURN_PASSES):
        # small churn: 2-4 new pods arrive; 1-2 bound pods leave
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
            # capture the referee problem BEFORE the pass mutates state
            referee_problem = build_problem(
                op.cluster.pending_pods(), list(op.node_pools.values()),
                op.solver.lattice,
                existing=op.cluster.existing_bins(op.solver.lattice),
                daemonset_pods=op.cluster.daemonset_pods(),
                bound_pods=op.cluster.bound_pods())
        result = op.provisioner.provision_once()
        if referee_problem is not None and result.plan is not None:
            plan = result.plan
            if plan.mesh_devices != MESH_DEVICES:
                failures.append(f"pass {pass_i}: plan did not ride the "
                                f"mesh (mesh_devices={plan.mesh_devices})")
            ref = referee.solve(referee_problem)
            got = sorted((n.instance_type, n.zone, len(n.pods))
                         for n in plan.new_nodes)
            want = sorted((n.instance_type, n.zone, len(n.pods))
                          for n in ref.new_nodes)
            if got != want:
                failures.append(
                    f"pass {pass_i}: mesh plan diverged from the "
                    f"single-device referee ({got} vs {want})")
            if abs(plan.new_node_cost - ref.new_node_cost) > 1e-6:
                failures.append(
                    f"pass {pass_i}: cost {plan.new_node_cost} != "
                    f"referee {ref.new_node_cost}")
            parity_checked += 1
        # let launches register so later passes see the new capacity
        op.settle(max_rounds=10)

    st = op.solver.stats()
    if st.get("mesh_devices", 0) <= 1:
        failures.append(f"mesh not engaged in stats: {st.get('mesh_devices')}")
    if st.get("mesh_solves", 0) == 0:
        failures.append("no sharded solve carried a pass (mesh_solves=0)")
    if st.get("delta_solves", 0) == 0:
        failures.append("delta path never engaged ON THE MESH "
                        "(delta_solves=0) — last gate reason: "
                        f"{op.provisioner.inc_builder.last_reason!r}")
    imb = st.get("mesh_shard_imbalance", 0.0)
    if not (imb == 0.0 or imb >= 1.0):
        failures.append(f"nonsensical shard imbalance {imb}")
    if parity_checked == 0:
        failures.append("no parity pass executed (harness bug)")
    claims = [c for c in op.cluster.snapshot_claims()]
    mesh_anns = [c.annotations.get(wk.ANNOTATION_SOLVER_MESH_DEVICES)
                 for c in claims]
    if claims and str(MESH_DEVICES) not in mesh_anns:
        failures.append(
            f"no claim carries the mesh provenance annotation: {mesh_anns}")

    gate.report("sharded", device, st["device"], failures)
    if failures:
        print("sharded smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"sharded smoke: OK (mesh_devices={st['mesh_devices']}, "
          f"mesh_solves={st['mesh_solves']}, "
          f"delta_solves={st['delta_solves']}, "
          f"resident_problem_hits={st['resident_problem_hits']}, "
          f"imbalance={st['mesh_shard_imbalance']}, "
          f"parity passes={parity_checked})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
