"""CI smoke for the batched consolidation engine (ci.sh gate), for this
package (the counterpart of the repository's
``tools/smoke_consolidation.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_consolidation [--device cuda]

Boots a real Operator (its Solver on ``--device``), churns it to an
over-provisioned steady state (oversized nodes pinned non-empty by one
tiny anti-affine pod each), and asserts the engine actually carries the
consolidation search end to end (docs/reference/consolidation.md):

1. BATCHED: >=2 nodes consolidate via the batched device path —
   ``vmapped_whatifs`` > 0 with candidate sets batched per dispatch
   (``Solver.probe_batch``: one pass over K probes, one kernel launch),
   and ZERO host-ladder fallbacks (every candidate problem stayed inside
   the batched envelope);
2. REFEREE: every accepted removal passed the host-FFD cost referee
   (``referee_checks`` > 0, accepted plans within the <=2% envelope —
   a referee that never ran would make the envelope vacuous);
3. BUDGET PACING: with the pool's disruption budget pinned to 0, the
   search probes but refuses — ``not-consolidatable-budget`` skips
   recorded, zero nodes touched — and consolidating resumes the pass
   after the budget opens to 1-at-a-time;
4. ZERO-LEG CACHE: pending-only churn after the fleet settles re-runs
   the search entirely from the probe cache (``fp_unchanged`` grows,
   ``vmapped_whatifs`` does not);
5. SURFACES: the ``consolidation`` introspection provider reports over
   live HTTP, the kpctl top CONSOLIDATION row renders, and
   ``kpctl explain node`` answers "why was this node NOT consolidated"
   with a taxonomy code.

Fast by design: small-family lattice, 6 nodes, FakeClock.
"""

from __future__ import annotations

import contextlib
import io
import json
import urllib.request

from . import gate

N_NODES = 6


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..apis.objects import DisruptionBudget, NodePool, PodAffinityTerm
    from ..apis import wellknown as wk
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock
    from . import kpctl

    failures = []
    clock = FakeClock()
    lattice = gate.small_lattice()
    pool = NodePool(name="default")
    pool.disruption.consolidation_policy = "WhenUnderutilized"
    pool.disruption.consolidate_after = 5.0
    # phase 1: budget CLOSED — the engine must probe yet refuse
    pool.disruption.budgets = [DisruptionBudget(nodes="0")]
    # spot fleet: replacements are spot too, so the spot->spot gate +
    # 15-type flexibility floor are on the accept path
    op = Operator(options=Options(registration_delay=0.5,
                                  spot_to_spot_consolidation=True),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  node_pools=[pool], device=device)
    engine = op.disruption.engine

    # over-provision: one 3-cpu anti-affine pod per node forces 6
    # oversized nodes; swapping them for 250m pods leaves every node
    # non-empty (emptiness can't claim them) but wildly underutilized —
    # exactly the consolidation method's territory
    anti = [PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME,
                            label_selector=(("app", "spread"),), anti=True)]
    for i in range(N_NODES):
        op.cluster.add_pod(Pod(name=f"big-{i}", labels={"app": "spread"},
                               requests={"cpu": "3", "memory": "6Gi"},
                               pod_affinity=list(anti)))
    op.settle(max_rounds=30)
    if len(op.cluster.nodes) != N_NODES:
        failures.append(f"seed did not build {N_NODES} nodes "
                        f"({len(op.cluster.nodes)})")
    for i in range(N_NODES):
        op.cluster.delete_pod(f"big-{i}")
        op.cluster.add_pod(Pod(name=f"tiny-{i}", labels={"app": "spread"},
                               requests={"cpu": "250m",
                                         "memory": "256Mi"},
                               pod_affinity=list(anti)))
    op.settle(max_rounds=10)
    if len(op.cluster.nodes) != N_NODES:
        failures.append("tiny pods did not land on the existing fleet")
    clock.step(6.0)   # past consolidate_after

    # phase 1: budget 0 — probes run, pacing refuses, nothing moves
    for _ in range(3):
        op.run_once(force_provision=False)
        clock.step(0.5)
    stats = engine.stats()
    if stats.get("vmapped_whatifs", 0) < 1:
        failures.append("budget-0 phase never dispatched a probe batch")
    if stats.get("skip_not_consolidatable_budget", 0) < 1:
        failures.append("budget pacing never recorded a "
                        "not-consolidatable-budget skip")
    if stats.get("nodes_consolidated", 0) != 0 or op.disruption._in_flight:
        failures.append("a node was disrupted under a 0-node budget")
    budget_skips = stats.get("skip_not_consolidatable_budget", 0)

    # phase 2: budget opens to 1-at-a-time — consolidation proceeds,
    # paced, until the fleet is tight
    pool.disruption.budgets = [DisruptionBudget(nodes="1")]
    for _ in range(40):
        op.run_once(force_provision=bool(op.cluster.pending_pods()))
        clock.step(0.5)
        if engine.counters["nodes_consolidated"] >= 2 \
                and not op.disruption._in_flight \
                and not op.cluster.pending_pods():
            break
    op.settle(max_rounds=10)
    stats = engine.stats()
    if stats.get("nodes_consolidated", 0) < 2:
        failures.append(
            f"engine consolidated {stats.get('nodes_consolidated', 0):g} "
            f"nodes, expected >=2 (accepted={stats.get('accepted', 0):g}, "
            f"ledger={engine.ledger_doc()})")
    if stats.get("host_fallbacks", 0) != 0:
        failures.append(f"candidates left the vmapped envelope: "
                        f"{stats.get('host_fallbacks'):g} host fallbacks")
    if stats.get("vmapped_whatifs", 0) < 2:
        failures.append("the batched device path barely engaged")
    if stats.get("batched_candidates", 0) <= stats.get("vmapped_whatifs", 0):
        failures.append("dispatches did not batch >1 candidate set")
    if stats.get("referee_checks", 0) < 1:
        failures.append("the savings referee never ran")
    if stats.get("savings_per_hour", 0) <= 0:
        failures.append("accepted consolidations recorded no savings")
    if op.cluster.pending_pods():
        failures.append(f"{len(op.cluster.pending_pods())} pods stranded "
                        "pending after consolidation")

    # phase 3: close the budget again and age the fleet back into
    # eligibility; the warmup pass dispatches one fresh batch (and codes
    # every candidate not-consolidatable-budget -> the ledger the explain
    # stanza reads), then pending-only churn must re-run the search
    # entirely from the probe cache: zero device legs, zero snapshots
    pool.disruption.budgets = [DisruptionBudget(nodes="0")]
    clock.step(6.0)
    for _ in range(2):
        op.run_once(force_provision=False)
        clock.step(0.5)
    pre = engine.stats()
    op.cluster.add_pod(Pod(name="impossible",
                           requests={"cpu": "4000", "memory": "64Ti"}))
    for _ in range(2):
        op.run_once(force_provision=True)
        clock.step(0.5)
    post = engine.stats()
    if post.get("fp_unchanged", 0) <= pre.get("fp_unchanged", 0):
        failures.append(
            "pending-only churn never hit the zero-leg probe cache "
            f"(fp_unchanged {pre.get('fp_unchanged', 0):g} -> "
            f"{post.get('fp_unchanged', 0):g})")
    if post.get("vmapped_whatifs", 0) > pre.get("vmapped_whatifs", 0):
        failures.append("pending-only churn paid a fresh device dispatch")

    # surfaces: provider + CONSOLIDATION row + explain node, live HTTP
    op.sampler.sample_once()
    server = start_server(op, 0)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/vars", timeout=10).read())
        co = doc.get("providers", {}).get("consolidation", {})
        if co.get("vmapped_whatifs", 0) < 1:
            failures.append(f"consolidation provider dark over HTTP: {co}")
        top = "\n".join(kpctl._render_top(doc, base))
        row = next((ln for ln in top.splitlines()
                    if ln.startswith("CONSOLIDATION")), "")
        if not row:
            failures.append("kpctl top renders no CONSOLIDATION row")
        elif "dispatches" not in row or "referee" not in row:
            failures.append(f"CONSOLIDATION row malformed: {row}")
        # a node the engine skipped answers over /debug/explain + kpctl
        ledger = engine.ledger_doc()
        if ledger:
            name, entry = next(iter(ledger.items()))
            ed = json.loads(urllib.request.urlopen(
                f"{base}/debug/explain?node={name}", timeout=10).read())
            if ed.get("code") != entry["code"]:
                failures.append(f"explain?node= disagrees with the "
                                f"engine ledger: {ed} vs {entry}")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = kpctl.main(["--server", base, "explain", "node",
                                 name])
            if rc != 0 or entry["code"] not in out.getvalue():
                failures.append(f"kpctl explain node failed (rc={rc}): "
                                f"{out.getvalue()!r}")
        else:
            failures.append("engine ledger empty — no skip decision to "
                            "explain (harness bug)")
    finally:
        server.shutdown()

    gate.report("consolidation", device, op.solver.stats()["device"],
                failures)
    if failures:
        print("consolidation smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"consolidation smoke: OK "
          f"(nodes_consolidated={stats['nodes_consolidated']:g}, "
          f"savings=${stats['savings_per_hour']:.2f}/hr, "
          f"dispatches={post['vmapped_whatifs']:g} "
          f"({post['batched_candidates']:g} sets), "
          f"cached={post['fp_unchanged']:g}, host_fallbacks=0, "
          f"referee={post['referee_checks']:g} checks/"
          f"{post['referee_rejects']:g} rejects, "
          f"budget_skips={budget_skips:g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
