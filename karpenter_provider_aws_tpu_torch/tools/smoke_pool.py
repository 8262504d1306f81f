"""CI smoke for the solver failover pool (ci.sh pool gate), for this
package (the counterpart of the repository's ``tools/smoke_pool.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_pool [--device cuda]

Boots a real Operator against a 2-sidecar unix-socket pool
(parallel/pool.py SolverPool; docs/reference/solver-pool.md) — each
sidecar an in-process ``ChaosSidecar`` over a Solver on ``--device``, and
the pool's local rung on ``--device`` too — kills one sidecar mid-churn,
and asserts the four things the pool exists to prove:

1. passes KEEP LANDING on the survivor: failovers > 0, the survivor's
   per-endpoint solve count grows, and the local rung never engages
   while a sidecar is healthy (local_solves == 0, no pool-exhausted
   degradation — "host_ffd never becomes the common rung"),
2. a junk-talking endpoint classifies as a sidecar failure and fails
   over (no JSONDecodeError out of a pass),
3. the breaker state is VISIBLE over live HTTP: the kpctl top POOL row
   renders the open breaker, and the karpenter_solver_pool_* gauges ride
   a /metrics scrape that lints clean,
4. the dead sidecar restarted → the half-open probation probe RE-CLOSES
   the breaker (FakeClock-stepped probation) and delegation resumes.

Fast by design: small-family lattice, a handful of passes. The sidecars
run in this process, so the gate's kernel launches count theirs.
"""

from __future__ import annotations

import json
import tempfile
import urllib.request

from . import gate

# the pool's solve deadline (s), the reference gate's: there it covers the
# first pass's XLA compile; here the first pass on the card is a cold
# start of 1-3 s (the scan's first kernels), well inside it. Kill and
# junk fail fast, so the failover phases never wait it out.
SOLVE_DEADLINE = 10.0


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..metrics import lint_exposition
    from ..operator import Operator, Options
    from ..parallel.sidecar import ChaosSidecar
    from ..solver import Solver
    from ..utils.clock import FakeClock
    from . import kpctl

    failures = []
    clock = FakeClock()
    lattice = gate.small_lattice()
    pool_dir = tempfile.mkdtemp(prefix="smoke-pool-")
    s0 = ChaosSidecar(Solver(lattice, device=device),
                      f"unix:{pool_dir}/sidecar0.sock").start()
    s1 = ChaosSidecar(Solver(lattice, device=device),
                      f"unix:{pool_dir}/sidecar1.sock").start()
    op = Operator(options=Options(registration_delay=0.5,
                                  solver_address=f"{s0.address},{s1.address}",
                                  solver_solve_deadline=SOLVE_DEADLINE),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  device=device)
    serial = 0

    def churn(n_passes: int) -> None:
        nonlocal serial
        for _ in range(n_passes):
            for _ in range(2):
                serial += 1
                op.cluster.add_pod(Pod(name=f"pl{serial}",
                                       requests={"cpu": "500m",
                                                 "memory": "1Gi"}))
            op.run_once(force_provision=True)
            clock.step(2.0)

    # phase 1: both sidecars healthy — delegation, no failovers
    churn(3)
    pst = op.solver.pool_stats()
    if pst["delegated_solves"] == 0:
        failures.append("no pass delegated to the pool while healthy")
    if pst["failovers"] != 0:
        failures.append(f"failovers={pst['failovers']} with a healthy pool")

    # phase 2: kill sidecar 0 mid-churn — survivor carries every pass
    s0.kill()
    ep1_before = pst["ep1_solves"]
    churn(4)
    pst = op.solver.pool_stats()
    if pst["failovers"] == 0:
        failures.append("sidecar killed but the pool never failed over")
    if pst["ep1_solves"] <= ep1_before:
        failures.append("passes did not land on the surviving sidecar")
    if pst["local_solves"] != 0:
        failures.append(f"local rung engaged {pst['local_solves']}x "
                        "while a sidecar was healthy")
    if op.solver.degraded_counts.get("pool-exhausted"):
        failures.append("pool-exhausted degradation with a healthy "
                        "endpoint in the pool")
    if pst["ep0_state"] != 2:
        failures.append(f"dead sidecar's breaker not open "
                        f"(state={pst['ep0_state']})")

    # phase 3: junk-talking survivor endpoint — still no decode error
    # out of a pass (the junk classifies as a sidecar failure); with
    # ep0 dead AND ep1 junking this is a full blackout: the local rung
    # is the correct final answer
    s1.set_junk(True)
    try:
        churn(1)
    except Exception as e:   # noqa: BLE001 - any escape is the failure
        failures.append(f"junk response escaped the pass: "
                        f"{type(e).__name__}: {e}")
    s1.set_junk(False)
    pst = op.solver.pool_stats()
    if pst["local_solves"] == 0:
        failures.append("full blackout (dead + junk) did not engage "
                        "the local final rung")
    if not op.solver.degraded_counts.get("pool-exhausted"):
        failures.append("blackout pass not counted pool-exhausted "
                        f"(degraded_counts={op.solver.degraded_counts})")

    # phase 4: the live HTTP surfaces, with the breaker still open
    server = start_server(op, 0)
    port = server.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/vars", timeout=10).read())
        sp = doc.get("providers", {}).get("solver_pool", {})
        if not sp or sp.get("endpoints") != 2:
            failures.append(f"solver_pool provider wrong over HTTP: {sp}")
        top = "\n".join(kpctl._render_top(doc, base))
        pool_rows = [ln for ln in top.splitlines()
                     if ln.startswith("POOL")]
        if not pool_rows:
            failures.append("kpctl top renders no POOL row")
        elif "open" not in pool_rows[0]:
            failures.append(f"POOL row hides the open breaker: "
                            f"{pool_rows[0]!r}")
        scrape = urllib.request.urlopen(f"{base}/metrics",
                                        timeout=10).read().decode()
        for series in ("karpenter_solver_pool_endpoints",
                       "karpenter_solver_pool_healthy_endpoints",
                       "karpenter_solver_pool_failovers",
                       "karpenter_solver_pool_breaker_state"):
            if series not in scrape:
                failures.append(f"/metrics missing {series}")
        if 'karpenter_solver_pool_breaker_state{endpoint="' not in scrape:
            failures.append("breaker-state gauge carries no endpoint label")
        lint = lint_exposition(scrape)
        if lint:
            failures.append(f"live scrape lint: {lint[:3]}")
    finally:
        server.shutdown()

    # phase 5: restart the dead sidecar → probation elapses on the
    # stepped clock → the half-open probe re-closes the breaker and
    # delegation resumes on it
    s0.restart()
    clock.step(120.0)
    op.solver.check_endpoints()
    pst = op.solver.pool_stats()
    if pst["ep0_state"] != 0:
        failures.append(f"restarted sidecar's breaker did not re-close "
                        f"(state={pst['ep0_state']})")
    ep0_before = pst["ep0_solves"]
    churn(3)
    pst = op.solver.pool_stats()
    if pst["ep0_solves"] <= ep0_before:
        failures.append("no pass landed on the recovered sidecar")
    if pst["healthy"] != 2:
        failures.append(f"pool not fully healthy at exit "
                        f"({pst['healthy']}/2)")

    device_label = op.solver.stats()["device"]
    op.solver.close()
    s0.kill()
    s1.kill()
    gate.report("pool", device, device_label, failures)
    if failures:
        print("pool smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"pool smoke: OK (delegated={pst['delegated_solves']}, "
          f"failovers={pst['failovers']}, "
          f"local={pst['local_solves']}, "
          f"breakers closed,closed, "
          f"recovered ep0 solves={pst['ep0_solves']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
