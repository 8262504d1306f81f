"""CI smoke for the API-stratum write path (ci.sh writepath gate), for this
package (the counterpart of the repository's ``tools/smoke_writepath.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_writepath [--device cuda]

What this gate asserts (docs/reference/watch.md):

1. an API-mode operator boots (its Solver on ``--device``) and a churn
   burst drives writes through ``ApiWriter`` — and the COALESCED path
   actually engaged: the apiserver's bulk counters and the writer's
   ``bulk_binds`` count moved past zero (a batching seam silently falling
   back to per-pod verbs would otherwise read as a vacuous green),
2. zero per-watcher envelope copies were made delivering the burst's
   watch events (``fanout_envelope_copies`` — the shared-frozen-event
   design's pin),
3. the watch-fed mirror CONVERGES to the server's truth after the burst
   (same pod set, same bound assignments — snapshot-free delivery must
   not lose or corrupt events),
4. the live ``/metrics`` scrape carries the new ``karpenter_api_*``
   write/fan-out series with sane values and lints clean
   (metrics.lint_exposition).

Fast by design: small-family lattice, a few hundred pods, seconds.
"""

from __future__ import annotations

import urllib.request

from . import gate


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..kube import FakeAPIServer, KubeClient
    from ..metrics import lint_exposition
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock

    clock = FakeClock()
    lattice = gate.small_lattice()
    api_server = FakeAPIServer()
    client = KubeClient(api_server)
    op = Operator(options=Options(registration_delay=1.0), lattice=lattice,
                  cloud=FakeCloud(clock), clock=clock, api_server=api_server,
                  device=device)
    failures = []

    # churn burst through the protocol: a seed wave to build capacity,
    # then a second wave that lands on EXISTING nodes — the provisioning
    # pass's existing-capacity binds are the coalesced-write hot path
    errs = client.create_pods([
        Pod(name=f"seed-{i}", requests={"cpu": "250m", "memory": "256Mi"})
        for i in range(120)])
    if any(errs):
        failures.append(f"bulk seed creates failed: {errs}")
    op.settle(max_rounds=30)
    client.create_pods([
        Pod(name=f"wave-{i}", requests={"cpu": "250m", "memory": "256Mi"})
        for i in range(120)])
    op.settle(max_rounds=30)
    op.run_once()   # final gauge pass renders the karpenter_api_* series

    if op.cluster.pending_pods():
        failures.append(f"churn burst did not converge: "
                        f"{len(op.cluster.pending_pods())} pods pending")

    # 1. the coalesced write path engaged
    if api_server.bulk_calls == 0:
        failures.append("bulk verb never engaged (bulk_calls == 0)")
    wstats = op.writer.stats()
    if not wstats.get("bulk_binds"):
        failures.append(f"ApiWriter.bind_pods never batched: {wstats}")
    if not wstats.get("bind_pod"):
        failures.append("no pod ever bound through the writer seam")

    # 2. snapshot-free fan-out: zero per-watcher envelope copies
    astats = api_server.stats()
    if astats["fanout_envelope_copies"] != 0:
        failures.append(f"fan-out made envelope copies: "
                        f"{astats['fanout_envelope_copies']}")
    if astats["events_emitted"] == 0:
        failures.append("watch hub delivered no events during the burst")

    # 3. watch-fed mirror converged to the server's truth
    server_pods = {o["metadata"]["name"]: o["spec"].get("nodeName")
                   for o in api_server._store["pods"].values()}
    mirror_pods = {p.name: p.node_name for p in op.cluster.pods.values()}
    if server_pods != mirror_pods:
        only_s = set(server_pods) - set(mirror_pods)
        only_m = set(mirror_pods) - set(server_pods)
        diff = {n for n in set(server_pods) & set(mirror_pods)
                if server_pods[n] != mirror_pods[n]}
        failures.append(f"mirror diverged from server: server-only "
                        f"{sorted(only_s)[:3]} mirror-only "
                        f"{sorted(only_m)[:3]} bind-diff {sorted(diff)[:3]}")

    # 4. live /metrics carries the karpenter_api_* series and lints clean
    server = start_server(op, 0)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        scrape = urllib.request.urlopen(f"{base}/metrics",
                                        timeout=10).read().decode()
        problems = lint_exposition(scrape)
        if problems:
            failures.append(f"/metrics lint: {problems[:5]}")
        for series, minimum in (("karpenter_api_bulk_ops", 1.0),
                                ("karpenter_api_watch_events_delivered", 1.0),
                                ("karpenter_api_watchers", 1.0)):
            val = None
            for line in scrape.splitlines():
                if line.startswith(series + " "):
                    val = float(line.split()[-1])
            if val is None:
                failures.append(f"/metrics: series {series} missing")
            elif val < minimum:
                failures.append(f"/metrics: {series}={val} < {minimum}")
        for line in scrape.splitlines():
            if line.startswith("karpenter_api_fanout_envelope_copies "):
                if float(line.split()[-1]) != 0.0:
                    failures.append(f"/metrics: fan-out copies nonzero: "
                                    f"{line}")
    finally:
        server.shutdown()

    gate.report("writepath", device, op.solver.stats()["device"], failures)
    if failures:
        print("smoke_writepath: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"smoke_writepath: OK "
          f"(bulk_calls={api_server.bulk_calls}, "
          f"bulk_ops={api_server.bulk_ops}, "
          f"bulk_binds={wstats.get('bulk_binds')}, "
          f"events_delivered={astats['events_emitted']}, "
          f"watchers={astats['watchers']}, "
          f"fanout_copies=0, mirror converged over "
          f"{len(server_pods)} pods)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
