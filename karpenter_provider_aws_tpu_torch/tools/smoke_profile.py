"""CI smoke for the continuous-profiling layer (docs/reference/profiling.md),
for this package (the counterpart of the repository's
``tools/smoke_profile.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_profile [--device cuda]

What the ci.sh gate asserts here:

1. an operator boots WITH profiling on (sampling profiler running,
   contention accounting live; its Solver on ``--device``) and a real
   provisioning pass is driven,
2. over live HTTP, /debug/pprof/profile serves NON-EMPTY folded stacks
   (and the Chrome form parses), /debug/pprof/contention reports the
   instrumented hot locks with non-zero acquisitions,
   /debug/pprof/device parses, and /debug/pprof/captures parses,
3. the live /metrics scrape — now carrying the
   karpenter_lock_wait_seconds histogram family — still lints clean
   (metrics.lint_exposition), and honors Accept-Encoding: gzip,
4. the profiler's self-measured overhead stays under the 5% bound.

Fast by design: small-family lattice, one pass, ~a second of 100 Hz
sampling. The wait for the sampler reads the wall clock through
``utils/clock.WALL``, as the clock-discipline lint asks.
"""

from __future__ import annotations

import gzip
import json
import urllib.request

from . import gate

EXPECT_LOCKS = ("cluster_state", "solver_solve", "writer", "batcher_bucket")


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from .. import introspect
    from ..apis import Pod
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..metrics import lint_exposition
    from ..operator import Operator, Options
    from ..utils.clock import WALL, FakeClock

    clock = FakeClock()
    lattice = gate.small_lattice()
    op = Operator(options=Options(registration_delay=1.0), lattice=lattice,
                  cloud=FakeCloud(clock), clock=clock, device=device)
    prof = introspect.enable_profiling(hz=100)
    for i in range(8):
        op.cluster.add_pod(Pod(name=f"smoke-{i}",
                               requests={"cpu": "500m", "memory": "1Gi"}))
    op.settle(max_rounds=20)
    # let the daemon sampler watch the (now idle-ish) process briefly so
    # the folded store is non-vacuous even on a fast machine
    deadline = WALL.monotonic() + 5.0
    while prof.samples < 20 and WALL.monotonic() < deadline:
        WALL.sleep(0.05)

    failures = []
    server = start_server(op, 0)
    port = server.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        # 1. non-empty folded stacks over live HTTP
        folded = urllib.request.urlopen(
            f"{base}/debug/pprof/profile", timeout=10).read().decode()
        stacks = [ln for ln in folded.splitlines()
                  if ln and not ln.startswith("#")]
        if not stacks:
            failures.append("/debug/pprof/profile: empty folded stacks")
        chrome = json.loads(urllib.request.urlopen(
            f"{base}/debug/pprof/profile?format=chrome", timeout=10).read())
        if not chrome.get("traceEvents"):
            failures.append("profile chrome export: no traceEvents")
        # 2. contention counters present for the instrumented hot locks
        cont = json.loads(urllib.request.urlopen(
            f"{base}/debug/pprof/contention", timeout=10).read())
        locks = cont.get("locks", {})
        for name in EXPECT_LOCKS:
            if name not in locks:
                failures.append(f"contention: lock {name!r} not reported")
            elif not locks[name].get("acquisitions"):
                failures.append(f"contention: lock {name!r} has zero "
                                "acquisitions after a real pass")
        for path in ("/debug/pprof/device", "/debug/pprof/captures"):
            try:
                json.loads(urllib.request.urlopen(
                    f"{base}{path}", timeout=10).read())
            except Exception as e:
                failures.append(f"{path}: {type(e).__name__}: {e}")
        # 3. the scrape (with karpenter_lock_wait_seconds) lints clean,
        #    plain AND gzipped
        scrape = urllib.request.urlopen(f"{base}/metrics",
                                        timeout=10).read().decode()
        if "karpenter_lock_wait_seconds" not in scrape:
            failures.append("metrics: karpenter_lock_wait_seconds missing")
        failures.extend(f"metrics lint: {p}"
                        for p in lint_exposition(scrape))
        req = urllib.request.Request(
            f"{base}/metrics", headers={"Accept-Encoding": "gzip"})
        resp = urllib.request.urlopen(req, timeout=10)
        if resp.headers.get("Content-Encoding") != "gzip":
            failures.append("/metrics ignored Accept-Encoding: gzip")
        else:
            # the scrape may drift between reads (counters move), so
            # don't byte-compare — the decompressed body must itself be
            # a lint-clean exposition (catches corrupt/truncated gzip)
            gz_scrape = gzip.decompress(resp.read()).decode()
            failures.extend(f"gzipped metrics lint: {p}"
                            for p in lint_exposition(gz_scrape))
        req = urllib.request.Request(
            f"{base}/debug/vars?series=1",
            headers={"Accept-Encoding": "gzip"})
        resp = urllib.request.urlopen(req, timeout=10)
        if resp.headers.get("Content-Encoding") != "gzip":
            failures.append("/debug/vars?series=1 ignored "
                            "Accept-Encoding: gzip")
        else:
            json.loads(gzip.decompress(resp.read()))
        # 4. self-measured overhead under the documented bound
        pstats = prof.stats()
        if pstats["overhead_pct"] >= 5.0:
            failures.append(
                f"profiler overhead {pstats['overhead_pct']:.2f}% >= 5%")
    finally:
        server.shutdown()
        prof.stop()
        introspect.set_profiler(None)
    gate.report("profile", device, op.solver.stats()["device"], failures)
    if failures:
        print("profiling smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"profiling smoke: OK ({prof.samples} samples, "
          f"{len(stacks)} folded stacks, "
          f"{len(locks)} locks accounted, "
          f"overhead {prof.stats()['overhead_pct']:.2f}%, "
          f"gzip + lint clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
