"""CI smoke for the introspection layer + metrics wire format, for this
package (the counterpart of the repository's ``tools/smoke_introspect.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_introspect [--device cuda]

What the ci.sh gate asserts here (docs/reference/introspection.md):

1. a real Operator comes up on ``--device`` and EVERY registered
   introspection provider reports a non-error stats dict through
   /debug/vars,
2. /debug/statusz renders (human surface) and /debug/vars parses (JSON
   surface) over live HTTP on the metrics server,
3. the live /metrics scrape passes the promtool-style lint
   (metrics.lint_exposition): HELP/TYPE pairing and ordering, label
   escaping, histogram bucket monotonicity and +Inf/_count agreement,
   exemplar comment lines staying scrape-safe.

Fast by design: the small-family lattice, one provisioning pass, one
sampler tick — a broken provider or a malformed series fails CI in
seconds instead of riding to the next soak. The device line and the
kernel-launch gate are ``tools/gate.py``'s.
"""

from __future__ import annotations

import json
import urllib.request

from . import gate


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from .. import introspect
    from ..apis import Pod
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..metrics import lint_exposition
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock

    clock = FakeClock()
    lattice = gate.small_lattice()
    op = Operator(options=Options(registration_delay=1.0), lattice=lattice,
                  cloud=FakeCloud(clock), clock=clock, device=device)
    # drive one real pass so counters move (a vacuously-empty smoke would
    # pass with every provider broken-but-zero)
    for i in range(8):
        op.cluster.add_pod(Pod(name=f"smoke-{i}",
                               requests={"cpu": "500m", "memory": "1Gi"}))
    op.settle(max_rounds=20)
    op.sampler.sample_once()

    failures = []
    server = start_server(op, 0)
    port = server.server_address[1]
    try:
        base = f"http://127.0.0.1:{port}"
        # 1. /debug/vars: parses, and every registered provider reports
        doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/vars?series=1", timeout=10).read())
        registered = set(introspect.registry().names())
        reported = set(doc.get("providers", {}))
        if registered - reported:
            failures.append(f"providers missing from /debug/vars: "
                            f"{sorted(registered - reported)}")
        for name, stats in doc.get("providers", {}).items():
            if not isinstance(stats, dict) or not stats:
                failures.append(f"provider {name}: empty stats")
            elif "error" in stats:
                failures.append(f"provider {name}: {stats['error']}")
        if not doc.get("series"):
            failures.append("/debug/vars?series=1 carries no ring series")
        # 2. /debug/statusz renders every provider section
        sz = urllib.request.urlopen(f"{base}/debug/statusz",
                                    timeout=10).read().decode()
        if not sz.startswith("karpenter-tpu statusz"):
            failures.append("statusz: unexpected header")
        for name in sorted(registered):
            if f"== {name} ==" not in sz:
                failures.append(f"statusz: provider {name} not rendered")
        # 3. the live scrape passes the wire-format lint
        scrape = urllib.request.urlopen(f"{base}/metrics",
                                        timeout=10).read().decode()
        problems = lint_exposition(scrape)
        failures.extend(f"metrics lint: {p}" for p in problems)
        for series in ("karpenter_pods_state", "karpenter_build_info",
                       "karpenter_slo_latency_budget_burn"):
            if series not in scrape:
                failures.append(f"metrics: {series} missing from scrape")
    finally:
        server.shutdown()
    n = len(introspect.registry().names())
    gate.report("introspect", device, op.solver.stats()["device"], failures)
    if failures:
        print("introspection smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"introspection smoke: OK ({n} providers, statusz+vars parse, "
          f"metrics lint clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
