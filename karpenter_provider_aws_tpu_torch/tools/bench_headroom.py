"""Headroom-registry overhead bench, for this package.

The counterpart of the repository's ``tools/bench_headroom.py``: the SAME
operator churn loop runs twice, once with the saturation observatory's
full probe set wired (the production default: every bounded queue and
ring registered, observed and rendered into the ``karpenter_headroom_*``
families on each gauge pass) and once with every probe unregistered, and
the bench records the end-to-end per-pass p50 delta. The timed window is
``provision_once`` + ``emit_gauges``, where the registry runs. The bar is
the reference's: < 1 % e2e p50 regression. The Operator's Solver runs on
``--device`` (default ``cuda``).

    python -m karpenter_provider_aws_tpu_torch.tools.bench_headroom \\
        [--pods 4000] [--passes 30] [--device cuda] \\
        [--out HEADROOM_gpu_r01_overhead.json]

Both runs share one process; the measured window starts after a warmup
pass, and the probes-ON run goes FIRST so any residual warm-up cost lands
on the observatory's side (the overhead reads as an upper bound).
"""

from __future__ import annotations

import argparse
import json

from .churn import operator_churn, p50_p90_ms

DEFAULT_OUT = "HEADROOM_gpu_r01_overhead.json"


def run_loop(probes: bool, n_pods: int, n_passes: int, device=None) -> dict:
    n_probes = 0

    def setup(op):
        nonlocal n_probes
        n_probes = len(op.headroom.names())
        if not probes:
            # the OFF side: an empty registry; observe()/table() sweep
            # nothing, the gauge families render zero rows
            for name in list(op.headroom.names()):
                op.headroom.unregister_probe(name)

    op, times = operator_churn(n_pods, n_passes, device, setup=setup,
                               gauges=True)
    return {
        "probes": n_probes if probes else 0,
        "passes": n_passes,
        **p50_p90_ms(times),
        "resources": len(op.headroom.table()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=4000)
    ap.add_argument("--passes", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="the Operator's Solver device (default cuda; "
                         "raises without a card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    on = run_loop(True, args.pods, args.passes, device=args.device)
    off = run_loop(False, args.pods, args.passes, device=args.device)
    delta_pct = (100.0 * (on["e2e_p50_ms"] - off["e2e_p50_ms"])
                 / max(off["e2e_p50_ms"], 1e-9))
    doc = {
        "bench": "headroom_registry_overhead",
        "pods": args.pods,
        "device": args.device,
        "probes_on": on, "probes_off": off,
        "e2e_p50_delta_pct": round(delta_pct, 3),
        "bound_pct": 1.0,
        "within_bound": delta_pct < 1.0,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"headroom overhead: on={on['e2e_p50_ms']}ms "
          f"({on['probes']} probes) off={off['e2e_p50_ms']}ms "
          f"delta={delta_pct:+.2f}% (bound <1%) -> {args.out}")
    return 0 if doc["within_bound"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
