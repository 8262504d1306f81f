"""Explain-capture overhead bench, for this package.

The counterpart of the repository's ``tools/bench_explain.py``: the SAME
operator churn loop runs twice, once with the provisioner's incremental
builder capturing constraint-elimination ledgers (``explain=True``, the
production default) and once with capture off, and the bench records the
end-to-end per-pass p50 delta. The bar is the reference's: < 1 % e2e p50
regression from explain capture. The Operator's Solver runs on
``--device`` (default ``cuda``).

    python -m karpenter_provider_aws_tpu_torch.tools.bench_explain \\
        [--pods 4000] [--passes 30] [--device cuda] \\
        [--out EXPLAIN_gpu_r01_overhead.json]

Both runs share one process; the measured window starts after a warmup
pass, and the capture-ON run goes FIRST so any residual warm-up cost
lands on the explain side (the overhead reads as an upper bound).
"""

from __future__ import annotations

import argparse
import json

from .churn import operator_churn, p50_p90_ms

DEFAULT_OUT = "EXPLAIN_gpu_r01_overhead.json"


def run_loop(explain: bool, n_pods: int, n_passes: int, device=None) -> dict:
    from ..solver.incremental import IncrementalProblemBuilder

    def setup(op):
        op.provisioner.inc_builder = IncrementalProblemBuilder(explain=explain)

    op, times = operator_churn(n_pods, n_passes, device, setup=setup)
    stats = op.provisioner.explain.stats()
    return {
        "explain": explain,
        "passes": n_passes,
        **p50_p90_ms(times),
        "ring_passes": stats.get("passes", 0),
        "incremental_builds": op.provisioner.inc_builder.incremental_builds,
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
        "bench": "explain_capture_overhead",
        "pods": args.pods,
        "device": args.device,
        "capture_on": on, "capture_off": off,
        "e2e_p50_delta_pct": round(delta_pct, 3),
        "bound_pct": 1.0,
        "within_bound": delta_pct < 1.0,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"explain overhead: on={on['e2e_p50_ms']}ms "
          f"off={off['e2e_p50_ms']}ms delta={delta_pct:+.2f}% "
          f"(bound <1%) -> {args.out}")
    return 0 if doc["within_bound"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
