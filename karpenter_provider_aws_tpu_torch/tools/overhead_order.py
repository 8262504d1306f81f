"""The order of the three overhead gates' passes, measured.

``bench_explain``, ``bench_headroom`` and ``profile_run`` each run their
ON pass first and their OFF pass second in one process, as the
repository's tools do, so whatever the first pass pays once (the first
use of a bin bucket's kernels, the allocator's first pools) lands on the
ON side. This script runs each tool's pair twice in one process, in the
order ON, OFF, OFF, ON, and reports three deltas per tool:

- ``on_first_delta_pct``: run 1 (ON) against run 2 (OFF), the tools' order;
- ``off_first_delta_pct``: run 4 (ON) against run 3 (OFF);
- ``off_off_delta_pct``: run 2 against run 3, the same pass twice, the
  spread of a pair.

If the first is well above the other two and the second is within the
spread, the tool's gap is the order's residue and not the ON pass's work.

    python -m karpenter_provider_aws_tpu_torch.tools.overhead_order \\
        [--pods 4000] [--passes 30] [--prof-pods 15000] \\
        [--device cuda] [--out OVERHEAD_ORDER_gpu_r01.json]
"""

from __future__ import annotations

import argparse
import json

from . import bench_explain, bench_headroom, profile_run

DEFAULT_OUT = "OVERHEAD_ORDER_gpu_r01.json"
ORDER = (True, False, False, True)
HZ = 50.0   # profile_run's default sampling rate


def _pct(a: float, b: float) -> float:
    return round(100.0 * (a - b) / max(b, 1e-9), 3)


def _deltas(values) -> dict:
    on1, off2, off3, on4 = values
    return {"on_first_delta_pct": _pct(on1, off2),
            "off_first_delta_pct": _pct(on4, off3),
            "off_off_delta_pct": _pct(off2, off3)}


def churn_order(tool, pods: int, passes: int, device) -> dict:
    """``tool.run_loop`` (explain or headroom) four times, in ``ORDER``."""
    runs = [tool.run_loop(on, pods, passes, device=device) for on in ORDER]
    return {"pods": pods, "passes": passes, "order": list(ORDER),
            "e2e_p50_ms": [r["e2e_p50_ms"] for r in runs],
            **_deltas([r["e2e_p50_ms"] for r in runs])}


def profile_order(pods: int, device) -> dict:
    """``profile_run``'s deterministic pump four times, in ``ORDER``,
    after the tool's own shared warmup. The gate reads the wall time."""
    from .. import introspect
    lattice = profile_run.real_lattice()
    profile_run.shared_warmup(lattice, device)
    walls, pass_p50, nodes, pending = [], [], [], []
    for i, on in enumerate(ORDER):
        wall, op, _ = profile_run.run_deterministic(
            lattice, pods, profile=on, hz=HZ, label=f"o{i}", device=device)
        walls.append(round(wall, 4))
        pass_p50.append(round(op.slo.latency_percentiles()[0] * 1e3, 3))
        nodes.append(len(op.cluster.nodes))
        pending.append(op.final_pending)
        del op
    introspect.set_profiler(None)
    return {"pods": pods, "hz": HZ, "order": list(ORDER),
            "wall_seconds": walls, "pass_p50_ms": pass_p50, "nodes": nodes,
            "pending_at_end": pending,
            **_deltas(walls),
            "pass_p50": _deltas(pass_p50)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=4000)
    ap.add_argument("--passes", type=int, default=30)
    ap.add_argument("--prof-pods", type=int, default=15000)
    ap.add_argument("--device", default="cuda",
                    help="the Operator's Solver device (default cuda; "
                         "raises without a card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from ..bench import device_detail
    from ..device import resolve_device
    device = resolve_device(args.device)
    doc = {"device": device_detail(device),
           "explain": churn_order(bench_explain, args.pods, args.passes,
                                  device),
           "headroom": churn_order(bench_headroom, args.pods, args.passes,
                                   device),
           "profile_run": profile_order(args.prof_pods, device)}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    for name in ("explain", "headroom", "profile_run"):
        d = doc[name]
        print(f"{name}: ON first {d['on_first_delta_pct']:+.2f}%, OFF first "
              f"{d['off_first_delta_pct']:+.2f}%, OFF against OFF "
              f"{d['off_off_delta_pct']:+.2f}%")
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
