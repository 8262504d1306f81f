"""Where one north-star solve spends its time on the card.

    python3 -m karpenter_provider_aws_tpu_torch.profile_solve [--solves N]

Solves ``workloads.config5_full_scale`` (50k pods x the real 759-type
catalog) with ``Solver(lattice)`` on ``cuda``: a few warm solves, then N
solves under ``torch.profiler``. Prints, per solve: wall time, the stage
times the solver records, the summed device time of every kernel the
profiler saw, the device's idle share of the wall time, and the kernels
that took the most device time. The last line is one JSON object with the
same numbers. Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solves", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import workloads
    from .solver import Solver

    if not torch.cuda.is_available():
        print("profile: needs a CUDA card", file=sys.stderr)
        return 1
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config5_full_scale()
    solver = Solver(lattice)
    for _ in range(3):
        solver.solve_relaxed(pods, pools, existing=existing)
    torch.cuda.synchronize()

    walls, stages = [], {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.solves):
            t = time.perf_counter()
            plan = solver.solve_relaxed(pods, pools, existing=existing)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            for k, v in plan.stage_ms.items():
                stages.setdefault(k, []).append(v)

    def dev_us(e) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    # kernel records only: an aten op's own row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3 / args.solves
    wall_ms = statistics.mean(walls)
    top = sorted(events, key=dev_us, reverse=True)[:12]
    result = {
        "card": _card(),
        "solves": args.solves,
        "wall_ms_mean": wall_ms,
        "wall_ms_p50": statistics.median(walls),
        "stage_ms_p50": {k: statistics.median(v) for k, v in stages.items()},
        "device_kernel_ms_per_solve": device_ms,
        "device_idle_share": (1.0 - device_ms / wall_ms) if wall_ms else None,
        "device_ops_per_solve": sum(e.count for e in events) / args.solves,
        "top_kernels": [{"name": e.key[:80], "calls_per_solve": e.count / args.solves,
                         "ms_per_solve": dev_us(e) / 1e3 / args.solves}
                        for e in top],
    }
    print(f"card: {result['card']}")
    print(f"wall p50 {result['wall_ms_p50']:.3f} ms; device kernels "
          f"{device_ms:.3f} ms per solve; idle share "
          f"{result['device_idle_share']:.3f}")
    for k in result["top_kernels"]:
        print(f"  {k['ms_per_solve']:9.3f} ms  {k['calls_per_solve']:7.1f} calls  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
