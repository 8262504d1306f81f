"""Run one cell of the port's benchmark and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Needs as many CUDA cards as the cell asks
for, and exits non-zero with no result without them. The last line on
standard output is the result's JSON object; the numbers compared with the
plain reference, each beside its limit, are the last lines on standard
error. A run that cannot read one of the cell's end-to-end metrics exits
non-zero with no result. See README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    cell = next((c for c in bench["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      T_START, device="cuda", bench=bench, root=ROOT)
    missing = [m["name"] for m in harness.metrics_of(bench, args.workload, "end_to_end")
               if m["name"] not in out["metrics"]]
    if not args.trace and missing:
        print(f"end-to-end metrics with nothing to read: {missing}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
