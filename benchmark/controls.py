"""The control of the benchmark's comparison: it must come out not correct.

    python3 benchmark/controls.py --workload <cell> --seeds <n> [<n> ...] [--seconds 5]

Runs the cell as ``run.py`` does, with a short window at the cell's own
size, and then checks, in the program's place, the plain reference packing
to each node's raw capacity: the allocatable after kube-reserved, system
and eviction overhead, a guarantee the configuration states, left out.
``raw_capacity`` puts it there by standing in for the one bridge that
hands the program's answers to the check (``drivers/port.py``), so the
drivers and the harness know nothing of it. For each seed it prints the
numbers compared and whether the check held, then one JSON line with every
reading. The benchmark's own runs never run it. Needs the cell's CUDA
cards, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def raw_capacity():
    """While open, every plan and verdict that the check reads is the
    reference FFD's on the same plain problem, packed to raw capacity."""
    from benchmark.drivers import port
    from benchmark.reference import ffd

    def plan(_plan, cat, problem):
        return ffd.pack(cat, problem, alloc=cat.capacity)

    def verdict(_probe, removed_price, cat, problem):
        raw = plan(None, cat, problem)
        lone = raw["new_nodes"][0] if len(raw["new_nodes"]) == 1 else None
        return {"feasible": not raw["unschedulable"], "n_new": len(raw["new_nodes"]),
                "new_cost": raw["new_node_cost"],
                "new_cap_type": lone["capacity_type"] if lone else None,
                "flex": len(lone["feasible_types"]) if lone else 0,
                "removed_price": removed_price}
    saved = port.plain_plan, port.plain_verdict
    port.plain_plan, port.plain_verdict = plan, verdict
    try:
        yield
    finally:
        port.plain_plan, port.plain_verdict = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of one cell's comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("the control runs the cell on a CUDA card", file=sys.stderr)
        return 2
    readings = {}
    for seed in args.seeds:
        with raw_capacity():
            out = harness.run(args.workload, seed, args.seconds, False,
                              time.perf_counter(), device="cuda", root=ROOT)
        readings[seed] = {k: c["value"] for k, c in out["compared"].items()}
        print(f"control seed {seed}: correct={out['correct']} {readings[seed]}", flush=True)
    print(json.dumps({"workload": args.workload, "control": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
