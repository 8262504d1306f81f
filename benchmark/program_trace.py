"""The program's own spans and counters over one cell's window, and its
ranges on the device trace.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> --seconds <s> \\
        --tracing <0|1> [--device cuda|cpu]

Runs the cell as ``run.py --trace 0`` does (``harness.run``: set-up, the
window, the check), with three additions:

- ``--tracing 1`` turns the program's tracing on (``trace.enable()``) at
  the end of set-up, and the tally's difference over the window
  (``trace.totals()`` before and after) gives the span and counter
  readings per step (``READERS``, by the cell's kind of traffic).
  ``--tracing 0`` leaves it off, so a pair of runs gives the cost of
  tracing on the cell's end-to-end metric;
- the finalization kernel's calls over the window
  (``ops.offering_argmin.CALLS``), priced by ``kernels/argmin.py
  nbytes``, give its bytes per step (``argmin_bytes_per_step``);
- on the card, after the window and before the program's state is
  released, the traffic's ``trace_steps`` more steps run under the
  harness's profiler (``harness._profiled``), where every span of the
  program is a range; ``reduce_ranges`` tallies those ranges (count, the
  device time and the kernel launches inside them) and names each idle gap
  of the device by the innermost range open at its middle, the harness's
  or the program's. The finalization's bytes noted by the harness's
  wrapper (``noting_bytes``) stand beside its priced calls there.

The last line on standard output is one JSON object: the cell's metrics,
``correct``, the readings and the traced steps' breakdown. Nothing here
changes what ``run.py`` measures.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _span(diff: Dict, name: str, key: str = "seconds") -> Optional[float]:
    row = diff["spans"].get(name)
    return row[key] if row else None


def _per(x: Optional[float], n: int, scale: float) -> Optional[float]:
    return scale * x / n if x is not None and n else None


def _scan_useful(diff: Dict, steps: int) -> Optional[float]:
    c = diff["counters"]
    return 100.0 * c["scan.groups"] / c["scan.steps"] if c.get("scan.steps") else None


def _step_issue(diff: Dict, steps: int) -> Optional[float]:
    row = diff["spans"].get("pack.step")
    return 1e6 * row["seconds"] / row["count"] if row and row["count"] else None


def _exact_build(diff: Dict, steps: int) -> Optional[float]:
    row = diff["spans"].get("problem.build")
    under = row["under"].get("solver.solve_relaxed") if row else None
    n = diff["spans"].get("solver.solve_relaxed", {}).get("count", 0)
    return _per(under, n, 1e3)


# by the traffic's kind (``drivers/<kind>.py``), the readings of the
# program's tally over a window of ``steps`` steps
READERS: Dict[str, Dict[str, Callable[[Dict, int], Optional[float]]]] = {
    "waves": {
        "scan_step_issue_us.wave": _step_issue,
        "scan_useful_pct.wave": _scan_useful,
        "fetch_wait_ms.wave": lambda d, n: _per(_span(d, "fetch.wait"), n, 1e3),
        "decode_prep_ms.wave": lambda d, n: _per(_span(d, "decode.prep"), n, 1e3),
        "solve_self_ms.wave":
            lambda d, n: _per(_span(d, "solver.solve", "self_seconds"), n, 1e3),
    },
    "consolidate": {
        "engine_build_ms.consolidate":
            lambda d, n: _per(_span(d, "engine.whatif_build"), n, 1e3),
        "probe_stage_ms.consolidate": lambda d, n: _per(_span(d, "probe.stage"), n, 1e3),
        "probe_wait_ms.consolidate": lambda d, n: _per(_span(d, "probe.wait"), n, 1e3),
        "exact_build_ms.consolidate": _exact_build,
    },
}


def diff_totals(before: Dict, after: Dict) -> Dict:
    """What the program's tally gained between two ``trace.totals()``."""
    spans = {}
    for name, row in after["spans"].items():
        old = before["spans"].get(name)
        if old is None:
            spans[name] = row
        elif row["count"] != old["count"]:
            spans[name] = {
                "count": row["count"] - old["count"],
                "seconds": row["seconds"] - old["seconds"],
                "self_seconds": row["self_seconds"] - old["self_seconds"],
                "under": {p: s - old["under"].get(p, 0.0) for p, s in row["under"].items()}}
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    return {"spans": spans, "counters": counters}


def reduce_ranges(events: List[Dict], t0_us: float, t1_us: float, prefix: str) -> Dict:
    """Of a Chrome trace of ``torch.profiler``, inside ``[t0_us, t1_us]``:
    per name of the program's ranges (``user_annotation`` without the
    harness's ``prefix``) the count, the device seconds of the operations
    launched while one of that name was open (by correlation) and the
    kernel launch calls made meanwhile; and the device's idle gaps, each
    named by the innermost range open at its middle (the harness's names
    without their prefix), largest first.

    One sorted sweep over the ranges' ends, the launches and the gaps'
    middles: ranges open and close in time order, and each launch or gap
    reads the ranges open at its instant."""
    from benchmark.harness import _DEVICE_CATS, _LAUNCHES
    ranges, dev, launch_at = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            dev.append((ts, ts + dur, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                launch_at[corr] = (ts, name in _LAUNCHES)
        elif cat == "user_annotation":
            ranges.append((ts, ts + dur, name))
    dev = [(max(s, t0_us), min(e, t1_us), c) for s, e, c in dev if e > t0_us and s < t1_us]
    by_corr: Dict[object, float] = {}
    for s, e, c in dev:
        by_corr[c] = by_corr.get(c, 0.0) + (e - s) / 1e6
    # (time, order, kind, payload): at one instant a range opens before
    # what reads it and closes after
    points = []
    for i, (s, e, name) in enumerate(ranges):
        points.append((s, 0, "open", i))
        points.append((e, 2, "close", i))
    for corr, (ts, is_launch) in launch_at.items():
        if t0_us <= ts <= t1_us:
            points.append((ts, 1, "launch", (by_corr.get(corr, 0.0), is_launch)))
    end = t0_us
    for s, e, _ in sorted(dev) + [(t1_us, t1_us, None)]:
        if s > end:
            points.append(((s + end) / 2, 1, "gap", (s - end) / 1e6))
        end = max(end, e)
    points.sort(key=lambda p: (p[0], p[1]))
    tally: Dict[str, Dict] = {}
    idle: Dict[str, float] = {}
    open_: Dict[int, tuple] = {}
    for _, _, kind, x in points:
        if kind == "open":
            open_[x] = ranges[x]
        elif kind == "close":
            open_.pop(x, None)
        elif kind == "launch":
            for name in {r[2] for r in open_.values() if not r[2].startswith(prefix)}:
                row = tally.setdefault(name, {"count": 0, "device_s": 0.0, "launches": 0})
                row["device_s"] += x[0]
                row["launches"] += x[1]
        else:
            inner = min(open_.values(), key=lambda r: r[1] - r[0], default=None)
            label = inner[2][len(prefix):] if inner and inner[2].startswith(prefix) \
                else inner[2] if inner else "between steps"
            idle[label] = idle.get(label, 0.0) + x
    for s, e, name in ranges:
        if not name.startswith(prefix) and s >= t0_us and e <= t1_us:
            tally.setdefault(name, {"count": 0, "device_s": 0.0, "launches": 0})["count"] += 1
    return {"ranges": tally,
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])}


def priced_calls(before: Dict, after: Dict, nbytes: Callable) -> int:
    """The bytes of the finalization calls made between two snapshots of
    ``offering_argmin.CALLS``, each call priced by ``nbytes`` on meta
    tensors of its shape."""
    import torch
    meta = dict(device="meta")
    return sum((n - before.get((B, T, ZC), 0))
               * nbytes(torch.empty((B, T), **meta), torch.empty((B, ZC), **meta),
                        torch.empty((T, ZC), **meta))
               for (B, T, ZC), n in after.items())


def _profiled_steps(drv, state: Dict, n: int, kernels: Dict) -> Dict:
    """``n`` steps under the harness's profiler (``harness._profiled``):
    its summary, with the program's ranges of the same trace
    (``reduce_ranges``) and the finalization's priced calls."""
    from benchmark import harness
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin
    reduce, got = harness.reduce_trace, {}

    def both(events, t0_us, t1_us, match):
        got.update(reduce_ranges(events, t0_us, t1_us, harness.SPAN_PREFIX))
        return reduce(events, t0_us, t1_us, match)

    def steps():
        for i in range(n):
            drv.step(state, (1 << 30) + i)
    calls = dict(offering_argmin.CALLS)
    harness.reduce_trace = both
    try:
        summary = harness._profiled(steps, state["env"]["spans"], kernels)
    finally:
        harness.reduce_trace = reduce
    got.update(busy_s=summary["busy_s"], window_s=summary["window_s"],
               launches=summary["launches"], steps=n)
    if "argmin" in kernels:
        got["argmin_bytes"] = {
            "noted": summary["kernel_bytes"]["argmin"],
            "priced_calls": priced_calls(calls, offering_argmin.CALLS,
                                         kernels["argmin"].nbytes)}
    return got


def run(cell: str, seed: int, seconds: float, tracing: bool, device: str = "cuda",
        root: pathlib.Path = ROOT, log=sys.stderr) -> Dict:
    """One run of ``cell`` through ``harness.run`` (``--trace 0``), with the
    program's tracing on over the window when ``tracing``, and on the card
    the traffic's ``trace_steps`` profiled steps before the state is
    released."""
    from benchmark import harness
    from karpenter_provider_aws_tpu_torch import trace
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin
    bench = harness.load_benchmark(root)
    base = root / harness.HERE.name
    traffic = json.loads((base / "traffic"
                          / f"{harness._cell(bench, cell)['traffic']}.json").read_text())
    kernels = {k: harness.load_module(base / "kernels" / f"{k}.py")
               for k in traffic.get("kernels", [])}
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    got: Dict = {}
    setup, release = drv.setup, drv.release

    def traced_setup(env):
        state = setup(env)
        if tracing:
            trace.enable()
        got["before"] = trace.totals()
        got["calls"] = dict(offering_argmin.CALLS)
        return state

    def traced_release(state):
        got["after"] = trace.totals()
        got["calls_after"] = dict(offering_argmin.CALLS)
        trace.disable()
        if device == "cuda":
            got["profiled"] = _profiled_steps(drv, state, int(traffic.get("trace_steps", 3)),
                                              kernels)
        release(state)
    drv.setup, drv.release = traced_setup, traced_release
    try:
        out = harness.run(cell, seed, seconds, False, T_START, device=device, bench=bench,
                          root=root, log=log)
    finally:
        drv.setup, drv.release = setup, release
    steps = out["attempted"]
    diff = diff_totals(got["before"], got["after"])
    readings = ({name: fn(diff, steps) for name, fn in READERS[traffic["driver"]].items()}
                if tracing else {})
    if "argmin" in kernels and steps:
        readings["argmin_bytes_per_step"] = priced_calls(
            got["calls"], got["calls_after"], kernels["argmin"].nbytes) / steps
    prof = got.get("profiled")
    if prof and traffic["driver"] == "waves":
        step = prof["ranges"].get("pack.step")
        readings["scan_step_device_us.wave"] = (1e6 * step["device_s"] / step["count"]
                                                if step and step["device_s"] else None)
    return {"cell": cell, "seed": seed, "tracing": int(tracing), "correct": out["correct"],
            "steps": steps, "failed": out["failed"], "metrics": out["metrics"],
            "device": out["device"],
            "readings": {k: v for k, v in readings.items() if v is not None},
            "tally": diff if tracing else None, "profiled": prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the program's spans over one cell's window")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracing", type=int, choices=(0, 1), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args.workload, args.seed, args.seconds, bool(args.tracing),
                  device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
