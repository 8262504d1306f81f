"""The benchmark's general machinery: cells by name, the window, the trace, the result.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names its parts, and
each part is found by name as files of its own:

- ``configs/<config>.json``, the deployment's sizes, source and
  guarantees, and ``configs/<config>.py``, which draws its inputs from a
  seed as plain data;
- ``traffic/<traffic>.json``, the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``, the general driver of that kind of window;
- ``kernels/<kernel>.py`` for each hand-written kernel the traffic's
  ``kernels`` lists: its name in the trace and the bytes a call must move;
- ``metrics/<metric>.py`` for each metric, a reader with ``read(ctx)``
  that returns the metric's value, or None where the run has nothing to
  read (the metric is then left out of the result).

A driver has ``setup(env)``, ``step(state, i)`` (one unit of work: it
returns a record), ``release(state)`` (drops the program's state, so the
reference runs after the device memory is freed) and ``check(state,
records)`` (the comparison with the plain reference, after the window).

A run: set-up with its warm-up, then ``--seconds`` of back-to-back steps
(the window), then, with ``--trace 1``, a few more steps under
``torch.profiler`` (the traced window), then the check. The last line on
standard output is the result's JSON; the numbers compared, each beside
its limit, are the last lines on standard error.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_provider_aws_tpu")
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
SPAN_PREFIX = "bench::"


def load_module(path: pathlib.Path):
    name = "bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: pathlib.Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


MIN_TAIL = 10                     # values a percentile wants beyond it


def quantile(values: List[float], q: int, log=None) -> Optional[float]:
    """The q-th percentile of all ``values``; None for fewer than
    ``MIN_TAIL`` values. Where fewer than ``MIN_TAIL`` lie beyond it, it
    is still the percentile of them all, and ``log`` is told so."""
    if len(values) < MIN_TAIL:
        return None
    beyond = len(values) * (100 - q) / 100
    if beyond < MIN_TAIL and log is not None:
        print(f"the {q}th percentile of {len(values)} values has {beyond:g} beyond it, "
              f"under {MIN_TAIL}", file=log)
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Spans:
    """Host-clock spans from the benchmark's own files, around calls into
    the program's layers. While the profiler runs, each is also a
    ``record_function`` range, so the trace can say what the host was
    doing while the device sat idle."""

    def __init__(self):
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str, into: Optional[Dict] = None):
        rf = None
        if self.tracing:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t) * 1e3
            if into is not None:
                into[name] = into.get(name, 0.0) + ms
            if rf is not None:
                rf.__exit__(None, None, None)


@dataclass
class Context:
    """What a metric reader reads."""

    cell: Dict
    log: object
    setup_s: float
    window_s: float
    records: List[Dict]                   # the window's steps
    traced: List[Dict] = field(default_factory=list)
    trace: Optional[Dict] = None          # reduce_trace's summary of the traced steps
    check: Dict = field(default_factory=dict)

    def mean(self, key: str) -> Optional[float]:
        """Mean of ``key`` over the window's steps that have it."""
        vals = [r[key] for r in self.records if r.get(key) is not None]
        return statistics.fmean(vals) if vals else None

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """Share of the HBM bound in the named kernel's device time over
        the traced window: the bytes its calls must move
        (``kernels/<kernel>.py``) at 3.35 TB/s."""
        if not self.trace:
            return None
        dev_s = self.trace["kernel_s"].get(kernel, 0.0)
        nbytes = self.trace["kernel_bytes"].get(kernel, 0)
        if dev_s <= 0 or nbytes <= 0:
            return None
        return 100.0 * nbytes / H100_BYTES_PER_S / dev_s

    def idle_pct(self) -> Optional[float]:
        if not self.trace or self.trace["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])


def _union_s(intervals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def reduce_trace(events: List[Dict], t0_us: float, t1_us: float,
                 match: Dict[str, str]) -> Dict:
    """The traced window's device busy time, kernel time by name, launch
    count, device time by the harness span its launch came from, the
    device operations that took most time and the idle time by what the
    host was doing: each idle gap is named by the innermost harness span
    open on the host at its middle. ``match`` maps a kernel's short name to
    a part of its name in the trace."""
    dev, spans, launches, launched_at = [], [], 0, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            dev.append((ts, ts + dur, name, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches += name in _LAUNCHES
            if corr is not None:
                launched_at[corr] = ts
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ts, ts + dur, name[len(SPAN_PREFIX):]))
    dev = [(max(s, t0_us), min(e, t1_us), n, c) for s, e, n, c in dev
           if e > t0_us and s < t1_us]
    by_name: Dict[str, float] = {}
    for s, e, n, _ in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    busy_s = _union_s((s, e) for s, e, _, _ in dev) / 1e6

    def inside(name: str, ts: float) -> bool:
        return any(a <= ts <= b for a, b, n in spans if n == name)

    span_dev: Dict[str, float] = {}
    for name in {n for _, _, n in spans}:
        span_dev[name] = sum((e - s) / 1e6 for s, e, _, c in dev
                             if c in launched_at and inside(name, launched_at[c]))
    gaps, end = [], t0_us
    for s, e, _, _ in sorted(dev) + [(t1_us, t1_us, "", None)]:
        if s > end:
            mid = (s + end) / 2
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            label = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "between steps"
            gaps.append((label, (s - end) / 1e6))
        end = max(end, e)
    by_label: Dict[str, float] = {}
    for label, sec in gaps:
        by_label[label] = by_label.get(label, 0.0) + sec
    return {
        "window_s": (t1_us - t0_us) / 1e6,
        "busy_s": busy_s,
        "launches": launches,
        "kernel_s": {k: sum(v for n, v in by_name.items() if sub in n)
                     for k, sub in match.items()},
        "span_device_s": span_dev,
        "device_ops": sorted(([n[:160], v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in by_label.items()),
                            key=lambda x: -x[1])[:10],
    }


@contextlib.contextmanager
def noting_bytes(kernels: Dict):
    """Wrap each kernel's ``PATCH`` attribute so that every call adds its
    ``nbytes`` to the returned tally; restored on exit."""
    tally = dict.fromkeys(kernels, 0)
    saved = []
    for name, mod in kernels.items():
        owner = importlib.import_module(mod.PATCH[0])
        fn = getattr(owner, mod.PATCH[1])

        def noted(*args, _fn=fn, _mod=mod, _name=name, **kw):
            tally[_name] += _mod.nbytes(*args, **kw)
            return _fn(*args, **kw)
        saved.append((owner, mod.PATCH[1], fn))
        setattr(owner, mod.PATCH[1], noted)
    try:
        yield tally
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def unmatched_kernels(summary: Dict) -> List[str]:
    """Kernels whose calls the traced window saw on one side only: device
    time in the trace but no bytes noted, or bytes noted but no device
    time. A roofline read from them would be wrong or silent while the
    kernel runs."""
    return sorted(k for k, b in summary["kernel_bytes"].items()
                  if (summary["kernel_s"].get(k, 0.0) > 0) != (b > 0))


def _profiled(steps: Callable[[], None], spans: Spans, kernels: Dict) -> Dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    spans.tracing = True
    with noting_bytes(kernels) as tally, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "between steps"):
            steps()
            torch.cuda.synchronize()
    spans.tracing = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
    finally:
        os.unlink(path)
    win = [e for e in events if e.get("name") == SPAN_PREFIX + "between steps"
           and e.get("ph") == "X"]
    t0 = float(win[0]["ts"])
    out = reduce_trace(events, t0, t0 + float(win[0]["dur"]),
                       {k: m.MATCH for k, m in kernels.items()})
    out["kernel_bytes"] = tally
    return out


def _cell(bench: Dict, name: str) -> Dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: Dict, cell: str, kind: str) -> List[Dict]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def enable_caches(root: pathlib.Path = ROOT) -> None:
    """The program's kernel and library builds (``nvcc``, ``g++``) in a
    fixed directory of the checkout, so only a checkout's first run builds."""
    cache = root / HERE.name / ".cache" / "compile"
    from karpenter_provider_aws_tpu_torch.solver.solve import enable_persistent_compile_cache
    if not enable_persistent_compile_cache(str(cache)):
        raise SystemExit(f"cannot write the compile cache {cache}")


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", bench: Optional[Dict] = None,
        root: pathlib.Path = ROOT, log=sys.stderr) -> Dict:
    """One run of one cell; returns the result's JSON object (with the
    compared numbers under ``compared``, last). A traced run that saw a
    listed kernel's calls on one side only (``unmatched_kernels``) stops
    with no result."""
    bench = bench or load_benchmark(root)
    cell = _cell(bench, cell_name)
    base = root / HERE.name
    cfg = json.loads((base / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    env = {"cfg": cfg, "gen": load_module(base / "configs" / f"{cell['config']}.py"),
           "traffic": traffic, "seed": int(seed), "device": device, "spans": Spans(),
           "root": root, "base": base, "log": log}
    driver = importlib.import_module(f"{HERE.name}.drivers.{traffic['driver']}")
    import torch
    enable_caches(root)
    state = driver.setup(env)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    records: List[Dict] = []
    t0 = time.perf_counter()
    while True:
        records.append(driver.step(state, len(records)))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0

    traced: List[Dict] = []
    summary = None
    if trace:
        n = int(traffic.get("trace_steps", 3))

        def steps():
            for _ in range(n):
                traced.append(driver.step(state, len(records) + len(traced)))
        if device == "cuda":
            kernels = {k: load_module(base / "kernels" / f"{k}.py")
                       for k in traffic.get("kernels", [])}
            summary = _profiled(steps, env["spans"], kernels)
            unmatched = unmatched_kernels(summary)
            if unmatched:
                raise SystemExit(f"kernels traced without their bytes noted, or noted "
                                 f"without device time: {unmatched}")
        else:
            steps()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    driver.release(state)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    checked = driver.check(state, records + traced)

    ctx = Context(cell=cell, log=log, setup_s=setup_s, window_s=window_s, records=records,
                  traced=traced, trace=summary, check=checked)
    kind_of = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell_name, kind_of):
        v = load_module(base / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(1 for r in records + traced if r.get("failed"))
    compared = {k: {"value": v, "limit": cfg["limits"][k]}
                for k, v in checked["numbers"].items()}
    correct = bool(records) and all(c["value"] <= c["limit"] for c in compared.values())
    out = {"correct": correct, "attempted": len(records) + len(traced), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                      "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}}
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["compared"] = compared
    for k, c in compared.items():
        print(f"compared {k}: {c['value']} (limit {c['limit']})", file=log)
    return out
