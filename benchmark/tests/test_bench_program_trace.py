"""The program's spans read over a cell's window (``program_trace.py``),
and its ranges on a trace, on the CPU.

- On a synthetic trace the harness's summary (``harness.reduce_trace``)
  is the same with the program's ranges in it as without them, so every
  metric read from it reads as before; ``reduce_ranges`` tallies the
  program's ranges (count, device time and launches inside them, by
  correlation) and names an idle gap by the innermost range open at its
  middle, the program's or the harness's.
- A CPU run of each cut cell with the program's tracing on reads the span
  and counter readings of that cell and the finalization's bytes per
  step, and is correct; the profiled steps are the card's alone.
- The finalization kernel's call tally (``offering_argmin.CALLS``), priced
  by ``program_trace.priced_calls`` with ``kernels/argmin.py nbytes``,
  equals the bytes the traced window's wrapper (``harness.noting_bytes``)
  notes, over a small CPU wave.
"""

import copy
import io
import time

import pytest

CELLS = ("wave50k.burst", "fleet500.consolidate")
WANT = {
    "wave50k.burst": ("scan_step_issue_us.wave", "scan_useful_pct.wave",
                      "fetch_wait_ms.wave", "decode_prep_ms.wave", "solve_self_ms.wave"),
    "fleet500.consolidate": ("engine_build_ms.consolidate", "probe_stage_ms.consolidate",
                             "probe_wait_ms.consolidate", "exact_build_ms.consolidate"),
}


def _x(name, cat, ts, dur, corr=None):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _events(program=True):
    """A window [0, 100] us: the harness's span around a solve, the
    program's pack with two scan steps and its decode prep, two kernels and
    a copy."""
    ev = [_x("bench::between steps", "user_annotation", 0, 100),
          _x("bench::solve", "user_annotation", 5, 90),
          _x("cudaLaunchKernel", "cuda_runtime", 13, 1, corr=1),
          _x("cudaLaunchKernel", "cuda_runtime", 23, 1, corr=2),
          _x("cudaMemcpyAsync", "cuda_runtime", 56, 1, corr=3),
          _x("kernel_a", "kernel", 30, 5, corr=1),
          _x("kernel_b", "kernel", 36, 4, corr=2),
          _x("Memcpy DtoH", "gpu_memcpy", 61, 1, corr=3)]
    if program:
        ev += [_x("solver.pack", "user_annotation", 10, 40),
               _x("pack.step", "user_annotation", 12, 8),
               _x("pack.step", "user_annotation", 22, 8),
               _x("decode.prep", "user_annotation", 55, 5),
               _x("solver.pack", "gpu_user_annotation", 30, 10)]
    return ev


def test_reduce_trace_is_unchanged_by_program_ranges():
    from benchmark import harness
    match = {"a": "kernel_a"}
    plain = harness.reduce_trace(_events(False), 0, 100, match)
    assert harness.reduce_trace(copy.deepcopy(_events()), 0, 100, match) == plain
    assert plain["launches"] == 2 and plain["busy_s"] == pytest.approx(10e-6)
    assert plain["span_device_s"]["solve"] == pytest.approx(10e-6)


def test_reduce_ranges_tallies_and_names_gaps():
    from benchmark import program_trace
    out = program_trace.reduce_ranges(_events(), 0, 100, "bench::")
    r = out["ranges"]
    assert set(r) == {"solver.pack", "pack.step", "decode.prep"}
    assert (r["pack.step"]["count"], r["pack.step"]["launches"]) == (2, 2)
    assert r["pack.step"]["device_s"] == pytest.approx(9e-6)
    assert r["solver.pack"]["device_s"] == pytest.approx(9e-6)
    assert (r["decode.prep"]["count"], r["decode.prep"]["launches"]) == (1, 0)
    assert r["decode.prep"]["device_s"] == pytest.approx(1e-6)
    gaps = dict(out["idle_gaps"])
    # [0,30] mid 15: a step; [35,36]: the pack between steps; [40,61] mid
    # 50.5 and [62,100] mid 81: the harness's solve
    assert gaps == pytest.approx({"pack.step": 30e-6, "solver.pack": 1e-6,
                                  "solve": 59e-6})


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reads_the_program_spans(checkout, cell):
    from benchmark import program_trace
    out = program_trace.run(cell, 2**31 + 777, 0.5, True, device="cpu",
                            root=checkout, log=io.StringIO())
    assert out["correct"] is True and out["failed"] == 0
    assert set(WANT[cell]) | {"argmin_bytes_per_step"} <= set(out["readings"]), \
        out["readings"]
    assert all(v >= 0 for v in out["readings"].values())
    assert out["readings"]["argmin_bytes_per_step"] > 0
    assert out["profiled"] is None
    if cell.startswith("wave"):
        assert 0 < out["readings"]["scan_useful_pct.wave"] <= 100
    off = program_trace.run(cell, 2**31 + 778, 0.3, False, device="cpu",
                            root=checkout, log=io.StringIO())
    assert off["correct"] is True and off["tally"] is None
    assert set(off["readings"]) == {"argmin_bytes_per_step"}


def test_finalization_tally_prices_as_the_wrapper(checkout):
    from benchmark import harness, program_trace
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    kernels = {"argmin": harness.load_module(checkout / "benchmark" / "kernels" / "argmin.py")}
    calls = dict(oa.CALLS)
    with harness.noting_bytes(kernels) as noted:
        out = harness.run("wave50k.burst", 2**31 + 99, 0.3, False, time.perf_counter(),
                          device="cpu", root=checkout, log=io.StringIO())
    assert out["correct"] is True
    priced = program_trace.priced_calls(calls, oa.CALLS, kernels["argmin"].nbytes)
    assert priced == noted["argmin"] > 0
