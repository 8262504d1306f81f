"""The PyTorch port's tracer inside the solve and consolidation paths, on
the CPU.

- The tally: per span name the count, the inclusive seconds, the self
  seconds (inclusive less the time its child spans cover) and the seconds
  under each parent name, and the named counters, on nested spans under a
  ``FakeClock``; nothing is tallied while tracing is off.
- The disabled path: with no profiler session, ``span()`` is the shared
  ``NOOP_SPAN`` and allocates nothing, and ``count`` adds nothing.
- Under a CPU ``torch.profiler`` session every span is a range of its own
  name in the Chrome trace, with tracing off or on, ``pack.step`` inside
  ``torch.func.vmap`` among them; the pack's analysis reads the same
  figures under a session as without one.
- A small CPU solve records one ``pack.step`` per step of the bucketed
  group axis, ``scan.steps`` and ``scan.groups`` as the bucket and the real
  groups, one ``solver.pack`` and one ``decode.prep``; a batched probe
  records ``probe.stage`` and ``probe.wait`` under ``solver.pack_probe``.
- ``ConsolidationEngine.probe`` on a small fleet records
  ``engine.whatif_build`` with one ``problem.build`` under it per set.
- Span and trace ids are valid W3C ids and distinct, and a forked child
  draws other ids than its parent; ``DeviceTimer`` on
  the CPU is the host clock between start and stop, and the
  finalization's call tally counts every call by shape.

Tolerance: none (the FakeClock steps are exact binary fractions).
"""

import gc
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_cases as cases
import test_torch_consolidation as tc
from karpenter_provider_aws_tpu_torch import trace
from karpenter_provider_aws_tpu_torch.ops import binpack, offering_argmin
from karpenter_provider_aws_tpu_torch.solver import Solver
from karpenter_provider_aws_tpu_torch.solver import solve as solve_mod
from karpenter_provider_aws_tpu_torch.solver.pipeline import DeviceTimer
from karpenter_provider_aws_tpu_torch.trace.recorder import FlightRecorder
from karpenter_provider_aws_tpu_torch.trace.span import (_new_span_id,
                                                        _new_trace_id,
                                                        _RangeSpan)
from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock

SPAN_TYPES = (trace.Span, _RangeSpan)


@pytest.fixture
def tracing():
    """The process tracer enabled with a recorder of its own; restored."""
    tr = trace.get_tracer()
    saved = (tr.enabled, tr.recorder, tr.clock)
    tr.enable(recorder=FlightRecorder())
    yield tr
    tr.enabled, tr.recorder, tr.clock = saved


def _diff(before, after):
    """The tally's spans and counters added between two snapshots."""
    spans = {}
    for name, row in after["spans"].items():
        old = before["spans"].get(name, {"count": 0, "seconds": 0.0,
                                         "self_seconds": 0.0, "under": {}})
        if row["count"] != old["count"]:
            spans[name] = {
                "count": row["count"] - old["count"],
                "seconds": row["seconds"] - old["seconds"],
                "self_seconds": row["self_seconds"] - old["self_seconds"],
                "under": {p: s - old["under"].get(p, 0.0)
                          for p, s in row["under"].items()
                          if s != old["under"].get(p, 0.0)}}
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in after["counters"].items()
                if v != before["counters"].get(k, 0)}
    return spans, counters


def _range_names(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_tally_counts_and_self_times_under_fake_clock():
    clock = FakeClock()
    tr = trace.Tracer(clock=clock)
    tr.enable(recorder=FlightRecorder(), clock=clock)
    with tr.span("outer"):
        clock.step(1.0)
        with tr.span("a"):
            clock.step(2.0)
            with tr.span("b"):
                clock.step(3.0)
        with tr.span("a"):
            clock.step(0.5)
        tr.count("steps", 32)
        tr.count("steps")
    tot = tr.totals()
    assert tot["spans"] == {
        "outer": {"count": 1, "seconds": 6.5, "self_seconds": 1.0,
                  "under": {}},
        "a": {"count": 2, "seconds": 5.5, "self_seconds": 2.5,
              "under": {"outer": 5.5}},
        "b": {"count": 1, "seconds": 3.0, "self_seconds": 3.0,
              "under": {"a": 3.0}},
    }
    assert tot["counters"] == {"steps": 33}
    # a snapshot, not a view
    tot["spans"]["a"]["count"] = 0
    assert tr.totals()["spans"]["a"]["count"] == 2
    tr.disable()
    with tr.span("outer"):
        clock.step(1.0)
    tr.count("steps")
    assert tr.totals()["spans"]["outer"]["count"] == 1
    assert tr.totals()["counters"] == {"steps": 33}


def test_closed_spans_hold_no_parent():
    """A closed span that the recorder keeps does not keep the span it
    opened inside alive, nor through it another trace's spans."""
    tr = trace.Tracer(clock=FakeClock())
    rec = FlightRecorder()
    tr.enable(recorder=rec)
    with tr.span("outer") as outer:
        with tr.span("inner", parent=None) as inner:
            assert inner.trace_id != outer.trace_id
    assert inner._up is None and outer._up is None
    assert outer._child == inner.duration


def test_disabled_path_is_the_noop_span_and_allocates_nothing():
    assert not trace.enabled()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("pack.step") is trace.NOOP_SPAN
    before = trace.totals()
    gc.collect()
    alive = sum(1 for o in gc.get_objects() if type(o) in SPAN_TYPES)
    for _ in range(100):
        with trace.span("pack.step") as sp:
            sp.set(k=1)
            trace.count("scan.steps", 32)
    gc.collect()
    assert alive == sum(1 for o in gc.get_objects() if type(o) in SPAN_TYPES)
    assert trace.totals() == before


@pytest.mark.parametrize("enabled", [False, True])
def test_spans_are_profiler_ranges(request, tmp_path, enabled):
    if enabled:
        request.getfixturevalue("tracing")
    before = trace.totals()

    def step(x):
        with trace.span("pack.step"):
            return x * 2 + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("solver.pack") as sp:
            assert sp is not trace.NOOP_SPAN
            sp.set(bins=1)
            torch.func.vmap(step)(torch.ones(4, 3))
    if not enabled:
        assert trace.span("solver.pack") is trace.NOOP_SPAN
    names = _range_names(prof, tmp_path)
    assert names.count("solver.pack") == 1
    assert names.count("pack.step") == 1
    spans, _ = _diff(before, trace.totals())
    if enabled:
        assert spans["pack.step"]["under"].keys() == {"solver.pack"}
        assert spans["solver.pack"]["count"] == 1
    else:
        assert spans == {}


def test_pack_analysis_is_the_same_under_a_profiler():
    alone = binpack.pack_analysis(16, 32, 20, 3, 2, 1, 1, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = binpack.pack_analysis(16, 32, 20, 3, 2, 1, 1, 5)
    assert traced == alone


def test_solve_records_scan_steps_and_decode_prep(tracing):
    lat, pods, pools, _ = cases.build(cases.TORCH_PKG, "generic")
    P = cases.mod(cases.TORCH_PKG, "solver.problem")
    s = Solver(lat, device="cpu")
    problem = P.build_problem(pods, pools, lat)
    G = solve_mod._bucket(problem.G, solve_mod._G_BUCKETS)
    assert G > problem.G > 0
    before = trace.totals()
    plan = s.solve(problem)
    spans, counters = _diff(before, trace.totals())
    assert plan.solver_path == "device"
    assert counters == {"scan.steps": G, "scan.groups": problem.G}
    assert spans["pack.step"]["count"] == G
    assert spans["pack.step"]["under"].keys() == {"stage.compute"}
    assert spans["solver.pack"]["count"] == 1
    assert spans["decode.prep"]["count"] == 1
    assert spans["stage.compute"]["under"].keys() == {"solver.pack"}
    for name in ("solver.pack", "decode.prep", "solver.solve"):
        assert spans[name]["self_seconds"] <= spans[name]["seconds"]

    before = trace.totals()
    s.probe_batch([problem, problem, problem])
    spans, counters = _diff(before, trace.totals())
    assert counters == {"scan.steps": G, "scan.groups": problem.G}
    assert spans["solver.pack_probe"]["count"] == 1
    assert spans["probe.wait"]["count"] == 1
    assert spans["probe.stage"]["count"] >= 2
    for name in ("probe.stage", "probe.wait"):
        assert spans[name]["under"].keys() == {"solver.pack_probe"}
    assert spans["pack.step"]["count"] == G      # once, vmapped over K


def test_engine_probe_records_whatif_build(tracing):
    env = tc.Env(cases.TORCH_PKG, **tc.OVERPROVISIONED)
    tc.overprovisioned(env)
    sets = tc.singles(env)
    before = trace.totals()
    verdicts = env.disruption.engine.probe(sets)
    spans, _ = _diff(before, trace.totals())
    assert len(verdicts) == len(sets) and not any(v.cached for v in verdicts)
    assert spans["engine.whatif_build"]["count"] == 1
    assert spans["problem.build"]["count"] == len(sets)
    assert spans["problem.build"]["under"].keys() == {"engine.whatif_build"}
    build = spans["engine.whatif_build"]
    assert build["seconds"] - build["self_seconds"] == pytest.approx(
        spans["problem.build"]["seconds"])
    assert spans["solver.pack_probe"]["count"] == 1


def test_ids_are_valid_and_distinct():
    spans = {_new_span_id() for _ in range(10000)}
    traces = {_new_trace_id() for _ in range(10000)}
    assert len(spans) == len(traces) == 10000
    for t, sp in zip(sorted(traces)[:100], sorted(spans)[:100]):
        assert trace.parse_traceparent(trace.format_traceparent(t, sp)) == (t, sp, True)


def test_forked_processes_draw_other_ids():
    import os
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        os.write(w, (_new_span_id() + _new_trace_id()).encode())
        os._exit(0)
    os.close(w)
    mine = _new_span_id() + _new_trace_id()
    with os.fdopen(r) as f:
        theirs = f.read()
    os.waitpid(pid, 0)
    assert len(theirs) == 48 and theirs != mine


def test_device_timer_on_the_cpu_is_the_host_clock():
    clock = DeviceTimer(torch.device("cpu"))
    torch.ones(64, 64) @ torch.ones(64, 64)
    clock.stop()
    first = clock.seconds()
    assert first >= 0.0 and clock.seconds() == first


def test_finalization_calls_are_tallied_by_shape():
    calls = dict(offering_argmin.CALLS)
    tmask = torch.ones((5, 7), dtype=torch.bool)
    zcmask = torch.ones((5, 6), dtype=torch.bool)
    price = torch.arange(42, dtype=torch.float32).reshape(7, 6)
    launches = offering_argmin.LAUNCHES
    for _ in range(3):
        offering_argmin.cheapest_offering(tmask, zcmask, price)
    assert offering_argmin.CALLS[(5, 7, 6)] == calls.get((5, 7, 6), 0) + 3
    assert offering_argmin.LAUNCHES == launches
