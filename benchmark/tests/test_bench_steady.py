"""The cell ``steady20k.churn`` end to end on the CPU at a tiny size (600
pods in 6 shapes, 12 standing nodes): the result line, its metrics, the
per-layer readings of the window's passes, ``correct`` false under the control
and under faults planted in the timed path, and a generator that imports
nothing of the program."""

import io
import json
import time

import pytest

from benchmark.tests.conftest import _cut
from benchmark.tests.test_bench_guard import BENCH, JAX_SIDE, PORT, imported_tops

CELL = "steady20k.churn"
TINY = {"steady20k": {"pods": 600, "shapes": 6, "nodes": 12}}
TINY_TRAFFIC = {"churn": {"warmup_passes": 1, "trace_steps": 8}}


@pytest.fixture
def steady(checkout):
    _cut(checkout, TINY, TINY_TRAFFIC)
    return checkout


def run(root, trace=False, seconds=0.5, seed=2**31 + 4242):
    from benchmark import harness
    log = io.StringIO()
    out = harness.run(CELL, seed, seconds, trace, time.perf_counter(), device="cpu",
                      root=root, log=log)
    return out, log.getvalue()


READERS = ("delta_build_ms.steady", "pack_issue_ms.steady", "decode_ms.steady",
           "upload_bytes.steady", "fetch_skipped_pct.steady", "micro_pass_pct.steady")


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(steady, trace):
    out, log = run(steady, trace)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert all(c["value"] == 0 for c in out["compared"].values())
    json.dumps(out)
    # the harness profiles only on a card: on the CPU the device's numbers
    # are absent, and the readers of the window's passes read
    want = set(READERS) if trace else {"wave_ms", "cost_vs_ffd", "setup_s"}
    assert set(out["metrics"]) == want
    assert "checked:" in log


def _passes(root, n=8):
    """A context over ``n`` window passes after set-up."""
    from benchmark import harness
    from benchmark.drivers import steady as drv
    base = root / "benchmark"
    env = {"cfg": json.loads((base / "configs" / "steady20k.json").read_text()),
           "gen": harness.load_module(base / "configs" / "steady20k.py"),
           "traffic": json.loads((base / "traffic" / "churn.json").read_text()),
           "seed": 91, "device": "cpu", "spans": harness.Spans(), "root": root,
           "base": base, "log": io.StringIO()}
    state = drv.setup(env)
    records = [drv.step(state, k) for k in range(n)]
    return harness.Context(cell={"name": CELL}, log=io.StringIO(), setup_s=0.0,
                           window_s=1.0, records=records)


def _read(root, ctx):
    from benchmark import harness
    return {m: harness.load_module(root / "benchmark" / "metrics" / f"{m}.py").read(ctx)
            for m in READERS}


def test_window_passes_feed_the_per_layer_readers(steady):
    from karpenter_provider_aws_tpu_torch import trace
    ctx = _passes(steady)
    assert not trace.enabled()
    read = _read(steady, ctx)
    assert read["fetch_skipped_pct.steady"] == 25.0       # 2 no-churn passes in 8
    assert read["micro_pass_pct.steady"] == 100.0
    assert read["upload_bytes.steady"] >= 4096 * 6 / 8    # 6 churned passes ship blocks
    assert all(read[m] > 0 for m in ("delta_build_ms.steady", "pack_issue_ms.steady",
                                     "decode_ms.steady"))
    assert ctx.roofline_pct("argmin") is None and ctx.idle_pct() is None


def test_readers_read_a_program_without_the_build_span(steady, monkeypatch):
    """The readers read the solver's own stats and the harness's spans, so a
    program whose build has no ``incremental.build`` span (the parent of the
    change that added it) reads the same metrics."""
    from karpenter_provider_aws_tpu_torch.solver import incremental
    monkeypatch.setattr(incremental.IncrementalProblemBuilder, "build", _untraced_build)
    read = _read(steady, _passes(steady, 4))
    assert read["micro_pass_pct.steady"] == 100.0 and read["fetch_skipped_pct.steady"] == 25.0
    assert all(v is not None for v in read.values()), read


def _untraced_build(self, pods, node_pools, lattice, existing=(), daemonset_pods=(),
                    bound_pods=(), pvcs=None, storage_classes=None, pool_headroom=None,
                    dirty=None, touched=None):
    return self._build(pods, node_pools, lattice, existing, daemonset_pods, bound_pods,
                       pvcs, storage_classes, pool_headroom, dirty, touched)


def test_control_is_not_correct(steady):
    from benchmark import controls, harness
    with controls.raw_capacity():
        out = harness.run(CELL, 7, 0.5, False, time.perf_counter(), device="cpu",
                          root=steady, log=io.StringIO())
    assert out["correct"] is False, out["compared"]
    assert out["compared"]["nodes_over_allocatable"]["value"] > 0


def _plant(monkeypatch, fault):
    from karpenter_provider_aws_tpu_torch.solver.solve import Solver
    solve_delta, last, dropped = Solver.solve_delta, {}, []

    def broken(self, problem, dirty_groups=(), **kw):
        plan = solve_delta(self, problem, dirty_groups=dirty_groups, **kw)
        if fault.startswith("stale") and dirty_groups:   # a churned pass: the last plan
            plan, last["plan"] = last.get("plan", plan), plan
        elif fault.startswith("stale"):
            last["plan"] = plan
        elif fault == "dropped" and plan.existing_assignments:
            name = next(iter(plan.existing_assignments))
            plan.existing_assignments[name] = plan.existing_assignments[name][1:]
            dropped.append(name)
        return plan
    monkeypatch.setattr(Solver, "solve_delta", broken)
    return dropped


@pytest.mark.parametrize("fault", ["stale", "stale_unkept", "dropped"])
def test_broken_path_is_not_correct(steady, monkeypatch, fault):
    """``stale_unkept`` keeps no plan for the full check, so the names the
    step records are all that catch the stale plan."""
    if fault == "stale_unkept":
        from benchmark.drivers import steady as drv
        monkeypatch.setattr(drv, "kept", lambda i, traced: False)
    dropped = _plant(monkeypatch, fault)
    out, _ = run(steady)
    assert out["correct"] is False, out["compared"]
    assert out["compared"]["pods_misplaced"]["value"] > 0
    if fault == "dropped":
        assert dropped


def test_the_generator_imports_nothing_of_the_program():
    for f in (BENCH / "configs").glob("*.py"):
        assert not imported_tops(f) & (JAX_SIDE | {PORT}), f.name
