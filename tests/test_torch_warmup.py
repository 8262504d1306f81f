"""The PyTorch port's warm start and profiling (``Solver.warmup``,
``start_profiling`` / ``stop_profiling``) on the CPU, against the JAX
package's Solver where a plan comes out.

- After ``warmup(g_buckets=(16,), b_buckets=(32,))`` a cfg1-style solve
  of that shape (cfg1's first 24 pods: G bucket 16, B bucket 32) gives
  the same ``plan_semantic_dict`` as the JAX Solver's; so does all of
  cfg1 (B bucket 128) after a warmup of that bucket. Each warmed shape
  launched the cheapest-offering kernel (its plain version on the CPU):
  once per bucket without and with an existing-bin buffer, and once per
  probe bucket with ``probes``.
- ``background=True`` returns a started daemon thread named
  ``solver-warmup`` that joins within 120 s; each shape holds the solve
  lock, so a solve arriving mid-warmup waits.
- ``on_done`` fires exactly once, also when a bucket raises (the error
  still reaches the caller), and a callback that raises does not kill
  the warmup thread.
- Profiling writes a Chrome trace under ``<dir>/plugins/profile/<run>/``
  naming the pack spans of the solves it saw (``solver.pack``,
  ``solver.pack_micro``, ``solver.pack_probe``, ``solver.pack_sharded``),
  tracing off, and every step of their scans (``pack.step``) inside one
  of them or the mesh's merge pack (``solver.pack_merge``); with profiling and tracing off a span is the no-op span.

Tolerance: none.
"""

import json
import threading

import pytest

import bench
import test_torch_cases as cases
from karpenter_provider_aws_tpu.apis import serde as j_serde
from karpenter_provider_aws_tpu.lattice import build_lattice as j_build_lattice
from karpenter_provider_aws_tpu.lattice.realdata import load_catalog as j_catalog
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu_torch import trace, workloads
from karpenter_provider_aws_tpu_torch.apis import serde as t_serde
from karpenter_provider_aws_tpu_torch.ops import binpack
from karpenter_provider_aws_tpu_torch.solver import Solver
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

_LATS = {}


def _lattices():
    if not _LATS:
        _LATS["jax"] = j_build_lattice(j_catalog(None, require_price=True))
        _LATS["port"] = workloads.real_lattice()
    return _LATS["jax"], _LATS["port"]


@pytest.fixture
def launches(monkeypatch):
    """Calls of the cheapest-offering wrapper from the pack."""
    calls = []
    real = binpack.cheapest_offering

    def count(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(binpack, "cheapest_offering", count)
    return calls


@pytest.mark.parametrize("n_pods,b_bucket", [(24, 32), (100, 128)],
                         ids=["cfg1-first-24", "cfg1"])
def test_warmed_solve_equals_jax(n_pods, b_bucket, launches):
    jl, tl = _lattices()
    s = Solver(tl, device="cpu")
    s.warmup(g_buckets=(16,), b_buckets=(b_bucket,))
    assert launches == [b_bucket, b_bucket]       # without, with init
    jpods, jpools, _ = bench.config1_parity()
    tpods, tpools, _ = workloads.config1_parity()
    t_plan = s.solve_relaxed(tpods[:n_pods], tpools)
    j_plan = JaxSolver(jl).solve_relaxed(jpods[:n_pods], jpools)
    # the solve dispatched the warmed shape: one launch at B=b_bucket
    assert s._b_hint[16][0] == b_bucket
    assert launches == [b_bucket] * 3
    assert not t_plan.unschedulable and not t_plan.degraded
    assert t_serde.plan_semantic_dict(t_plan) == \
        j_serde.plan_semantic_dict(j_plan)


def test_probes_warm_the_first_two_probe_buckets(launches):
    s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu")
    s.warmup(g_buckets=(16,), b_buckets=(32,), probes=True)
    # two single packs, then K=4 and K=8 probes: one launch over K*B rows
    assert launches == [32, 32, 4 * 32, 8 * 32]


def test_background_warmup_joins_and_holds_the_solve_lock(monkeypatch):
    s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu")
    blocked = []
    real = binpack.pack_packed_efused

    def pack(*args, **kwargs):
        # another thread (a solve arriving now) cannot take the lock
        got = []
        probe = threading.Thread(target=lambda: got.append(
            s._solve_lock.acquire(blocking=False)))
        probe.start()
        probe.join()
        if got[0]:
            s._solve_lock.release()
        blocked.append(not got[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(binpack, "pack_packed_efused", pack)
    done = []
    t = s.warmup(g_buckets=(16,), b_buckets=(32,), background=True,
                 on_done=lambda: done.append(threading.current_thread().name))
    assert isinstance(t, threading.Thread) and t.daemon
    assert t.name == "solver-warmup"
    t.join(timeout=120)
    assert not t.is_alive()
    assert blocked == [True, True]
    assert done == ["solver-warmup"]


def test_on_done_fires_once_when_a_bucket_raises(monkeypatch):
    s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("bucket failed")

    monkeypatch.setattr(binpack, "pack_packed_efused", broken)
    done = []
    with pytest.raises(RuntimeError, match="bucket failed"):
        s.warmup(g_buckets=(16, 32), b_buckets=(32,),
                 on_done=lambda: done.append(1))
    assert done == [1]


def test_raising_callback_does_not_kill_the_thread(launches, monkeypatch):
    s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu")
    errors = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: errors.append(args.exc_value))
    calls = []

    def callback():
        calls.append(1)
        raise ValueError("callback bug")

    t = s.warmup(g_buckets=(16,), b_buckets=(32,), background=True,
                 on_done=callback)
    t.join(timeout=120)
    assert not t.is_alive()
    assert calls == [1] and errors == []
    assert launches == [32, 32]          # the ladder ran to its end


def _trace_ranges(path):
    """(name, start, end) of the host's ranges in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"]


def test_profiling_writes_a_trace_naming_the_spans(tmp_path):
    lat, pods, pools, kw = cases.build(cases.TORCH_PKG, "generic")
    P = cases.mod(cases.TORCH_PKG, "solver.problem")
    parallel = cases.mod(cases.TORCH_PKG, "parallel")
    s = Solver(lat, device="cpu")
    assert trace.span("solver.pack") is trace.NOOP_SPAN
    s.start_profiling(str(tmp_path))
    try:
        s.solve_relaxed(pods, pools)
        problem = P.build_problem(pods, pools, lat)
        s.solve_delta(problem)
        s.probe_batch([problem, problem])
        s.solve(problem, mesh=parallel.plan_mesh("2", device="cpu").mesh)
    finally:
        path = s.stop_profiling()
    assert s.stop_profiling() is None
    assert trace.span("solver.pack") is trace.NOOP_SPAN
    runs = list((tmp_path / "plugins" / "profile").iterdir())
    assert len(runs) == 1 and path.startswith(str(runs[0]))
    ranges = _trace_ranges(path)
    names = {n for n, _, _ in ranges}
    packs = ("solver.pack", "solver.pack_micro", "solver.pack_probe",
             "solver.pack_sharded")
    for span in packs:
        assert span in names, span
    assert not any("#" in n for n in names)
    outer = [(a, b) for n, a, b in ranges
             if n in packs + ("solver.pack_merge",)]
    steps = [(a, b) for n, a, b in ranges if n == "pack.step"]
    assert steps and all(any(a0 <= a and b <= b0 for a0, b0 in outer)
                         for a, b in steps)
