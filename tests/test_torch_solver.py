"""The PyTorch port's problem build, FFD oracle and Solver against the JAX
package's, on the CPU.

Inputs are built from the same generators in both packages (numpy seeds).
Tolerance: none. ``build_problem`` arrays must be ``np.array_equal``; plans
must have equal ``serde.plan_semantic_dict`` (the JAX package's own plan
comparison, which reads only plan attributes).
"""

import types

import numpy as np
import pytest

import bench
from karpenter_provider_aws_tpu.apis import serde
from karpenter_provider_aws_tpu.lattice import build_lattice as j_build_lattice
from karpenter_provider_aws_tpu.lattice.realdata import load_catalog as j_load_catalog
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu.solver.oracle import ffd_oracle as j_oracle
from karpenter_provider_aws_tpu.solver.problem import build_problem as j_build
from karpenter_provider_aws_tpu_torch import convert, workloads
from karpenter_provider_aws_tpu_torch.errors import SolverDeviceError
from karpenter_provider_aws_tpu_torch.lattice import build_lattice as t_build_lattice
from karpenter_provider_aws_tpu_torch.ops import binpack as tb
from karpenter_provider_aws_tpu_torch.solver import Solver as TorchSolver
from karpenter_provider_aws_tpu_torch.solver import solve as tsolve
from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle as t_oracle
from karpenter_provider_aws_tpu_torch.solver.problem import build_problem as t_build

import test_torch_cases as cases

CPU = "cpu"
PLAN_CASES = ("generic", "selectors_taints", "affinity", "existing", "relax",
              "random-0", "random-1", "random-2", "random-3")

_CACHE = {}


def solvers():
    if "s" not in _CACHE:
        _CACHE["s"] = (JaxSolver(cases.small_lattice(cases.JAX_PKG), pipeline=False),
                       TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU))
    return _CACHE["s"]


def assert_problems_equal(jp, tp):
    assert (jp.G, jp.NP, jp.E, jp.A) == (tp.G, tp.NP, tp.E, tp.A)
    for name in convert.PROBLEM_ARRAYS:
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert [g.pod_names for g in jp.groups] == [g.pod_names for g in tp.groups]
    assert [g.signature for g in jp.groups] == [g.signature for g in tp.groups]
    assert [p.name for p in jp.node_pools] == [p.name for p in tp.node_pools]
    assert jp.unschedulable == tp.unschedulable
    assert jp.warnings == tp.warnings


class TestBuildProblem:
    @pytest.mark.parametrize("case", cases.CASES)
    def test_small_cases(self, case):
        assert_problems_equal(cases.problem(cases.JAX_PKG, case),
                              cases.problem(cases.TORCH_PKG, case))

    def test_bench_configs_1_to_4(self):
        """workloads.py's copies of bench.py's generators give the same
        problems over the full synthetic catalog."""
        jl, tl = j_build_lattice(), t_build_lattice()
        for jgen, tgen, needs_lat in [
                (bench.config1_parity, workloads.config1_parity, False),
                (bench.config2_selectors_taints, workloads.config2_selectors_taints, False),
                (bench.config3_affinity_spread, workloads.config3_affinity_spread, False),
                (bench.config4_consolidation_repack,
                 workloads.config4_consolidation_repack, True)]:
            jpods, jpools, jex = jgen(jl) if needs_lat else jgen()
            tpods, tpools, tex = tgen(tl) if needs_lat else tgen()
            assert_problems_equal(j_build(jpods, jpools, jl, existing=jex),
                                  t_build(tpods, tpools, tl, existing=tex))

    def test_bench_config10_and_its_churn(self, monkeypatch):
        """workloads.py's cfg10 and SteadyStateChurn give the same pods,
        pools, existing nodes and churn as bench.py's config10_steady_state
        and the pass loop of run_microloop_config (seeds 10 and 14). The
        bench harness runs with its solvers and builder replaced by
        recorders, so only its own generator code runs."""
        import karpenter_provider_aws_tpu.solver as jsolver
        import karpenter_provider_aws_tpu.solver.incremental as jinc
        from karpenter_provider_aws_tpu.solver.solve import NodePlan as JaxPlan

        def pod_row(p):
            return (p.name, tuple(p.requests.items()), tuple(p.node_selector.items()))

        def bins_row(existing):
            return [(b.name, b.node_pool, b.instance_type, b.zone, b.capacity_type,
                     b.used.tobytes()) for b in existing]

        def touched_row(touched):
            return sorted((n, st, None if p is None else pod_row(p))
                          for n, (st, p) in touched.items())

        recorded = []

        class Recorder:
            rev = -1

            def build(self, pods, pools, lattice, existing=(), dirty=None,
                      touched=None, **kw):
                ex = existing() if callable(existing) else existing
                recorded.append(([pod_row(p) for p in pods], [p.name for p in pools],
                                 bins_row(ex), (dirty.since, dirty.rev, dirty.full,
                                                sorted(dirty.pods), dirty.bins),
                                 touched_row(touched or {})))
                self.rev = dirty.rev
                return types.SimpleNamespace(problem=types.SimpleNamespace(G=0),
                                             incremental=True,
                                             dirty_groups=(), reason="")

        counters = {k: 0 for k in ("micro_skipped_syncs", "micro_solves",
                                   "delta_solves", "micro_merge_solves",
                                   "micro_merge_regrows", "micro_last_legs")}

        class NoSolver:
            mesh = None
            pipeline_stats = counters

            def __init__(self, *a, **k):
                pass

            def solve(self, problem, **kw):
                return JaxPlan([], {}, {}, 0.0, 0.0, 0.0)

            solve_delta = solve

            def stats(self):
                return {"link_upload_bytes": 0, "link_fetch_bytes": 0}

        monkeypatch.setattr(jsolver, "Solver", NoSolver)
        monkeypatch.setattr(jsolver, "build_problem", lambda *a, **k: None)
        monkeypatch.setattr(jinc, "IncrementalProblemBuilder", Recorder)
        jl = j_build_lattice(j_load_catalog(None, require_price=True))
        bench.run_microloop_config(jl, NoSolver())
        assert len(recorded) == 1 + workloads.STEADY_PASSES == 1 + bench.DELTA_PASSES

        tl = workloads.real_lattice()
        pods, pools, shapes = workloads.config10_steady_state()
        churn = workloads.SteadyStateChurn(tl, pods, shapes)
        mine = [([pod_row(p) for p in churn.pods], [p.name for p in pools],
                 bins_row(churn.existing), (-1, 0, True, [], False), [])]
        for pass_i in range(workloads.STEADY_PASSES):
            touched, nochurn = churn.churn(pass_i)
            mine.append(([pod_row(p) for p in churn.pods], [p.name for p in pools],
                         bins_row(churn.existing),
                         (pass_i, pass_i + 1, False, sorted(touched), not nochurn),
                         touched_row(touched)))
        assert len(churn.pods) == 20000 and len(churn.existing) == 120
        assert sum(not m[3][4] for m in mine[1:]) == 3
        for step, (got, want) in enumerate(zip(mine, recorded)):
            assert got == want, f"pass {step - 1} differs"

    def test_cfg5_full_size_real_catalog(self):
        """The north-star wave: 50k pods x the real 759-type catalog."""
        jl = j_build_lattice(j_load_catalog(None, require_price=True))
        tl = workloads.real_lattice()
        for name in ("alloc", "available", "price", "capacity"):
            assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
        assert (jl.names, jl.zones, jl.capacity_types) == \
            (tl.names, tl.zones, tl.capacity_types)
        jpods, jpools, _ = bench.config5_full_scale()
        tpods, tpools, _ = workloads.config5_full_scale()
        jp, tp = j_build(jpods, jpools, jl), t_build(tpods, tpools, tl)
        assert (tl.T, tl.Z, tl.C, tp.G, tp.NP) == (759, 5, 2, 31, 3)
        assert int(tp.count.sum()) == 50000
        assert_problems_equal(jp, tp)

    def test_explain_is_not_ported(self):
        """(Named when explain builds raised here.) ``explain=True`` now
        builds the JAX package's ledgers; tests/test_torch_explain.py
        holds them equal case by case."""
        lat, pods, pools, kw = cases.build(cases.TORCH_PKG, "generic")
        p = t_build(pods, pools, lat, explain=True, **kw)
        assert p.groups and all(g.ledger is not None for g in p.groups)
        jlat, jpods, jpools, jkw = cases.build(cases.JAX_PKG, "generic")
        jp = j_build(jpods, jpools, jlat, explain=True, **jkw)
        assert [g.ledger.to_doc() for g in p.groups] == \
            [g.ledger.to_doc() for g in jp.groups]


class TestOracle:
    @pytest.mark.parametrize("case", list(cases.CASES) + ["random-0", "random-1",
                                                          "random-2", "random-3"])
    def test_same_plan_as_jax_oracle(self, case):
        """The port's oracle resumes each pod's first-fit scan where the
        group's previous pod landed; the plan must equal the JAX package's
        scan-from-bin-0 oracle exactly."""
        j = j_oracle(cases.problem(cases.JAX_PKG, case))
        t = t_oracle(cases.problem(cases.TORCH_PKG, case))
        assert [(b.np_idx, b.pods, b.existing_idx) for b in j.bins] == \
            [(b.np_idx, b.pods, b.existing_idx) for b in t.bins]
        for jb_, tb_ in zip(j.bins, t.bins):
            assert np.array_equal(jb_.tmask, tb_.tmask)
            assert np.array_equal(jb_.cum, tb_.cum)
        assert j.chosen == t.chosen
        assert j.new_node_cost == t.new_node_cost
        assert j.unschedulable == t.unschedulable


class TestSolverParity:
    @pytest.mark.parametrize("case", PLAN_CASES)
    def test_plan_semantic_dict_equal(self, case):
        js, ts = solvers()
        _, jpods, jpools, jkw = cases.build(cases.JAX_PKG, case)
        _, tpods, tpools, tkw = cases.build(cases.TORCH_PKG, case)
        jplan = js.solve_relaxed(jpods, jpools, **jkw)
        tplan = ts.solve_relaxed(tpods, tpools, **tkw)
        assert serde.plan_semantic_dict(tplan) == serde.plan_semantic_dict(jplan)
        assert tplan.new_nodes or tplan.existing_assignments
        assert set(tplan.stage_ms) == {"build", "upload", "compute",
                                       "download", "decode"}

    def test_relaxation_round_ran(self):
        _, ts = solvers()
        _, pods, pools, kw = cases.build(cases.TORCH_PKG, "relax")
        plan = ts.solve_relaxed(pods, pools, **kw)
        assert not plan.unschedulable
        assert ts.solve(t_build(pods, pools, ts.lattice, **kw)).unschedulable

    @pytest.mark.parametrize("case", ["generic", "anti_wide"])
    def test_forced_overflow_regrow(self, case):
        """An estimator of 0 bins forces the undersized bin table; the
        solve must regrow the bucket and land on the same plan."""
        js, _ = solvers()
        ts = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU)
        ts._estimate_bins = lambda p: 0
        js2 = JaxSolver(js.lattice, pipeline=False)
        js2._estimate_bins = lambda p: 0
        jplan = js2.solve(cases.problem(cases.JAX_PKG, case))
        tplan = ts.solve(cases.problem(cases.TORCH_PKG, case))
        assert serde.plan_semantic_dict(tplan) == serde.plan_semantic_dict(jplan)
        if case == "anti_wide":
            # 150 one-pod nodes overflow the 128-bin table: two dispatches
            assert ts.link_stats["fetch_legs"] == 2
            (fresh, needed), = ts._b_hint.values()
            assert (fresh, needed) == (128, 512)

    def test_host_ffd_on_request(self):
        js, ts = solvers()
        jplan = js.solve_host_ffd(cases.problem(cases.JAX_PKG, "existing"))
        tplan = ts.solve_host_ffd(cases.problem(cases.TORCH_PKG, "existing"))
        jd, td = serde.plan_semantic_dict(jplan), serde.plan_semantic_dict(tplan)
        assert td == jd and td["solverPath"] == "host-ffd"


class TestNotPorted:
    def test_mesh_and_probe_raise(self):
        """The pipelined path, solve_delta and the batched probes are
        ported; the mesh still raises wherever it can be asked for."""
        lat = cases.small_lattice(cases.TORCH_PKG)
        ts = TorchSolver(lat, device=CPU)
        prob = cases.problem(cases.TORCH_PKG, "generic")
        _, pods, pools, _ = cases.build(cases.TORCH_PKG, "generic")
        with pytest.raises(NotImplementedError):
            ts.solve(prob, mesh=object())
        with pytest.raises(NotImplementedError):
            ts.solve_relaxed(pods, pools, mesh=object())
        with pytest.raises(NotImplementedError):
            ts.solve_delta(prob, mesh=object())

    def test_wave_split_raises(self):
        ts = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU)
        big = types.SimpleNamespace(G=tsolve._G_BUCKETS[-1] + 1,
                                    unschedulable={})
        with pytest.raises(NotImplementedError, match="wave split"):
            ts.solve(big)

    def test_exhausted_bin_table_raises_instead_of_host_ffd(self, monkeypatch):
        ts = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU)
        ts._estimate_bins = lambda p: 0
        monkeypatch.setattr(tsolve, "_grow_bucket", lambda b: (b, False))
        with pytest.raises(NotImplementedError, match="host-FFD"):
            ts.solve(cases.problem(cases.TORCH_PKG, "anti_wide"))

    def test_device_error_surfaces(self, monkeypatch):
        ts = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU)

        def broken(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(tb, "pack_packed_efused", broken)
        with pytest.raises(SolverDeviceError):
            ts.solve(cases.problem(cases.TORCH_PKG, "generic"))
