"""The PyTorch port's steady-state delta solve (``Solver.solve_delta`` and
its device-resident microloop) against the JAX package's, on the CPU.

Both packages' builders and Solvers go through one seeded churn sequence
(``test_torch_cases.churn_sequence``). Tolerance: none. Plans must have
equal ``serde.plan_semantic_dict``; ``pipeline_stats`` and ``link_stats``
(legs and bytes) must be equal after every pass; every plan must equal a
sequential Solver's plan of the same problem. Then the microloop's own
contracts: the overlap seam runs once, a skipped sync re-decodes with the
current pod names, a device error mid-microloop drops the retained state
and the next pass is exact, and the in-place scatter never touches the
retained result.
"""

import pytest
import torch

from karpenter_provider_aws_tpu.apis import serde
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu.solver.incremental import (
    IncrementalProblemBuilder as JaxBuilder)
from karpenter_provider_aws_tpu_torch.apis import NodePool, Pod
from karpenter_provider_aws_tpu_torch.errors import SolverDeviceError
from karpenter_provider_aws_tpu_torch.ops import binpack as tb
from karpenter_provider_aws_tpu_torch.solver import Solver as TorchSolver
from karpenter_provider_aws_tpu_torch.solver.incremental import (
    IncrementalProblemBuilder as TorchBuilder)
from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

import test_torch_cases as cases

CPU = "cpu"
_RUNS = {}


def _canon(plan):
    return serde.plan_semantic_dict(plan)


def _drive(pkg, Builder, solver):
    """(plans, pipeline_stats, link_stats, legs, problems) per pass of the
    churn sequence: full builds through ``solve``, deltas through
    ``solve_delta``, as the provisioner drives them."""
    lat = solver.lattice
    b = Builder()
    out = []
    for pods, pools, ex, dirty, touched in cases.churn_sequence(pkg, lat):
        res = b.build(pods, pools, lat, existing=lambda: ex, dirty=dirty,
                      touched=touched)
        if res.incremental:
            plan = solver.solve_delta(res.problem, dirty_groups=res.dirty_groups)
        else:
            plan = solver.solve(res.problem)
            # prime the resident state as the steady-state harness does
            solver.solve_delta(res.problem)
        out.append((plan, dict(solver.pipeline_stats), dict(solver.link_stats),
                    solver.pipeline_stats["micro_last_legs"], res))
    return out


def _runs():
    if "runs" not in _RUNS:
        js = JaxSolver(cases.small_lattice(cases.JAX_PKG))
        ts = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU)
        _RUNS["runs"] = (_drive(cases.JAX_PKG, lambda: JaxBuilder(explain=False), js),
                         _drive(cases.TORCH_PKG, lambda: TorchBuilder(explain=False), ts))
    return _RUNS["runs"]


class TestDeltaParity:
    @pytest.mark.parametrize("step", range(15))
    def test_pass_equal_to_jax(self, step):
        jr, tr = _runs()
        (jp, jstats, jlink, jlegs, _), (tp, tstats, tlink, tlegs, _) = jr[step], tr[step]
        assert _canon(tp) == _canon(jp)
        assert tp.pipelined is jp.pipelined
        assert tstats == jstats
        assert tlink == jlink
        assert tlegs == jlegs

    def test_every_pass_equals_the_sequential_solve(self):
        _, tr = _runs()
        ref = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU,
                          pipeline=False)
        for plan, _, _, _, res in tr:
            assert _canon(plan) == _canon(ref.solve(res.problem))

    def test_steady_passes_pay_at_most_two_legs(self):
        _, tr = _runs()
        stats = tr[-1][1]
        assert stats["micro_aborts"] == 0
        assert stats["micro_skipped_syncs"] >= 1
        delta_legs = [legs for _, _, _, legs, res in tr if res.incremental]
        assert delta_legs and max(delta_legs) <= 2
        # the pass with no churn re-uploads nothing and fetches nothing
        none_pass = next(i for i, (_, _, _, _, res) in enumerate(tr)
                         if res.incremental and not res.dirty_groups
                         and not res.problem.unschedulable)
        assert tr[none_pass][3] == 0


def _pods(n_sigs=10, per=5, prefix="p"):
    return [Pod(name=f"{prefix}{s}-{i}",
                requests={"cpu": f"{100 + s * 25}m", "memory": "1Gi"})
            for s in range(n_sigs) for i in range(per)]


@pytest.fixture
def lattice():
    return cases.small_lattice(cases.TORCH_PKG)


class TestMicroloop:
    def test_skipped_sync_redecodes_with_current_names(self, lattice):
        solver = TorchSolver(lattice, device=CPU)
        pools = [NodePool(name="default")]
        solver.solve_delta(build_problem(_pods(), pools, lattice))
        renamed = _pods(prefix="r")
        plan = solver.solve_delta(build_problem(renamed, pools, lattice))
        assert solver.stats()["micro_skipped_syncs"] == 1
        assert solver.pipeline_stats["micro_last_legs"] == 0
        placed = {p for n in plan.new_nodes for p in n.pods}
        assert placed == {p.name for p in renamed}

    def test_overlap_runs_exactly_once(self, lattice):
        solver = TorchSolver(lattice, device=CPU)
        problem = build_problem(_pods(), [NodePool(name="default")], lattice)
        calls = []
        solver.solve_delta(problem, overlap=lambda: calls.append(1))
        assert calls == [1] and solver.stats()["overlapped_admission"] == 1
        # the fallback path (the microloop's bin table overflows; the
        # standard solve regrows it) still runs it once, after the solve
        solver._estimate_bins = lambda p: 0
        wide = cases.problem(cases.TORCH_PKG, "anti_wide")
        calls.clear()
        plan = solver.solve_delta(wide, overlap=lambda: calls.append(1))
        assert calls == [1]
        assert solver.stats()["micro_aborts"] == 1
        ref = TorchSolver(lattice, device=CPU, pipeline=False).solve(wide)
        assert _canon(plan) == _canon(ref)

    def test_device_error_mid_microloop_drops_state_and_recovers(
            self, lattice, monkeypatch, caplog):
        solver = TorchSolver(lattice, device=CPU)
        ref = TorchSolver(lattice, device=CPU, pipeline=False)
        problem = build_problem(_pods(), [NodePool(name="default")], lattice)
        solver.solve_delta(problem)
        misses0 = solver._resident.misses
        real = tb.pack_packed_efused
        failures = [RuntimeError("CUDA error: an illegal memory access")]

        def once(*a, **k):
            if failures:
                raise failures.pop()
            return real(*a, **k)

        monkeypatch.setattr(tb, "pack_packed_efused", once)
        faulted = solver.solve_delta(problem)
        assert _canon(faulted) == _canon(ref.solve(problem))
        assert "illegal memory access" in caplog.text   # logged, not silent
        st = solver.stats()
        assert st["micro_aborts"] == 1 and st["micro_engaged"] is False
        assert solver._resident.misses > misses0     # re-uploaded fresh
        again = solver.solve_delta(problem)
        assert _canon(again) == _canon(ref.solve(problem))
        st = solver.stats()
        assert st["micro_solves"] == 2 and st["micro_engaged"] is True

    def test_device_error_in_the_fallback_surfaces(self, lattice, monkeypatch):
        solver = TorchSolver(lattice, device=CPU)
        problem = build_problem(_pods(), [NodePool(name="default")], lattice)

        def broken(*a, **k):
            raise RuntimeError("CUDA error: out of memory")

        monkeypatch.setattr(tb, "pack_packed_efused", broken)
        with pytest.raises(SolverDeviceError):
            solver.solve_delta(problem)
        assert solver.pipeline is True   # restored after the failure

    def test_in_place_scatter_leaves_the_retained_result(self, lattice):
        solver = TorchSolver(lattice, device=CPU)
        pools = [NodePool(name="default")]
        pods = _pods(n_sigs=40)
        solver.solve_delta(build_problem(pods, pools, lattice))
        ms = solver._micro
        prev_dev, prev_bytes = ms.prev_dev, ms.prev_dev.clone()
        (entry_host, resident), = solver._resident._entries.values()
        ptr = resident.data_ptr()
        churned = build_problem(pods[2:], pools, lattice)
        G = next(iter(solver._resident._entries))[2]
        solver._resident.upload(ms.key, solver._fused_inputs_np(churned, G),
                                donate=True)
        assert solver._resident.stats()["blocks_shipped"] >= 1
        assert torch.equal(prev_dev, prev_bytes)
        (_, resident2), = solver._resident._entries.values()
        assert resident2.data_ptr() == ptr
        # and a full pass over the churned problem stays exact
        solver2 = TorchSolver(lattice, device=CPU, pipeline=False)
        assert _canon(solver.solve_delta(churned)) == _canon(solver2.solve(churned))

    def test_layout_drift_restarts_cold(self, lattice):
        solver = TorchSolver(lattice, device=CPU)
        pools = [NodePool(name="default")]
        solver.solve_delta(build_problem(_pods(), pools, lattice))
        key0 = solver._micro.key
        bigger = build_problem(_pods(n_sigs=20), pools, lattice)
        solver.solve_delta(bigger)
        assert solver._micro.key != key0
        assert solver.stats()["micro_skipped_syncs"] == 0
        assert solver.stats()["micro_fetches"] == 2

    def test_restores_pipeline_flag_and_rejects_a_mesh(self, lattice):
        s = TorchSolver(lattice, device=CPU, pipeline=False)
        problem = build_problem(_pods(), [NodePool(name="default")], lattice)
        plan = s.solve_delta(problem, dirty_groups=(0, 1))
        assert plan.pipelined and s.pipeline is False
        assert s.pipeline_stats["delta_dirty_groups"] == 2
        with pytest.raises(NotImplementedError):
            s.solve_delta(problem, mesh=object())


class TestSteadyStateHarness:
    def test_cfg10_passes_on_the_small_lattice(self):
        """workloads.steady_state_passes (chip_smoke.py's cfg10 phase) on
        the CPU: cfg10's pods and churn over the m5/c5 slice, 4 passes, the
        4th churning nothing. Every pass rides the microloop, pays at most
        2 legs (0 on the no-churn pass, whose fetch is skipped) and equals
        a sequential Solver's plan of the same problem."""
        from karpenter_provider_aws_tpu_torch import workloads
        lat = cases.small_lattice(cases.TORCH_PKG)
        pods, pools, shapes = workloads.config10_steady_state()
        churn = workloads.SteadyStateChurn(lat, pods, shapes)
        solver = TorchSolver(lat, device=CPU)
        ref = TorchSolver(lat, device=CPU, pipeline=False)
        legs = []
        for pass_i, res, plan, ms, pass_legs in workloads.steady_state_passes(
                solver, lat, pools, churn, passes=4):
            assert res.incremental == (pass_i >= 0)
            assert _canon(plan) == _canon(ref.solve(res.problem))
            assert ms > 0
            legs.append(pass_legs)
        assert legs == [None, 2, 2, 2, 0]
        st = solver.stats()
        assert (st["micro_solves"], st["micro_aborts"], st["micro_skipped_syncs"]) \
            == (5, 0, 1)
        assert len(churn.pods) == 20000
