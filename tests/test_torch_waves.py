"""The PyTorch port's wave split and device-fault rungs against the JAX
package's, on the CPU.

The wave and fault cases of the JAX package's other test files are
replayed on both packages by ``test_torch_replay`` (their own checks run
on each, and everything both make is compared; tolerances there):

- ``test_pipeline.py``: the pipelined wave split equals the sequential
  one and prefetches every wave but the first; a transient device error
  is retried on both paths; a fault while waves are in flight; a
  persistent failure reaches the host FFD; a wave split's stage times
  accumulate;
- ``test_microloop.py``: the admission seam runs once when a wave-scale
  delta leaves the microloop; a device fault mid-microloop drops the
  resident state and the ladder re-solves;
- ``test_trace.py``: a degraded solve's trace survives the recorder's
  ring.

Those files compare plans with ``serde.plan_semantic_dict``; each
package's replay uses its own.

One more test holds the bytes: for a seeded problem with existing bins
and affinity classes under ``g_limit=32``, every wave's fused group+pool
buffer and existing-bin buffer equal the JAX package's, byte for byte, on
the sequential and on the pipelined path, and so do the merged plans.
Tolerance: none.
"""

import numpy as np
import pytest

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

REPLAYS = {
    "test_pipeline.py": (
        ["TestPlanParity::test_wave_split_parity",
         "TestFaultsMidPipeline::test_transient_device_error_parity",
         "TestFaultsMidPipeline::test_wave_fault_mid_pipeline",
         "TestFaultsMidPipeline::test_persistent_failure_reaches_host_ffd",
         "TestStageTimings::test_wave_split_accumulates_stages"],
        []),
    "test_microloop.py": (
        ["TestMicroloopSingleDevice::test_overlap_runs_exactly_once",
         "TestDonationSafety::test_fault_mid_microloop_rebuilds_donated_state"],
        []),
    "test_trace.py": (
        ["TestTailSampling::test_degraded_device_solve_trace_retained_after_wrap"],
        []),
}
CASES = [(f, f"{f}::{t}") for f, (tests, _) in REPLAYS.items() for t in tests]


@pytest.mark.parametrize("filename,test_id", CASES, ids=[t for _, t in CASES])
def test_wave_and_fault_cases_equal_to_jax(filename, test_id, tmp_path):
    replay.replay(filename, test_id, tmp_path, shims=REPLAYS[filename][1])


def test_replayed_cases_exist():
    for filename, (tests, _) in REPLAYS.items():
        names = set(replay.jax_tests(filename))
        assert {f"{filename}::{t}" for t in tests} <= names


# ---- the per-wave buffers, byte for byte ----

def wave_inputs(pkg, lat, seed=5):
    """About 100 distinct signatures (a seeded numpy mix): plain groups,
    hostname anti-affinity against ``app=web``, hostname spread, and
    hostname affinity to ``app=db``, beside six partly used existing
    nodes, two of them with bound ``db`` and ``web`` pods."""
    A = cases.mod(pkg, "apis")
    wk = cases.mod(pkg, "apis.wellknown")
    O = cases.mod(pkg, "apis.objects")
    P = cases.mod(pkg, "solver.problem")
    T = cases.mod(pkg, "solver.topology")
    R = cases.mod(pkg, "apis.resources").R
    rng = np.random.default_rng(seed)
    host = wk.LABEL_HOSTNAME
    existing = []
    for i in range(6):
        used = np.zeros((R,), np.float32)
        used[0] = float(rng.choice([0, 500, 1500]))
        used[1] = float(rng.choice([0, 1024, 2048]))
        existing.append(P.ExistingBin(
            name=f"n{i}", node_pool="default",
            instance_type=str(rng.choice(["m5.xlarge", "c5.2xlarge",
                                          "m5.2xlarge"])),
            zone=lat.zones[int(rng.integers(lat.Z))],
            capacity_type=str(rng.choice(["spot", "on-demand"])), used=used))
    bound = [T.BoundPod(pod=A.Pod(name="b-db", labels={"app": "db"}),
                        node_name="n0", zone=existing[0].zone),
             T.BoundPod(pod=A.Pod(name="b-web", labels={"app": "web"}),
                        node_name="n1", zone=existing[1].zone)]
    pods = []
    for g in range(100):
        req = {"cpu": f"{100 + 7 * g}m",
               "memory": f"{int(rng.choice([256, 512, 1024, 2048]))}Mi"}
        kw = {"labels": {"app": f"g{g}"}}
        if g % 10 == 0:
            kw["labels"] = {"app": "web"}
            kw["pod_affinity"] = [O.PodAffinityTerm(
                topology_key=host, anti=True,
                label_selector=(("app", "web"),))]
        elif g % 10 == 3:
            kw["topology_spread"] = [O.TopologySpreadConstraint(
                max_skew=1, topology_key=host,
                label_selector=(("app", f"g{g}"),))]
        elif g % 10 == 5:
            kw["pod_affinity"] = [O.PodAffinityTerm(
                topology_key=host, label_selector=(("app", "db"),))]
        n = int(rng.integers(1, 6))
        pods += [A.Pod(name=f"w{g}-{i}", requests=req, **kw)
                 for i in range(n)]
    problem = P.build_problem(pods, [A.NodePool(name="default")], lat,
                              existing=existing, bound_pods=bound)
    return problem


def _recorded(solver):
    """Wrap ``solver``'s two buffer builders; returns the list every built
    buffer is appended to, as (kind, bytes), in build order."""
    out = []
    fused, init = solver._fused_inputs_np, solver._fused_init_np

    def fused_rec(*a, **k):
        buf = fused(*a, **k)
        out.append(("groups", buf.tobytes()))
        return buf

    def init_rec(*a, **k):
        buf = init(*a, **k)
        out.append(("bins", buf.tobytes()))
        return buf

    solver._fused_inputs_np = fused_rec
    solver._fused_init_np = init_rec
    return out


def _nodes(plan):
    return sorted((n.node_pool, n.instance_type, n.zone, n.capacity_type,
                   float(n.price_per_hour), tuple(sorted(n.pods)))
                  for n in plan.new_nodes)


@pytest.mark.parametrize("pipeline", [False, True])
def test_wave_buffers_byte_identical(pipeline):
    from karpenter_provider_aws_tpu.apis import serde
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat = cases.family_lattice(pkg, ("m5", "c5"))
        S = cases.mod(pkg, "solver")
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        solver = S.Solver(lat, pipeline=pipeline, **kw)
        solver.inject_faults(S.FaultInjector(g_limit=32))
        problem = wave_inputs(pkg, lat)
        assert problem.G == 100 and problem.E == 6 and problem.A > 0
        bufs = _recorded(solver)
        plan = solver.solve(problem)
        out[pkg] = (plan, bufs, dict(solver.pipeline_stats))
    (jplan, jbufs, jstats), (tplan, tbufs, tstats) = \
        out[cases.JAX_PKG], out[cases.TORCH_PKG]
    assert tplan.solver_path == jplan.solver_path == "wave-split"
    assert tplan.waves == jplan.waves == 4
    assert [k for k, _ in tbufs] == [k for k, _ in jbufs]
    assert sum(k == "groups" for k, _ in tbufs) == 4
    for i, ((_, a), (_, b)) in enumerate(zip(jbufs, tbufs)):
        assert a == b, f"buffer {i} differs"
    assert _nodes(tplan) == _nodes(jplan)
    assert serde.plan_semantic_dict(tplan) == serde.plan_semantic_dict(jplan)
    assert not any(k.startswith("__wave") for k in tplan.existing_assignments)
    assert tstats["prefetched_waves"] == jstats["prefetched_waves"] \
        == (3 if pipeline else 0)


def test_config7_equal_to_bench():
    """``workloads.config7_highG_wave_split`` is ``bench.py``'s cfg7: the
    same 4,608 pods and pool, G=4608 distinct groups, 5 waves of 1,024."""
    import bench
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem
    jp, jpools, jex = bench.config7_highG_wave_split()
    tp, tpools, tex = workloads.config7_highG_wave_split()
    assert [(p.name, p.requests) for p in tp] == \
        [(p.name, p.requests) for p in jp]
    assert [p.name for p in tpools] == [p.name for p in jpools] == ["default"]
    assert tex == jex == []
    lat = cases.family_lattice(cases.TORCH_PKG, ("m5", "c5"))
    problem = build_problem(tp, tpools, lat)
    assert problem.G == 4608 > Solver(lat, device="cpu")._g_ceiling()
    assert -(-problem.G // Solver._WAVE_G_TARGET) == 5
