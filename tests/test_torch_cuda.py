"""Tests of the PyTorch port that need an NVIDIA card (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false. This file imports
neither jax nor the JAX package, so it runs on a machine with only the
port's dependencies; there, skip the repository's conftest (which pins
jax to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: none. The kernel must give the same indices and the same
finite values as its plain version, and the pack on the card the same
result bytes as the pack on the CPU. The one exception is the batched
probe's ``new_cost``, a float32 sum over bins that the card reduces in
another order than the CPU: within 1e-6 relative (its counts are exact).
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch import convert
from karpenter_provider_aws_tpu_torch.apis import NodePool, Pod
from karpenter_provider_aws_tpu_torch.lattice import build_catalog, build_lattice
from karpenter_provider_aws_tpu_torch.ops import binpack as tb
from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
from karpenter_provider_aws_tpu_torch.ops import offering_cases
from karpenter_provider_aws_tpu_torch.solver import Solver
from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


KERNEL_CASES = offering_cases.kernel_cases()


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_matches_plain(cuda, case):
    args = [torch.from_numpy(a).to(cuda) for a in KERNEL_CASES[case]()]
    before = oa.LAUNCHES
    kv, ki = oa.cheapest_offering(*args)
    rv, ri = oa.cheapest_offering_ref(*args)
    torch.cuda.synchronize()
    assert oa.LAUNCHES == before + 1
    assert torch.equal(ki, ri)
    fin = torch.isfinite(rv)
    assert torch.equal(kv[fin], rv[fin])
    assert not torch.isfinite(kv[~fin]).any()


def _small_problem():
    lat = build_lattice([s for s in build_catalog()
                         if s.family in ("m5", "c5", "m6g", "t3")])
    shapes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi")]
    pods = [Pod(name=f"p{i}", requests={"cpu": shapes[i % 4][0],
                                        "memory": shapes[i % 4][1]})
            for i in range(300)]
    return lat, pods, [NodePool(name="default")]


@pytest.mark.parametrize("lean", [True, False])
def test_pack_bytes_equal_cpu(cuda, lean):
    lat, pods, pools = _small_problem()
    prob = build_problem(pods, pools, lat)
    s = Solver(lat, device="cpu")
    G, B = 16, 512
    gbuf = s._fused_inputs_np(prob, G)
    outs = []
    for dev in ("cpu", cuda):
        outs.append(tb.pack_packed_efused(
            *convert.lattice_tensors(lat, dev), convert.fused_buffer(gbuf, dev),
            None, 0, B, G, lat.T, lat.Z, lat.C, 1, 1, lean=lean).cpu().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_solver_on_the_card_equals_cpu(cuda):
    lat, pods, pools = _small_problem()
    gpu = Solver(lat)
    assert gpu.device.type == "cuda"
    oa.LAUNCHES = 0
    plan = gpu.solve_relaxed(pods, pools)
    assert oa.LAUNCHES >= 1
    ref = Solver(lat, device="cpu").solve_relaxed(pods, pools)
    rows = [(n.instance_type, n.zone, n.capacity_type, sorted(n.pods))
            for n in plan.new_nodes]
    assert rows == [(n.instance_type, n.zone, n.capacity_type, sorted(n.pods))
                    for n in ref.new_nodes]
    assert not plan.unschedulable


def test_existing_bins_and_affinity_on_the_card(cuda):
    """The combined upload (groups + existing bins, whose fields sit
    unaligned after the split), the one-hot existing-bin masks and the
    affinity-class state, on the card against the CPU."""
    from karpenter_provider_aws_tpu_torch.apis import wellknown as wk
    from karpenter_provider_aws_tpu_torch.apis.objects import PodAffinityTerm
    from karpenter_provider_aws_tpu_torch.apis.resources import R
    from karpenter_provider_aws_tpu_torch.solver.problem import ExistingBin
    lat, pods, pools = _small_problem()
    existing = [ExistingBin(name=f"e{i}", node_pool="default",
                            instance_type="m5.xlarge", zone=lat.zones[i % lat.Z],
                            capacity_type="on-demand",
                            used=np.zeros((R,), np.float32)) for i in range(5)]
    pods = pods[:120] + [
        Pod(name=f"a{i}", labels={"app": "solo"},
            requests={"cpu": "250m", "memory": "512Mi"},
            pod_affinity=[PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME,
                                          anti=True,
                                          label_selector=(("app", "solo"),))])
        for i in range(40)]
    plans = [Solver(lat, device=d).solve_relaxed(pods, pools, existing=existing)
             for d in (cuda, "cpu")]
    rows = [[(n.instance_type, n.zone, n.capacity_type, sorted(n.pods))
             for n in p.new_nodes] for p in plans]
    assert rows[0] == rows[1]
    assert plans[0].existing_assignments == plans[1].existing_assignments
    assert plans[0].existing_assignments and not plans[0].unschedulable


def test_steady_state_on_the_card_equals_cpu(cuda):
    """The steady-state sequence (incremental builds, solve_delta with the
    resident in-place scatter, the fingerprint and the async fetch) on the
    card: every pass's plan, counters and link accounting equal the CPU
    run's, and every pass launches the kernel."""
    import test_torch_cases as cases
    from karpenter_provider_aws_tpu_torch.solver.incremental import (
        IncrementalProblemBuilder)
    lat = cases.small_lattice(cases.TORCH_PKG)
    runs = []
    for dev in (cuda, "cpu"):
        solver, builder, out = Solver(lat, device=dev), IncrementalProblemBuilder(), []
        for pods, pools, ex, dirty, touched in cases.churn_sequence(cases.TORCH_PKG, lat):
            res = builder.build(pods, pools, lat, existing=ex, dirty=dirty,
                                touched=touched)
            before = oa.LAUNCHES
            if res.incremental:
                plan = solver.solve_delta(res.problem, dirty_groups=res.dirty_groups)
            else:
                plan = solver.solve(res.problem)
                solver.solve_delta(res.problem)
            launched = oa.LAUNCHES - before
            out.append(([(n.instance_type, n.zone, n.capacity_type, n.pods)
                         for n in plan.new_nodes], plan.existing_assignments,
                        plan.unschedulable, dict(solver.pipeline_stats),
                        dict(solver.link_stats), launched))
        runs.append(out)
    for step, (card, host) in enumerate(zip(*runs)):
        assert card[:5] == host[:5], f"step {step}"
        assert card[5] >= 1 and host[5] == 0
    assert runs[0][-1][3]["micro_skipped_syncs"] >= 1
    assert runs[0][-1][3]["micro_aborts"] == 0


def test_provisioner_on_the_card(cuda):
    """A few pods through ``Provisioner.provision_once`` on the card: the
    pass launches the kernel, is not degraded, and its claims, and the
    pods registration binds, equal a CPU stack's."""
    from karpenter_provider_aws_tpu_torch import workloads
    lat = build_lattice([s for s in build_catalog()
                         if s.family in ("m5", "c5", "m6g", "t3")])
    outs = []
    for dev in (cuda, "cpu"):
        stack = workloads.ProvisionerStack(lat, [NodePool(name="default")],
                                           Solver(lat, device=dev))
        for i in range(12):
            stack.cluster.add_pod(Pod(name=f"p{i}", requests={
                "cpu": ("250m", "1", "2")[i % 3], "memory": "1Gi"}))
        before = oa.LAUNCHES
        result, _ = stack.provision()
        launched = oa.LAUNCHES - before
        stack.register()
        assert not result.degraded and result.plan.solver_path == "device"
        assert result.pods_unschedulable == 0 and result.launch_failures == 0
        assert not stack.cluster.pending_pods()
        outs.append((launched,
                     sorted((c.name, c.instance_type, c.zone, c.capacity_type)
                            for c in stack.cluster.claims.values()),
                     sorted((p.name, p.node_name)
                            for p in stack.cluster.pods.values())))
    assert outs[0][0] >= 1 and outs[1][0] == 0
    assert outs[0][1:] == outs[1][1:]


def test_kernel_over_flattened_probe_batch(cuda):
    """One launch over the batched probe's largest flattened bin table
    (32 probes x 1,024 bins against one shared price panel)."""
    tm, zc, pr = (torch.from_numpy(a).to(cuda)
                  for a in offering_cases.probe_case())
    assert tm.shape[0] == offering_cases.PROBE_K * offering_cases.PROBE_B
    before = oa.LAUNCHES
    kv, ki = oa.cheapest_offering(tm, zc, pr)
    rv, ri = oa.cheapest_offering_ref(tm, zc, pr)
    torch.cuda.synchronize()
    assert oa.LAUNCHES == before + 1
    assert torch.equal(ki, ri)
    fin = torch.isfinite(rv)
    assert torch.equal(kv[fin], rv[fin])
    assert not torch.isfinite(kv[~fin]).any()


def test_probe_batch_on_the_card_equals_cpu(cuda):
    """``probe_batch`` on the card launches the kernel once for the whole
    batch and its [K,6] summary equals the CPU Solver's on the same
    problems: probes with different counts of existing bins, one without,
    and one infeasible."""
    from karpenter_provider_aws_tpu_torch.apis.resources import R
    from karpenter_provider_aws_tpu_torch.solver.problem import ExistingBin
    lat, pods, pools = _small_problem()
    existing = [ExistingBin(name=f"e{i}", node_pool="default",
                            instance_type=("m5.xlarge", "c5.2xlarge")[i % 2],
                            zone=lat.zones[i % lat.Z], capacity_type="on-demand",
                            used=np.zeros((R,), np.float32)) for i in range(8)]
    problems = [build_problem(pods[: 20 * (k + 1)], pools, lat,
                              existing=existing[: 2 * k]) for k in range(5)]
    problems.append(build_problem([Pod(name="huge", requests={"cpu": "10000"})],
                                  pools, lat))
    out = []
    for dev in (cuda, "cpu"):
        solver = Solver(lat, device=dev)
        before = oa.LAUNCHES
        res = solver.probe_batch(problems)
        out.append((oa.LAUNCHES - before, res, solver.last_probe["summary"]))
    (gl, gres, gsum), (cl, cres, csum) = out
    assert gl == 1 and cl == 0
    assert [(r.feasible, r.n_new, r.new_cap_type, r.flex) for r in gres] == \
        [(r.feasible, r.n_new, r.new_cap_type, r.flex) for r in cres]
    np.testing.assert_array_equal(np.delete(gsum, 2, axis=1),
                                  np.delete(csum, 2, axis=1))
    np.testing.assert_allclose(gsum[:, 2], csum[:, 2], rtol=1e-6, atol=0.0)
    assert not gres[-1].feasible and any(r.feasible for r in gres)
