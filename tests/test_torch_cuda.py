"""Tests of the PyTorch port that need an NVIDIA card (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false. This file imports
neither jax nor the JAX package, so it runs on a machine with only the
port's dependencies; there, skip the repository's conftest (which pins
jax to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: none. The kernel must give the same indices and the same
finite values as its plain version, and the pack on the card the same
result bytes as the pack on the CPU.
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu_torch import convert
from karpenter_provider_aws_tpu_torch.apis import NodePool, Pod
from karpenter_provider_aws_tpu_torch.lattice import build_catalog, build_lattice
from karpenter_provider_aws_tpu_torch.ops import binpack as tb
from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
from karpenter_provider_aws_tpu_torch.solver import Solver
from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_case(rng, B, T, ZC):
    tm = rng.random((B, T)) < 0.4
    zc = rng.random((B, ZC)) < 0.6
    pr = (rng.random((T, ZC)) + 0.01).astype(np.float32)
    pr[rng.random((T, ZC)) < 0.2] = np.inf
    return tm, zc, pr


@pytest.mark.parametrize("B,T,ZC", [(2048, 759, 10), (300, 37, 10),
                                    (129, 200, 130), (64, 6000, 10), (1, 1, 1)])
def test_kernel_matches_plain(cuda, B, T, ZC):
    args = [torch.from_numpy(a).to(cuda)
            for a in random_case(np.random.default_rng(B + T), B, T, ZC)]
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
