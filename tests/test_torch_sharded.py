"""The PyTorch port's pod-axis sharded solve against the JAX package's, on
the CPU: the port's D shards batched on one device against the JAX
package's 8-way virtual CPU mesh (``tests/conftest.py`` forces 8 host
devices).

- Every test of the JAX package's ``tests/test_sharded.py`` is replayed on
  both packages by ``test_torch_replay`` (the two ``slow`` ones stay
  ``slow``): the test's own checks run on each, and the two must return
  equal plans (``serde.plan_semantic_dict``) from every solve, and make
  equal sharded packs: the [D,G] split, the stacked per-shard decode
  buffers byte for byte and the totals (the float32 cost too: the port
  sums in the order of XLA's CPU backend, then shard by shard), and equal
  seeded merge packs (fused input and result bytes).
- ``split_counts`` and ``device_split_counts`` equal the JAX package's on
  seeded counts, with and without whole and shard-0 groups.
- The seeded merge on a problem with existing bins, bound pods and
  affinity classes: every merge's input and result bytes, every shard
  buffer and the plans equal the JAX package's.
- Sharded packs whose every bin is live at its own price give the JAX
  package's float32 cost bit for bit, for a bin table of 32 (summed in
  the fused loop's 8 lanes) and of 128 to 1024 (blocks of 32).
- The consolidation engine flags co-located and shard-0 pinned groups on a
  mesh (``pinned groups on mesh``) as the JAX package's does.

Tolerance: none anywhere.
"""

import numpy as np
import pytest

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_sharded.py"
NOT_REPLAYED = {}
SLOW = {"test_sharded.py::TestShardedScale::test_16k_pod_parity_and_conservation",
        "test_sharded.py::TestShardedScale::test_16k_selector_group_isolation_across_shards"}


def _cases():
    out = []
    for test_id, params in replay.parametrized(
            FILE, replay.replayed(FILE, NOT_REPLAYED)):
        name = test_id + (f"[{','.join(map(str, params.values()))}]"
                          if params else "")
        marks = [pytest.mark.slow] if test_id in SLOW else []
        out.append(pytest.param(test_id, params, id=name, marks=marks))
    return out


@pytest.mark.parametrize("test_id,params", _cases())
def test_sharded_equal_to_jax(test_id, params, tmp_path):
    replay.replay(FILE, test_id, tmp_path, plans=True, buffers=True,
                  params=params)


def test_sharded_replays_cover_the_jax_tests():
    """Every test of test_sharded.py is replayed, the slow ones slow."""
    names = replay.jax_tests(FILE)
    assert len(names) == 13
    assert set(replay.replayed(FILE, NOT_REPLAYED)) == set(names)
    assert SLOW <= set(names)


# ---- the split, on the host and on the device ----

@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_counts_equal_to_jax(D, seed):
    from karpenter_provider_aws_tpu.parallel import sharded as js
    from karpenter_provider_aws_tpu_torch.parallel import sharded as ts
    rng = np.random.default_rng(seed)
    G = 32
    count = rng.integers(0, 500, G).astype(np.int32)
    count[-5:] = 0
    keep = rng.random(G) < 0.2
    pin = keep & (rng.random(G) < 0.5)
    for kw in ({}, {"keep_whole": keep}, {"keep_whole": keep, "pin_shard0": pin}):
        j = js.split_counts(count, D, **kw)
        t = ts.split_counts(count, D, **kw)
        assert t.dtype == j.dtype and np.array_equal(t, j)
        assert np.array_equal(ts.shard_groups(t), js.shard_groups(j))


@pytest.mark.parametrize("D", [2, 8])
def test_device_split_counts_equal_to_jax(D):
    """The microloop's on-device split, read from the fused group buffer
    at its ``count`` offset (an unaligned slice included), equals the JAX
    package's and the host split."""
    import jax.numpy as jnp
    import torch
    from karpenter_provider_aws_tpu.parallel import sharded as js
    from karpenter_provider_aws_tpu_torch.ops import binpack as tb
    from karpenter_provider_aws_tpu_torch.parallel import sharded as ts
    tprob = cases.problem(cases.TORCH_PKG, "random-1")
    lat = cases.small_lattice(cases.TORCH_PKG)
    solver = cases.mod(cases.TORCH_PKG, "solver").Solver(lat, device="cpu")
    G = 32
    buf = solver._fused_inputs_np(tprob, G)
    layout, _ = tb.group_layout(G, lat.T, lat.Z, lat.C, max(tprob.NP, 1),
                                max(tprob.A, 1), lat.alloc.shape[1])
    off = next(f.offset for f in layout if f.name == "count")
    j = np.asarray(js.device_split_counts(jnp.asarray(buf), D, off, G))
    t = ts.device_split_counts(torch.from_numpy(buf), D, off, G)
    count = np.zeros((G,), np.int32)
    count[: tprob.G] = tprob.count
    assert t.dtype == torch.int32
    assert np.array_equal(t.numpy(), j)
    assert np.array_equal(j, js.split_counts(count, D))
    shifted = np.concatenate([np.zeros((1,), np.uint8), buf])
    t1 = ts.device_split_counts(torch.from_numpy(shifted)[1:], D, off, G)
    assert np.array_equal(t1.numpy(), j)


# ---- the seeded merge, byte for byte ----

def test_seeded_merge_bytes_equal_to_jax(tmp_path):
    """About 100 signatures beside six partly used existing nodes, two with
    bound pods that seed affinity classes (``test_torch_waves``'s seeded
    problem), solved on an 8-shard mesh by each package, sequential and
    pipelined: every sharded pack (split, buffers, totals), every seeded
    merge (its fused input: the merge counts and the seed table of
    existing and kept bins; its result) and the plans are equal. At least
    one merge runs with existing bins in its seed."""
    import test_torch_waves as waves
    obs = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat = cases.small_lattice(pkg)
        problem = waves.wave_inputs(pkg, lat)
        assert problem.E == 6 and problem.A > 0
        S = cases.mod(pkg, "solver")
        plan_mesh = cases.mod(pkg, "parallel").plan_mesh
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        with replay.recording(pkg, plans=True, buffers=True) as made:
            for pipeline in (False, True):
                mesh = plan_mesh("8", **kw).mesh
                S.Solver(lat, pipeline=pipeline, mesh=mesh, **kw).solve(problem)
        obs[pkg] = [(k, o) for k, o in made
                    if k in (replay.PLANS, replay.BUFFERS)]
    j, t = obs[cases.JAX_PKG], obs[cases.TORCH_PKG]
    assert [k for k, _ in t] == [k for k, _ in j]
    for (_, a), (_, b) in zip(j, t):
        assert b == a
    seeded = [o for k, o in t if k == replay.BUFFERS and o[0] == "seeded"]
    assert len(seeded) >= 2
    plans = [o for k, o in t if k == replay.PLANS]
    assert len(plans) == 2 and plans[0] == plans[1]


# ---- the reduction order ----

@pytest.mark.parametrize("D,B", [(8, 32), (8, 128), (2, 512), (2, 1024)])
def test_sharded_pack_totals_equal_to_jax(D, B):
    """One pod a node (hostname anti-affinity across 60 sizes of 40 pods
    each, so every bin of every shard is live at its own price; the bins
    past B overflow into leftover): both packages' sharded packs at the
    same split and B give equal decode buffers, node and leftover counts,
    and the float32 cost bit for bit. B=32 is summed in the fused loop's 8
    lanes, longer tables in blocks of 32 (``_xla_sum_f32``)."""
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        A = cases.mod(pkg, "apis")
        O = cases.mod(pkg, "apis.objects")
        wk = cases.mod(pkg, "apis.wellknown")
        P = cases.mod(pkg, "parallel")
        S = cases.mod(pkg, "solver")
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        lat = cases.family_lattice(pkg, ("m5", "c5", "r5", "m6g", "c6g"))
        rng = np.random.default_rng(1)
        pods = []
        for g in range(60):
            req = {"cpu": f"{int(rng.integers(100, 3000))}m",
                   "memory": f"{int(rng.integers(128, 6000))}Mi"}
            pods += [A.Pod(name=f"g{g}-{i}", labels={"app": "x"}, requests=req,
                           pod_affinity=[O.PodAffinityTerm(
                               topology_key=wk.LABEL_HOSTNAME, anti=True,
                               label_selector=(("app", "x"),))])
                     for i in range(40)]
        problem = S.build_problem(pods, [A.NodePool(name="default")], lat)
        solver = S.Solver(lat, **kw)
        G = 64
        count = np.zeros((G,), np.int32)
        count[: problem.G] = problem.count
        sp = P.sharded_pack(P.plan_mesh(str(D), **kw).mesh, solver._alloc,
                            solver._avail, solver._price,
                            solver._fused_inputs(problem, G), None, 0,
                            P.split_counts(count, D), B, G, lat.T, lat.Z,
                            lat.C, 1, max(problem.A, 1))
        out[pkg] = (replay._host(sp.packed).tobytes(),
                    np.float32(replay._host(sp.total_cost)).tobytes(),
                    int(sp.total_nodes), int(sp.total_leftover))
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG]
    assert out[cases.TORCH_PKG][2] == min(D * B, 2400)


# ---- the consolidation engine's envelope ----

def test_pinned_groups_on_mesh_flagged_like_jax():
    """``_vmap_ineligible`` of a consolidation engine whose Solver runs an
    8-shard mesh: a co-located (single-bin) group and a group that needs
    an existing bin's presence are outside the batched probe's envelope
    (``pinned groups on mesh``), a plain group is not, and without a mesh
    none is; the same verdicts in both packages."""
    import test_torch_waves as waves
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        A = cases.mod(pkg, "apis")
        O = cases.mod(pkg, "apis.objects")
        wk = cases.mod(pkg, "apis.wellknown")
        P = cases.mod(pkg, "solver.problem")
        S = cases.mod(pkg, "solver")
        C = cases.mod(pkg, "solver.consolidate")
        plan_mesh = cases.mod(pkg, "parallel").plan_mesh
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        lat = cases.small_lattice(pkg)
        pools = [A.NodePool(name="default")]
        colocated = P.build_problem(
            [A.Pod(name=f"aff{i}", labels={"app": "aff"},
                   requests={"cpu": "500m", "memory": "512Mi"},
                   pod_affinity=[O.PodAffinityTerm(
                       topology_key=wk.LABEL_HOSTNAME, anti=False,
                       label_selector=(("app", "aff"),))])
             for i in range(4)], pools, lat)
        plain = cases.problem(pkg, "generic")
        needs = waves.wave_inputs(pkg, lat)
        assert colocated.single_bin.any() and needs.g_need.any()
        verdicts = []
        for mesh in (plan_mesh("8", **kw).mesh, None):
            solver = S.Solver(lat, mesh=mesh, **kw)
            eng = C.ConsolidationEngine(None, solver, {}, None)
            verdicts.append([eng._vmap_ineligible(p)
                             for p in (colocated, needs, plain)])
        out[pkg] = verdicts
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG] == [
        ["pinned groups on mesh", "pinned groups on mesh", ""], ["", "", ""]]
