"""The PyTorch port's pipelined solve path against the JAX package's, on
the CPU: ``StageTimer``, ``ResidentInputCache``, ``plan_changed``,
``fetch_async``, and ``Solver(pipeline=True/False)`` plans.

Inputs are seeded numpy buffers and the ``test_torch_cases`` problems.
Tolerance: none. Cache contents are compared byte for byte after every
upload and every ``stats()`` counter must be equal; plans must have equal
``serde.plan_semantic_dict``, equal ``pipelined`` flags, equal link
accounting.
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.apis import serde
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu.solver import pipeline as jpipe
from karpenter_provider_aws_tpu_torch.solver import Solver as TorchSolver
from karpenter_provider_aws_tpu_torch.solver import pipeline as tpipe

import test_torch_cases as cases
from test_torch_solver import PLAN_CASES

CPU = "cpu"


# ---- the resident input cache -------------------------------------------

def _bufs(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8) for _ in range(n)]


def _seq_cold_and_reupload():
    a, = _bufs(1, 1, 10_000)
    return [(("g", 16, a.size), a, False), (("g", 16, a.size), a.copy(), False)]


def _seq_sparse_change():
    a, = _bufs(2, 1, 50_000)
    out = [(("g", 32, a.size), a, False)]
    for i, pos in enumerate((3, 4097, 30_000, 49_999)):
        b = out[-1][1].copy()
        b[pos] ^= 0xFF
        b[(pos * 7) % b.size] ^= 0x0F
        out.append((("g", 32, a.size), b, False))
    return out


def _seq_bulk_change():
    a, b = _bufs(3, 2, 40_000)
    return [(("g", 8, a.size), a, False), (("g", 8, a.size), b, False),
            (("g", 8, a.size), b, False)]


def _seq_layout_growth():
    a, = _bufs(4, 1, 9_000)
    big, = _bufs(5, 1, 20_000)
    small = big[:9_000].copy()
    return [(("g", 16), a, False), (("g", 16), big, False),
            (("g", 16), small, False), (("g", 16), small, False)]


def _seq_key_collision():
    """Two different problems under one key: a collision costs a full
    upload (bulk) or a delta against the true previous content."""
    a, b = _bufs(6, 2, 12_288)
    c = a.copy()
    c[5] ^= 1
    return [(("g", 16, a.size), a, False), (("g", 16, a.size), b, False),
            (("g", 16, a.size), c, False), (("g", 16, a.size), a, False)]


def _seq_donated():
    a, = _bufs(7, 1, 30_000)
    out = [(("m", 1, 32, 512, a.size), a, True)]
    for pos in (10, 20_000, 10, 29_999):
        b = out[-1][1].copy()
        b[pos] = (int(b[pos]) + 1) % 256
        out.append((("m", 1, 32, 512, a.size), b, True))
    out.append((out[-1][0], out[-1][1], True))
    return out


def _seq_eviction_bound():
    bufs = _bufs(8, 5, 5_000)
    out = [((f"k{i}",), b, False) for i, b in enumerate(bufs)]
    # revisit: the admitted keys delta-hit, the bypassed ones upload whole
    out += [((f"k{i}",), b, False) for i, b in enumerate(bufs)]
    return out


CACHE_SEQS = {
    "cold_and_identical_reupload": (_seq_cold_and_reupload, {}),
    "sparse_change": (_seq_sparse_change, {}),
    "bulk_change": (_seq_bulk_change, {}),
    "layout_growth": (_seq_layout_growth, {}),
    "key_collision": (_seq_key_collision, {}),
    "donated": (_seq_donated, {}),
    "eviction_bound": (_seq_eviction_bound, {"max_entries": 3}),
    "small_blocks": (_seq_sparse_change, {"block": 512}),
}


class TestResidentInputCache:
    @pytest.mark.parametrize("name", list(CACHE_SEQS))
    def test_same_contents_and_counters(self, name):
        make, kw = CACHE_SEQS[name]
        jc = jpipe.ResidentInputCache(**kw)
        tc = tpipe.ResidentInputCache(device=CPU, **kw)
        jlegs, tlegs = [], []
        jc.account = lambda d, n: jlegs.append((d, n))
        tc.account = lambda d, n: tlegs.append((d, n))
        for key, buf, donate in make():
            jd = jc.upload(key, buf, donate=donate)
            td = tc.upload(key, buf, donate=donate)
            assert isinstance(td, torch.Tensor) and td.dtype == torch.uint8
            assert np.array_equal(td.numpy(), buf)
            assert np.array_equal(td.numpy(), np.asarray(jd))
            assert tc.stats() == jc.stats()
            assert tc.headroom_probe() == jc.headroom_probe()
        assert tlegs == jlegs
        assert tc.stats()["bytes_shipped"] == sum(n for _, n in tlegs)

    def test_donated_scatter_is_in_place(self):
        """One device address for the key's life; the non-donated scatter
        writes a new buffer instead."""
        a, = _bufs(9, 1, 20_000)
        b = a.copy()
        b[100] ^= 0xFF
        for donate in (True, False):
            tc = tpipe.ResidentInputCache(device=CPU)
            d1 = tc.upload(("k",), a, donate=donate)
            ptr, before = d1.data_ptr(), d1.clone()
            d2 = tc.upload(("k",), b, donate=donate)
            assert tc.stats()["blocks_shipped"] == 1
            assert np.array_equal(d2.numpy(), b)
            assert (d2.data_ptr() == ptr) is donate
            # the old view sees the new bytes only when scattered in place
            assert torch.equal(d1, d2 if donate else before)

    def test_resident_copy_never_aliases_the_host_copy(self):
        a, = _bufs(10, 1, 8192)
        tc = tpipe.ResidentInputCache(device=CPU)
        d = tc.upload(("k",), a)
        a[0] ^= 0xFF          # the caller reuses its buffer
        assert d[0].item() != a[0]
        assert tc.upload(("k",), a).numpy()[0] == a[0]

    def test_invalidate_and_sharding(self):
        a, = _bufs(11, 1, 4096)
        tc = tpipe.ResidentInputCache(device=CPU)
        tc.upload(("k",), a)
        tc.invalidate()
        tc.upload(("k",), a)
        assert tc.stats()["misses"] == 2
        # a mesh's shared placement: stored once on the cache's device,
        # delta-served like any other entry under its shard-count key
        from karpenter_provider_aws_tpu_torch.parallel import plan_mesh
        from karpenter_provider_aws_tpu_torch.parallel.sharded import (
            replicated_sharding)
        repl = replicated_sharding(plan_mesh("8", device=CPU).mesh)
        d = tc.upload(("g", 8), a, sharding=repl)
        assert np.array_equal(d.numpy(), a)
        tc.upload(("g", 8), a, sharding=repl)
        assert (tc.stats()["misses"], tc.stats()["hits"]) == (3, 1)
        with pytest.raises(ValueError):
            tc.upload(("k",), a, sharding=object())


# ---- fingerprint, fetch, stage timer --------------------------------------

class TestFingerprintAndFetch:
    @pytest.mark.parametrize("kind", ["equal", "one_byte", "last_byte",
                                      "shape", "none"])
    def test_plan_changed_equal(self, kind):
        rng = np.random.default_rng(12)
        a = rng.integers(0, 256, (64, 37), dtype=np.uint8)
        b = a.copy()
        if kind == "one_byte":
            b[5, 3] ^= 1
        elif kind == "last_byte":
            b[-1, -1] ^= 0x80
        elif kind == "shape":
            b = a[:63].copy()
        want = jpipe.plan_changed(jpipe.jnp.asarray(b),
                                  None if kind == "none" else jpipe.jnp.asarray(a))
        got = tpipe.plan_changed(torch.from_numpy(b),
                                 None if kind == "none" else torch.from_numpy(a))
        assert got is want
        assert got is (kind != "equal")

    def test_fetch_async_on_cpu_is_a_copy(self):
        t = torch.arange(10, dtype=torch.uint8)
        host = tpipe.fetch_async(t).wait()
        assert isinstance(host, np.ndarray) and np.array_equal(host, t.numpy())
        t[0] = 99
        assert host[0] == 0

    def test_stage_timer_accumulates_and_merges(self):
        outs = []
        for mod in (jpipe, tpipe):
            t = mod.StageTimer()
            t.add("upload", 0.001)
            t.add("upload", 0.002)
            t.merge({"upload": 1.0, "decode": 2.0})
            outs.append(t.ms)
        assert outs[0] == outs[1]
        assert tpipe.STAGES == jpipe.STAGES


# ---- the pipelined and sequential Solver ---------------------------------

_SOLVERS = {}


def _solvers(pipeline):
    if pipeline not in _SOLVERS:
        _SOLVERS[pipeline] = (
            JaxSolver(cases.small_lattice(cases.JAX_PKG), pipeline=pipeline),
            TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU,
                        pipeline=pipeline))
    return _SOLVERS[pipeline]


class TestSolverPaths:
    @pytest.mark.parametrize("pipeline", [True, False])
    @pytest.mark.parametrize("case", PLAN_CASES)
    def test_plan_equal_to_jax(self, case, pipeline):
        js, ts = _solvers(pipeline)
        _, jpods, jpools, jkw = cases.build(cases.JAX_PKG, case)
        _, tpods, tpools, tkw = cases.build(cases.TORCH_PKG, case)
        j0, t0 = dict(js.link_stats), dict(ts.link_stats)
        jplan = js.solve_relaxed(jpods, jpools, **jkw)
        tplan = ts.solve_relaxed(tpods, tpools, **tkw)
        assert serde.plan_semantic_dict(tplan) == serde.plan_semantic_dict(jplan)
        assert tplan.pipelined is jplan.pipelined is pipeline
        assert ({k: ts.link_stats[k] - t0[k] for k in t0}
                == {k: js.link_stats[k] - j0[k] for k in j0})
        assert set(tplan.stage_ms) == set(tpipe.STAGES)

    @pytest.mark.parametrize("case", ["generic", "existing", "anti_wide"])
    def test_pipelined_equals_sequential_and_engages_the_cache(self, case):
        lat = cases.small_lattice(cases.TORCH_PKG)
        seq = TorchSolver(lat, device=CPU, pipeline=False)
        pip = TorchSolver(lat, device=CPU)
        prob = cases.problem(cases.TORCH_PKG, case)
        want = serde.plan_semantic_dict(seq.solve(prob))
        for _ in range(2):
            assert serde.plan_semantic_dict(pip.solve(prob)) == want
        st = pip.stats()
        assert st["pipeline"] is True and st["async_solves"] == 2
        # the second solve re-uploaded nothing: every entry delta-hit
        assert st["resident_hits"] >= 1 and st["resident_blocks_shipped"] == 0
        assert seq.stats()["resident_misses"] == 0

    def test_default_is_pipelined_and_toggles(self):
        lat = cases.small_lattice(cases.TORCH_PKG)
        ts = TorchSolver(lat, device=CPU)
        assert ts.pipeline is True and TorchSolver.supports_delta is True
        prob = cases.problem(cases.TORCH_PKG, "generic")
        assert ts.solve(prob).pipelined
        ts.set_pipeline(False)
        assert not ts.solve(prob).pipelined
        assert ts.stats()["async_solves"] == 1

    def test_stats_keys_are_the_jax_packages_minus_the_unported(self):
        js, ts = _solvers(True)
        jkeys, tkeys = set(js.stats()), set(ts.stats())
        # the one key the port adds (a settled seam): the Solver's device,
        # which kpctl top's SOLVER row names
        assert tkeys - jkeys == {"device"} and ts.stats()["device"] == "cpu"
        tkeys.discard("device")
        missing = {k for k in jkeys - tkeys if not k.startswith("degraded_")}
        assert missing == set() and ts.stats()["faults_injected"] is False
        # one device: the mesh keys report a single-device solver
        assert (ts.stats()["mesh_devices"], ts.stats()["mesh_shard_imbalance"]) \
            == (js.stats()["mesh_devices"], js.stats()["mesh_shard_imbalance"]) \
            == (1, 0.0)
        assert set(ts.pipeline_stats) == set(js.pipeline_stats)
