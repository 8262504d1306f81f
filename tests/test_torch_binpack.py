"""The PyTorch port's grouped-FFD pack against the JAX package's.

The JAX package's own ``build_problem`` output is padded by its own Solver
helpers and carried across with ``convert.py``, so both packs see identical
inputs. Every PackResult field, and the lean and full fused result bytes,
must be exactly equal: both run the same float32 / int32 arithmetic in the
same order, so no tolerance is allowed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_provider_aws_tpu.ops import binpack as jb
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu.solver.solve import _B_BUCKETS as J_B_BUCKETS
from karpenter_provider_aws_tpu.solver.solve import _G_BUCKETS as J_G_BUCKETS
from karpenter_provider_aws_tpu.solver.solve import _bucket
from karpenter_provider_aws_tpu_torch import convert
from karpenter_provider_aws_tpu_torch.ops import binpack as tb
from karpenter_provider_aws_tpu_torch.solver import Solver as TorchSolver

import test_torch_cases as cases

CPU = "cpu"
CASES = ("generic", "selectors_taints", "affinity", "existing")

_SOLVERS = {}


def jax_solver():
    s = _SOLVERS.get("jax")
    if s is None:
        s = _SOLVERS["jax"] = JaxSolver(cases.small_lattice(cases.JAX_PKG),
                                        pipeline=False)
    return s


def staged(case, B=None):
    """(jax problem, G, B) at the solver's own buckets unless B is given."""
    s = jax_solver()
    prob = cases.problem(cases.JAX_PKG, case)
    G = _bucket(prob.G, J_G_BUCKETS)
    if B is None:
        B = s._b_budget_single(prob, G)[1]
    return prob, G, B


def lattice_args(lat, device=CPU):
    return convert.lattice_tensors(lat, device)


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_results_equal(jres, tres):
    for name in ("assign", "leftover", "chosen_t", "chosen_z", "chosen_c",
                 "chosen_price"):
        np.testing.assert_array_equal(np_of(getattr(tres, name)),
                                      np_of(getattr(jres, name)), err_msg=name)
    for name in jb.BinState._fields:
        np.testing.assert_array_equal(np_of(getattr(tres.state, name)),
                                      np_of(getattr(jres.state, name)),
                                      err_msg=f"state.{name}")


def run_both_packs(case, B=None):
    s = jax_solver()
    prob, G, B = staged(case, B)
    lat = s.lattice
    groups = s._padded_groups(prob, G)
    pools = s._pool_params(prob)
    init = s._init_state(prob, B, A=max(prob.A, 1))
    jres = jb.pack(s._alloc, s._avail, s._price, groups, pools, init)
    tres = tb.pack(*lattice_args(lat),
                   convert.named_tensors(tb.GroupBatch, groups, CPU),
                   convert.named_tensors(tb.PoolParams, pools, CPU),
                   convert.named_tensors(tb.BinState, init, CPU))
    return prob, jres, tres


class TestPackParity:
    @pytest.mark.parametrize("case", CASES)
    def test_every_field_equal(self, case):
        prob, jres, tres = run_both_packs(case)
        assert_results_equal(jres, tres)
        assert int(tres.state.npods.sum()) > 0

    @pytest.mark.parametrize("seed", range(6))
    def test_random_sweep(self, seed):
        """Seeded random mixes of shapes, pools, existing nodes and
        hostname rules, at the solver's own buckets and at a bin table
        small enough to overflow."""
        case = f"random-{seed}"
        prob, jres, tres = run_both_packs(case)
        assert_results_equal(jres, tres)
        prob, jres, tres = run_both_packs(case, B=max(prob.E + 1, 4))
        assert_results_equal(jres, tres)

    def test_forced_overflow(self):
        """A bin table far too small: leftover with next_open >= B, and
        both packs agree on every field of the clamped result."""
        prob, jres, tres = run_both_packs("affinity", B=4)
        assert int(tres.leftover.sum()) > 0
        assert int(tres.state.next_open) >= 4
        assert_results_equal(jres, tres)

    def test_cases_cover_the_pack_features(self):
        """The inputs above reach every feature the parity claims: existing
        bins, affinity classes, single-bin groups, hostname-spread caps."""
        aff = cases.problem(cases.JAX_PKG, "affinity")
        ex = cases.problem(cases.JAX_PKG, "existing")
        assert ex.E > 0 and ex.g_need.any()
        assert aff.A > 0 and aff.g_owner.any() and aff.single_bin.any()
        assert (aff.g_spread >= 0).any()
        assert (aff.max_per_bin < np.iinfo(np.int32).max).any()


class TestFusedBytes:
    @pytest.mark.parametrize("lean", [True, False])
    @pytest.mark.parametrize("case", CASES)
    def test_efused_result_bytes(self, case, lean):
        s = jax_solver()
        prob, G, B = staged(case)
        lat = s.lattice
        NP, A = max(prob.NP, 1), max(prob.A, 1)
        gbuf = s._fused_inputs_np(prob, G)
        ibuf = s._fused_init_np(prob, B) if prob.E else None
        jout = jb.pack_packed_efused(
            s._alloc, s._avail, s._price, jnp.asarray(gbuf),
            None if ibuf is None else jnp.asarray(ibuf), prob.E, B, G,
            lat.T, lat.Z, lat.C, NP, A, lean=lean)
        tout = tb.pack_packed_efused(
            *lattice_args(lat), convert.fused_buffer(gbuf, CPU),
            None if ibuf is None else convert.fused_buffer(ibuf, CPU),
            prob.E, B, G, lat.T, lat.Z, lat.C, NP, A, lean=lean)
        assert tout.dtype == torch.uint8
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))

    @pytest.mark.parametrize("lean", [True, False])
    def test_combined_result_bytes(self, lean):
        """Groups + existing bins in ONE upload; the split point leaves the
        existing-bin fields unaligned, which the port must copy, not view."""
        s = jax_solver()
        prob, G, B = staged("existing")
        lat = s.lattice
        NP, A = max(prob.NP, 1), max(prob.A, 1)
        gbuf = s._fused_inputs_np(prob, G)
        combined = np.concatenate([gbuf, s._fused_init_np(prob, B)])
        jout = jb.pack_packed_combined(
            s._alloc, s._avail, s._price, jnp.asarray(combined), len(gbuf),
            prob.E, B, G, lat.T, lat.Z, lat.C, NP, A, lean=lean)
        tout = tb.pack_packed_combined(
            *lattice_args(lat), convert.fused_buffer(combined, CPU), len(gbuf),
            prob.E, B, G, lat.T, lat.Z, lat.C, NP, A, lean=lean)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))

    def test_pack_packed_matches_encoder_of_pack(self):
        s = jax_solver()
        prob, G, B = staged("affinity")
        groups = s._padded_groups(prob, G)
        pools = s._pool_params(prob)
        init = s._init_state(prob, B, A=max(prob.A, 1))
        jout = jb.pack_packed(s._alloc, s._avail, s._price, groups, pools,
                              init, lean=True)
        tout = tb.pack_packed(*lattice_args(s.lattice),
                              convert.named_tensors(tb.GroupBatch, groups, CPU),
                              convert.named_tensors(tb.PoolParams, pools, CPU),
                              convert.named_tensors(tb.BinState, init, CPU),
                              lean=True)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


class TestStaging:
    @pytest.mark.parametrize("case", CASES)
    def test_fused_input_bytes(self, case):
        """The port's staging writes the same input bytes as the JAX
        package's, from the port's own build of the same inputs."""
        s = jax_solver()
        t = TorchSolver(cases.small_lattice(cases.TORCH_PKG), device=CPU)
        jp, G, B = staged(case)
        tp = cases.problem(cases.TORCH_PKG, case)
        np.testing.assert_array_equal(t._fused_inputs_np(tp, G),
                                      s._fused_inputs_np(jp, G))
        np.testing.assert_array_equal(t._fused_init_np(tp, B),
                                      s._fused_init_np(jp, B))

    def test_layouts_equal(self):
        for args in [(32, 759, 5, 2, 3, 1, 11), (16, 40, 4, 2, 1, 7, 11)]:
            assert tb.group_layout(*args) == jb.group_layout(*args)
        assert tb.init_layout(128, 11, 3) == jb.init_layout(128, 11, 3)

    def test_unpack_inputs_roundtrip(self):
        """The port's unpacker reads back exactly the JAX package's
        padded per-array staging."""
        s = jax_solver()
        prob, G, _ = staged("affinity")
        lat = s.lattice
        NP, A = max(prob.NP, 1), max(prob.A, 1)
        groups, pools = tb._unpack_inputs(
            convert.fused_buffer(s._fused_inputs_np(prob, G), CPU),
            G, lat.T, lat.Z, lat.C, NP, A, lat.alloc.shape[1])
        jg, jp = s._padded_groups(prob, G), s._pool_params(prob)
        for name in tb.GroupBatch._fields:
            np.testing.assert_array_equal(getattr(groups, name).numpy(),
                                          np.asarray(getattr(jg, name)),
                                          err_msg=name)
        for name in tb.PoolParams._fields:
            np.testing.assert_array_equal(getattr(pools, name).numpy(),
                                          np.asarray(getattr(jp, name)),
                                          err_msg=name)

    @pytest.mark.parametrize("lean", [True, False])
    def test_decode_of_result_bytes(self, lean):
        """The port's host decoder reads the JAX package's result bytes
        into the same fields as the JAX package's decoder."""
        from karpenter_provider_aws_tpu.solver.solve import (
            _unpack_decode_set as j_decode)
        from karpenter_provider_aws_tpu_torch.solver.solve import (
            _unpack_decode_set as t_decode)
        s = jax_solver()
        prob, G, B = staged("existing")
        lat = s.lattice
        NP, A = max(prob.NP, 1), max(prob.A, 1)
        buf = np.asarray(jb.pack_packed_efused(
            s._alloc, s._avail, s._price,
            jnp.asarray(s._fused_inputs_np(prob, G)),
            jnp.asarray(s._fused_init_np(prob, B)), prob.E, B, G,
            lat.T, lat.Z, lat.C, NP, A, lean=lean))
        jd, td = j_decode(buf, G, lat.T, lat.Z, lat.C, A, lean=lean), \
            t_decode(buf, G, lat.T, lat.Z, lat.C, A, lean=lean)
        for name, v in vars(jd).items():
            w = getattr(td, name)
            if v is None:
                assert w is None, name
            else:
                np.testing.assert_array_equal(np.asarray(w), np.asarray(v),
                                              err_msg=name)

    def test_problem_tensors(self):
        prob = cases.problem(cases.JAX_PKG, "affinity")
        got = convert.problem_tensors(prob, CPU)
        assert set(got) == set(convert.PROBLEM_ARRAYS)
        for name, t in got.items():
            a = getattr(prob, name)
            assert t.shape == a.shape
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)

    def test_packbits_matches_numpy(self):
        rng = np.random.default_rng(1)
        for n in (1, 7, 8, 9, 759):
            m = rng.random((5, n)) < 0.5
            np.testing.assert_array_equal(
                tb.packbits_rows(torch.from_numpy(m)).numpy(),
                np.packbits(m, axis=1))


def test_bucket_ladders_match():
    from karpenter_provider_aws_tpu_torch.solver import solve as ts
    assert ts._G_BUCKETS == J_G_BUCKETS and ts._B_BUCKETS == J_B_BUCKETS
