"""Cheapest-offering finalization of the PyTorch port against the JAX
package's Pallas kernel (interpret mode on the CPU) and its XLA form.

The port's layout is unpadded (flat index ``t*ZC + zc``); the Pallas
kernel pads the zone x capacity-type axis to one 128-lane tile (flat index
``t*128 + zc``) and both axes B and T to multiples of 128. Inputs are made
from numpy seeds and fed to both. Tolerance: none — indices and finite
values must be exactly equal (a min and an argmin over the same float32
values involve no rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_provider_aws_tpu.ops.offering_argmin import (
    _ZCP, cheapest_offering_pallas, cheapest_offering_xla,
)
from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa


def random_case(rng, B, T, ZC, p_t=0.4, p_zc=0.6, p_unavail=0.2):
    tm = rng.random((B, T)) < p_t
    zc = rng.random((B, ZC)) < p_zc
    pr = (rng.random((T, ZC)) + 0.01).astype(np.float32)
    pr[rng.random((T, ZC)) < p_unavail] = np.inf
    return tm, zc, pr


def port_ref(tm, zc, pr):
    v, i = oa.cheapest_offering(torch.from_numpy(tm), torch.from_numpy(zc),
                                torch.from_numpy(pr))
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return v.numpy(), i.numpy()


def padded_for_pallas(tm, zc, pr):
    """The JAX kernel's padded f32 layout of the same inputs."""
    B, T = tm.shape
    ZC = zc.shape[1]
    Bp, Tp = -(-B // 128) * 128, -(-T // 128) * 128
    tmp = np.zeros((Bp, Tp), np.float32)
    tmp[:B, :T] = tm
    zcp = np.zeros((Bp, _ZCP), np.float32)
    zcp[:B, :ZC] = zc
    prp = np.full((Tp, _ZCP), np.inf, np.float32)
    prp[:T, :ZC] = pr
    return jnp.asarray(tmp), jnp.asarray(zcp), jnp.asarray(prp)


def from_padded_index(i_pad, ZC):
    """t*128 + zc  ->  t*ZC + zc"""
    i_pad = np.asarray(i_pad).astype(np.int64)
    return (i_pad // _ZCP) * ZC + i_pad % _ZCP


def assert_same(got, want_v, want_i):
    gv, gi = got
    np.testing.assert_array_equal(gi, np.asarray(want_i))
    want_v = np.asarray(want_v)
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(gv[fin], want_v[fin])
    assert not np.isfinite(gv[~fin]).any()


class TestAgainstPallasInterpret:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("B,T", [(128, 128), (256, 256), (128, 768)])
    def test_sweep(self, seed, B, T):
        """The B/T sweep of tests/test_pallas_argmin.py, 8 live zc lanes."""
        tm, zc, pr = random_case(np.random.default_rng(seed), B, T, 8)
        v_p, i_p = cheapest_offering_pallas(*padded_for_pallas(tm, zc, pr),
                                            interpret=True)
        v_p, i_p = np.asarray(v_p)[:B], np.asarray(i_p)[:B]
        got = port_ref(tm, zc, pr)
        assert_same(got, v_p, from_padded_index(i_p, 8))

    def test_real_catalog_shape(self):
        """T=759 types, ZC=10 (5 zones x 2 capacity types), ragged B."""
        tm, zc, pr = random_case(np.random.default_rng(7), 200, 759, 10)
        v_p, i_p = cheapest_offering_pallas(*padded_for_pallas(tm, zc, pr),
                                            interpret=True)
        got = port_ref(tm, zc, pr)
        assert_same(got, np.asarray(v_p)[:200],
                    from_padded_index(np.asarray(i_p)[:200], 10))


class TestAgainstXla:
    @pytest.mark.parametrize("B,T,ZC", [(64, 759, 10), (50, 37, 3),
                                        (33, 100, 130), (8, 20, 257)])
    def test_unpadded_xla_form(self, B, T, ZC):
        """The XLA form is shape-generic: it runs the unpadded layout,
        including ZC above the Pallas kernel's one 128-lane tile."""
        tm, zc, pr = random_case(np.random.default_rng(B + T + ZC), B, T, ZC)
        v_x, i_x = cheapest_offering_xla(jnp.asarray(tm, jnp.float32),
                                         jnp.asarray(zc, jnp.float32),
                                         jnp.asarray(pr))
        assert_same(port_ref(tm, zc, pr), v_x, i_x)

    def test_coarse_prices_tie_often(self):
        tm, zc, pr = random_case(np.random.default_rng(11), 300, 759, 10)
        pr = np.where(np.isfinite(pr), np.floor(pr * 4) / 4, pr).astype(np.float32)
        v_x, i_x = cheapest_offering_xla(jnp.asarray(tm, jnp.float32),
                                         jnp.asarray(zc, jnp.float32),
                                         jnp.asarray(pr))
        assert_same(port_ref(tm, zc, pr), v_x, i_x)


class TestEdges:
    def test_ties_resolve_to_lowest_flat_index(self):
        tm = np.ones((16, 40), bool)
        zc = np.zeros((16, 10), bool)
        zc[:, 3:7] = True
        pr = np.full((40, 10), 2.5, np.float32)
        v, i = port_ref(tm, zc, pr)
        assert np.all(i == 3)                    # t=0, first allowed zc
        assert np.all(v == np.float32(2.5))

    def test_all_infeasible_bins_report_inf_and_zero(self):
        tm, zc, pr = random_case(np.random.default_rng(3), 32, 50, 10)
        tm[:8] = False                           # no type allowed
        zc[8:16] = False                         # no zone x captype allowed
        pr_inf = np.full_like(pr, np.inf)        # nothing available
        v, i = port_ref(tm, zc, pr)
        assert np.all(~np.isfinite(v[:16])) and np.all(i[:16] == 0)
        v2, i2 = port_ref(tm, zc, pr_inf)
        assert np.all(~np.isfinite(v2)) and np.all(i2 == 0)
        v_p, i_p = cheapest_offering_pallas(*padded_for_pallas(tm, zc, pr),
                                            interpret=True)
        assert_same((v, i), np.asarray(v_p)[:32],
                    from_padded_index(np.asarray(i_p)[:32], 10))

    def test_uint8_masks_match_bool_masks(self):
        tm, zc, pr = random_case(np.random.default_rng(5), 20, 30, 4)
        a = port_ref(tm, zc, pr)
        b = port_ref(tm.astype(np.uint8), zc.astype(np.uint8), pr)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])

    def test_cpu_tensors_never_count_a_launch(self):
        before = oa.LAUNCHES
        tm, zc, pr = random_case(np.random.default_rng(9), 64, 100, 10)
        port_ref(tm, zc, pr)
        assert oa.LAUNCHES == before
