"""The PyTorch port's per-shape analysis of the pack
(``ops/binpack.pack_analysis``) and ``Solver.capture_cost_model``, on the
CPU, against the JAX package's capture at the same shapes.

At (G, B) = (16, 32), (64, 32) and (64, 512) on the m5+c5 lattice (T=18,
Z=5, C=2):

- every shape is captured on both packages, with FLOPs and bytes above 0;
- two captures give equal figures (the analysis is a function of the
  shape);
- the port's figures count all G scan steps, so G=64 counts more than
  G=16 at the same B, in proportion to G within 10 % (the JAX lowering
  counts the scan body once, so its FLOPs move by less than 10 %: a
  divergence by design);
- bytes accessed are at least the pack's argument and result bytes, and
  the peak at least their sum;
- no pack ran on a card or on the host: the analysis traces on the meta
  device, the cheapest-offering kernel is never launched nor its plain
  version called.

Then the surfaces: ``stats()["last_flops"]`` after a solve of a captured
shape, and the CLI's ``--profile`` capture thread.

Tolerance: 10 % on the proportion to G; everything else exact.
"""

import threading

import pytest
import torch

import test_torch_cases as cases
from karpenter_provider_aws_tpu.solver import costmodel as j_costmodel
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu_torch.apis.resources import R
from karpenter_provider_aws_tpu_torch.ops import binpack
from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
from karpenter_provider_aws_tpu_torch.solver import Solver, costmodel

SHAPES = ((16, 32), (64, 32), (64, 512))
FAMILIES = ("m5", "c5")


@pytest.fixture(scope="module")
def captured():
    """Each package's captured shapes at SHAPES (two captures on the
    port), with the devices and calls the port's captures made."""
    out = {}
    lat = cases.family_lattice(cases.TORCH_PKG, FAMILIES)
    s = Solver(lat, device="cpu")
    seen, kernel_devices = [], []
    real_pack, real_kernel = binpack.pack_packed_efused, binpack.cheapest_offering

    def pack(alloc, *a, **kw):
        seen.append(alloc.device.type)
        return real_pack(alloc, *a, **kw)

    def kernel(tm, zc, pr):
        kernel_devices.append(tm.device.type)
        return real_kernel(tm, zc, pr)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran")

    mp = pytest.MonkeyPatch()
    mp.setattr(binpack, "pack_packed_efused", pack)
    mp.setattr(binpack, "cheapest_offering", kernel)
    mp.setattr(oa, "cheapest_offering_ref", no_plain)
    launches = oa.LAUNCHES
    try:
        runs = []
        for _ in range(2):
            costmodel.model().reset()
            n = s.capture_cost_model(g_buckets=(16, 64), b_buckets=(32, 512))
            runs.append((n, costmodel.model().summary()["shapes"]))
    finally:
        mp.undo()
        costmodel.model().reset()
    out["port"] = runs
    out["port_devices"] = (seen, kernel_devices, oa.LAUNCHES - launches)
    out["lattice"] = lat
    j_costmodel.model().reset()
    js = JaxSolver(cases.family_lattice(cases.JAX_PKG, FAMILIES))
    n = js.capture_cost_model(g_buckets=(16, 64), b_buckets=(32, 512))
    out["jax"] = (n, j_costmodel.model().summary()["shapes"])
    j_costmodel.model().reset()
    return out


def _key(G, B):
    return costmodel.shape_key(G, B)


@pytest.mark.parametrize("G,B", SHAPES)
def test_shape_captured_on_both_with_flops_and_bytes(captured, G, B):
    (n, shapes), _ = captured["port"]
    jn, jshapes = captured["jax"]
    assert n == jn == 4
    assert set(shapes) == set(jshapes)
    for rec in (shapes[_key(G, B)], jshapes[_key(G, B)]):
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert shapes[_key(G, B)]["peak_bytes"] > 0


@pytest.mark.parametrize("G,B", SHAPES)
def test_two_captures_give_equal_figures(captured, G, B):
    (_, a), (_, b) = captured["port"]
    assert a[_key(G, B)] == b[_key(G, B)]


@pytest.mark.parametrize("B", (32, 512))
def test_counts_grow_with_G(captured, B):
    (_, shapes), _ = captured["port"]
    _, jshapes = captured["jax"]
    g16, g64 = shapes[_key(16, B)], shapes[_key(64, B)]
    for f in ("flops", "bytes_accessed"):
        assert g64[f] > g16[f]
        assert g64[f] / g16[f] == pytest.approx(4.0, rel=0.10)
    # the reference's lowering counts the scan body once
    j16, j64 = jshapes[_key(16, B)], jshapes[_key(64, B)]
    assert j64["flops"] / j16["flops"] < 1.10


@pytest.mark.parametrize("G,B", SHAPES)
def test_bytes_cover_the_arguments_and_the_result(captured, G, B):
    lat = captured["lattice"]
    T, Z, C = lat.T, lat.Z, lat.C
    an = binpack.pack_analysis(G, B, T, Z, C, 1, 1, R)
    _, g_total = binpack.group_layout(G, T, Z, C, 1, 1, R)
    args = T * R * 4 + T * Z * C + T * Z * C * 4 + g_total
    assert an.argument_size_in_bytes == args
    assert an.output_size_in_bytes > 0
    assert an.bytes_accessed >= args + an.output_size_in_bytes
    (_, shapes), _ = captured["port"]
    rec = shapes[_key(G, B)]
    assert rec["flops"] == an.flops
    assert rec["peak_bytes"] == (an.temp_size_in_bytes
                                 + an.output_size_in_bytes + args)
    assert rec["peak_bytes"] >= args + an.output_size_in_bytes


def test_no_pack_ran_on_a_real_device(captured):
    seen, kernel_devices, launched = captured["port_devices"]
    # 4 shapes, captured twice, each one traced pack with one kernel call
    assert seen == ["meta"] * 8 and kernel_devices == ["meta"] * 8
    assert launched == 0


def test_result_bytes_equal_a_real_pack(captured):
    """The traced result buffer has the real pack's shape: a CPU pack of
    the same zero-filled inputs."""
    lat = captured["lattice"]
    s = Solver(lat, device="cpu")
    T, Z, C = lat.T, lat.Z, lat.C
    _, g_total = binpack.group_layout(16, T, Z, C, 1, 1, R)
    out = binpack.pack_packed_efused(
        s._alloc, s._avail, s._price, torch.zeros(g_total, dtype=torch.uint8),
        None, 0, 32, 16, T, Z, C, 1, 1, lean=True)
    an = binpack.pack_analysis(16, 32, T, Z, C, 1, 1, R)
    assert an.output_size_in_bytes == out.numel() * out.element_size()


def test_stats_show_the_solved_shape_flops():
    """After a capture of the shape a solve lands on, the introspection
    provider's ``last_flops`` is that shape's figure, and ``kpctl top``'s
    DEVICE row counts the shape."""
    costmodel.model().reset()
    lat = cases.small_lattice(cases.TORCH_PKG)
    s = Solver(lat, device="cpu")
    problem = cases.problem(cases.TORCH_PKG, "generic")
    s.solve(problem)
    key = costmodel.model().last_shape
    G, B = (int(x[1:]) for x in key.split("_"))
    assert s.capture_cost_model(g_buckets=(G,), b_buckets=(B,)) == 1
    stats = costmodel.model().stats()
    rec = costmodel.model().summary()["shapes"][key]
    assert stats["last_flops"] == rec["flops"] > 0
    assert rec["bytes_accessed"] > 0 and rec["peak_bytes"] > 0
    # kpctl top's DEVICE row reads the same provider
    from karpenter_provider_aws_tpu_torch.tools import kpctl
    lines = kpctl._render_top({"providers": {"device": stats}}, "t")
    row = next(ln for ln in lines if ln.startswith("DEVICE"))
    assert "shapes 1" in row
    costmodel.model().reset()


def test_cli_profile_starts_the_capture_thread(monkeypatch, tmp_path):
    """``--profile`` captures the warm ladder on a daemon thread named
    ``costmodel-capture``, as the JAX CLI does."""
    from karpenter_provider_aws_tpu_torch import cli, introspect
    costmodel.model().reset()
    lat = cases.small_lattice(cases.TORCH_PKG)
    real = cli.Operator
    monkeypatch.setattr(cli, "Operator",
                        lambda *a, **k: real(*a, lattice=lat, **k))
    monkeypatch.setattr(introspect, "_PROFILER", None)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--device", "cpu", "--profile", "--metrics-port=0",
                   "--duration=0.1"])
    assert rc == 0
    threads = [t for t in threading.enumerate()
               if t.name == "costmodel-capture"]
    assert len(threads) == 1 and threads[0].daemon
    threads[0].join(120)
    shapes = costmodel.model().summary()["shapes"]
    assert sorted(shapes) == sorted(
        costmodel.shape_key(G, B) for G in Solver.WARM_G_BUCKETS
        for B in Solver.WARM_B_BUCKETS)
    assert all(r["flops"] > 0 and r["peak_bytes"] > 0
               for r in shapes.values())
    costmodel.model().reset()
