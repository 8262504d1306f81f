"""The PyTorch port's native FFD referee (``native/``) against the JAX
package's, on the CPU.

- The port keeps its own copy of the referee's C++ source, equal to the
  repo's ``native/ffd.cc`` byte for byte.
- ``g++`` builds it at first use into the port's ``_build/`` (never
  ``native/libffd.so``); without a toolchain ``native_available()`` is
  False and ``native_ffd_pack`` returns None.
- ``native_ffd_pack`` of both packages on the same problems, built from
  the same seeds in each package: ``test_torch_cases.random_inputs``
  seeds 0-23 (existing nodes, bound pods, selectors, anti-affinity,
  spread, self-affinity), those seeds with a kubelet ``max_pods`` cap,
  and cfg5 at full size on the real catalog (``bench.py``'s generator
  and seed; the port's copy in ``workloads``).

Tolerance: none, except ``new_node_cost`` at 1e-9 relative (the same C++
on the same float32 inputs; the slack only absorbs the sum's order if a
compiler reorders it).
"""

import filecmp
import pathlib

import numpy as np
import pytest

import bench
import test_torch_cases as cases
from karpenter_provider_aws_tpu.native import native_ffd_pack as j_native
from karpenter_provider_aws_tpu_torch import workloads
from karpenter_provider_aws_tpu_torch.native import build as t_build_mod
from karpenter_provider_aws_tpu_torch.native import native_available
from karpenter_provider_aws_tpu_torch.native import native_ffd_pack as t_native

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "karpenter_provider_aws_tpu_torch"
REL = 1e-9


def _fields(plan):
    if plan is None:
        return None
    return {"num_new_nodes": plan.num_new_nodes,
            "leftover": plan.leftover, "chosen": list(plan.chosen),
            "e_npods": None if plan.e_npods is None
            else plan.e_npods.tolist()}


def assert_same_plan(j, t):
    assert _fields(t) == _fields(j)
    if j is not None:
        assert t.new_node_cost == pytest.approx(j.new_node_cost, rel=REL)


def test_ffd_source_equals_the_repo_copy():
    assert filecmp.cmp(PORT / "native" / "ffd.cc", REPO / "native" / "ffd.cc",
                       shallow=False)


def test_builds_into_the_port_build_dir():
    if not native_available():
        pytest.skip("no C++ toolchain")
    lib = t_build_mod.library_path()
    assert lib.parent == PORT / "_build" == t_build_mod.DEFAULT_BUILD_DIR
    assert lib.name.startswith("libffd-") and lib.exists()
    assert lib.stat().st_mtime >= (PORT / "native" / "ffd.cc").stat().st_mtime


def test_no_toolchain_means_unavailable(monkeypatch, tmp_path):
    """With ``g++`` missing the build fails once, ``native_available()``
    is False and ``native_ffd_pack`` answers None (the caller falls back
    to the Python oracle); nothing is written."""
    import subprocess

    def no_gpp(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(t_build_mod, "_lib", None)
    monkeypatch.setattr(t_build_mod, "_build_failed", False)
    monkeypatch.setattr(t_build_mod, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(subprocess, "run", no_gpp)
    assert not native_available()
    assert t_native(cases.problem(cases.TORCH_PKG, "generic")) is None
    assert not list(tmp_path.rglob("*.so"))


def _random_problem(pkg, seed, max_pods=None):
    lat, pods, pools, kw = cases.build(pkg, f"random-{seed}")
    if max_pods is not None:
        O = cases.mod(pkg, "apis.objects")
        for p in pools:
            p.kubelet = O.KubeletSpec(max_pods=max_pods)
    return cases.mod(pkg, "solver.problem").build_problem(pods, pools, lat,
                                                          **kw)


@pytest.mark.parametrize("seed", range(24))
@pytest.mark.parametrize("max_pods", [None, 5], ids=["uncapped", "max-pods-5"])
def test_native_equal_to_jax_on_random_inputs(seed, max_pods):
    if not native_available():
        pytest.skip("no C++ toolchain")
    j = j_native(_random_problem(cases.JAX_PKG, seed, max_pods))
    t = t_native(_random_problem(cases.TORCH_PKG, seed, max_pods))
    assert_same_plan(j, t)


def test_native_equal_to_jax_on_cfg5():
    """cfg5 (50,000 pods, the real 759-type catalog, bench.py's seed): the
    same nodes and offerings; its cost equals the port's Python oracle's
    too (the same ``new_node_cost`` and node count)."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    from karpenter_provider_aws_tpu.lattice import build_lattice
    from karpenter_provider_aws_tpu.lattice.realdata import load_catalog
    from karpenter_provider_aws_tpu.solver.problem import build_problem
    from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle
    from karpenter_provider_aws_tpu_torch.solver.problem import \
        build_problem as t_build
    jl = build_lattice(load_catalog(None, require_price=True))
    jpods, jpools, _ = bench.config5_full_scale()
    j = j_native(build_problem(jpods, jpools, jl))
    tpods, tpools, _ = workloads.config5_full_scale()
    tp = t_build(tpods, tpools, workloads.real_lattice())
    t = t_native(tp)
    assert t is not None and t.leftover == 0 and t.num_new_nodes > 1000
    assert_same_plan(j, t)
    py = ffd_oracle(tp)
    assert t.num_new_nodes == py.num_new_nodes
    assert t.new_node_cost == pytest.approx(py.new_node_cost, rel=1e-5)
    assert np.isfinite(t.new_node_cost)
