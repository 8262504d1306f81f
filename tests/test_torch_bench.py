"""The PyTorch port's bench (``karpenter_provider_aws_tpu_torch/bench.py``)
against the repository's ``bench.py``, on the CPU.

Each row kind runs in both modules on the same inputs: small generators
passed as ``make``, or monkeypatched into both modules, over the same
slice of the synthetic catalog. A row's non-time fields must be equal
(``assert_rows_equal``): pod, group and node counts, $/hr, the cost
ratios and their referees, the repack fields, the solver path and waves,
legs, parity flags and pass counts. Tolerance: none. Fields that follow
the wall clock (``*_ms``, ``*_us``, rates, the gates read from them) are
not compared, and the port's rows alone carry ``device``,
``kernel_launches`` and, on the sharded row, which path ran. This file
holds the single-device rows, the entry point and the artifact names;
``test_torch_bench_mesh.py`` the mesh, overlap and steady-state rows.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import bench
from karpenter_provider_aws_tpu_torch import bench as pb
from karpenter_provider_aws_tpu_torch import workloads

import test_torch_cases as cases
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
# m5/c5/r5 carry cfg4's and cfg10's general-purpose candidates, g4dn the
# beat row's one-GPU pods
BENCH_FAMILIES = ("m5", "c5", "r5", "g4dn")
PORT_ONLY = {"device", "kernel_launches", "sharded_pack_ran", "mesh_path"}
# fields read from the wall clock (besides every *_ms and *_us)
TIMED = {"pods_per_sec", "speedup_vs_full", "last_vs_model",
         "overlap_margin_pct", "overlap_within_margin", "within_target",
         "delta_within_target", "algo_within_budget",
         "alloc_bytes_per_delivery", "flat_1k_to_50k_pct", "pass"}

_LATTICES = {}


def lattice(pkg):
    if pkg not in _LATTICES:
        L = cases.mod(pkg, "lattice")
        _LATTICES[pkg] = L.build_lattice(
            [s for s in L.build_catalog() if s.family in BENCH_FAMILIES])
    return _LATTICES[pkg]


def jax_solver(lat, **kw):
    return cases.mod(cases.JAX_PKG, "solver").Solver(lat, **kw)


def port_solver(lat, **kw):
    return cases.mod(cases.TORCH_PKG, "solver").Solver(lat, device="cpu", **kw)


def semantic(detail):
    return {k: v for k, v in detail.items()
            if k not in TIMED and k not in PORT_ONLY
            and "_ms" not in k and not k.endswith("_us")}


def assert_rows_equal(j, t):
    """The port's row has the JAX row's keys (plus its own), and equal
    values on every field that is not a time."""
    assert set(j) <= set(t) and set(t) - set(j) <= PORT_ONLY, \
        set(t) ^ set(j)
    assert semantic(t) == semantic(j)


def cut_config4(pkg, lat, nodes=40):
    """cfg4's first ``nodes`` candidate nodes and their 3 pods each."""
    gen = (bench.config4_consolidation_repack if pkg == cases.JAX_PKG
           else workloads.config4_consolidation_repack)
    pods, pools, existing = gen(lat)
    return pods[:3 * nodes], pools, existing[:nodes]


def small_config6(pkg):
    """cfg6's three waves at a hundredth of their size."""
    A = cases.mod(pkg, "apis")
    pods = [A.Pod(name=f"w{i}", requests={"cpu": "50m", "memory": "96Mi"})
            for i in range(200)]
    pods += [A.Pod(name=f"m{i}", requests={"cpu": "1", "memory": "2Gi"})
             for i in range(20)]
    pods += [A.Pod(name=f"g{i}", requests={"cpu": "2", "memory": "8Gi",
                                           "nvidia.com/gpu": 1})
             for i in range(4)]
    return pods, [A.NodePool(name="default")], []


ROWS = {
    # key: (make per package, run_config keyword arguments)
    "cfg1": (lambda pkg, lat: (bench.config1_parity if pkg == cases.JAX_PKG
                               else workloads.config1_parity), {}),
    "cfg4_repack": (lambda pkg, lat: (lambda: cut_config4(pkg, lat)), {}),
    "cfg6_beat": (lambda pkg, lat: (lambda: small_config6(pkg)),
                  {"uncapped_referee": True}),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_run_config_rows_equal_to_jax(row):
    make, kw = ROWS[row]
    jl, tl = lattice(cases.JAX_PKG), lattice(cases.TORCH_PKG)
    _, j = bench.run_config(row, make(cases.JAX_PKG, jl), jl, jax_solver(jl),
                            also_uncapped=True, iters=2, **kw)
    _, t = pb.run_config(row, make(cases.TORCH_PKG, tl), tl, port_solver(tl),
                         also_uncapped=True, iters=2, **kw)
    assert_rows_equal(j, t)
    assert t["device"] == {"type": "cpu"} and t["kernel_launches"] == 0
    assert t["referee"] == "native" and t["unschedulable"] == 0
    if row == "cfg4_repack":
        assert t["existing_nodes"] == 40 and t["repack_referee"] == "native"
    if row == "cfg6_beat":
        assert t["referee_problem"] == "uncapped" and "cost_vs_uncapped_ffd" in t


def test_rows_count_the_kernel_launches_they_make(monkeypatch):
    """``kernel_launches`` counts the wrapper's launches while the row
    runs: with the plain version counted as a launch, one a solve (the
    warm solve and 2 timed ones; the referees run on the host)."""
    from karpenter_provider_aws_tpu_torch.ops import binpack
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa

    def counted(*args):
        oa.LAUNCHES += 1
        return oa.cheapest_offering_ref(*args)

    monkeypatch.setattr(binpack, "cheapest_offering", counted)
    monkeypatch.setattr(oa, "LAUNCHES", 7)
    tl = lattice(cases.TORCH_PKG)
    _, t = pb.run_config("cfg1", workloads.config1_parity, tl, port_solver(tl),
                         also_uncapped=True, iters=2)
    assert t["kernel_launches"] == 3 and oa.LAUNCHES == 10


def test_config6_equal_to_bench_pod_for_pod():
    jpods, jpools, jex = bench.config6_ffd_beat()
    tpods, tpools, tex = workloads.config6_ffd_beat()
    assert len(tpods) == 22400 and jex == [] and tex == []
    assert [(p.name, p.requests, p.node_selector) for p in tpods] \
        == [(p.name, p.requests, p.node_selector) for p in jpods]
    assert [p.name for p in tpools] == [p.name for p in jpools]


def test_build_bench_problem_equal_to_bench():
    from test_torch_solver import assert_problems_equal
    jl, jp, jn = bench.build_bench_problem()
    tl, tp, tn = workloads.build_bench_problem()
    assert jn == tn == 50000 and (jl.T, jl.Z, jl.C) == (tl.T, tl.Z, tl.C)
    assert_problems_equal(jp, tp)


def test_constants_equal_to_bench():
    for name in ("TARGET_MS", "ITERS", "OVERLAP_MARGIN_REQUIRED_PCT",
                 "DELTA_TARGET_MS", "DELTA_PASSES", "DELTA_CHURN_FRACTION",
                 "MICRO_LEGS_BOUND", "MICRO_LEGS_BOUND_MERGE",
                 "MICRO_LVM_BOUND", "MICRO_NOCHURN_EVERY",
                 "CFG5_ALGO_BUDGET_MS", "WRITEPATH_SIZES",
                 "WRITEPATH_WATCHERS", "WRITEPATH_OPS", "WRITEPATH_FLAT_PCT"):
        assert getattr(pb, name) == getattr(bench, name), name


def test_smoke_prints_one_cfg1_row_on_the_cpu(capsys):
    assert pb.main(["--device", "cpu", "--smoke"]) is None
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "e2e_p50_latency_cfg1_100pods_parity"
    d = row["detail"]
    assert d["device"] == {"type": "cpu"} and d["smoke"] is True
    assert d["catalog"] == "synthetic" and d["pods"] == 100
    assert d["referee"] == "native" and d["cost_vs_ffd_oracle"] <= 1.02


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--sharded"],
                                  ["--device-delta"]])
def test_entry_point_defaults_to_cuda_and_raises_without_it(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.main(argv)


def test_kernel_parity_check_on_the_cpu_checks_nothing():
    assert pb.kernel_parity_check(lattice(cases.TORCH_PKG), "cpu") == {
        "checked": False, "reason": "cpu: the plain version only"}


def test_link_probe_on_the_cpu():
    assert pb.measure_link_rtt(torch.device("cpu")) >= 0.0


def test_default_outputs_name_no_file_of_the_repo():
    """The port's artifacts get names of their own (``_gpu_``); none names
    a file of the JAX rounds or any other file the repo held before the
    port wrote its own artifacts."""
    from karpenter_provider_aws_tpu_torch.tools import (
        bench_explain, bench_headroom, bench_interruption, overhead_order,
        profile_run)
    outs = [pb.SHARDED_OUT, pb.DEVICE_DELTA_OUT, pb.WRITEPATH_OUT,
            bench_explain.DEFAULT_OUT, bench_headroom.DEFAULT_OUT,
            bench_interruption.DEFAULT_OUT, overhead_order.DEFAULT_OUT,
            profile_run.DEFAULT_OUT]
    theirs = {p.name for p in REPO.iterdir()
              if p.is_file() and "_gpu_" not in p.name}
    assert {"MULTICHIP_r06.json", "BENCH_r14_device_delta.json",
            "BENCH_r07_writepath.json", "EXPLAIN_r11_overhead.json",
            "HEADROOM_r20_overhead.json", "PROF_r08.json"} <= theirs
    for out in outs:
        assert "_gpu_" in out and out not in theirs, out
    assert len(set(outs)) == len(outs)


def test_writepath_rows_equal_to_jax(monkeypatch, tmp_path):
    for mod in (bench, pb):
        monkeypatch.setattr(mod, "WRITEPATH_SIZES", (50, 100))
        monkeypatch.setattr(mod, "WRITEPATH_WATCHERS", (1, 4))
        monkeypatch.setattr(mod, "WRITEPATH_OPS", 40)
    bench.run_writepath_bench(str(tmp_path / "jax.json"))
    pb.run_writepath_bench(str(tmp_path / "port.json"))
    j = json.loads((tmp_path / "jax.json").read_text())
    t = json.loads((tmp_path / "port.json").read_text())
    assert set(j) == set(t)
    assert {k: v for k, v in semantic(t).items() if k != "rows"} \
        == {k: v for k, v in semantic(j).items() if k != "rows"}
    assert [semantic(r) for r in t["rows"]] == [semantic(r) for r in j["rows"]]
    assert [(r["pods"], r["watchers"], r["events_delivered"]) for r in t["rows"]] \
        == [(50, 1, 40), (50, 4, 160), (100, 1, 40), (100, 4, 160)]
    assert t["fanout_envelope_copies_total"] == 0


def test_rows_differ_when_the_plans_differ():
    """The comparison sees a different plan: cfg1 against cfg1 less a
    pod."""
    tl = lattice(cases.TORCH_PKG)
    s = port_solver(tl)
    _, a = pb.run_config("a", workloads.config1_parity, tl, s, iters=1)

    def fewer():
        pods, pools, ex = workloads.config1_parity()
        return pods[:-1], pools, ex

    _, b = pb.run_config("b", fewer, tl, s, iters=1)
    with pytest.raises(AssertionError):
        assert_rows_equal(a, b)
    assert np.isfinite(a["cost_vs_ffd_oracle"])
