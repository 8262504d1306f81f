"""The PyTorch port's bench against ``bench.py`` on the CPU: the overlap,
sharded, steady-state and microloop rows and the ``--sharded`` and
``--device-delta`` artifacts.

As in ``test_torch_bench.py``: the same small inputs through both
modules, and every non-time field of a row equal (no tolerance). The
generators the rows call by name (cfg10, cfg11) are cut by monkeypatching
them in both modules. The mesh has 8 shards on both sides: the JAX
package's 8-device virtual CPU mesh (``tests/conftest.py``) and the
port's 8 shards batched on the CPU (``visible_devices`` patched to 8,
since the port sees one CPU device).
"""

import json

import pytest

import bench
from karpenter_provider_aws_tpu_torch import bench as pb
from karpenter_provider_aws_tpu_torch import workloads

import test_torch_cases as cases
from test_torch_bench import (assert_rows_equal, jax_solver, lattice,
                              port_solver, semantic)
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

CFG10_STRIDE = 40     # cfg10's 20,000 pods cut to 500
CFG11_STRIDE = 100    # cfg11's 200,000 pods cut to 2,000
CFG9_STRIDE = 50      # cfg9's 16,500 pods cut to 330
CFG7_CUT = 320        # cfg7's first 320 pods, as chip_smoke.py cuts them
CFG7_G_LIMIT = 64     # and its injected group ceiling: 5 waves


def _cut(gen, stride):
    def make():
        pods, pools, rest = gen()
        return pods[::stride], pools, rest
    return make


@pytest.fixture
def small_cfg10(monkeypatch):
    monkeypatch.setattr(bench, "config10_steady_state",
                        _cut(bench.config10_steady_state, CFG10_STRIDE))
    monkeypatch.setattr(pb, "config10_steady_state",
                        _cut(workloads.config10_steady_state, CFG10_STRIDE))


@pytest.fixture
def small_catalog(tmp_path):
    """The bundled real catalog's m5, c5 and r5 types, as a catalog file
    both packages load (``--catalog PATH``)."""
    src = workloads.__file__.replace("workloads.py",
                                     "lattice/data/reference_catalog.json")
    with open(src) as f:
        doc = json.load(f)
    doc["types"] = [t for t in doc["types"]
                    if t["name"].split(".")[0] in ("m5", "c5", "r5")]
    path = tmp_path / "catalog.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture
def eight_shards(monkeypatch):
    monkeypatch.setattr(pb, "visible_devices", lambda device: 8)


def test_overlap_row_equal_to_jax():
    """cfg8: cfg7's first 320 pods under ``g_limit=64`` (5 waves),
    sequential then pipelined on one Solver."""
    jl, tl = lattice(cases.JAX_PKG), lattice(cases.TORCH_PKG)
    js, ts = jax_solver(jl), port_solver(tl)
    js.inject_faults(cases.mod(cases.JAX_PKG, "solver").FaultInjector(
        g_limit=CFG7_G_LIMIT))
    ts.inject_faults(cases.mod(cases.TORCH_PKG, "solver").FaultInjector(
        g_limit=CFG7_G_LIMIT))

    def cut(gen):
        def make():
            pods, pools, ex = gen()
            return pods[:CFG7_CUT], pools, ex
        return make

    _, j = bench.run_overlap_config(cut(bench.config7_highG_wave_split),
                                    jl, js, iters=1)
    _, t = pb.run_overlap_config(cut(workloads.config7_highG_wave_split),
                                 tl, ts, iters=1)
    assert_rows_equal(j, t)
    assert t["waves"] == 5 and t["plans_byte_identical"] is True
    # 4 waves prefetched in each of the pipelined warm and timed solves
    assert t["prefetched_waves"] == 8 and ts.pipeline is True


def test_cfg7_wave_row_equal_to_jax():
    """The run_config row of a wave-split plan records its rung and waves."""
    jl, tl = lattice(cases.JAX_PKG), lattice(cases.TORCH_PKG)
    js, ts = jax_solver(jl), port_solver(tl)
    for s, pkg in ((js, cases.JAX_PKG), (ts, cases.TORCH_PKG)):
        s.inject_faults(cases.mod(pkg, "solver").FaultInjector(
            g_limit=CFG7_G_LIMIT))
    make_j = _cut(bench.config7_highG_wave_split, 15)
    make_t = _cut(workloads.config7_highG_wave_split, 15)
    _, j = bench.run_config("cfg7", make_j, jl, js, also_uncapped=True,
                            iters=1)
    _, t = pb.run_config("cfg7", make_t, tl, ts, also_uncapped=True, iters=1)
    assert_rows_equal(j, t)
    assert t["solver_path"] == "wave-split" and t["waves"] == 5


def test_sharded_row_equal_to_jax(eight_shards):
    """cfg9 cut to 330 pods on 8 shards against the single-device solve."""
    jl, tl = lattice(cases.JAX_PKG), lattice(cases.TORCH_PKG)
    _, j = bench.run_sharded_config(_cut(bench.config9_sharded_16k, CFG9_STRIDE),
                                    jl, jax_solver(jl), iters=1)
    _, t = pb.run_sharded_config(_cut(workloads.config9_sharded_16k, CFG9_STRIDE),
                                 tl, port_solver(tl), iters=1)
    assert_rows_equal(j, t)
    assert t["mesh_devices"] == 8 and t["sharded_pack_ran"] is True
    assert "mesh_path" not in t


def test_one_shard_is_the_passthrough_and_says_so():
    """On one device the sharded row's mesh of one shard runs the
    Solver's own single-device path, and the row says so."""
    tl = lattice(cases.TORCH_PKG)
    _, t = pb.run_sharded_config(_cut(workloads.config9_sharded_16k, 500),
                                 tl, port_solver(tl), iters=1)
    assert t["mesh_devices"] == 1 and t["sharded_pack_ran"] is False
    assert "passthrough" in t["mesh_path"]
    assert t["cost_vs_single_device"] == 1.0


def test_mesh_parity_row_equal_to_jax():
    jmesh = cases.mod(cases.JAX_PKG, "parallel").solver_mesh(8)
    tmesh = cases.mod(cases.TORCH_PKG, "parallel").solver_mesh(8, device="cpu")
    j = bench.run_mesh_parity(jmesh)
    t = pb.run_mesh_parity(tmesh, device="cpu")
    assert t == j
    assert t["byte_identical"] is True and t["mesh_devices"] == 8


def test_steady_state_row_equal_to_jax(small_cfg10):
    """cfg10_steady_state_delta on cfg10 cut to 500 pods: 12 churned
    passes through the incremental builder and ``solve_delta``."""
    jl, tl = lattice(cases.JAX_PKG), lattice(cases.TORCH_PKG)
    _, j = bench.run_steady_state_config(jl, jax_solver(jl))
    _, t = pb.run_steady_state_config(tl, port_solver(tl))
    assert_rows_equal(j, t)
    assert t["passes"] == 12 and t["delta_solves"] == 12
    assert t["plan_nodes_match_full_rebuild"] is True


def test_microloop_row_equal_to_jax(small_cfg10):
    """The ``--device-delta`` single-device row on cfg10 cut to 500 pods:
    the microloop's legs, skipped fetches and parity."""
    jl, tl = lattice(cases.JAX_PKG), lattice(cases.TORCH_PKG)
    _, j, _ = bench.run_microloop_config(jl, jax_solver(jl), parity_every=3)
    _, t, _ = pb.run_microloop_config(tl, port_solver(tl), parity_every=3)
    assert_rows_equal(j, t)
    assert t["micro_solves"] == 12 and t["skipped_syncs"] == 3
    assert t["plan_parity_vs_full_rebuild"] is True
    assert t["legs_within_bound"] is True


def _artifacts(tmp_path, run_jax, run_port, timed=()):
    """Both artifacts written and compared: every row's non-time fields,
    and the document's own fields but its device, backend, round, link
    probe and the ``timed`` ones (gates read from the wall clock)."""
    jp, tp = tmp_path / "jax.json", tmp_path / "port.json"
    rc_j = run_jax(str(jp))
    rc_t = run_port(str(tp))
    j, t = json.loads(jp.read_text()), json.loads(tp.read_text())
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    assert t["device"] == {"type": "cpu"} and t["backend"] == "cpu"
    assert set(t["rows"]) == set(j["rows"])
    for name in j["rows"]:
        assert_rows_equal(j["rows"][name], t["rows"][name])
    same = {"backend", "device", "round", "rows", "link_rtt_ms", *timed}
    assert {k: v for k, v in t.items() if k not in same} \
        == {k: v for k, v in j.items() if k not in same}
    return rc_j, rc_t, t


def test_sharded_artifact_equal_to_jax(small_cfg10, small_catalog,
                                       monkeypatch, tmp_path):
    """``--sharded`` on 8 shards: cfg11 cut to 2,000 pods, the parity row
    and the delta-on-mesh row on cfg10 cut to 500, over the real
    catalog's m5, c5 and r5 types."""
    monkeypatch.setattr(bench, "config11_200k_sharded",
                        _cut(bench.config11_200k_sharded, CFG11_STRIDE))
    monkeypatch.setattr(pb, "config11_200k_sharded",
                        _cut(workloads.config11_200k_sharded, CFG11_STRIDE))
    rc_j, rc_t, t = _artifacts(
        tmp_path,
        lambda out: bench.run_sharded_artifact(catalog=small_catalog,
                                               out=out),
        lambda out: pb.run_sharded_artifact(catalog=small_catalog, out=out,
                                            device="cpu"))
    # at 2,000 pods the 8 shards' merge lands 1.0745 of the referee on
    # both packages, outside the full cfg11's 1.02 envelope: both exit 1
    assert rc_t == rc_j == 1 and t["acceptance_ok"] is False
    assert t["rows"]["cfg11_200k_sharded"]["cost_vs_ffd_oracle"] == 1.0745
    assert t["rows"]["mesh_vs_single_device_parity"]["byte_identical"]
    assert t["rows"]["cfg12_delta_on_mesh"]["delta_rode_mesh"]
    assert t["mesh_devices"] == 8 and t["round"] == "BENCH_gpu_r01_sharded"
    assert t["rows"]["cfg11_200k_sharded"]["referee"] == "native"


def test_device_delta_artifact_equal_to_jax(small_cfg10, small_catalog,
                                            tmp_path):
    """``--device-delta``: the microloop row on one device and on 8
    shards, cfg10 cut to 500 pods, over the real catalog's m5, c5 and r5
    types."""
    _, _, t = _artifacts(
        tmp_path,
        lambda out: bench.run_device_delta_artifact(catalog=small_catalog,
                                                    out=out),
        lambda out: pb.run_device_delta_artifact(catalog=small_catalog,
                                                 out=out, device="cpu"),
        # its acceptance reads the 20 ms plumbing bar and last_vs_model,
        # which follow the wall clock of each package's passes
        timed=("acceptance_ok",))
    mesh = t["rows"]["cfg14_micro_on_mesh"]
    assert mesh["mesh_devices"] == 8 and mesh["plan_parity_vs_full_rebuild"]
    assert semantic(t["rows"]["cfg14_micro_single_device"])["micro_solves"] == 12
