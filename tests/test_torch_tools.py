"""The PyTorch port's host-side benches
(``karpenter_provider_aws_tpu_torch/tools/``) on the CPU, at small sizes.

``bench_interruption``: its drain against the repository's
``tools/bench_interruption.py`` on the same queue (counts equal, no
tolerance), in direct and API mode. ``bench_explain`` and
``bench_headroom``: both passes of each (on and off) through ``main``,
written to ``tmp_path``, and their non-time fields equal to the
repository's tool's ``run_loop`` on the same sizes. ``profile_run``:
its three runs (deterministic profiled, deterministic control, threaded)
through ``main`` at a few hundred pods, written to ``tmp_path``.
``overhead_order``: the three tools' pairs twice each, ON, OFF, OFF, ON,
at small sizes. Every tool defaults to ``cuda`` and raises without it.
"""

import json
import sys
import pathlib

import pytest
import torch

from karpenter_provider_aws_tpu_torch.tools import (bench_explain,
                                                    bench_headroom,
                                                    bench_interruption,
                                                    overhead_order,
                                                    profile_run)

from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from tools import bench_explain as j_explain  # noqa: E402
from tools import bench_headroom as j_headroom  # noqa: E402
from tools import bench_interruption as j_interruption  # noqa: E402

PODS, PASSES = 200, 3
TIMED = ("e2e_p50_ms", "e2e_p90_ms", "wall_ms", "device")


def untimed(d):
    return {k: v for k, v in d.items() if k not in TIMED}


@pytest.mark.parametrize("api_mode", [False, True], ids=["direct", "api"])
def test_interruption_drain_equal_to_jax(api_mode):
    import karpenter_provider_aws_tpu.lattice as jl
    import karpenter_provider_aws_tpu_torch.lattice as tl
    fams = ("m5", "c5", "r5")
    j = j_interruption.run(500, jl.build_lattice(
        [s for s in jl.build_catalog() if s.family in fams]),
        api_mode=api_mode)
    t = bench_interruption.run(500, tl.build_lattice(
        [s for s in tl.build_catalog() if s.family in fams]),
        api_mode=api_mode, device="cpu")
    assert t["metric"] == j["metric"] and t["unit"] == j["unit"]
    assert untimed(t["detail"]) == untimed(j["detail"])
    assert t["detail"]["handled"] == 500 and t["detail"]["remaining"] == 0
    assert t["detail"]["device"] == "cpu"


def test_interruption_main_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "interruption.json"
    assert bench_interruption.main(["--device", "cpu", "--out", str(out),
                                    "100", "300"]) == 0
    rows = json.loads(out.read_text())
    assert [r["detail"]["messages"] for r in rows] == [100, 300]
    assert all(r["detail"]["remaining"] == 0 for r in rows)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


@pytest.mark.parametrize("tool,jtool,on,off", [
    (bench_explain, j_explain, "capture_on", "capture_off"),
    (bench_headroom, j_headroom, "probes_on", "probes_off"),
], ids=["explain", "headroom"])
def test_overhead_bench_both_passes_equal_to_jax(tool, jtool, on, off,
                                                 tmp_path):
    out = tmp_path / "overhead.json"
    rc = tool.main(["--pods", str(PODS), "--passes", str(PASSES),
                    "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == (0 if doc["within_bound"] else 1)
    assert doc["pods"] == PODS and doc["device"] == "cpu"
    assert doc[on]["passes"] == doc[off]["passes"] == PASSES
    for key, flag in ((on, True), (off, False)):
        assert untimed(doc[key]) == untimed(jtool.run_loop(flag, PODS, PASSES))
    if tool is bench_headroom:
        assert doc[on]["probes"] > 0 and doc[off]["probes"] == 0


def test_profile_run_writes_both_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(profile_run, "WARMUP_PODS", 100)
    monkeypatch.setattr(profile_run, "WARMUP_G_BUCKETS", (16,))
    monkeypatch.setattr(profile_run, "WARMUP_B_BUCKETS", (32,))
    out = tmp_path / "prof.json"
    rc = profile_run.main(["--pods", "300", "--device", "cpu",
                           "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == (0 if doc["overhead"]["within_bound"] else 1)
    assert doc["device"] == {"type": "cpu"} and doc["pods"] == 300
    parity = doc["parity"]
    assert parity["det_control_nodes"] == parity["det_profiled_nodes"]
    assert parity["det_pending_at_end"] == parity["threaded_pending_at_end"] == 0
    assert doc["overhead"]["det_runs_node_parity"] is True
    # the profiled pump runs for tenths of a second at 50 Hz; the threaded
    # run may drain 300 pods before the sampler's first tick
    assert doc["overhead"]["det_profiler_samples"] > 0
    assert "threaded_run_samples" in doc["profiler"]
    assert isinstance(doc["device_cost_model"], dict)


def test_profile_run_deterministic_pump_equal_to_jax():
    """The overhead stratum's single-threaded API-mode pump makes the same
    claims and binds the same pods as the repository's tool's."""
    from tools import profile_run as j_profile
    _, jop, _ = j_profile.run_deterministic(300, profile=False)
    _, top, _ = profile_run.run_deterministic(profile_run.real_lattice(), 300,
                                              profile=False, device="cpu")

    def seen(op):
        return (sorted((c.instance_type, c.zone, c.capacity_type)
                       for c in op.cluster.snapshot_claims()),
                sorted((p.name, p.node_name) for p in op.cluster.snapshot_pods()),
                len(op.cluster.nodes), op.final_pending)

    assert seen(top) == seen(jop)
    assert len(seen(top)[0]) > 0 and top.final_pending == 0


def test_overhead_order_runs_each_pair_twice(tmp_path, monkeypatch):
    monkeypatch.setattr(profile_run, "WARMUP_PODS", 100)
    monkeypatch.setattr(profile_run, "WARMUP_G_BUCKETS", (16,))
    monkeypatch.setattr(profile_run, "WARMUP_B_BUCKETS", (32,))
    out = tmp_path / "order.json"
    assert overhead_order.main(["--pods", str(PODS), "--passes", str(PASSES),
                                "--prof-pods", "300", "--device", "cpu",
                                "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["device"] == {"type": "cpu"}
    for name, key in (("explain", "e2e_p50_ms"), ("headroom", "e2e_p50_ms"),
                      ("profile_run", "wall_seconds")):
        d = doc[name]
        assert d["order"] == [True, False, False, True]
        on1, off2, off3, on4 = d[key]
        assert d["on_first_delta_pct"] == round(100 * (on1 - off2) / off2, 3)
        assert d["off_first_delta_pct"] == round(100 * (on4 - off3) / off3, 3)
        assert d["off_off_delta_pct"] == round(100 * (off2 - off3) / off3, 3)
    # the four pumps run one operation sequence: the same fleet each time,
    # every pod placed
    assert len(set(doc["profile_run"]["nodes"])) == 1
    assert doc["profile_run"]["pending_at_end"] == [0, 0, 0, 0]


@pytest.mark.parametrize("tool", [bench_explain, bench_headroom,
                                  bench_interruption, overhead_order,
                                  profile_run],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_default_to_cuda_and_raise_without_it(tool, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--pods", "10"] if tool is not bench_interruption
                  else ["10"])
    assert not list(tmp_path.iterdir())
