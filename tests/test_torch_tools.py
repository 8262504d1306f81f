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
at small sizes. Every tool defaults to ``cuda`` and raises without it,
and so do ``soak`` and the entry module's ``entry`` and
``dryrun_multichip``. The soak refuses ``--compile-cache-dir`` and names
its artifacts ``SOAK_gpu_*`` / ``WEATHER_gpu_*``; ``kpctl top``'s SOLVER
row names the Solver's device; the port's deployment template renders
with ``--device=cuda``, ``--warm-start``, one ``nvidia.com/gpu`` and no
``COMPILE_CACHE_DIR``.
"""

import json
import sys
import pathlib

import pytest
import torch

from karpenter_provider_aws_tpu_torch import deploy, entry
from karpenter_provider_aws_tpu_torch.tools import (bench_explain,
                                                    bench_headroom,
                                                    bench_interruption,
                                                    kpctl,
                                                    overhead_order,
                                                    profile_run, soak)

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


# each entry point's call with its defaults (None: the tool's ``main``
# with a size argument)
CUDA_DEFAULT_CALLS = {
    "bench_explain": lambda: bench_explain.main(["--pods", "10"]),
    "bench_headroom": lambda: bench_headroom.main(["--pods", "10"]),
    "bench_interruption": lambda: bench_interruption.main(["10"]),
    "overhead_order": lambda: overhead_order.main(["--pods", "10"]),
    "profile_run": lambda: profile_run.main(["--pods", "10"]),
    "soak": lambda: soak.main(["--minutes", "0.01"]),
    "entry": lambda: entry.entry(),
    "dryrun_multichip": lambda: entry.dryrun_multichip(8),
}


@pytest.mark.parametrize("tool", list(CUDA_DEFAULT_CALLS))
def test_tools_default_to_cuda_and_raise_without_it(tool, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CUDA_DEFAULT_CALLS[tool]()
    assert not list(tmp_path.iterdir())


def test_soak_refuses_the_compile_cache_and_names_its_artifacts(
        tmp_path, monkeypatch):
    """``--compile-cache-dir`` reaches the soak's Operator, which builds
    the kernels there, and with ``--warm-start`` the ladder runs ahead of
    time (the run is stopped once the ladder is asked for); the
    artifacts' default names are the port's own, never the JAX rounds'."""
    from karpenter_provider_aws_tpu_torch.native import build
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.chdir(tmp_path)

    class Stop(Exception):
        pass

    asked = []

    def warmup(self, **kw):
        asked.append((self.device.type, kw["aot"], kw["background"]))
        raise Stop

    from karpenter_provider_aws_tpu_torch.solver import Solver
    monkeypatch.setattr(Solver, "warmup", warmup)
    with pytest.raises(Stop):
        soak.main(["--device", "cpu", "--families", "m5",
                   "--compile-cache-dir", "cache", "--warm-start"])
    assert asked == [("cpu", True, True)]
    assert cuda_build.BUILD_DIR == build.BUILD_DIR == tmp_path / "cache"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cache"]
    assert soak.DEFAULT_OUT == "SOAK_gpu_timeseries.json.gz"
    src = pathlib.Path(soak.__file__).read_text()
    assert 'f"WEATHER_gpu_{' in src and '"WEATHER_{' not in src


def test_kpctl_top_solver_row_names_the_device():
    """The Solver's stats carry its device, and ``kpctl top`` renders it
    at the end of the SOLVER row (absent from a document without it)."""
    from karpenter_provider_aws_tpu_torch.lattice import (build_catalog,
                                                          build_lattice)
    from karpenter_provider_aws_tpu_torch.solver import Solver
    lat = build_lattice([s for s in build_catalog() if s.family == "m5"])
    stats = Solver(lat, device="cpu").stats()
    assert stats["device"] == "cpu"
    lines = kpctl._render_top({"providers": {"solver": stats}}, "t")
    row = next(ln for ln in lines if ln.startswith("SOLVER"))
    assert row.endswith("   device cpu")
    lines = kpctl._render_top({"providers": {}}, "t")
    row = next(ln for ln in lines if ln.startswith("SOLVER"))
    assert "device" not in row


def test_deployment_template_runs_the_port_controller_on_the_card():
    import yaml
    doc = yaml.safe_load(deploy.render(deploy.load_values()))
    spec = doc["spec"]["template"]["spec"]
    (c,) = spec["containers"]
    assert c["command"] == ["karpenter-tpu-controller-torch"]
    assert "--device=cuda" in c["args"] and "--warm-start" in c["args"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert c["resources"]["requests"]["nvidia.com/gpu"] == 1
    assert "google.com/tpu" not in c["resources"]["limits"]
    env = {e["name"]: e["value"] for e in c["env"]}
    assert "CLUSTER_NAME" in env
    # the kernel build cache on an emptyDir volume, as the reference's
    # compile cache
    cache = env["COMPILE_CACHE_DIR"]
    (mount,) = [m for m in c["volumeMounts"]
                if cache.startswith(m["mountPath"] + "/")]
    (vol,) = [v for v in spec["volumes"] if v["name"] == mount["name"]]
    assert vol["emptyDir"] == {}
    assert all("xla" not in v["name"] for v in spec["volumes"])
    assert doc["metadata"]["name"] == "karpenter-tpu"
    assert "${" not in yaml.safe_dump(doc)


def test_deploy_render_writes_every_template(tmp_path):
    """``python -m karpenter_provider_aws_tpu_torch.deploy`` renders every
    template of ``deploy/templates/``, the port's deployment in place of
    the reference's, and the CRDs."""
    import yaml
    assert deploy.main(["--out-dir", str(tmp_path)]) == 0
    names = {p.name for p in tmp_path.iterdir()}
    assert {p.name for p in deploy.TEMPLATES.glob("*.yaml")} <= names
    dep = yaml.safe_load((tmp_path / "deployment.yaml").read_text())
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    assert c["command"] == ["karpenter-tpu-controller-torch"]
    assert "karpenter.tpu_nodepools.yaml" in names
