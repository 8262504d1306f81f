"""The CLI as a whole, on both packages, on the CPU (its REST helpers
also serve ``test_torch_api_wave.py``, the API-mode wave).

- Both CLIs in process: each package's ``cli.main`` with ``--api-port``,
  ``--async-runtime`` (and on the port ``--device cpu``) in a thread; a
  NodePool and 40 of cfg10's pods (every 500th) POSTed over REST inside
  one batch window; when every pod is bound (read over REST), the
  election lease is held by this process and the two servers hold equal
  claims, nodes and bindings; ``main`` returns 0 after its stop event.
- ``--compile-cache-dir`` exits non-zero before anything is served;
  ``--warm-start`` starts the process and runs the boot ladder inside the
  SLO warmup window, ``--profile-dir`` leaves a profiler trace; the
  solver sidecar and pool flags start the process (``--sidecar-address``
  serves the Operator's Solver, ``--solver-address`` and
  ``SOLVER_ADDRESSES`` put it on a solver pool); a mesh (``--mesh N``,
  ``SOLVER_MESH=N``) starts the process, its Operator's Solver on an
  N-shard mesh.

Tolerance: none.
"""

import json
import os
import socket
import threading
import time
import urllib.request

import pytest

import test_torch_cases as cases
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

TOKEN = "api-slice-token"
PKGS = (cases.JAX_PKG, cases.TORCH_PKG)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _call(method, url, doc=None, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    r = urllib.request.Request(
        url, method=method, headers=headers,
        data=None if doc is None else json.dumps(doc).encode())
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read())


# ---- both CLIs in process ----

def _cli_run(pkg, pool_dict, pod_dicts):
    port = _free_port()
    argv = [f"--api-port={port}", "--metrics-port=0", "--async-runtime",
            "--step=0.5", "--batch-idle-duration=4",
            "--batch-max-duration=60"]
    if pkg == cases.TORCH_PKG:
        argv += ["--device", "cpu"]
    cli = cases.mod(pkg, "cli")
    stop = threading.Event()
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main(argv,
                                                           stop_event=stop)),
                         daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 60
    while True:
        try:
            _call("GET", f"{base}/apis/nodepools")
            break
        except OSError:
            assert time.monotonic() < deadline, "REST surface never came up"
            time.sleep(0.1)
    try:
        # the Operator seeds its default pool while it builds: the test's
        # pool is a second one, and every pod selects it
        _call("POST", f"{base}/apis/nodepools", pool_dict)
        for d in pod_dicts:
            _call("POST", f"{base}/apis/pods", d)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            items = _call("GET", f"{base}/apis/pods")["items"]
            if items and all(o["spec"].get("nodeName") for o in items):
                break
            time.sleep(0.2)
        lease = _call("GET", f"{base}/apis/leases/karpenter-tpu-leader-election")
        claims = sorted(
            (o["metadata"]["name"], o["spec"]["nodePool"],
             o["spec"]["instanceType"], o["spec"]["zone"],
             o["spec"]["capacityType"])
            for o in _call("GET", f"{base}/apis/nodeclaims")["items"])
        nodes = sorted((o["metadata"]["name"], o["spec"]["nodeClaim"])
                       for o in _call("GET", f"{base}/apis/nodes")["items"])
        bindings = sorted((o["metadata"]["name"], o["spec"].get("nodeName"))
                          for o in _call("GET", f"{base}/apis/pods")["items"])
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and rc == [0]
    return lease["spec"]["holder"], {"claims": claims, "nodes": nodes,
                                     "bindings": bindings}


def test_both_clis_bind_rest_posted_pods_equally():
    W = cases.mod(cases.TORCH_PKG, "workloads")
    serde = cases.mod(cases.TORCH_PKG, "apis.serde")
    A = cases.mod(cases.TORCH_PKG, "apis")
    wk = cases.mod(cases.TORCH_PKG, "apis.wellknown")
    pods, _, _ = W.config10_steady_state()
    pod_dicts = []
    for p in pods[::500]:
        d = serde.pod_to_dict(p)
        d["nodeSelector"] = {**d["nodeSelector"], wk.LABEL_NODEPOOL: "steady"}
        pod_dicts.append(d)
    pool_dict = serde.nodepool_to_dict(A.NodePool(name="steady"))
    out = {pkg: _cli_run(pkg, pool_dict, pod_dicts) for pkg in PKGS}
    for holder, truth in out.values():
        assert holder.endswith(f"-{os.getpid()}")
        assert len(truth["bindings"]) == 40
        assert all(node for _, node in truth["bindings"])
        assert truth["claims"] and {c[1] for c in truth["claims"]} == {"steady"}
    assert out[cases.TORCH_PKG][1] == out[cases.JAX_PKG][1]


# ---- the port's CLI starts on the warm-start, profiling, solver sidecar,
# pool and compile cache flags ----

@pytest.mark.parametrize("flags,env", [
    (["--warm-start"], {}),
    (["--profile-dir", "{tmp}/prof"], {}),
    (["--sidecar-address", "unix:{tmp}/s.sock"], {}),
    (["--solver-address", "unix:{tmp}/a.sock"], {}),
    ([], {"SOLVER_ADDRESSES": "unix:{tmp}/a.sock"}),
    (["--compile-cache-dir", "{tmp}/cache", "--warm-start"], {}),
], ids=["warm-start", "profile-dir", "sidecar-address", "solver-address",
        "SOLVER_ADDRESSES", "compile-cache-dir"])
def test_unported_flags_exit_before_serving(flags, env, monkeypatch,
                                            tmp_path):
    """Every flag starts the process as the JAX CLI's does (none reaches
    an unported part any more; the test keeps its name):
    ``--warm-start`` runs the Solver's boot ladder (cut to one shape
    here) on a ``solver-warmup`` thread inside the SLO warmup window,
    which its end closes, ahead of time with ``--compile-cache-dir``
    (the native referee built into the directory, the shape's analysis in
    the device cost model); ``--profile-dir`` writes a profiler trace
    under the directory on the way out; ``--sidecar-address`` serves the
    Operator's Solver for the run and stops it at the end,
    ``--solver-address`` and ``SOLVER_ADDRESSES`` build the Operator on a
    solver pool of those endpoints."""
    from karpenter_provider_aws_tpu_torch import cli
    from karpenter_provider_aws_tpu_torch.native import build
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    from karpenter_provider_aws_tpu_torch.parallel import sidecar
    from karpenter_provider_aws_tpu_torch.solver import costmodel
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    flags = [f.format(tmp=tmp_path) for f in flags]
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(tmp=tmp_path))
    lat = cases.small_lattice(cases.TORCH_PKG)
    built, health = [], []
    real, serve = cli.Operator, sidecar.serve

    def operator(*a, **k):
        op = real(*a, lattice=lat, **k)
        built.append(op)
        return op

    def serve_and_probe(solver, address, **kw):
        server = serve(solver, address, **kw)
        client = sidecar.SolverClient(address)
        health.append(client.health())
        client.close()
        return server

    monkeypatch.setattr(cli, "Operator", operator)
    monkeypatch.setattr(sidecar, "serve", serve_and_probe)
    Solver = cases.mod(cases.TORCH_PKG, "solver").Solver
    monkeypatch.setattr(Solver, "BOOT_G_BUCKETS", (16,))
    monkeypatch.setattr(Solver, "BOOT_B_BUCKETS", (32,))
    windows, aot = [], []
    costmodel.model().reset()
    if "--warm-start" in flags:
        real_warmup = Solver.warmup

        def warmup(self, **kw):
            windows.append(built[0].slo.warmup_active())
            aot.append(kw["aot"])
            return real_warmup(self, **kw)

        monkeypatch.setattr(Solver, "warmup", warmup)
    rc = cli.main(flags + ["--device", "cpu", "--metrics-port=0",
                           "--duration=0.1"])
    assert rc == 0
    op, = built
    if "--warm-start" in flags:
        warm = [t for t in threading.enumerate()
                if t.name == "solver-warmup"]
        for t in warm:
            t.join(120)
        assert windows and all(windows)
        assert not op.slo.warmup_active()
        assert op.solver.device.type == "cpu"
        shapes = costmodel.model().summary()["shapes"]
        costmodel.model().reset()
        if "--compile-cache-dir" in flags:
            cache = tmp_path / "cache"
            assert set(aot) == {True}
            assert cuda_build.BUILD_DIR == build.BUILD_DIR == cache
            assert build.library_path().parent == cache
            assert build.library_path().exists()
            assert shapes["G16_B32"]["flops"] > 0
        else:
            assert set(aot) == {False} and "G16_B32" not in shapes
    elif "--profile-dir" in flags:
        traces = list((tmp_path / "prof" / "plugins" / "profile").glob(
            "*/*.pt.trace.json"))
        assert len(traces) == 1 and traces[0].stat().st_size > 0
        assert op.solver._profiler is None
    elif "--sidecar-address" in flags:
        assert [h["types"] for h in health] == [lat.T]
        assert type(op.solver).__name__ == "Solver"
        assert not (tmp_path / "s.sock").exists()    # stopped
    else:
        assert not health
        assert [ep.address for ep in op.solver.endpoints] == \
            [f"unix:{tmp_path}/a.sock"]
        assert op.solver.device.type == "cpu"


# ---- a mesh starts the process ----

@pytest.mark.parametrize("flags,env,shards", [
    (["--mesh", "2"], {}, 2),
    ([], {"SOLVER_MESH": "4"}, 4),
], ids=["mesh", "SOLVER_MESH"])
def test_mesh_flags_start_the_process(flags, env, shards, monkeypatch,
                                      tmp_path):
    from karpenter_provider_aws_tpu_torch import cli
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    lat = cases.small_lattice(cases.TORCH_PKG)
    built = []
    real = cli.Operator

    def operator(*a, **k):
        op = real(*a, lattice=lat, **k)
        built.append(op)
        return op

    monkeypatch.setattr(cli, "Operator", operator)
    rc = cli.main(flags + ["--device", "cpu", "--metrics-port=0",
                           "--duration=0.1"])
    assert rc == 0
    op, = built
    assert op.mesh_plan.devices == shards and op.mesh_plan.source == "forced"
    assert op.solver.mesh_devices == shards
    assert op.solver.device.type == "cpu"
