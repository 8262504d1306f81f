"""Guards of the PyTorch port's package boundary.

The port imports torch and numpy, never jax and never the JAX package
(whose name is a prefix of the port's: ``karpenter_provider_aws_tpu``
followed by ``.`` or the end of the name, never ``_torch``), and never
``jsonschema`` or ``grpc``, which the machine with the card does not
have. Its entry points run on the card unless the caller asks for the
CPU.
"""

import ast
import hashlib
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "karpenter_provider_aws_tpu_torch"
JAX_PKG = "karpenter_provider_aws_tpu"

PORT_FILES = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)
CHECKED_FILES = PORT_FILES + [REPO / "chip_smoke.py"]


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == JAX_PKG or name.startswith(JAX_PKG + "."))


def _imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_forbidden_name_rule():
    assert _is_forbidden("karpenter_provider_aws_tpu")
    assert _is_forbidden("karpenter_provider_aws_tpu.solver.solve")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("karpenter_provider_aws_tpu_torch")
    assert not _is_forbidden("karpenter_provider_aws_tpu_torch.ops.binpack")
    assert not _is_forbidden("jaxlib_like_name_but_not_jax")


@pytest.mark.parametrize("path", CHECKED_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = [n for n in _imported_names(path) if _is_forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_no_jsonschema_imports():
    """The wire schema validates with the port's own validator: no file
    of the port, nor chip_smoke.py, imports ``jsonschema``."""
    bad = {str(p.relative_to(REPO)): n for p in CHECKED_FILES
           for n in _imported_names(p)
           if n == "jsonschema" or n.startswith("jsonschema.")}
    assert not bad, bad


def test_no_grpc_imports():
    """The sidecar, the solver pool and replication speak the port's own
    gRPC wire (parallel/rpc.py): no file of the port, nor chip_smoke.py,
    imports ``grpc``."""
    bad = {str(p.relative_to(REPO)): n for p in CHECKED_FILES
           for n in _imported_names(p)
           if n == "grpc" or n.startswith("grpc.")}
    assert not bad, bad


def test_guard_covers_the_remote_solver_modules():
    """The import guards above check the wire, the sidecar, the pool, the
    solve window and replication, and the parallel package exports what
    the JAX package's does."""
    mods = {_module_name(p) for p in PORT_FILES}
    port = "karpenter_provider_aws_tpu_torch"
    for name in ("parallel.rpc", "parallel.sidecar", "parallel.pool",
                 "batcher.solve_window", "state.replication"):
        assert f"{port}.{name}" in mods, name
    import karpenter_provider_aws_tpu.parallel as jax_parallel
    from karpenter_provider_aws_tpu_torch import parallel
    assert set(jax_parallel.__all__) <= set(parallel.__all__)
    for name in parallel.__all__:
        assert getattr(parallel, name) is not None


def test_guard_covers_the_native_referee_and_every_jax_module():
    """Every module file of the JAX package has its counterpart in the
    port (the native referee, ``native/``, was the last), so the import
    guards above check the port's copy of each; the referee's C++ source
    ships inside the port package."""
    jax_root = REPO / JAX_PKG
    jax_files = {p.relative_to(jax_root) for p in jax_root.rglob("*.py")}
    port_files = {p.relative_to(PORT) for p in PORT_FILES}
    assert jax_files <= port_files, sorted(map(str, jax_files - port_files))
    mods = {_module_name(p) for p in PORT_FILES}
    for name in ("native", "native.build", "native.oracle"):
        assert f"karpenter_provider_aws_tpu_torch.{name}" in mods, name
    assert (PORT / "native" / "ffd.cc").is_file()
    from karpenter_provider_aws_tpu_torch import native
    assert set(native.__all__) >= {"ensure_built", "native_available",
                                   "native_ffd_pack"}


def test_guard_covers_the_bench_and_its_tools():
    """The import guards above check the port's bench and its host-side
    benches, and no file of the port, nor chip_smoke.py, imports the
    repository's ``bench.py`` or ``tools/`` (both import the JAX
    package)."""
    mods = {_module_name(p) for p in PORT_FILES}
    port = "karpenter_provider_aws_tpu_torch"
    for name in ("bench", "tools", "tools.bench_interruption",
                 "tools.bench_explain", "tools.bench_headroom",
                 "tools.churn", "tools.overhead_order", "tools.profile_run"):
        assert f"{port}.{name}" in mods, name
    bad = {str(p.relative_to(REPO)): n for p in CHECKED_FILES
           for n in _imported_names(p)
           if n in ("bench", "tools") or n.startswith("tools.")}
    assert not bad, bad


def test_every_module_imports_without_jax():
    """Every port module imports in a fresh process where importing jax,
    the JAX package, jsonschema or grpc fails."""
    mods = [_module_name(p) for p in PORT_FILES]
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['jsonschema'] = None",
        "sys.modules['grpc'] = None",
        f"sys.modules['{JAX_PKG}'] = None",
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "leaked = [m for m, v in sys.modules.items() if v is not None and (",
        f"          m == 'jax' or m.startswith('jax.') or m == '{JAX_PKG}'",
        f"          or m.startswith('{JAX_PKG}.'))]",
        "assert not leaked, leaked",
        "print('imported', len(" + repr(mods) + "))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {len(mods)}" in out.stdout


def test_guard_covers_the_operator_modules():
    """The import guards above check the Operator and every module it
    constructs: its subpackages, the webhooks, the providers, the
    controllers and the introspection layer."""
    mods = {_module_name(p) for p in PORT_FILES}
    port = "karpenter_provider_aws_tpu_torch"
    for name in ("operator", "operator.operator", "operator.options",
                 "interruption", "interruption.controller",
                 "interruption.messages", "interruption.queue",
                 "parallel", "parallel.mesh", "webhooks",
                 "cloudprovider.decorator", "controllers.tagging",
                 "controllers.garbagecollection", "controllers.nodeclass",
                 "providers.version", "providers.subnet",
                 "providers.securitygroup", "providers.instanceprofile",
                 "providers.launchtemplate", "providers.pricing",
                 "utils.logging", "utils.fanout", "solver.costmodel",
                 "introspect.registry", "introspect.slo", "introspect.sampler",
                 "introspect.headroom", "introspect.profiler"):
        assert f"{port}.{name}" in mods, name


def test_guard_covers_the_api_stratum_and_the_cli():
    """The import guards above check every module of the API stratum and
    the CLI, and the kube package exports what the JAX package's does."""
    mods = {_module_name(p) for p in PORT_FILES}
    port = "karpenter_provider_aws_tpu_torch"
    for name in ("apis.serde", "apis.schema", "kube", "kube.apiserver",
                 "kube.client", "kube.informer", "kube.eventsink",
                 "kube.writer", "kube.httpserver", "operator.sync",
                 "operator.leaderelection", "operator.runtime", "debug",
                 "cli", "__main__"):
        assert f"{port}.{name}" in mods, name
    from karpenter_provider_aws_tpu_torch import kube
    assert "serve_http" in kube.__all__ and "KubeClient" in kube.__all__


def test_cli_runs_where_jax_and_jsonschema_cannot_load(tmp_path):
    """``python -m karpenter_provider_aws_tpu_torch`` in a process where
    jax, the JAX package and jsonschema cannot be imported: ``--help``
    names the ``--device`` flag, the port's own schema validator admits
    a NodePool, a short run on the CPU in API mode (``--api-port``)
    exits 0, and nothing of jax, the JAX package or jsonschema was
    loaded."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = "\n".join([
        "import runpy, sys",
        "sys.modules['jax'] = None",
        "sys.modules['jsonschema'] = None",
        "sys.modules['grpc'] = None",
        f"sys.modules['{JAX_PKG}'] = None",
        "sys.argv = ['karpenter_provider_aws_tpu_torch', '--device', 'cpu',",
        f"            '--metrics-port', '0', '--api-port', '{port}',",
        "            '--duration', '0.3', '--step', '0.1']",
        "from karpenter_provider_aws_tpu_torch.kube import FakeAPIServer",
        "from karpenter_provider_aws_tpu_torch.apis import NodePool, serde",
        "from karpenter_provider_aws_tpu_torch import kube",
        "s = FakeAPIServer(); kube.install_admission(s)",
        "s.create('nodepools', serde.nodepool_to_dict(NodePool(name='np')))",
        "try:",
        "    runpy.run_module('karpenter_provider_aws_tpu_torch',",
        "                     run_name='__main__')",
        "except SystemExit as e:",
        "    assert e.code in (0, None), e.code",
        "leaked = [m for m, v in sys.modules.items() if v is not None and (",
        f"          m == 'jax' or m.startswith('jax.') or m == '{JAX_PKG}'",
        f"          or m.startswith('{JAX_PKG}.') or m == 'jsonschema')]",
        "assert not leaked, leaked",
        "print('ran')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ran" in out.stdout
    helped = subprocess.run(
        [sys.executable, "-m", "karpenter_provider_aws_tpu_torch", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert helped.returncode == 0 and "--device" in helped.stdout


def test_guard_covers_the_ladder_and_weather_modules():
    """The import guards above check the fault injector and the weather
    package, and both export what the JAX package's do."""
    mods = {_module_name(p) for p in PORT_FILES}
    port = "karpenter_provider_aws_tpu_torch"
    for name in ("solver.faults", "weather", "weather.fields",
                 "weather.scenario", "weather.simulator"):
        assert f"{port}.{name}" in mods, name
    from karpenter_provider_aws_tpu_torch import solver, weather
    assert "FaultInjector" in solver.__all__
    assert weather.__all__ == [
        "WeatherScenario", "Regime", "Storm", "IceSpell", "SidecarOutage",
        "NAMED_SCENARIOS", "named", "load_scenario", "SpotMarketField",
        "IceField", "WeatherSimulator", "inject_device_errors"]


def test_solver_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from karpenter_provider_aws_tpu_torch.lattice import build_catalog, build_lattice
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch import convert
    lat = build_lattice([s for s in build_catalog() if s.family == "m5"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver(lat)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver(lat, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.lattice_tensors(lat)
    s = Solver(lat, device="cpu")
    assert s.device.type == "cpu" and s._alloc.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_wrapper_rejects_bad_inputs():
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    if not torch.cuda.is_available():
        # CPU tensors take the plain version; nothing else is accepted
        with pytest.raises(ValueError):
            oa.cheapest_offering(torch.zeros((2, 3), dtype=torch.bool,
                                             device="meta"),
                                 torch.zeros((2, 2), dtype=torch.bool),
                                 torch.zeros((3, 2)))
        return
    dev = torch.device("cuda")
    tm = torch.ones((4, 5), dtype=torch.bool, device=dev)
    zc = torch.ones((4, 2), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        oa.cheapest_offering(tm, zc, torch.zeros((5, 3), device=dev))
    with pytest.raises(TypeError):
        oa.cheapest_offering(tm, zc, torch.zeros((5, 2), dtype=torch.float64,
                                                 device=dev))


def test_catalog_copied_byte_for_byte():
    rel = pathlib.Path("lattice") / "data" / "reference_catalog.json"
    a = (REPO / JAX_PKG / rel).read_bytes()
    b = (PORT / rel).read_bytes()
    assert hashlib.sha256(a).hexdigest() == hashlib.sha256(b).hexdigest()


def test_cuda_source_and_build_dir(monkeypatch):
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) \
        == ["offering_argmin.cu"]
    src = (PORT / "csrc" / "offering_argmin.cu").read_text()
    assert 'extern "C"' in src and "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    ignored = (REPO / ".gitignore").read_text().split()
    assert "karpenter_provider_aws_tpu_torch/_build/" in ignored
    assert cuda_build.DEFAULT_BUILD_DIR == PORT / "_build"
    monkeypatch.setattr(cuda_build, "compiler_version", lambda: "nvcc 12")
    assert cuda_build.library_path("offering_argmin").parent == cuda_build.BUILD_DIR


def test_cuda_build_failure_is_a_kernel_build_error(monkeypatch, tmp_path):
    """No ``nvcc`` and a compiler that fails both raise
    ``KernelBuildError``, which the Solver's ladder never retries and no
    rung carries."""
    import shutil
    from karpenter_provider_aws_tpu_torch.errors import KernelBuildError
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        cuda_build.build("offering_argmin")
    assert issubclass(KernelBuildError, RuntimeError)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "compiler_version", lambda: "nvcc 12")
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 2, "", "error: bad"))
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        cuda_build.build("offering_argmin")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_convert_keeps_dtypes_and_shapes():
    import numpy as np
    from karpenter_provider_aws_tpu_torch import convert
    from karpenter_provider_aws_tpu_torch.ops import binpack as tb
    t = convert.tensor(np.int32(7), "cpu")
    assert t.shape == () and t.dtype == torch.int32
    st = tb.empty_state(4, 3, 2, 2, 11, 1, device="cpu")
    again = convert.named_tensors(tb.BinState, st, "cpu")
    for name in tb.BinState._fields:
        a, b = getattr(st, name), getattr(again, name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    with pytest.raises(TypeError):
        convert.fused_buffer(np.zeros(4, np.int32), "cpu")


# the repository's tool modules, which import the JAX package (and put the
# repository on ``sys.path`` to do it): the port carries its own copies
REPO_TOOL_MODULES = ("tools", "kpctl", "soak", "gen_crds", "gen_docs",
                     "allocatable_diff", "import_reference_data", "kompat",
                     "deflake", "lint", "bench", "__graft_entry__")
OPERATOR_TOOLS = ("entry", "deploy", "tools.kpctl", "tools.soak",
                  "tools.gen_crds", "tools.gen_docs", "tools.allocatable_diff",
                  "tools.import_reference_data", "tools.kompat",
                  "tools.lint", "tools.lint.rules", "tools.lint.baseline",
                  "tools.lint.run", "tools.gate")
# the CI gates, counterparts of the repository's tools/smoke_*.py, in the
# order of the repository's tools/ci.sh
SMOKE_GATES = tuple(re.findall(r"^\$PY tools/smoke_(\w+)\.py",
                               (REPO / "tools" / "ci.sh").read_text(),
                               re.MULTILINE))
OPERATOR_TOOLS += tuple(f"tools.smoke_{g}" for g in SMOKE_GATES)


def test_guard_covers_the_operator_tools_and_entry():
    """The import guards above check the port's kpctl, soak, generators,
    lint runner, CI gates, entry module and deployment renderer; no file of the
    port, nor chip_smoke.py, imports one of the repository's tool modules
    or edits ``sys.path`` to reach them, and each new module imports in a
    process where jax, the JAX package and the repository's tools cannot
    load."""
    mods = {_module_name(p) for p in PORT_FILES}
    port = "karpenter_provider_aws_tpu_torch"
    for name in OPERATOR_TOOLS:
        assert f"{port}.{name}" in mods, name
    assert (PORT / "tools" / "lint" / "baseline.json").is_file()
    assert (PORT / "deploy" / "deployment.yaml").is_file()
    bad = {str(p.relative_to(REPO)): n for p in CHECKED_FILES
           for n in _imported_names(p)
           if n.split(".")[0] in REPO_TOOL_MODULES}
    assert not bad, bad
    touching = [str(p.relative_to(REPO)) for p in PORT_FILES
                if "sys.path" in p.read_text()]
    assert not touching, touching
    code = "\n".join(
        ["import sys"]
        + [f"sys.modules[{m!r}] = None"
           for m in ("jax", "jsonschema", "grpc", JAX_PKG)
           + REPO_TOOL_MODULES]
        + ["import importlib",
           f"for m in {[f'{port}.{n}' for n in OPERATOR_TOOLS]!r}:",
           "    importlib.import_module(m)",
           "print('imported')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout


def test_port_ci_script_runs_the_ports_modules_only():
    """The port's ``tools/ci.sh`` runs, in the repository gate's order,
    the port's drift check (``gen_crds`` and ``gen_docs --check``), its
    lint, each of the twelve CI gates with ``--device "$DEVICE"``, the
    port's tests and its bench; it names no module of the repository's
    ``tools/`` and nothing of the JAX package."""
    text = (PORT / "tools" / "ci.sh").read_text()
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    pkg = "$PKG"
    assert "PKG=karpenter_provider_aws_tpu_torch" in code
    steps = [f"{pkg}.tools.gen_crds --check",
             f"{pkg}.tools.gen_docs --check",
             f"{pkg}.tools.lint.run --check"]
    steps += [f'{pkg}.tools.smoke_{g} --device "$DEVICE"'
              for g in SMOKE_GATES]
    steps += ["pytest tests/test_torch_*.py", "-m 'not slow'",
              f'{pkg}.bench --device "$DEVICE" --smoke']
    at = [code.find(s) for s in steps]
    assert -1 not in at, [s for s, a in zip(steps, at) if a == -1]
    assert at == sorted(at)
    assert len(SMOKE_GATES) == 12
    assert sorted(SMOKE_GATES) == sorted(
        re.findall(r"\.tools\.smoke_(\w+) ", code)) == sorted(
        p.stem[len("smoke_"):] for p in (PORT / "tools").glob("smoke_*.py"))
    assert "DEVICE=${DEVICE:-cuda}" in code and "--fast" in code
    assert code.count("=== ci [") == 17          # 16 steps, 16 skipped
    # the port's own path is the one mention of a tools/ directory
    rest = text.replace("karpenter_provider_aws_tpu_torch/tools/ci.sh", "")
    assert not re.search(r"(^|[^\w.])tools/", rest), rest
    assert not re.search(r"karpenter_provider_aws_tpu[./]", text)
    assert "JAX_PLATFORMS" not in code and "bench.py" not in text


def test_guard_covers_the_rank_worker(tmp_path):
    """The worker ranks of a mesh (parallel/ranks.py) are processes of
    their own: their entry module is a module of the port, which the
    guards above check, and in a process where importing jax or the JAX
    package fails, ranks start, and what each worker had imported when
    it joined its group holds the pack's modules and nothing of either."""
    mods = {_module_name(p) for p in PORT_FILES}
    assert "karpenter_provider_aws_tpu_torch.parallel.ranks" in mods
    from karpenter_provider_aws_tpu_torch.parallel import ranks
    assert ranks._worker_main.__module__ == \
        "karpenter_provider_aws_tpu_torch.parallel.ranks"
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        f"sys.modules['{JAX_PKG}'] = None",
        "import torch",
        "torch.set_num_threads(1)",
        "from karpenter_provider_aws_tpu_torch.parallel import ranks, "
        "solver_mesh",
        "rs = ranks.acquire(solver_mesh(2, device='cpu', ranks=2), "
        "torch.device('cpu'))",
        "mods = rs.worker_modules[0]",
        "assert 'karpenter_provider_aws_tpu_torch.parallel.sharded' in mods",
        "bad = [m for m in mods if m == 'jax' or m.startswith('jax.')",
        f"       or m == '{JAX_PKG}' or m.startswith('{JAX_PKG}.')]",
        "assert not bad, bad",
        "rs.close()",
        "assert not ranks.live_workers()",
        "print('worker clean', len(mods))",
    ])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "worker clean" in out.stdout
