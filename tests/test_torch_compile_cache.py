"""The PyTorch port's kernel build cache behind ``COMPILE_CACHE_DIR``
(``solver.solve.enable_persistent_compile_cache``) on the CPU, against the
JAX package's function of that name where both answer.

- The native referee (``native/build.py``, g++ here) builds into the cache
  directory; a second process loads it from there without running the
  compiler, and two processes building into one empty directory at once
  leave one library and no temporary file.
- A library's key carries its compiler's version: another ``g++ --version``
  or ``nvcc --version`` text names another library (the CUDA build is
  reached here only through its key: there is no nvcc).
- A directory that cannot be written returns False, as the JAX function
  does for a knob it cannot set, and leaves the process as it was: its
  build directories and its device (no card still raises).
- The Operator, ``warmup(aot=True)`` and the rank workers use the
  directory that was set.

Tolerance: none (paths, names and flags).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import test_torch_cases as cases
from karpenter_provider_aws_tpu.solver.solve import (
    enable_persistent_compile_cache as j_enable)
from karpenter_provider_aws_tpu_torch.native import build as native_build
from karpenter_provider_aws_tpu_torch.ops import cuda_build
from karpenter_provider_aws_tpu_torch.solver import costmodel
from karpenter_provider_aws_tpu_torch.solver.solve import (
    enable_persistent_compile_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def build_dirs(monkeypatch):
    """Each test's changes to the build directories end with it."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(native_build, "BUILD_DIR", native_build.BUILD_DIR)
    monkeypatch.setattr(native_build, "_build_failed",
                        native_build._build_failed)


def _have_gpp():
    try:
        native_build.compiler_version()
        return True
    except (OSError, subprocess.SubprocessError):
        return False


_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    from karpenter_provider_aws_tpu_torch.solver.solve import (
        enable_persistent_compile_cache)
    from karpenter_provider_aws_tpu_torch.native import build
    assert enable_persistent_compile_cache({cache!r})
    lib = build.ensure_built()
    print(json.dumps({{"built": sorted(build.BUILD_LOGS),
                       "path": str(build.library_path()),
                       "loaded": lib is not None}}))
""")


def _child(cache):
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO, cache=str(cache))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_enable_points_both_builds_at_the_directory(tmp_path):
    cache = tmp_path / "a" / "cache"
    assert enable_persistent_compile_cache(str(cache))
    assert cache.is_dir()
    assert cuda_build.BUILD_DIR == native_build.BUILD_DIR == cache
    # again, and elsewhere: safe to call more than once
    assert enable_persistent_compile_cache(str(cache))
    other = tmp_path / "other"
    assert enable_persistent_compile_cache(str(other))
    assert cuda_build.BUILD_DIR == native_build.BUILD_DIR == other
    # the JAX function answers True for a writable directory too
    assert j_enable(str(tmp_path / "jax"))


def test_unwritable_directory_returns_false_and_changes_nothing(
        tmp_path, monkeypatch, caplog):
    """A path under a regular file cannot be created (also as root): the
    call says False and logs why; the build directories stay, and a
    process without a card still refuses to run (nothing falls back to
    the CPU)."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    before = (cuda_build.BUILD_DIR, native_build.BUILD_DIR)
    with caplog.at_level("WARNING"):
        assert not enable_persistent_compile_cache(str(blocker / "cache"))
    assert "not writable" in caplog.text
    assert (cuda_build.BUILD_DIR, native_build.BUILD_DIR) == before
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Operator(options=Options(compile_cache_dir=str(blocker / "cache")),
                 lattice=cases.small_lattice(cases.TORCH_PKG))
    assert (cuda_build.BUILD_DIR, native_build.BUILD_DIR) == before


def test_key_changes_with_the_compiler_version(monkeypatch):
    monkeypatch.setattr(native_build, "compiler_version", lambda: "g++ 12.2")
    a = native_build.library_path()
    monkeypatch.setattr(native_build, "compiler_version", lambda: "g++ 13.1")
    b = native_build.library_path()
    assert a != b and a.parent == b.parent == native_build.BUILD_DIR
    assert a.name.startswith("libffd-") and b.name.startswith("libffd-")
    monkeypatch.setattr(cuda_build, "compiler_version",
                        lambda: "Cuda compilation tools, release 12.4")
    c = cuda_build.library_path("offering_argmin")
    monkeypatch.setattr(cuda_build, "compiler_version",
                        lambda: "Cuda compilation tools, release 12.8")
    d = cuda_build.library_path("offering_argmin")
    assert c != d and c.parent == cuda_build.BUILD_DIR
    assert c.name.startswith("liboffering_argmin-")


def test_cuda_build_lands_in_the_cache_and_is_not_rebuilt(tmp_path,
                                                         monkeypatch):
    """With a stand-in compiler (there is no nvcc here): the library is
    written in the cache directory under its key, and the next build of
    the same source runs no compiler."""
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "compiler_version", lambda: "nvcc 12")
    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    assert enable_persistent_compile_cache(str(tmp_path / "cache"))
    names = cuda_build.sources()
    assert names == ["offering_argmin"]
    path = cuda_build.build(names[0])
    assert path.parent == tmp_path / "cache" and path.read_bytes() == b"lib"
    assert cuda_build.build(names[0]) == path and len(calls) == 1
    assert os.listdir(tmp_path / "cache") == [path.name]


def test_second_process_loads_without_a_rebuild(tmp_path):
    if not _have_gpp():
        pytest.skip("no C++ toolchain")
    cache = tmp_path / "cache"
    first = _result(_child(cache))
    assert first["loaded"] and first["built"] == ["ffd"]
    path = first["path"]
    assert os.path.dirname(path) == str(cache)
    mtime = os.stat(path).st_mtime_ns
    second = _result(_child(cache))
    assert second == {**first, "built": []}
    assert os.stat(path).st_mtime_ns == mtime
    assert os.listdir(cache) == [os.path.basename(path)]


def test_two_processes_build_into_one_directory_at_once(tmp_path):
    if not _have_gpp():
        pytest.skip("no C++ toolchain")
    cache = tmp_path / "cache"
    procs = [_child(cache), _child(cache)]
    results = [_result(p) for p in procs]
    assert all(r["loaded"] for r in results)
    assert {r["path"] for r in results} == {results[0]["path"]}
    # the rename is atomic: one library, no temporary file left
    assert os.listdir(cache) == [os.path.basename(results[0]["path"])]


def test_operator_sets_the_cache_before_its_solver(tmp_path):
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    cache = tmp_path / "cache"
    op = Operator(options=Options(compile_cache_dir=str(cache)),
                  lattice=cases.small_lattice(cases.TORCH_PKG), device="cpu")
    assert cuda_build.BUILD_DIR == native_build.BUILD_DIR == cache
    assert op.solver.device.type == "cpu"


def test_aot_warmup_builds_into_the_cache_and_records_the_shape(tmp_path):
    if not _have_gpp():
        pytest.skip("no C++ toolchain")
    from karpenter_provider_aws_tpu_torch.solver import Solver
    # a library this process loaded before the cache was set is built
    # into the cache all the same
    assert native_build.ensure_built() is not None
    cache = tmp_path / "cache"
    assert enable_persistent_compile_cache(str(cache))
    costmodel.model().reset()
    s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu")
    s.warmup(g_buckets=(16,), b_buckets=(32,), aot=True)
    assert native_build.library_path().parent == cache
    assert native_build.library_path().exists()
    rec = costmodel.model().summary()["shapes"][costmodel.shape_key(16, 32)]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["peak_bytes"] > 0
    costmodel.model().reset()


def test_rank_workers_load_from_the_parent_directory(tmp_path):
    """Spawned workers start with the package's default build directory:
    rank 0 hands them its own."""
    from karpenter_provider_aws_tpu_torch.parallel import ranks, solver_mesh
    from karpenter_provider_aws_tpu_torch.solver import Solver
    cache = tmp_path / "cache"
    assert enable_persistent_compile_cache(str(cache))
    mesh = solver_mesh(4, device="cpu", ranks=2)
    try:
        s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu",
                   mesh=mesh)
        s.solve(cases.problem(cases.TORCH_PKG, "generic"))
        assert s._ranks.worker_build_dirs == [str(cache)]
    finally:
        ranks.shutdown_all()
    assert ranks.live_workers() == []


def test_sidecar_takes_the_directory_from_its_environment(tmp_path,
                                                          monkeypatch):
    """A sidecar process started with ``COMPILE_CACHE_DIR`` (as a parent
    that set the cache passes it on) builds there, before its Solver."""
    from karpenter_provider_aws_tpu_torch.parallel import sidecar

    class Stop(Exception):
        pass

    seen = []

    def serve(solver, address, **kw):
        seen.append((str(cuda_build.BUILD_DIR), str(native_build.BUILD_DIR),
                     solver.device.type))
        raise Stop

    monkeypatch.setattr(sidecar, "serve", serve)
    monkeypatch.setenv("COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(Stop):
        sidecar.main(["--device", "cpu", "--synthetic-catalog",
                      "--address", f"unix:{tmp_path}/s.sock"])
    assert seen == [(str(tmp_path / "cache"),) * 2 + ("cpu",)]
