"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher, so it
compiles in seconds without PyTorch's headers. The shared library goes to
the build directory: ``karpenter_provider_aws_tpu_torch/_build/`` (listed
in ``.gitignore``) unless ``set_build_dir`` points it elsewhere (the
persistent compile cache, ``solver.solve.enable_persistent_compile_cache``).
A library is named by a hash of its source, the flags, the target arch and
the ``nvcc --version`` text, so an edited source, or another toolkit, is
rebuilt and an unchanged one is loaded as it is. Nothing is built at
import: the first launch builds, or a caller (``chip_smoke.py``, the
Solver's ahead-of-time warmup) builds ahead. A source that does not build
or load raises ``KernelBuildError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Union

from ..errors import KernelBuildError

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_BUILD_DIR = PKG_DIR / "_build"
# where libraries are built and looked up; set_build_dir moves it
BUILD_DIR = DEFAULT_BUILD_DIR

ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# the compiler's output of each build this process ran (ptxas registers,
# shared memory and spills), and its seconds, by source name
BUILD_LOGS: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def set_build_dir(path: Union[str, os.PathLike]) -> None:
    """Build and look up libraries in ``path`` from now on. A library this
    process already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = pathlib.Path(path)


def sources() -> List[str]:
    """The names of the package's CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels are built from source at first use")


@functools.lru_cache(maxsize=None)
def _version_of(nvcc: str) -> str:
    try:
        proc = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise KernelBuildError(f"{nvcc} --version failed: {e}") from e
    if proc.returncode != 0:
        raise KernelBuildError(f"{nvcc} --version failed "
                               f"(exit {proc.returncode}): {proc.stderr}")
    return proc.stdout


def compiler_version() -> str:
    """The ``nvcc --version`` text, part of every library's key (asked
    once a process; it compiles nothing)."""
    return _version_of(nvcc_path())


def library_path(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for part in (" ".join(NVCC_FLAGS), ARCH, compiler_version()):
        h.update(b"\0" + part.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. Safe across processes: the library is
    written under a temporary name in the build directory and renamed into
    place, so a reader never sees a part-written file."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n"
                                   f"{BUILD_LOGS[name]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path.name}: {e}") from e
            _LIBS[name] = lib
        return lib
