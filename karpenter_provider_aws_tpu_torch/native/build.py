"""On-demand build and load of the native (C++) FFD referee.

The referee is host C++ (``ffd.cc`` beside this file, a copy of the
repo's ``native/ffd.cc``), not a device kernel: the benchmarks hold every
device plan's cost to it, and it runs the 50k-pod configurations in about
a second where the Python oracle takes tens. No pybind11, so the ABI is a
plain ``extern "C"`` function called through ctypes. ``g++`` builds the
shared object at first use into the build directory: the package's
``_build/`` (ignored by git) unless ``set_build_dir`` points it elsewhere
(the persistent compile cache). The library is named by a hash of the
source, the flags, the ``g++ --version`` text and the target machine, so
another source or compiler builds anew and an unchanged one is loaded as
it is. Without a toolchain ``native_available()`` is False and callers
use the Python oracle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Union

_SRC = Path(__file__).resolve().parent / "ffd.cc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# where the library is built and looked up; set_build_dir moves it
BUILD_DIR = DEFAULT_BUILD_DIR
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# the compiler's output and seconds of each build this process ran
BUILD_LOGS: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def set_build_dir(path: Union[str, os.PathLike]) -> None:
    """Build and look up the library in ``path`` from now on. A library
    already loaded stays loaded; a failed build is tried again there."""
    global BUILD_DIR, _build_failed
    with _lock:
        BUILD_DIR = Path(path)
        _build_failed = False


@functools.lru_cache(maxsize=None)
def compiler_version() -> str:
    """The ``g++ --version`` text, part of the library's key (asked once
    a process). Raises ``OSError`` or ``SubprocessError`` without g++."""
    return subprocess.run(["g++", "--version"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    for part in (" ".join(GXX_FLAGS), platform.machine(), compiler_version()):
        h.update(b"\0" + part.encode())
    return BUILD_DIR / f"libffd-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``ffd.cc`` unless its library is already built; returns the
    library's path. The build writes a temporary file in the build
    directory and renames it, so processes building at once never load a
    half-written library. Raises ``OSError`` or ``SubprocessError``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        t = time.perf_counter()
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)],
                              check=True, capture_output=True, text=True,
                              timeout=120)
        BUILD_SECONDS["ffd"] = time.perf_counter() - t
        BUILD_LOGS["ffd"] = proc.stdout + proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def ensure_built() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if there is no
    toolchain or the build directory cannot be written."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.ffd_pack.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return ensure_built() is not None
