"""On-demand build and load of the native (C++) FFD referee.

The referee is host C++ (``ffd.cc`` beside this file, a copy of the
repo's ``native/ffd.cc``), not a device kernel: the benchmarks hold every
device plan's cost to it, and it runs the 50k-pod configurations in about
a second where the Python oracle takes tens. No pybind11, so the ABI is a
plain ``extern "C"`` function called through ctypes. ``g++`` builds the
shared object at first use into the package's ``_build/`` directory
(ignored by git), again whenever the source is newer than it; without a
toolchain ``native_available()`` is False and callers use the Python
oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "ffd.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LIB = BUILD_DIR / "libffd.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def ensure_built() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load the native library; None if no
    toolchain. The build writes a temporary file and renames it, so
    processes building at once never load a half-written library."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            if (not _LIB.exists()
                    or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                         "-o", tmp, str(_SRC)],
                        check=True, capture_output=True, timeout=120)
                    os.replace(tmp, _LIB)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(_LIB))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.ffd_pack.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return ensure_built() is not None
