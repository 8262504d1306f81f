"""Device cost model: what a solve SHOULD cost vs what it measured.

Every live solve's measured compute stage is attributed to its (G, B)
bucket-ladder shape:

- **modeled floor** = the best compute time ever measured for that
  shape (self-calibrating: the first solves establish what the hardware
  actually achieves for this pack; no hand-waved peak-FLOPs constant),
- **measured vs modeled** ratio per solve: ~1.0 means the device ran
  the pack at its demonstrated speed; >>1.0 means the slowness is NOT
  the pack — queueing, another caller's kernels — and the profiler and
  contention layers say which.

``kpctl top``'s DEVICE row and ``/debug/pprof/device`` render this;
burn-triggered captures (introspect/profiler.py BurnCapture) embed the
summary so a degradation episode records whether the device itself
slowed down. Live device memory rides along from
``torch.cuda.memory_stats`` once the process has used the card, mapped
onto the reference's key names; before that (and on a CPU-only run) the
fields report 0, as the reference's do on its CPU backend.

Each shape's FLOPs, bytes accessed and peak footprint come from the
pack's analysis (ops/binpack.py ``pack_analysis``, a trace on the meta
device that runs nothing), recorded through ``record_compiled`` as the
reference records a compiled executable's: by ``Solver.capture_cost_model``
and by the ahead-of-time warmup (``Solver.warmup(aot=True)``, which on the
card takes the peak from the allocator over the shape's run). Unlike the
reference's lowering, which counts the scan body once, the analysis
counts every one of the G scan steps, so its figures grow with G.

Everything is bounded (one entry per shape — the bucket ladder is
finite by construction) and off the hot path: ``observe_solve`` is a
dict update per solve.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_MAX_SHAPES = 256   # bucket ladder is ~dozens; this is a runaway bound


class DeviceCostModel:
    def __init__(self):
        self._lock = threading.Lock()
        # shape key ("G64_B512") -> model/measurement record
        self._shapes: Dict[str, Dict] = {}
        self.last_shape: Optional[str] = None
        self.captures = 0          # analyses recorded
        self.capture_errors = 0

    # ---- per-shape analysis ------------------------------------------------

    def record_compiled(self, key: str, compiled) -> bool:
        """Capture ``cost_analysis()`` / ``memory_analysis()`` from an
        analysis handle (``binpack.pack_analysis``; the reference's
        compiled or lowered executable has the same two methods). Never
        raises: an analysis that fails counts in ``capture_errors``."""
        flops = bytes_accessed = peak_bytes = 0.0
        try:
            ca = compiled.cost_analysis()
            # a dict, or a 1-list of dicts, as the reference's versions give
            if isinstance(ca, (list, tuple)):
                ca = ca[0] if ca else {}
            if isinstance(ca, dict):
                flops = float(ca.get("flops", 0.0) or 0.0)
                bytes_accessed = float(ca.get("bytes accessed", 0.0) or 0.0)
        except Exception:   # noqa: BLE001
            self.capture_errors += 1
        try:
            ma = compiled.memory_analysis()
            for attr in ("temp_size_in_bytes", "output_size_in_bytes",
                         "argument_size_in_bytes"):
                peak_bytes += float(getattr(ma, attr, 0) or 0)
        except Exception:   # noqa: BLE001
            pass   # memory_analysis is rarer than cost_analysis
        if not (flops or bytes_accessed or peak_bytes):
            return False
        self.record_analysis(key, flops=flops, bytes_accessed=bytes_accessed,
                             peak_bytes=peak_bytes)
        return True

    def record_analysis(self, key: str, flops: float = 0.0,
                        bytes_accessed: float = 0.0,
                        peak_bytes: float = 0.0) -> None:
        """The raw-form entry point (tests; analyses made elsewhere)."""
        with self._lock:
            if key not in self._shapes and len(self._shapes) >= _MAX_SHAPES:
                return
            rec = self._shapes.setdefault(key, self._fresh())
            rec["flops"] = flops
            rec["bytes_accessed"] = bytes_accessed
            rec["peak_bytes"] = peak_bytes
            self.captures += 1

    @staticmethod
    def _fresh() -> Dict:
        return {"flops": 0.0, "bytes_accessed": 0.0, "peak_bytes": 0.0,
                "solves": 0, "best_ms": 0.0, "last_ms": 0.0}

    # ---- per-solve attribution --------------------------------------------

    def observe_solve(self, key: str, compute_ms: float) -> None:
        """Attribute one solve's measured compute stage to its shape:
        the rolling best is the model floor; last-vs-best is the
        contention signal."""
        if compute_ms <= 0:
            return
        with self._lock:
            if key not in self._shapes and len(self._shapes) >= _MAX_SHAPES:
                return
            rec = self._shapes.setdefault(key, self._fresh())
            rec["solves"] += 1
            rec["last_ms"] = round(compute_ms, 4)
            if rec["best_ms"] == 0.0 or compute_ms < rec["best_ms"]:
                rec["best_ms"] = round(compute_ms, 4)
            self.last_shape = key

    # ---- reporting ---------------------------------------------------------

    @staticmethod
    def device_memory() -> Dict[str, float]:
        """Live device memory of the current CUDA device, under the
        reference's key names (zeros before the process touched the card,
        and on a CPU-only run)."""
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {"bytes_in_use": 0.0, "bytes_limit": 0.0,
                    "peak_bytes_in_use": 0.0}
        dev = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": float(
                torch.cuda.get_device_properties(dev).total_memory),
            "peak_bytes_in_use": float(
                stats.get("allocated_bytes.all.peak", 0)),
        }

    def stats(self) -> Dict[str, float]:
        """The introspection provider (flat numeric keys): the LAST
        solved shape's measured-vs-modeled plus live device memory."""
        with self._lock:
            out: Dict[str, float] = {
                "shapes": len(self._shapes),
                "captures": self.captures,
                "capture_errors": self.capture_errors,
            }
            key = self.last_shape
            rec = self._shapes.get(key) if key else None
            if rec is not None:
                out["last_compute_ms"] = rec["last_ms"]
                out["last_model_ms"] = rec["best_ms"]
                out["last_vs_model"] = (
                    round(rec["last_ms"] / rec["best_ms"], 3)
                    if rec["best_ms"] else 0.0)
                out["last_flops"] = rec["flops"]
        out.update(self.device_memory())
        return out

    def summary(self) -> Dict:
        """The /debug/pprof/device document + burn-capture embed: every
        shape's model and measurements."""
        with self._lock:
            shapes = {k: dict(v) for k, v in sorted(self._shapes.items())}
            for rec in shapes.values():
                if rec["best_ms"]:
                    rec["last_vs_model"] = round(
                        rec["last_ms"] / rec["best_ms"], 3)
        return {"shapes": shapes, "captures": self.captures,
                "captureErrors": self.capture_errors,
                "deviceMemory": self.device_memory(),
                "lastShape": self.last_shape}

    def reset(self) -> None:
        with self._lock:
            self._shapes.clear()
            self.last_shape = None
            self.captures = 0
            self.capture_errors = 0


_MODEL = DeviceCostModel()


def model() -> DeviceCostModel:
    """The process-wide cost model (one device pipeline per process)."""
    return _MODEL


def shape_key(G: int, B: int, mesh_devices: int = 1) -> str:
    """Cost-model key for one compiled shape. The device count is PART
    of the key: a mesh-compiled executable is a different program (D-way
    shard_map + collectives) with a different demonstrated-best compute
    floor — letting it share the single-device (G,B) entry would pollute
    the best-demonstrated baseline in both directions and make
    ``last_vs_model`` read as phantom contention after every mesh↔single
    transition (bench rows key the same way)."""
    if mesh_devices > 1:
        return f"G{G}_B{B}_D{mesh_devices}"
    return f"G{G}_B{B}"
