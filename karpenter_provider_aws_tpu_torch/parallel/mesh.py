"""Device-mesh planning for the solver: the boot-time mesh decision.

The reference shards the pod dimension of a solve over a device mesh and
decides the mesh once, at boot: :func:`plan_mesh` resolves the
operator's ``--mesh``/``SOLVER_MESH`` setting against the devices it
sees and hands the resulting :class:`MeshPlan` to the Solver.

The port solves on one device, so the only plan it accepts is the
single-device passthrough (``mesh=None``). A spec that would shard — a
forced device count above 1, or ``auto`` with more than one CUDA device
visible — raises ``NotImplementedError``: the sharded solve is not
ported. ``auto`` on the CPU, or with one card, is single-device, as in
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..device import DeviceLike


@dataclass(frozen=True)
class MeshPlan:
    """A resolved mesh decision: how many devices, why, and the mesh
    itself (always ``None`` here: the single-device passthrough)."""

    devices: int
    axis: str
    source: str               # "single" | "off"
    mesh: Optional[object]


def _single(axis: str, source: str) -> MeshPlan:
    return MeshPlan(devices=1, axis=axis, source=source, mesh=None)


def _sharded(n: int) -> NotImplementedError:
    return NotImplementedError(
        f"a {n}-device solver mesh is not ported to the PyTorch solver "
        "(ROADMAP.md A10, the sharded solve); only the single-device "
        "solve is (set SOLVER_MESH=off)")


def plan_mesh(spec: Optional[str] = None, axis: str = "pods",
              device: DeviceLike = None) -> MeshPlan:
    """Resolve a mesh spec against the devices of ``device``'s type
    (None = ``cuda``).

    ``spec``: ``None``/``""``/``"auto"`` auto-selects (single-device on
    the CPU and with one card), ``"off"``/``"none"``/``"single"``/``"1"``
    pins the single-device passthrough, and an integer string forces an
    N-way mesh. Raises ValueError for an unparseable spec and
    NotImplementedError for any plan of more than one device.
    """
    s = (spec or "auto").strip().lower()
    if s in ("off", "none", "single", "1"):
        return _single(axis, "off")
    if s == "auto":
        dev = torch.device("cuda" if device is None else device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        if n > 1:
            raise _sharded(n)
        return _single(axis, "single")
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"invalid mesh spec {spec!r}: expected 'auto', 'off', or a "
            "positive device count")
    if n < 1:
        raise ValueError(f"mesh device count must be >= 1, got {n}")
    if n == 1:
        return _single(axis, "off")
    raise _sharded(n)
