"""Device-mesh planning for the solver: the boot-time mesh decision.

The reference shards the pod dimension of a solve over a device mesh and
decides the mesh once, at boot: :func:`plan_mesh` resolves the
operator's ``--mesh``/``SOLVER_MESH`` setting against the devices it
sees and hands the resulting :class:`MeshPlan` to the Solver, which then
runs every solve (full, wave-split and the steady-state delta) over it.

Here a mesh of D shards is one batched pass on the Solver's own device
(parallel/sharded.py ``sharded_pack``): the D shards' scans run as one
vmapped scan and their bins as one cheapest-offering launch over D·B
rows. A mesh never moves work off the Solver's device, and there is no
virtual-CPU fallback: ``--mesh 8`` on the card runs 8 shards on the
card.

Auto policy: ``auto`` plans the single-device path, on the CPU and on
CUDA with any number of cards visible. The reference's ``auto`` takes
every chip of a multi-chip backend because each shard gets a chip of its
own; here the N shards would all share the Solver's one card (one shard
per card is not ported), so ``auto`` gains no hardware from them, and a
mesh batched on one card is slower than the single-device solve (cfg11:
677-721 ms on 8 shards against 305-318 ms, PERF.md). A forced ``"N"``
still plans the batched mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike


@dataclass(frozen=True)
class SolverMesh:
    """A 1-D mesh of ``shards`` pod shards over the ``axis`` axis, all on
    one device. ``device`` is the device it was planned for (None: the
    Solver's, whichever it is); a Solver refuses a mesh planned for
    another device. Hashes and compares by its fields."""

    shards: int
    axis: str = "pods"
    device: Optional[torch.device] = None

    @property
    def devices(self) -> np.ndarray:
        """The placement of each shard, one entry per shard (``size`` is
        the shard count, as a device mesh's device array reads)."""
        where = str(self.device) if self.device is not None else "solver"
        return np.full((self.shards,), where, dtype=object)

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)


@dataclass(frozen=True)
class MeshPlan:
    """A resolved mesh decision: how many shards, why, and the mesh
    itself (``None`` = the single-device passthrough, the Solver's
    non-sharded path)."""

    devices: int
    axis: str
    source: str               # "forced" | "single" (auto) | "off"
    mesh: Optional[SolverMesh]


def _single(axis: str, source: str) -> MeshPlan:
    return MeshPlan(devices=1, axis=axis, source=source, mesh=None)


def _visible(device: DeviceLike) -> int:
    """Cards of ``device``'s type visible to this process (1 on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def plan_mesh(spec: Optional[str] = None, axis: str = "pods",
              device: DeviceLike = None) -> MeshPlan:
    """Resolve a mesh spec for a Solver on ``device`` (None = ``cuda``).

    ``spec``: ``None``/``""``/``"auto"`` auto-selects (the single-device
    path, whatever the number of cards: the module docstring),
    ``"off"``/``"none"``/``"single"``/``"1"`` pins the
    single-device passthrough, and an integer string forces an N-way
    mesh, batched on the Solver's device. Raises ValueError for an
    unparseable spec or a count below 1.
    """
    s = (spec or "auto").strip().lower()
    if s in ("off", "none", "single", "1"):
        return _single(axis, "off")
    if s == "auto":
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
    return MeshPlan(devices=n, axis=axis, source="forced",
                    mesh=solver_mesh(n, axis=axis, device=device))


def solver_mesh(n_devices: Optional[int] = None, axis: str = "pods",
                device: DeviceLike = None) -> SolverMesh:
    """A 1-D mesh of ``n_devices`` pod shards (None: one per visible card
    of ``device``'s type). ``device`` None leaves the mesh to the Solver's
    device; a mesh is never short of devices, since its shards share
    one."""
    n = _visible(device) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"mesh needs at least 1 shard, got {n}")
    return SolverMesh(shards=n, axis=axis,
                      device=None if device is None else torch.device(device))
