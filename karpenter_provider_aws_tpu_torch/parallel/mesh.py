"""Device-mesh planning for the solver: the boot-time mesh decision.

The reference shards the pod dimension of a solve over a device mesh and
decides the mesh once, at boot: :func:`plan_mesh` resolves the
operator's ``--mesh``/``SOLVER_MESH`` setting against the devices it
sees and hands the resulting :class:`MeshPlan` to the Solver, which then
runs every solve (full, wave-split and the steady-state delta) over it.

A mesh of D shards runs on W ranks, one card each (``SolverMesh.ranks``):
W = min(D, the visible cards of the Solver's device type). Rank 0 is the
Solver's own card; ranks 1..W-1 take the other visible cards in index
order, each a worker process of one process group (parallel/ranks.py),
and the shards split over the ranks in contiguous blocks, shard 0 (the
only one holding existing bins) on rank 0. With W = 1 (one card, or the
CPU) the D shards are one batched pass on the Solver's device
(parallel/sharded.py ``sharded_pack``), with no process group; on the
CPU the ranks are asked for explicitly (``solver_mesh(8, ranks=4,
device="cpu")``), as the tests do, and ``group=True`` runs the rank
program even at W = 1 (a group of one rank). A mesh never moves work off
the Solver's device type: there is no virtual-CPU fallback.

Auto policy: ``auto`` plans the single-device path, on the CPU and on
CUDA with any number of cards visible; a forced ``"N"`` plans the mesh
of N shards over min(N, cards) ranks. The reference's ``auto`` takes every
chip of a multi-chip backend, for the hardware it adds; here the mesh is
slower than one device even with a card per shard, since the host's
decode of the shard tables and the merge stay on rank 0 and each rank
issues the scan's every group step: on four H100s, cfg11 took 605 ms on
4 shards over 4 ranks (what the reference's ``auto`` would plan) against
176 ms on one device (PERF.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike


@dataclass(frozen=True)
class SolverMesh:
    """A 1-D mesh of ``shards`` pod shards over the ``axis`` axis, run on
    ``ranks`` cards (1: batched on the Solver's device). ``device`` is
    the device it was planned for (None: the Solver's, whichever it is);
    a Solver refuses a mesh planned for another device type. ``group``
    runs the rank program (parallel/ranks.py) even for one rank; more
    than one rank always runs it. Hashes and compares by its fields."""

    shards: int
    axis: str = "pods"
    device: Optional[torch.device] = None
    ranks: int = 1
    group: bool = False

    def __post_init__(self):
        if not 1 <= self.ranks <= self.shards:
            raise ValueError(f"a mesh of {self.shards} shard(s) runs on 1 to "
                             f"{self.shards} ranks, not {self.ranks}")
        if self.ranks > 1 and not self.group:
            object.__setattr__(self, "group", True)

    def blocks(self) -> List[Tuple[int, int]]:
        """Each rank's shards ``[lo, hi)``: contiguous blocks, the first
        D mod W ranks one shard longer, so shard 0 is on rank 0."""
        return rank_blocks(self.shards, self.ranks)

    def rank_devices(self, solver_device: torch.device) -> List[torch.device]:
        """The device of each rank for a Solver on ``solver_device``:
        rank 0 is that device, the other ranks the other cards of its
        type in index order."""
        dev = torch.device(solver_device)
        if dev.type != "cuda":
            return [dev] * self.ranks
        first = dev.index if dev.index is not None else 0
        others = [k for k in range(self.ranks + 1) if k != first]
        return [torch.device("cuda", first)] + [
            torch.device("cuda", k) for k in others[: self.ranks - 1]]

    @property
    def devices(self) -> np.ndarray:
        """The placement of each shard, one entry per shard (``size`` is
        the shard count, as a device mesh's device array reads): the
        device of the rank that runs it (for a mesh left to the Solver's
        device, ``solver`` on rank 0 and ``rank<r>`` on the others)."""
        if self.device is None:
            where = ["solver"] + [f"rank{r}" for r in range(1, self.ranks)]
        else:
            where = [str(d) for d in self.rank_devices(self.device)]
        out = np.empty((self.shards,), dtype=object)
        for r, (lo, hi) in enumerate(self.blocks()):
            out[lo:hi] = where[r]
        return out

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)


def rank_blocks(shards: int, ranks: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each of ``ranks`` contiguous blocks of ``shards``."""
    base, extra = divmod(shards, ranks)
    out, lo = [], 0
    for r in range(ranks):
        hi = lo + base + (1 if r < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


@dataclass(frozen=True)
class MeshPlan:
    """A resolved mesh decision: how many shards, why, and the mesh
    itself (``None`` = the single-device passthrough, the Solver's
    non-sharded path)."""

    devices: int
    axis: str
    source: str               # "forced" | "single" (auto) | "off"
    mesh: Optional[SolverMesh]

    @property
    def ranks(self) -> int:
        """Cards the mesh runs on (1: the Solver's own)."""
        return self.mesh.ranks if self.mesh is not None else 1


def _single(axis: str, source: str) -> MeshPlan:
    return MeshPlan(devices=1, axis=axis, source=source, mesh=None)


def _visible(device: DeviceLike) -> int:
    """Cards of ``device``'s type visible to this process (1 on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def plan_mesh(spec: Optional[str] = None, axis: str = "pods",
              device: DeviceLike = None,
              ranks: Optional[int] = None) -> MeshPlan:
    """Resolve a mesh spec for a Solver on ``device`` (None = ``cuda``).

    ``spec``: ``None``/``""``/``"auto"`` auto-selects (the single-device
    path, whatever the number of cards: the module docstring),
    ``"off"``/``"none"``/``"single"``/``"1"`` pins the
    single-device passthrough, and an integer string forces an N-way
    mesh over ``ranks`` cards (None: one per visible card, at most N;
    the CPU counts one). Raises ValueError for an unparseable spec or a
    count below 1.
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
                    mesh=solver_mesh(n, axis=axis, device=device,
                                     ranks=ranks))


def solver_mesh(n_devices: Optional[int] = None, axis: str = "pods",
                device: DeviceLike = None, ranks: Optional[int] = None,
                group: bool = False) -> SolverMesh:
    """A 1-D mesh of ``n_devices`` pod shards (None: one per visible card
    of ``device``'s type) on ``ranks`` cards (None: min(shards, visible
    cards); the CPU counts one card, so ranks there are asked for).
    ``device`` None leaves the mesh to the Solver's device. ``group``
    runs the rank program at one rank too. Raises ValueError for fewer
    than 1 shard, or for more ranks than shards or than visible cards."""
    n = _visible(device) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"mesh needs at least 1 shard, got {n}")
    dev = None if device is None else torch.device(device)
    visible = _visible(device)
    w = max(1, min(n, visible)) if ranks is None else int(ranks)
    if (dev is None or dev.type == "cuda") and w > max(visible, 1):
        raise ValueError(f"a mesh on {w} ranks needs {w} cards, "
                         f"{visible} visible")
    return SolverMesh(shards=n, axis=axis, device=dev, ranks=w,
                      group=group or w > 1)
