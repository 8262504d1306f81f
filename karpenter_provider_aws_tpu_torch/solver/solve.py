"""Host-facing Solve() API on one device.

The port of the JAX package's ``solver/solve.py`` for one device: shape
bucketing and padding, fused uint8 uploads, the grouped-FFD pack
(ops/binpack.py) with its cheapest-offering kernel, one fused result
buffer back, the bin-table overflow regrow, and the NodePlan decode. The
decoded plan equals the JAX package's, field for field.

Two paths solve a problem, with byte-identical plans. The pipelined one
(the default, ``pipeline=True``) uploads through the resident input cache
(solver/pipeline.py), starts the result copy right after dispatch and
runs decode prep while the card computes; the sequential one
(``pipeline=False``) synchronises after each stage. ``solve_delta`` is
the steady-state entry point: its microloop keeps the whole fused
problem resident on the card, ships only the changed blocks, and fetches
the plan only when an on-device fingerprint says it moved.

The degradation ladder of ``_solve_problem`` is the JAX package's: a
group axis past the largest bucket (4,096, or an injected ``g_limit``)
goes through the wave-split planner (``_solve_waves``: waves of at most
1,024 groups on the card, open bins carried between them); a bin table
that cannot grow past its ceiling lands on the host FFD (``b-exhausted``);
a device failure (``SolverDeviceError``: a kernel launch error, device
OOM, a failed transfer, or an injected fault) is retried once after a
backoff on the injected clock and then lands on the host FFD
(``device-error``); any other error goes straight to the host FFD
(``internal-error``). Every rung off the primary path is counted in
``degraded_counts`` and marks the plan ``degraded``. ``inject_faults``
attaches a ``FaultInjector`` (solver/faults.py) that forces each rung.

On a CUDA device the host FFD carries only what cannot be the card's
fault: a structural ceiling (``SolverCapacityError``) and an injected
device fault. A real device error that outlives its retry, a kernel that
does not build (``KernelBuildError``, never retried) and a host-side bug
on the device path raise to the caller, so no plan made on the host
stands in for a card that does not work. A failure on the card after
which a one-element probe of the device fails too is sticky (the CUDA
context is gone): it raises ``DeviceLostError``, kept in ``device_lost``,
and every later entry point raises it at once. On the CPU the ladder is the
reference's in full: the host is the solve's own device there.

``solve_relaxed``, ``solve`` and ``solve_delta`` open the JAX package's
trace spans (``solver.solve_relaxed``, ``solver.solve``,
``solver.solve_delta``, ``solver.wave``, ``solver.host_ffd`` and a
``stage.*`` span per stage timer); every device pack call is a span
(``solver.pack``, ``solver.pack_micro``, ``solver.pack_probe``,
``solver.pack_sharded``, ``solver.pack_merge``), and so are decode prep (``decode.prep``) and
the batched probe's staging and wait (``probe.stage``, ``probe.wait``).
Each dispatch counts the scan's steps issued (``scan.steps``), the real
groups among them (``scan.groups``) and the steps of the bucketed group
axis not issued (``scan.skipped``): the single-device packs and the
batched probe issue steps for the real groups alone, the sharded pack and
the tail-bin merge for the whole bucket. A problem built
with ``explain=True`` carries its constraint-elimination ledgers into the
unplaced reasons.

``warmup`` runs the boot (G, B) bucket ladder once on the Solver's
device (optionally on a background thread) so that a process's first
real solve does not pay the cold cost: the first launch of each of the
scan's kernels (CUDA loads a kernel's module at its first use), the
caching allocator's first pools and the kernel library's load. ``start_profiling`` / ``stop_profiling``
open a ``torch.profiler`` session, in which every trace span above is a
range beside the kernels it launched, and write the trace as Chrome
JSON.

``NodePlan.device_seconds`` and ``ProbeResult.device_seconds`` are the
card's time for the pack, from a pair of CUDA events around it that are
read once the fetch has waited (solver/pipeline.py ``DeviceTimer``); on
the CPU, the host clock around the pack call.

``probe_batch`` answers K consolidation what-ifs in one batched device
pass (ops/binpack.py ``pack_probe_fused``) on the Solver's own device,
with no fallback: a device error raises ``SolverDeviceError``.

A mesh (parallel/mesh.py ``plan_mesh``, the Solver's ``mesh`` or a
per-call ``mesh=``) shards the pod axis into D shards that pack as ONE
batched pass on the Solver's device (parallel/sharded.py
``sharded_pack``: a vmapped scan and one cheapest-offering launch over
the D·B bins), or, on a mesh of W > 1 cards, as W such passes, each
rank's block of shards on its own card (parallel/ranks.py), gathered to
the Solver's card; then a host-side refinement dissolves under-filled tail
bins and re-packs them, seeded with the kept bins, in one small merge
pack (ops/binpack.py ``pack_packed_seeded``). Every path runs over the
mesh: the full solve, the wave split, the ladder and the microloop,
whose merge is reused while the shard results do not move. Every
completed solve attributes its measured compute stage to its (G, B, D)
shape in the device cost model (solver/costmodel.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..apis.resources import R
from ..device import DeviceLike, resolve_device
from ..errors import (DeviceLostError, KernelBuildError,
                      SolverCapacityError, SolverDeviceError, SolverError,
                      is_retryable_solver_error)
from ..lattice.tensors import Lattice
from ..ops import binpack
from . import costmodel, taxonomy
from .explain import unplaced_reason
from .faults import FaultInjector
from .pipeline import (DeviceTimer, ResidentInputCache, StageTimer,
                       fetch_async, plan_changed)
from .problem import Problem

_LOG = logging.getLogger(__name__)
# a Solver's serial: its name for its resident buffers on a mesh's ranks
_SOLVER_SERIALS = itertools.count()

_G_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 512, 1024, 4096)
_B_BUCKETS = (32, 128, 512, 1024, 2048, 8192)


def enable_persistent_compile_cache(cache_dir: str) -> bool:
    """Build and load this process's compiled code in ``cache_dir``: the
    CUDA kernel libraries (ops/cuda_build.py) and the native referee
    (native/build.py). A restarted operator whose cache volume survives
    then loads them instead of running ``nvcc`` and ``g++`` again, and an
    image whose package directory is read-only still builds. Each
    library's name carries its compiler's version, so a library another
    toolkit built is never served. Creates the directory; safe to call
    more than once. Returns False, logs why and changes nothing when the
    directory cannot be created or written: the process keeps building
    where it did, on the same device. A relative path is taken from the
    working directory of the call."""
    import tempfile
    from ..native import build as native_build
    from ..ops import cuda_build
    cache_dir = os.path.abspath(cache_dir)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, probe = tempfile.mkstemp(prefix=".probe-", dir=cache_dir)
        os.close(fd)
        os.unlink(probe)
    except OSError as e:
        _LOG.warning("compile cache %s is not writable (%s); kernels build "
                     "in %s", cache_dir, e, cuda_build.BUILD_DIR)
        return False
    cuda_build.set_build_dir(cache_dir)
    native_build.set_build_dir(cache_dir)
    return True


@dataclass
class PlannedNode:
    node_pool: str
    instance_type: str
    zone: str
    capacity_type: str
    price_per_hour: float
    pods: List[str] = field(default_factory=list)
    # the bin's full feasible sets (every instance type that can hold the
    # bin's contents, cheapest-first, capped at MAX_FLEXIBLE_TYPES): the
    # CreateFleet overrides an ICE on the chosen offering falls through to.
    # Same-pattern bins SHARE one immutable tuple: consumers may reassign
    # the field but must never mutate it in place
    feasible_types: Sequence[str] = field(default_factory=tuple)
    feasible_zones: Sequence[str] = field(default_factory=tuple)
    feasible_capacity_types: Sequence[str] = field(default_factory=tuple)
    # custom labels a virtual-pool bin pins on its node; node_pool is
    # always the REAL pool name
    extra_labels: Dict[str, str] = field(default_factory=dict)


def _pool_out(pool) -> Tuple[str, Dict[str, str]]:
    """(real pool name, custom labels) for a possibly-virtual pool."""
    return (pool.base_name or pool.name, dict(pool.custom_labels))


MAX_FLEXIBLE_TYPES = 60  # reference pkg/providers/instance/instance.go:50


@dataclass
class NodePlan:
    new_nodes: List[PlannedNode]
    existing_assignments: Dict[str, List[str]]   # existing node name -> pods
    unschedulable: Dict[str, str]                # pod name -> reason
    new_node_cost: float                         # $/hr
    solve_seconds: float
    device_seconds: float
    warnings: List[str] = field(default_factory=list)
    # degradation-ladder provenance: which rung produced the plan
    # ("device" | "wave-split" | "host-ffd") and why it left the primary
    # path
    degraded: bool = False
    degraded_reason: str = ""
    solver_path: str = "device"
    waves: int = 1
    device_retries: int = 0
    # per-stage wall-clock (ms), keyed by solver/pipeline.py STAGES
    stage_ms: Dict[str, float] = field(default_factory=dict)
    pipelined: bool = False
    mesh_devices: int = 1
    shard_imbalance: float = 0.0

    @property
    def num_new_nodes(self) -> int:
        return len(self.new_nodes)


@dataclass
class _MicroState:
    """Retained cross-pass state of the device-resident reconcile
    microloop. ``key`` pins the layout this state was built under: any
    bucket or size drift is a cold restart, never a stale reuse.
    ``prev_dev`` is the previous pass's device result buffer (the
    changed-plan fingerprint compares against it ON DEVICE); ``prev_host``
    its host copy, re-decoded with the current pass's pod names whenever
    the fingerprint says the packing did not move (the skipped-sync
    path). The result never aliases the resident input: the pack encodes
    it into a buffer of its own. The mesh merge refinement retains its
    own result the same way."""

    key: Tuple
    prev_dev: Optional[torch.Tensor] = None
    prev_host: Optional[np.ndarray] = None
    prev_cost: float = 0.0                       # mesh: summed raw cost
    prev_merge: Optional[Tuple[np.ndarray, int]] = None  # (result, B2)
    # the lattice VIEW (strong ref — an id() can never be reused stale)
    # and price version this state solved against: a reprice or a new
    # ICE-masked view invalidates retention outright
    lattice: object = None
    price_version: int = -1


@dataclass
class ProbeResult:
    """Host-side aggregates of one batched what-if probe (ops/binpack.py
    pack_probe_fused). Enough to answer the consolidation criterion — "do
    the pods fit on the remaining capacity + ≤1 cheaper node?" (reference
    designs/consolidation.md) — without decoding a full NodePlan."""

    feasible: bool            # every pod placed (no leftover, no overflow)
    n_new: int                # new bins opened
    new_cost: float           # $/hr over new bins
    new_cap_type: Optional[str]  # capacity type of the single new bin
    flex: int                 # feasible-type count of that bin (spot guard)
    device_seconds: float = 0.0


class _MicroIneligible(Exception):
    """Internal: this pass cannot ride the microloop (shape or bin-table
    overflow outside the steady-state envelope) — solve_delta falls back
    to the standard solve. Never surfaces to callers."""


def _bucket(n: int, buckets: Sequence[int], clamp: bool = False) -> int:
    for b in buckets:
        if n <= b:
            return b
    if clamp:
        # the kernel's overflow path marks what doesn't fit as leftover
        return buckets[-1]
    raise ValueError(f"problem size {n} exceeds the largest bucket {buckets[-1]}")


def _count_scan(G: int, groups: int, steps: int) -> None:
    """A dispatch's scan on the tally: ``steps`` steps issued of the ``G``
    the bucketed group axis holds (``scan.skipped`` the rest), and
    ``groups`` real groups among them."""
    trace.count("scan.steps", steps)
    trace.count("scan.groups", groups)
    trace.count("scan.skipped", G - steps)


def _grow_bucket(b: int) -> Tuple[int, bool]:
    """Next bin bucket for the overflow retry; (same, False) at the top."""
    i = _B_BUCKETS.index(b)
    if i + 1 >= len(_B_BUCKETS):
        return b, False
    return _B_BUCKETS[i + 1], True


@dataclass
class _DecodeSet:
    """Host-side view of one pack result, decoded from the single fused
    device buffer (ops/binpack.py _encode_decode_set)."""

    assign: np.ndarray        # [G,B] i32
    leftover: np.ndarray      # [G] i32
    np_id: np.ndarray         # [B] i32
    open: np.ndarray          # [B] bool
    fixed: np.ndarray         # [B] bool
    chosen_t: np.ndarray      # [B] i32
    chosen_z: np.ndarray      # [B] i32
    chosen_c: np.ndarray      # [B] i32
    chosen_price: np.ndarray  # [B] f32
    tmask_p: np.ndarray       # [B,ceil(T/8)] u8 packed
    zmask_p: np.ndarray       # [B,ceil(Z/8)] u8 packed
    cmask_p: np.ndarray       # [B,ceil(C/8)] u8 packed
    next_open: int
    # full-layout-only fields
    npods: Optional[np.ndarray] = None      # [B] i32
    cum: Optional[np.ndarray] = None        # [B,R] f32
    alloc_cap: Optional[np.ndarray] = None  # [B,R] f32
    pm: Optional[np.ndarray] = None         # [B,A] i32
    po: Optional[np.ndarray] = None         # [B,A] bool

    def tmask(self, rows, T: int) -> np.ndarray:
        return np.unpackbits(self.tmask_p[rows], axis=1)[:, :T].astype(bool)

    def zmask(self, rows, Z: int) -> np.ndarray:
        return np.unpackbits(self.zmask_p[rows], axis=1)[:, :Z].astype(bool)

    def cmask(self, rows, C: int) -> np.ndarray:
        return np.unpackbits(self.cmask_p[rows], axis=1)[:, :C].astype(bool)


def _unpack_decode_set(buf: np.ndarray, G: int, T: int, Z: int, C: int,
                       A: int, lean: bool = False) -> _DecodeSet:
    """Inverse of ops/binpack.py _encode_decode_set (row layouts there)."""
    Tp, Zp, Cp, Ap = (T + 7) // 8, (Z + 7) // 8, (C + 7) // 8, (A + 7) // 8
    W = buf.shape[1]
    n_trailer = -(-(4 * G + 4) // W)
    B = buf.shape[0] - n_trailer
    rows = buf[:B]

    def col_i32(off: int) -> np.ndarray:
        return np.ascontiguousarray(rows[:, off: off + 4]).view(np.int32).ravel()

    def col_i16(off: int) -> np.ndarray:
        return (np.ascontiguousarray(rows[:, off: off + 2])
                .view(np.int16).ravel().astype(np.int32))

    def block_f32(off: int, n: int) -> np.ndarray:
        return np.ascontiguousarray(rows[:, off: off + 4 * n]).view(np.float32)

    trailer = np.ascontiguousarray(buf[B:]).reshape(-1)
    leftover = np.ascontiguousarray(trailer[: 4 * G]).view(np.int32).copy()
    next_open = int(np.ascontiguousarray(trailer[4 * G: 4 * G + 4]).view(np.int32)[0])

    if lean:
        o = 11 + Tp + Zp + Cp
        flags = rows[:, 10]
        return _DecodeSet(
            assign=(np.ascontiguousarray(rows[:, o: o + 2 * G])
                    .view(np.int16).astype(np.int32).T),
            leftover=leftover,
            np_id=col_i16(0), chosen_t=col_i16(2),
            chosen_z=rows[:, 4].astype(np.int32),
            chosen_c=rows[:, 5].astype(np.int32),
            chosen_price=np.ascontiguousarray(rows[:, 6:10]).view(np.float32).ravel(),
            open=(flags & 1).astype(bool), fixed=(flags & 2).astype(bool),
            tmask_p=rows[:, 11: 11 + Tp],
            zmask_p=rows[:, 11 + Tp: 11 + Tp + Zp],
            cmask_p=rows[:, 11 + Tp + Zp: o],
            next_open=next_open,
        )

    o = 26 + Tp + Zp + Cp
    assign = (np.ascontiguousarray(rows[:, o: o + 2 * G])
              .view(np.int16).astype(np.int32).T)            # [G,B]
    oc = o + 2 * G
    return _DecodeSet(
        assign=assign, leftover=leftover,
        npods=col_i32(0), np_id=col_i32(4),
        chosen_t=col_i32(8), chosen_z=col_i32(12), chosen_c=col_i32(16),
        chosen_price=np.ascontiguousarray(rows[:, 20:24]).view(np.float32).ravel(),
        open=rows[:, 24].astype(bool), fixed=rows[:, 25].astype(bool),
        tmask_p=rows[:, 26: 26 + Tp], zmask_p=rows[:, 26 + Tp: 26 + Tp + Zp],
        cmask_p=rows[:, 26 + Tp + Zp: o],
        cum=block_f32(oc, R),
        alloc_cap=block_f32(oc + 4 * R, R),
        pm=(np.ascontiguousarray(rows[:, oc + 8 * R: oc + 8 * R + 2 * A])
            .view(np.int16).astype(np.int32)),
        po=(np.unpackbits(rows[:, oc + 8 * R + 2 * A: oc + 8 * R + 2 * A + Ap],
                          axis=1)[:, :A].astype(bool)),
        next_open=next_open,
    )


def _unpack_sharded(packed: np.ndarray, G: int, T: int, Z: int, C: int,
                    A: int) -> List[_DecodeSet]:
    """One host-side _DecodeSet per shard of a fetched [D, B+n_trailer, W]
    buffer (each shard's rows use the single-device layout)."""
    return [_unpack_decode_set(packed[d], G, T, Z, C, A)
            for d in range(packed.shape[0])]


def decode_sharded_pack(sp, G: int, T: int, Z: int, C: int,
                        A: int) -> List[_DecodeSet]:
    """Decode a ShardedPack's fused buffer into one _DecodeSet per shard
    (one device→host copy for all shards)."""
    return _unpack_sharded(sp.packed.cpu().numpy(), G, T, Z, C, A)


def _locked(fn):
    """Serialize a Solver entry point on the instance's solve lock
    (re-entrant: solve_relaxed → solve nests fine), with the Solver's
    device current: the entry points run on whichever thread calls them
    (a controller runtime's, a REST handler's), and a thread that never
    touched CUDA has the default device current, so every allocation,
    launch and event of the call lands on the Solver's device and its
    current stream."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._solve_lock:
            if self.device_lost is not None:
                # a lost context fails every call: fail at once
                raise DeviceLostError(str(self.device_lost)) \
                    from self.device_lost
            if self.device.type != "cuda":
                return fn(self, *args, **kwargs)
            with torch.cuda.device(self.device):
                return fn(self, *args, **kwargs)
    return wrapper


class Solver:
    """Holds the lattice resident on one device; solves padded problems.

    ``device`` None means ``cuda`` and raises when CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch path on the CPU. ``pipeline``
    picks the overlapped path (default) or the strictly sequential one.
    ``clock`` is the injected clock (the Operator's): the device-retry
    backoff sleeps on it. ``mesh`` is the production mesh every solve runs
    over (parallel/mesh.py; None = the single-device path), its D shards
    batched on this Solver's device or on the mesh's ranks, rank 0 this
    Solver's card; a mesh planned for another device type, or for more
    cards than are visible, raises ValueError. Thread-safe: every public
    solve entry point serializes on an internal RLock."""

    # the steady-state delta path (IncrementalProblemBuilder +
    # solve_delta) runs in this process, on this Solver's device
    supports_delta = True

    def __init__(self, lattice: Lattice, device: DeviceLike = None,
                 pipeline: bool = True, clock=None, mesh=None):
        from ..utils.clock import WALL
        self._clock = clock if clock is not None else WALL
        self.device = resolve_device(device)
        # the device as the introspection surface names it (``kpctl top``'s
        # SOLVER row): ``cuda:<index> (<card>)``, or ``cpu``
        self._device_label = str(self.device)
        if self.device.type == "cuda":
            index = (torch.cuda.current_device() if self.device.index is None
                     else self.device.index)
            self._device_label = (f"cuda:{index} "
                                  f"({torch.cuda.get_device_name(index)})")
        # the device mesh every solve runs over (parallel/mesh.py
        # plan_mesh resolves --mesh/SOLVER_MESH at boot; None = the
        # single-device path). A per-call ``mesh=`` still overrides
        self.mesh = self._check_mesh(mesh)
        # whether the host FFD may carry a real device error or a host bug
        # (the module docstring): on the CPU only, never on the card
        self._host_ffd_carries_all = self.device.type != "cuda"
        # the pack's only matmul (_offer_reachable) is a 0/1 count that
        # must stay exact: full float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.lattice = lattice
        dev = self.device
        self._alloc = torch.as_tensor(lattice.alloc, device=dev)
        self._avail = torch.as_tensor(lattice.available, device=dev)
        self._price = torch.as_tensor(lattice.price, device=dev)
        self._price_version = lattice.price_version
        # instrumented (introspect/contention.py): solve-lock wait is
        # exactly "how long a caller queued behind another solve"
        from ..introspect import contention
        self._solve_lock = contention.rlock("solver_solve")
        # per group-bucket: (fresh-estimate bucket, bucket actually needed)
        # of the last solve; a same-or-larger fresh estimate starts at the
        # size that worked (each overflow retry costs a full device pass)
        self._b_hint: Dict[int, Tuple[int, int]] = {}
        # content-keyed memo of _estimate_bins' per-group fit caps
        self._est_cache: Dict[bytes, np.ndarray] = {}
        # degradation ladder state: an optional FaultInjector (tests force
        # each failure mode deterministically) and plain counters of every
        # off-primary-path event
        self.faults: Optional[FaultInjector] = None
        self.degraded_counts: Dict[str, int] = {}
        # the sticky device error that took this Solver's device (None
        # while the device works); every entry point raises it once set
        self.device_lost: Optional[DeviceLostError] = None
        # the overlapped solve path: resident input deltas, the result
        # copy started at dispatch, decode prep while the card computes.
        # Off = the strictly sequential path
        self.pipeline = pipeline
        self._resident = ResidentInputCache(device=dev)
        # proof that the overlap, the microloop and the mesh engaged; the
        # keys are the JAX package's, so both report alike
        self.pipeline_stats: Dict[str, int] = {
            "async_solves": 0,       # device solves that dispatched async
            "prefetched_waves": 0,   # wave inputs uploaded during compute
            # the steady-state delta path: passes it carried, group rows
            # it re-tensorized, and whether the resident entry was warm
            "delta_solves": 0,
            "delta_dirty_groups": 0,
            "resident_problem_hits": 0,
            "resident_problem_misses": 0,
            # sharded solves carried by the mesh (full, wave and delta)
            "mesh_solves": 0,
            # the microloop (solve_delta → _solve_micro): passes it
            # carried, plan fetches its fingerprint suppressed, plan
            # fetches it paid, passes that fell back to the standard
            # solve, O(1) fingerprint syncs, and admission-bookkeeping
            # closures it overlapped with the in-flight dispatch
            "micro_solves": 0,
            "micro_skipped_syncs": 0,
            "micro_fetches": 0,
            "micro_merge_solves": 0,
            "micro_merge_skips": 0,
            # merge bin-table overflow regrows: each pays one more
            # upload and fetch on the pass that paid it
            "micro_merge_regrows": 0,
            "micro_aborts": 0,
            "micro_tiny_syncs": 0,
            "overlapped_admission": 0,
            # link legs of the LAST delta pass (uploads + fetches)
            "micro_last_legs": 0,
        }
        # host↔device transfers: a LEG is a transfer whose size scales
        # with the problem or plan (fused uploads, dirty-block scatters,
        # result fetches); the fingerprint's one bool is a micro_tiny_sync
        self.link_stats: Dict[str, int] = {
            "upload_legs": 0, "upload_bytes": 0,
            "fetch_legs": 0, "fetch_bytes": 0,
        }
        self._resident.account = self._account_link
        # retained microloop state (None = cold); reset by every
        # device-state invalidation (fault recovery, mesh swap)
        self._micro: Optional[_MicroState] = None
        # max/mean per-shard pod load of the last sharded solve's split
        # (parallel/sharded.py shard_groups): the shard-imbalance gauge
        self._mesh_imbalance = 0.0
        # the mesh's lattice tensors (_mesh_inputs): avail/price memoized
        # per (mesh, lattice view, price version); alloc is invariant for
        # this Solver's lifetime, so it keys on the mesh alone
        self._mesh_consts = None
        self._mesh_alloc = None
        # the worker ranks a mesh of more than one card runs on
        # (parallel/ranks.py): bound at first use and kept, so that a set
        # that lost a rank fails this Solver's later solves (the ladder's
        # rungs, and on the card a lost device) until set_mesh
        self._ranks = None
        # this Solver's name for its resident buffers on those ranks
        self._serial = next(_SOLVER_SERIALS)
        # the last probe_batch dispatch: its buckets and raw [K,6] summary
        self.last_probe: Optional[Dict[str, object]] = None
        # torch.profiler session (start_profiling)
        self._profiler = None
        self._profile_dir = ""

    def set_pipeline(self, enabled: bool) -> None:
        """Toggle the overlapped solve path (thread-safe)."""
        with self._solve_lock:
            self.pipeline = bool(enabled)

    def _account_link(self, direction: str, nbytes: int) -> None:
        """One host↔device transfer crossed the link (see link_stats)."""
        self.link_stats[direction + "_legs"] += 1
        self.link_stats[direction + "_bytes"] += int(nbytes)

    def _invalidate_device_state(self) -> None:
        """Drop every retained device buffer: the resident input entries,
        the mesh's lattice memo and the microloop's retained result. One
        helper so neither a recovery path nor set_mesh can forget a
        layer."""
        self._resident.invalidate()
        self._mesh_consts = None
        self._mesh_alloc = None
        self._micro = None

    def _check_mesh(self, mesh):
        """``mesh`` if this Solver may run it: a mesh planned for a device
        of another type never moves the solve there (nor off the card),
        and a mesh on more cards than this process sees cannot run."""
        dev = getattr(mesh, "device", None)
        if dev is not None and torch.device(dev).type != self.device.type:
            raise ValueError(f"a mesh planned for {dev} cannot run on this "
                             f"Solver's {self.device}: a mesh's shards run "
                             f"on the Solver's device")
        w = int(getattr(mesh, "ranks", 1))
        if (w > 1 and self.device.type == "cuda"
                and w > torch.cuda.device_count()):
            raise ValueError(f"a mesh on {w} cards cannot run where "
                             f"{torch.cuda.device_count()} are visible")
        return mesh

    def _mesh_ranks(self, mesh):
        """The worker ranks ``mesh`` runs on (None: its shards are batched
        on this Solver's device). The set this Solver first used stays
        bound, broken or not, while the mesh asks for as many ranks."""
        if not getattr(mesh, "group", False):
            return None
        rs = self._ranks
        if rs is None or rs.size != int(mesh.ranks):
            from ..parallel import ranks
            rs = self._ranks = ranks.acquire(mesh, self.device)
        return rs

    @property
    def mesh_ranks(self) -> int:
        """Cards the production mesh runs on (1: this Solver's own)."""
        m = self.mesh
        return int(getattr(m, "ranks", 1)) if m is not None else 1

    @property
    def mesh_devices(self) -> int:
        """Shards of the production mesh (1 = single-device path)."""
        m = self.mesh
        return int(m.devices.size) if m is not None else 1

    def set_mesh(self, mesh) -> None:
        """Swap the production mesh (thread-safe). Invalidates the
        resident input cache, the mesh's lattice memo and the microloop
        state: entries are keyed by shard count, but a mesh-sized change
        re-uploads, it never delta-hits state of the old shape."""
        with self._solve_lock:
            self.mesh = self._check_mesh(mesh)
            self._ranks = None
            self._invalidate_device_state()

    def stats(self) -> Dict[str, object]:
        """Introspection snapshot (counter reads only; never takes the
        solve lock, so it never queues behind an in-flight solve)."""
        out: Dict[str, object] = {
            "pipeline": bool(self.pipeline),
            "device": self._device_label,
            "est_cache_entries": len(self._est_cache),
            "b_hint_entries": len(self._b_hint),
            "faults_injected": self.faults is not None,
            # the mesh surface: shards of the production mesh (1 =
            # single-device) and the last split's load imbalance
            "mesh_devices": self.mesh_devices,
            "mesh_shard_imbalance": round(self._mesh_imbalance, 4),
            "micro_engaged": self._micro is not None,
        }
        for k, v in self.pipeline_stats.items():
            out[k] = v
        for k, v in self.link_stats.items():
            out["link_" + k] = v
        for k, v in self.degraded_counts.items():
            out["degraded_" + k.replace("-", "_")] = v
        for k, v in self._resident.stats().items():
            out["resident_" + k] = v
        return out

    _EST_CACHE_MAX = 128
    _DEVICE_RETRIES = 1          # transient device failures retried this often
    _RETRY_BACKOFF_SECONDS = 0.05
    _WAVE_G_TARGET = 1024        # per-wave group budget

    # ---- degradation ladder plumbing ----

    def inject_faults(self, faults: Optional[FaultInjector]) -> None:
        """Attach (or clear) a FaultInjector; see solver/faults.py."""
        with self._solve_lock:
            self.faults = faults

    def _count_degraded(self, key: str) -> None:
        self.degraded_counts[key] = self.degraded_counts.get(key, 0) + 1

    def _g_ceiling(self) -> int:
        """Effective group-axis ceiling: the largest group bucket, or an
        injected fake ceiling so tests exercise the wave split at small G."""
        top = _G_BUCKETS[-1]
        f = self.faults
        if f is not None and f.g_limit:
            return max(1, min(int(f.g_limit), top))
        return top

    def _b_ceiling(self) -> int:
        """Effective bin-table ceiling (snapped down to a bucket value)."""
        top = _B_BUCKETS[-1]
        f = self.faults
        if f is not None and f.b_limit:
            snapped = [b for b in _B_BUCKETS if b <= int(f.b_limit)]
            return snapped[-1] if snapped else _B_BUCKETS[0]
        return top

    def _maybe_inject_device_fault(self) -> None:
        f = self.faults
        if f is not None and f.take_device_error():
            raise SolverDeviceError("injected device fault", injected=True)

    def _host_ffd_may_carry(self, err: BaseException) -> bool:
        """Whether the host-FFD rung may carry a solve that failed with
        ``err`` (the module docstring): a structural ceiling or an injected
        fault always; a kernel that did not build never; anything else
        only off the card."""
        if isinstance(err, SolverCapacityError) or getattr(
                err, "injected", False):
            return True
        if isinstance(err, KernelBuildError):
            return False
        return self._host_ffd_carries_all

    def _device_alive(self) -> bool:
        """Whether the device still runs a one-element op and a
        synchronize: after a sticky error (a device-side assert) the CUDA
        context fails every later call."""
        if self._ranks is not None and self._ranks.broken is not None:
            # a mesh whose rank is lost is a lost device for this Solver
            return False
        try:
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return True
        except RuntimeError:
            return False

    def _estimate_bins(self, problem: Problem) -> int:
        """Lower-bound estimate of bins the pack will open: each group
        needs at least count / (best-case per-node fit) bins, and never
        packs more than max_per_bin per node. The [G,T,R] fit scan is
        count-independent and content-cached."""
        if problem.G == 0:
            return 0
        h = hashlib.blake2b(digest_size=16)
        for a in (problem.req, problem.g_type):
            h.update(a.tobytes())
        key = h.digest()
        caps = self._est_cache.get(key)
        if caps is None:
            caps = self._estimate_caps_uncached(problem)
            if len(self._est_cache) >= self._EST_CACHE_MAX:
                self._est_cache.clear()
            self._est_cache[key] = caps
        capped = np.minimum(np.maximum(caps, 1.0),
                            problem.max_per_bin.astype(np.float64))
        return int(np.ceil(problem.count / np.maximum(capped, 1.0)).sum())

    def _estimate_caps_uncached(self, problem: Problem) -> np.ndarray:
        """Per-group best-case per-node pod fit [G] (pre max_per_bin
        clamp): the joint vector fit of the best type the group's type
        mask allows. The overflow regrow stays as the backstop."""
        alloc = self.lattice.alloc.astype(np.float64)               # [T,R]
        req = problem.req.astype(np.float64)                        # [G,R]
        caps = np.zeros((problem.G,), np.float64)
        CH = 256  # bound the [g,T,R] temp
        for s in range(0, problem.G, CH):
            r = req[s: s + CH]                                      # [g,R]
            m = problem.g_type[s: s + CH]                           # [g,T]
            pos = r[:, None, :] > 0
            ratio = np.where(pos, alloc[None, :, :]
                             / np.where(pos, r[:, None, :], 1.0), np.inf)
            fit_t = np.floor(np.nan_to_num(ratio.min(axis=2), posinf=1e9))
            caps[s: s + CH] = np.where(m, fit_t, 0.0).max(axis=1, initial=0.0)
        return caps

    def _device_avail_price(self, problem: Problem):
        """A problem built over a masked lattice view brings its own
        availability; a pricing refresh re-uploads the price tensor."""
        if problem.lattice is self.lattice:
            if self.lattice.price_version != self._price_version:
                self._price = torch.as_tensor(self.lattice.price,
                                              device=self.device)
                self._price_version = self.lattice.price_version
            return self._avail, self._price
        return (torch.as_tensor(problem.lattice.available, device=self.device),
                torch.as_tensor(problem.lattice.price, device=self.device))

    def _mesh_inputs(self, problem: Problem, mesh):
        """(alloc, avail, price) for ``mesh``'s shards, which share them:
        copied to the device once and kept across passes. avail/price are
        memoized per (mesh, lattice view, price version), so a pricing
        refresh or a new ICE-masked view re-keys exactly those two; alloc
        is invariant for this Solver's lifetime and keys on the mesh
        alone. The memo holds a strong ref to the view, so an id() can
        never be reused stale."""
        dev = self.device
        ma = self._mesh_alloc
        if ma is None or ma[0] != mesh:
            ma = (mesh, torch.tensor(np.asarray(self.lattice.alloc),
                                     device=dev))
            self._mesh_alloc = ma
        lat = problem.lattice
        key = (mesh, id(lat), lat.price_version)
        mc = self._mesh_consts
        if mc is None or mc[0] != key:
            mc = (key, lat,
                  (torch.tensor(np.asarray(lat.available), device=dev),
                   torch.tensor(np.asarray(lat.price), device=dev)))
            self._mesh_consts = mc
        return (ma[1],) + mc[2]

    # ---- padding ----

    def _layout(self, problem: Problem, G: int, A: Optional[int] = None,
                NP: Optional[int] = None):
        lat = self.lattice
        A = max(problem.A, 1) if A is None else A
        NP = max(problem.NP, 1) if NP is None else NP
        return binpack.group_layout(G, lat.T, lat.Z, lat.C, NP, A, R)

    @staticmethod
    def _pad_field(problem: Problem, f: binpack.FieldSpec,
                   out: Optional[np.ndarray] = None,
                   override: Optional[np.ndarray] = None) -> np.ndarray:
        """Pad one staged field per its spec. ``out`` writes into a
        caller-provided view (the fused buffer); ``override`` replaces the
        problem's source array."""
        if out is None:
            dt = bool if f.dtype is np.uint8 else f.dtype
            out = np.full(f.shape, f.fill, dt)
        elif f.fill != 0:
            out.fill(f.fill)
        a = getattr(problem, f.src) if override is None else override
        if a.size:
            out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    def _padded_groups(self, problem: Problem, G: int,
                       A: Optional[int] = None,
                       NP: Optional[int] = None) -> binpack.GroupBatch:
        """The group fields of the fused buffer as separate padded
        tensors on the Solver's device (kernel tests and the unfused
        ``binpack.pack_packed``; every solve path ships the fused
        buffer)."""
        layout, _ = self._layout(problem, G, A, NP)
        return binpack.GroupBatch(**{
            f.name: torch.as_tensor(self._pad_field(problem, f),
                                    device=self.device)
            for f in layout if f.name in binpack.GroupBatch._fields})

    def _pool_params(self, problem: Problem,
                     NP: Optional[int] = None) -> binpack.PoolParams:
        layout, _ = self._layout(problem, 1, None, NP)
        return binpack.PoolParams(**{
            f.name: torch.as_tensor(self._pad_field(problem, f),
                                    device=self.device)
            for f in layout if f.name in binpack.PoolParams._fields})

    def _init_state(self, problem: Problem, B: int,
                    A: Optional[int] = None) -> binpack.BinState:
        """The bin table of B rows with the problem's existing bins open
        in its first E rows, on the Solver's device (what the fused
        existing-bin buffer unpacks to)."""
        lat = self.lattice
        E = problem.E
        A = max(problem.A, 1) if A is None else A
        state = binpack.empty_state(B, lat.T, lat.Z, lat.C, R, A,
                                    device=self.device)
        if E == 0:
            return state
        cum = np.zeros((B, R), np.float32)
        tmask = np.zeros((B, lat.T), bool)
        zmask = np.zeros((B, lat.Z), bool)
        cmask = np.zeros((B, lat.C), bool)
        np_id = np.full((B,), -1, np.int32)
        open_ = np.zeros((B,), bool)
        fixed = np.zeros((B,), bool)
        alloc_cap = np.full((B, R), np.inf, np.float32)
        pm = np.zeros((B, A), np.int32)
        po = np.zeros((B, A), bool)
        cum[:E] = problem.e_used
        tmask[np.arange(E), problem.e_type] = True
        zmask[np.arange(E), problem.e_zone] = True
        cmask[np.arange(E), problem.e_cap] = True
        np_id[:E] = problem.e_np
        open_[:E] = True
        fixed[:E] = True
        alloc_cap[:E] = problem.e_alloc  # real node allocatable wins
        if problem.A:
            pm[:E, : problem.A] = problem.e_pm
            po[:E, : problem.A] = problem.e_po
        dev = self.device
        return state._replace(
            cum=torch.as_tensor(cum, device=dev),
            tmask=torch.as_tensor(tmask, device=dev),
            zmask=torch.as_tensor(zmask, device=dev),
            cmask=torch.as_tensor(cmask, device=dev),
            np_id=torch.as_tensor(np_id, device=dev),
            open=torch.as_tensor(open_, device=dev),
            fixed=torch.as_tensor(fixed, device=dev),
            alloc_cap=torch.as_tensor(alloc_cap, device=dev),
            pm=torch.as_tensor(pm, device=dev),
            po=torch.as_tensor(po, device=dev),
            next_open=torch.tensor(E, dtype=torch.int32, device=dev))

    def _fused_inputs_np(self, problem: Problem, G: int,
                         A: Optional[int] = None, NP: Optional[int] = None,
                         count_override: Optional[np.ndarray] = None) -> np.ndarray:
        """All group + pool tensors padded into ONE uint8 host buffer →
        one host→device transfer (layout: ops/binpack.group_layout)."""
        layout, total = self._layout(problem, G, A, NP)
        buf = np.zeros((total,), np.uint8)
        for f in layout:
            n = int(np.prod(f.shape)) * np.dtype(f.dtype).itemsize
            view = buf[f.offset: f.offset + n].view(f.dtype).reshape(f.shape)
            self._pad_field(problem, f, out=view,
                            override=count_override if f.name == "count" else None)
        return buf

    def _fused_inputs(self, problem: Problem, G: int,
                      count_override: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
        """``_fused_inputs_np`` uploaded to this Solver's device."""
        return self._upload(self._fused_inputs_np(
            problem, G, count_override=count_override))

    def _fused_init_np(self, problem: Problem, B: int,
                       A: Optional[int] = None) -> np.ndarray:
        """Existing bins as ONE small uint8 buffer (per-bin indices +
        resource rows; ops/binpack.init_layout); the device rebuilds the
        one-hot masks."""
        A = max(problem.A, 1) if A is None else A
        layout, total = binpack.init_layout(B, R, A)
        buf = np.zeros((total,), np.uint8)
        for f in layout:
            n = int(np.prod(f.shape)) * np.dtype(f.dtype).itemsize
            view = buf[f.offset: f.offset + n].view(f.dtype).reshape(f.shape)
            self._pad_field(problem, f, out=view)
        return buf

    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        self._account_link("upload", buf.nbytes)
        return torch.from_numpy(buf).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- solve ----

    @_locked
    def solve_relaxed(self, pods, node_pools, lattice=None, existing=(),
                      daemonset_pods=(), bound_pods=(), pvcs=None,
                      storage_classes=None, mesh=None,
                      pool_headroom=None, problem0=None) -> NodePlan:
        """Tracing shim over :meth:`_solve_relaxed`: the whole relaxation
        loop (every round's solve and stage spans nest underneath) is one
        span carrying the plan's provenance."""
        with trace.span("solver.solve_relaxed", pods=len(pods)) as sp:
            plan = self._solve_relaxed(
                pods, node_pools, lattice=lattice, existing=existing,
                daemonset_pods=daemonset_pods, bound_pods=bound_pods,
                pvcs=pvcs, storage_classes=storage_classes, mesh=mesh,
                pool_headroom=pool_headroom, problem0=problem0)
            sp.set(path=plan.solver_path, degraded=plan.degraded,
                   reason=plan.degraded_reason, waves=plan.waves,
                   pipelined=plan.pipelined,
                   new_nodes=len(plan.new_nodes),
                   unschedulable=len(plan.unschedulable))
            return plan

    def _solve_relaxed(self, pods, node_pools, lattice=None, existing=(),
                       daemonset_pods=(), bound_pods=(), pvcs=None,
                       storage_classes=None, mesh=None,
                       pool_headroom=None, problem0=None) -> NodePlan:
        """Solve with preferred-rule relaxation (reference
        scheduling.md:203-206, 322-334).

        Round 0 treats every soft constraint — preferred node affinity,
        ScheduleAnyway topology spread — as hard. Pods that come back
        unschedulable and still have soft constraints get them relaxed one
        tier at a time and only those pods' groups re-enter the next
        round. Bounded by the deepest pod's soft-constraint count.
        ``problem0`` is an already-built round-0 problem for exactly these
        inputs."""
        from ..apis.objects import relax_pod, relaxation_depth
        from .problem import build_problem

        lattice = lattice if lattice is not None else self.lattice
        depth = {p.name: relaxation_depth(p) for p in pods}
        relax: Dict[str, int] = {}
        # every round increments at least one pod's level, so sum-of-depths
        # bounds termination; capped to keep a pathological wave sane
        max_rounds = min(1 + sum(depth.values()), 64)
        best = None
        total_solve = total_device = 0.0
        # degradation provenance aggregates across rounds: the returned
        # plan reports the WORST rung any round landed on, so one degraded
        # relaxation round is never laundered into a clean-looking plan
        path_order = {"device": 0, "wave-split": 1, "host-ffd": 2}
        worst_path, any_degraded, reasons = "device", False, []
        total_retries, max_waves = 0, 1
        stage_total: Dict[str, float] = {}
        any_pipelined = False
        for _ in range(max_rounds):
            if problem0 is not None and not relax:
                problem = problem0
            else:
                eff = [p if relax.get(p.name, 0) == 0
                       else relax_pod(p, relax[p.name]) for p in pods]
                problem = build_problem(eff, node_pools, lattice,
                                        existing=existing,
                                        daemonset_pods=daemonset_pods,
                                        bound_pods=bound_pods, pvcs=pvcs,
                                        storage_classes=storage_classes,
                                        pool_headroom=pool_headroom)
            plan = self.solve(problem, mesh=mesh)
            total_solve += plan.solve_seconds
            total_device += plan.device_seconds
            total_retries += plan.device_retries
            max_waves = max(max_waves, plan.waves)
            any_pipelined = any_pipelined or plan.pipelined
            for k, v in plan.stage_ms.items():
                stage_total[k] = stage_total.get(k, 0.0) + v
            if plan.degraded:
                any_degraded = True
                if plan.degraded_reason and plan.degraded_reason not in reasons:
                    reasons.append(plan.degraded_reason)
            if path_order.get(plan.solver_path, 0) > path_order[worst_path]:
                worst_path = plan.solver_path
            # a relaxation round re-packs globally and may regress a pod
            # relaxation cannot help — keep the best plan seen, not the last
            if best is None or ((len(plan.unschedulable), plan.new_node_cost)
                                < (len(best.unschedulable), best.new_node_cost)):
                best = plan
            improvable = [n for n, reason in plan.unschedulable.items()
                          if relax.get(n, 0) < depth.get(n, 0)
                          # pre-solve failures (unknown resource names) are
                          # not fixable by dropping preferences
                          and taxonomy.code_of(reason)
                          != taxonomy.UNKNOWN_RESOURCE
                          and not reason.startswith("unknown resource")]
            if not improvable:
                break
            for n in improvable:
                relax[n] = relax.get(n, 0) + 1
        best.solve_seconds = total_solve
        best.device_seconds = total_device
        best.degraded = any_degraded
        best.degraded_reason = reasons[0] if reasons else best.degraded_reason
        best.solver_path = worst_path
        best.device_retries = total_retries
        best.waves = max_waves
        best.stage_ms = stage_total
        best.pipelined = any_pipelined
        return best

    @_locked
    def solve(self, problem: Problem, mesh=None) -> NodePlan:
        """Tracing shim over :meth:`_solve_problem`: one span per solve
        round with the outcome attached."""
        with trace.span("solver.solve", groups=problem.G) as sp:
            plan = self._solve_problem(problem, mesh=mesh)
            sp.set(path=plan.solver_path, degraded=plan.degraded,
                   reason=plan.degraded_reason, retries=plan.device_retries)
            return plan

    def _solve_problem(self, problem: Problem, mesh=None) -> NodePlan:
        """Solve one built problem into a NodePlan on this Solver's
        device, degrading gracefully (the ladder in the module docstring).
        The ladder never raises for input shape or injected faults:
        adversarial batches degrade in latency, not availability. A
        ``mesh`` (None = the Solver's own ``mesh``) shards the pod axis; every
        rung of the ladder rides it. On a CUDA device every failure that
        :meth:`_host_ffd_may_carry` refuses raises, once its retry (if it
        earns one) failed too."""
        t0 = time.perf_counter()
        mesh = self.mesh if mesh is None else self._check_mesh(mesh)
        if problem.G == 0:
            return NodePlan([], {}, dict(problem.unschedulable), 0.0,
                            time.perf_counter() - t0, 0.0)
        retries = 0
        while True:
            try:
                if problem.G > self._g_ceiling():
                    # provenance counts ONCE per solve, not per retry
                    if retries == 0:
                        self._count_degraded("wave_split")
                        if self.faults is not None and self.faults.g_limit:
                            self.faults.note("g_overflow")
                    plan = self._solve_waves(problem, mesh, t0)
                else:
                    plan = self._solve_device(problem, mesh, t0)
                plan.device_retries = retries
                return plan
            except SolverCapacityError as e:
                # structural ceiling: retrying the same path cannot help
                reason = "b-exhausted" if e.axis == "B" else "g-overflow"
                detail = str(e)
                break
            except Exception as e:
                # only errors the taxonomy marks retryable (a kernel launch
                # failure, device OOM or failed transfer, which the device
                # path wraps as SolverDeviceError) earn a backoff and a
                # re-solve; a deterministic host-side failure goes straight
                # to the fallback (off the card; on it, it raises), never
                # misreported as device trouble
                if is_retryable_solver_error(e):
                    # the failure may have taken the resident device
                    # buffers with it: drop them so the retry, and every
                    # later solve, re-uploads instead of delta-hitting them
                    self._invalidate_device_state()
                if is_retryable_solver_error(e) and retries < self._DEVICE_RETRIES:
                    retries += 1
                    self._count_degraded("device_retry")
                    self._clock.sleep(self._RETRY_BACKOFF_SECONDS * retries)
                    continue
                if not self._host_ffd_may_carry(e):
                    # whatever raised, a device that no longer runs the
                    # probe is lost (the error may surface in host code
                    # that touched the device first)
                    if not self._device_alive():
                        self.device_lost = DeviceLostError(
                            f"the device is lost: a one-element probe "
                            f"fails after {type(e).__name__}: {e}; "
                            f"restart the process",
                            cause=e)
                        raise self.device_lost from e
                    raise
                reason = ("device-error" if isinstance(e, SolverDeviceError)
                          else "internal-error")
                detail = f"{type(e).__name__}: {e}"
                break
        self._count_degraded("host_ffd")
        with trace.span("solver.host_ffd", reason=reason, degraded=True):
            plan = self.solve_host_ffd(problem)
        plan.solve_seconds = time.perf_counter() - t0
        plan.degraded = True
        plan.degraded_reason = reason
        plan.solver_path = "host-ffd"
        plan.device_retries = retries
        plan.warnings = list(problem.warnings) + [
            f"solver degraded to host FFD ({reason}: {detail})"]
        return plan

    def _b_budget_single(self, problem: Problem,
                         G: int) -> Tuple[int, int]:
        """The single-device bin budget, including the ``_b_hint``
        fast-restart. Returns ``(fresh, B)``; the caller feeds ``fresh``
        back into ``_b_hint`` after decode."""
        total_pods = int(problem.count.sum())
        b_needed = problem.E + min(total_pods,
                                   self._estimate_bins(problem) + 64)
        fresh = _bucket(max(b_needed, problem.E + 1), _B_BUCKETS,
                        clamp=True)
        prev = self._b_hint.get(G)
        if prev is not None and fresh >= prev[0]:
            # a same-or-larger problem shape than the one that last forced
            # a retry: start directly at the size that worked
            B = max(fresh, prev[1])
        else:
            B = fresh
        return fresh, min(B, self._b_ceiling())

    def _b_budget_sharded(self, problem: Problem, D: int) -> int:
        """The per-shard bin budget of the mesh pack, shared by
        :meth:`_solve_sharded` and the microloop: existing bins (shard 0)
        + this shard's slice of the splittable groups + one tail bin per
        group + whole (pinned/co-located) groups + slack. The whole-group
        term is 0 inside the microloop's envelope (pinned groups leave it
        first), so sharing the formula keeps both paths' resident keys
        identical."""
        total_pods = int(problem.count.sum())
        caps = np.minimum(problem.max_per_bin.astype(np.int64),
                          np.maximum(problem.count.astype(np.int64), 1))
        capped_bins = int(np.ceil(problem.count
                                  / np.maximum(caps, 1)).sum())
        n_whole = int(problem.single_bin.sum()) + (
            int(problem.g_need.any(axis=1).sum()) if problem.A else 0)
        b_needed = problem.E + min(
            total_pods, -(-capped_bins // D) + problem.G + n_whole + 64)
        return min(_bucket(max(b_needed, problem.E + 1), _B_BUCKETS,
                           clamp=True), self._b_ceiling())

    def _stage_upload(self, key: Tuple, buf: np.ndarray,
                      pipelined: bool) -> torch.Tensor:
        """One fused upload: through the resident cache on the pipelined
        path, whole and synchronised on the sequential one."""
        if pipelined:
            return self._resident.upload(key, buf)
        dev = self._upload(buf)
        self._sync()
        return dev

    def _solve_device(self, problem: Problem, mesh=None,
                      t0: Optional[float] = None,
                      gbuf: Optional[torch.Tensor] = None,
                      overlap=None) -> NodePlan:
        """The primary path: one bucketed device pack (the pod-axis sharded
        variant, :meth:`_solve_sharded`, over a mesh of more than one
        shard). Raises
        SolverCapacityError when the bin table cannot grow past its
        ceiling and SolverDeviceError when the device call fails; the
        ladder in :meth:`_solve_problem` owns what happens next.

        The pipelined variant (``self.pipeline``) overlaps host work with
        the in-flight pack: the group and init buffers ride the resident
        cache, nothing synchronises between dispatch and fetch, the result
        copy starts right after dispatch (solver/pipeline.py
        ``fetch_async``), the ``overlap`` callable (the wave planner's
        "upload wave k+1 while wave k computes" hook) runs between
        dispatch and fetch, and decode prep fills the rest of the wait.
        So its ``compute`` stage is the host's issue time and ``download``
        holds the wait for the card; the sequential variant synchronises
        after each stage, so there ``compute`` is the device time.
        ``gbuf`` is an already-uploaded fused group+pool buffer; when
        given, the caller paid its build and upload stages (possibly
        inside a previous wave's compute window)."""
        t0 = time.perf_counter() if t0 is None else t0
        if mesh is not None and mesh.devices.size > 1:
            return self._solve_sharded(problem, mesh, t0, gbuf=gbuf,
                                       overlap=overlap)
        pipelined = self.pipeline
        stages = StageTimer()
        G = _bucket(problem.G, _G_BUCKETS)
        fresh, B = self._b_budget_single(problem, G)
        if problem.E > B:
            # the existing bins alone overflow the bin-table ceiling
            if self.faults is not None and self.faults.b_limit:
                self.faults.note("b_exhausted")
            raise SolverCapacityError(
                f"{problem.E} existing bins exceed the bin-table ceiling "
                f"B={B}", axis="B")
        lat = self.lattice
        NP, A = max(problem.NP, 1), max(problem.A, 1)

        fused_np = None
        if gbuf is None:
            with stages.span("build"):
                fused_np = self._fused_inputs_np(problem, G)
        # the group buffer is uploaded once across overflow regrows and
        # the (small) existing-bin buffer once per dispatch, except on the
        # sequential path with existing bins, where groups + bins ride one
        # combined upload per dispatch (the bin table grows with B)
        use_efused = pipelined or gbuf is not None or problem.E == 0
        avail, price = self._device_avail_price(problem)
        overlap_pending = overlap
        prep = None
        while True:
            # per-dispatch compute baseline: the cost model attributes
            # only the final dispatch's compute to the final (G, B) shape
            compute_ms0 = stages.ms.get("compute", 0.0)
            try:
                if use_efused:
                    if gbuf is None:
                        with stages.span("upload"):
                            # ("g", G, size): the whole-problem resident
                            # entry a steady-state solve delta-refreshes
                            gbuf = self._stage_upload(
                                ("g", G, fused_np.size), fused_np, pipelined)
                    self._maybe_inject_device_fault()
                    init_dev = None
                    if problem.E:
                        with stages.span("build"):
                            init_np = self._fused_init_np(problem, B)
                        with stages.span("upload"):
                            init_dev = self._stage_upload(
                                ("i", B, init_np.size), init_np, pipelined)
                    _count_scan(G, problem.G, problem.G)
                    with trace.span("solver.pack"), stages.span("compute"):
                        clock = DeviceTimer(self.device)
                        dev_buf = binpack.pack_packed_efused(
                            self._alloc, avail, price, gbuf, init_dev,
                            problem.E, B, G, lat.T, lat.Z, lat.C, NP, A,
                            lean=True, n_groups=problem.G)
                        clock.stop()
                        if not pipelined:
                            self._sync()
                else:
                    self._maybe_inject_device_fault()
                    with stages.span("build"):
                        init_np = self._fused_init_np(problem, B)
                        combined_np = np.concatenate([fused_np, init_np])
                    with stages.span("upload"):
                        combined = self._upload(combined_np)
                        self._sync()
                    _count_scan(G, problem.G, problem.G)
                    with trace.span("solver.pack"), stages.span("compute"):
                        clock = DeviceTimer(self.device)
                        dev_buf = binpack.pack_packed_combined(
                            self._alloc, avail, price, combined,
                            len(fused_np), problem.E, B,
                            G, lat.T, lat.Z, lat.C, NP, A, lean=True,
                            n_groups=problem.G)
                        clock.stop()
                        self._sync()
                # start streaming the result the moment the pack finishes;
                # the host fills the wait below
                pending = fetch_async(dev_buf) if pipelined else None
            except (SolverError, KernelBuildError):
                raise
            except RuntimeError as e:
                # kernel launch failure, device OOM, transfer failure
                raise SolverDeviceError(
                    f"{type(e).__name__}: {e}", cause=e) from e
            # host work outside the device-error wrap: a bug here (next-wave
            # input building, decode prep) must surface as internal-error,
            # not pass for a device fault. The card keeps computing the
            # dispatched pack meanwhile.
            if overlap_pending is not None:
                overlap_pending()
                overlap_pending = None
            if pipelined and prep is None:
                prep = self._decode_prep(problem)
            try:
                with stages.span("download"):
                    buf = (pending.wait() if pipelined
                           else dev_buf.cpu().numpy())
            except RuntimeError as e:
                raise SolverDeviceError(
                    f"{type(e).__name__}: {e}", cause=e) from e
            self._account_link("fetch", buf.nbytes)
            device_s = clock.seconds()
            with stages.span("decode"):
                dec = _unpack_decode_set(buf, G, lat.T, lat.Z, lat.C, A,
                                         lean=True)
            overflowed = (dec.leftover.sum() > 0) and dec.next_open >= B
            if overflowed:
                nb, grew = _grow_bucket(B)
                if grew and nb <= self._b_ceiling():
                    B = nb
                    continue
                # growth exhausted: never decode a plan that silently drops
                # the leftover; the ladder degrades to the host FFD, whose
                # bin table is unbounded
                if self.faults is not None and self.faults.b_limit:
                    self.faults.note("b_exhausted")
                raise SolverCapacityError(
                    f"bin table exhausted at B={B} with "
                    f"{int(dec.leftover.sum())} pod(s) left over", axis="B")
            break

        # record what this estimate bucket actually consumed, so the hint
        # decays as soon as a smaller wave passes through
        needed = _bucket(max(dec.next_open, problem.E + 1, 1), _B_BUCKETS,
                         clamp=True)
        self._b_hint[G] = (fresh, needed)
        with stages.span("decode"):
            plan = self._decode(problem, dec, device_s, prep=prep)
        plan.solve_seconds = time.perf_counter() - t0
        plan.warnings = list(problem.warnings)
        plan.stage_ms = stages.ms
        plan.pipelined = pipelined
        # last-vs-best per shape: was the device slow, or everything
        # around it (solver/costmodel.py)
        costmodel.model().observe_solve(
            costmodel.shape_key(G, B),
            stages.ms.get("compute", 0.0) - compute_ms0)
        if pipelined:
            # once per completed solve, not per overflow-regrow dispatch
            self.pipeline_stats["async_solves"] += 1
        return plan

    # ---- wave-split planner (group-axis graceful degradation) ----

    def _solve_waves(self, problem: Problem, mesh, t0: float) -> NodePlan:
        """Solve a problem whose group axis exceeds the group ceiling by
        partitioning it into bucket-sized WAVES and solving them in
        sequence on the device.

        Groups are already FFD-ordered (build_problem sorts descending), so
        waves run cost-ordered exactly like the sequential reference: the
        first wave packs the biggest groups, later waves fill in around
        them. Open-bin state carries BETWEEN waves: every node an earlier
        wave planned re-enters the next wave's problem as a pre-initialized
        existing bin (with its real chosen-type allocatable and its
        affinity-class presence counts), and placements onto REAL existing
        capacity update that capacity's remaining headroom, so packing
        quality stays within the host-FFD envelope instead of each wave
        opening its own fresh fleet.

        The pipelined planner double-buffers the wave INPUTS: wave k+1's
        fused group+pool buffer depends only on its group slice (never on
        carry state), so it builds and uploads while wave k computes. The
        carry state itself (the small init buffer) is derived at the stage
        boundary from wave k's decode, exactly as in the sequential
        planner, which is why the two produce byte-identical plans.

        A mesh composes with the planner: each wave's fused group buffer
        is exactly what the sharded pack shares across its shards, so the
        prefetch and the resident cache (keyed by shard count) ride the
        mesh unchanged."""
        ceiling = self._g_ceiling()
        wave = max(1, min(self._WAVE_G_TARGET, ceiling))
        bounds = [(lo, min(lo + wave, problem.G))
                  for lo in range(0, problem.G, wave)]
        n_waves = len(bounds)
        sharded = mesh is not None and int(mesh.devices.size) > 1
        D = int(mesh.devices.size) if sharded else 1
        wave_sharding = None
        if sharded and self.pipeline:
            from ..parallel.sharded import replicated_sharding
            wave_sharding = replicated_sharding(mesh)
        pipelined = self.pipeline
        stages = StageTimer()

        def wave_gbuf(i: int) -> torch.Tensor:
            """Wave i's fused group+pool upload through the resident cache
            (pipelined path only): carry-independent, so the loop runs this
            inside wave i-1's compute window (the _solve_device ``overlap``
            hook)."""
            lo_i, hi_i = bounds[i]
            gp = self._wave_slice(problem, lo_i, hi_i)
            Gw = _bucket(gp.G, _G_BUCKETS)
            with stages.span("build"):
                fnp = self._fused_inputs_np(gp, Gw)
            with stages.span("upload"):
                # a transfer failure is device weather (retryable), even in
                # the previous wave's overlap window; the shard count in
                # the key: a wave buffer resident under one mesh shape
                # never serves another's delta
                try:
                    return self._resident.upload(("w", D, i, Gw, fnp.size),
                                                 fnp, sharding=wave_sharding)
                except RuntimeError as e:
                    raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                            cause=e) from e

        A = problem.A
        # pod name -> group index (req/match/owner lookups while carrying
        # bin state across waves)
        gi_of: Dict[str, int] = {}
        for gi, g in enumerate(problem.groups):
            for name in g.pod_names:
                gi_of[name] = gi
        # pool identity -> index; virtual pools share a base name but
        # differ by custom labels, so the key carries both
        pool_idx: Dict[Tuple[str, frozenset], int] = {}
        for i, p in enumerate(problem.node_pools):
            pool_idx.setdefault(
                (p.base_name or p.name, frozenset(p.custom_labels.items())), i)
        e_idx = {b.name: i for i, b in enumerate(problem.existing)}

        # mutable copies of the real existing-bin running state
        e_used = problem.e_used.copy()
        e_pm = problem.e_pm.copy()
        e_po = problem.e_po.copy()

        # carried open bins: one pseudo existing bin per node planned by an
        # earlier wave (parallel lists; index = pseudo bin id)
        pseudo_nodes: List[PlannedNode] = []
        pseudo_used: List[np.ndarray] = []
        pseudo_np: List[int] = []
        pseudo_pm: List[np.ndarray] = []
        pseudo_po: List[np.ndarray] = []
        pseudo_by_name: Dict[str, int] = {}

        merged_assign: Dict[str, List[str]] = {}
        merged_unsched: Dict[str, str] = dict(problem.unschedulable)
        device_s = 0.0

        def register_pod(pn: str, used: np.ndarray, pm: np.ndarray,
                         po: np.ndarray) -> None:
            gi = gi_of[pn]
            used += problem.req[gi]
            if A:
                pm += problem.g_match[gi]
                po |= problem.g_owner[gi]

        # only the pipelined planner pre-builds wave inputs: the sequential
        # path keeps the single combined group+init upload inside
        # _solve_device
        next_gbuf = wave_gbuf(0) if pipelined else None
        for i, (lo, hi) in enumerate(bounds):
            sub = self._wave_problem(problem, lo, hi, e_used, e_pm, e_po,
                                     pseudo_nodes, pseudo_used, pseudo_np,
                                     pseudo_pm, pseudo_po)
            gbuf_i, next_gbuf = next_gbuf, None
            holder: Dict[str, torch.Tensor] = {}
            overlap = None
            if pipelined and i + 1 < n_waves:
                def overlap(j=i + 1):
                    # runs between wave i's dispatch and its result fetch:
                    # wave j's upload rides wave i's compute
                    holder["gbuf"] = wave_gbuf(j)
                    self.pipeline_stats["prefetched_waves"] += 1
            with trace.span("solver.wave", wave=i, groups=hi - lo,
                            prefetched=gbuf_i is not None and i > 0):
                plan_w = self._solve_device(sub, mesh, gbuf=gbuf_i,
                                            overlap=overlap)
            # _solve_device ran the hook once its dispatch succeeded
            next_gbuf = holder.get("gbuf")
            device_s += plan_w.device_seconds
            stages.merge(plan_w.stage_ms)
            merged_unsched.update(plan_w.unschedulable)
            for node_name, pod_names in plan_w.existing_assignments.items():
                pi = pseudo_by_name.get(node_name)
                if pi is not None:
                    # pods joining an earlier wave's planned node
                    pseudo_nodes[pi].pods.extend(pod_names)
                    for pn in pod_names:
                        register_pod(pn, pseudo_used[pi], pseudo_pm[pi],
                                     pseudo_po[pi])
                else:
                    merged_assign.setdefault(node_name, []).extend(pod_names)
                    ei = e_idx[node_name]
                    for pn in pod_names:
                        register_pod(pn, e_used[ei], e_pm[ei], e_po[ei])
            for node in plan_w.new_nodes:
                np_i = pool_idx.get(
                    (node.node_pool, frozenset(node.extra_labels.items())), 0)
                used = problem.ds_overhead[np_i].copy()
                pm = np.zeros((A,), np.int32)
                po = np.zeros((A,), bool)
                for pn in node.pods:
                    register_pod(pn, used, pm, po)
                # the name is positional: _wave_problem re-derives it from
                # the pseudo index, so later waves' assignments route back
                pseudo_by_name[f"__wave:{len(pseudo_nodes)}__"] = \
                    len(pseudo_nodes)
                pseudo_nodes.append(node)
                pseudo_used.append(used)
                pseudo_np.append(np_i)
                pseudo_pm.append(pm)
                pseudo_po.append(po)

        new_nodes = [n for n in pseudo_nodes if n.pods]
        cost = float(sum(n.price_per_hour for n in new_nodes))
        return NodePlan(
            new_nodes=new_nodes, existing_assignments=merged_assign,
            unschedulable=merged_unsched, new_node_cost=cost,
            solve_seconds=time.perf_counter() - t0, device_seconds=device_s,
            warnings=list(problem.warnings) + [
                f"wave-split: G={problem.G} over ceiling {ceiling}, "
                f"{n_waves} wave(s) of ≤{wave} groups"],
            degraded=True, degraded_reason="g-overflow",
            solver_path="wave-split", waves=n_waves,
            stage_ms=stages.ms, pipelined=pipelined, mesh_devices=D)

    def _wave_slice(self, problem: Problem, lo: int, hi: int) -> Problem:
        """Groups [lo, hi) with carry-INDEPENDENT fields only: exactly
        what the wave's fused group+pool buffer reads
        (ops/binpack.group_layout names no existing-bin field), so the
        pipelined planner can build wave k+1's upload before wave k's
        results exist. _wave_problem layers the carried bin state on top
        of this at the stage boundary."""
        sl = slice(lo, hi)
        return replace(
            problem,
            groups=problem.groups[sl], unschedulable={}, warnings=[],
            req=problem.req[sl], count=problem.count[sl],
            g_type=problem.g_type[sl], g_zone=problem.g_zone[sl],
            g_cap=problem.g_cap[sl], g_np=problem.g_np[sl],
            max_per_bin=problem.max_per_bin[sl],
            g_spread=problem.g_spread[sl], single_bin=problem.single_bin[sl],
            g_match=problem.g_match[sl], g_owner=problem.g_owner[sl],
            g_need=problem.g_need[sl], strict_custom=problem.strict_custom[sl])

    def _wave_problem(self, problem: Problem, lo: int, hi: int,
                      e_used: np.ndarray, e_pm: np.ndarray, e_po: np.ndarray,
                      pseudo_nodes: List[PlannedNode],
                      pseudo_used: List[np.ndarray], pseudo_np: List[int],
                      pseudo_pm: List[np.ndarray],
                      pseudo_po: List[np.ndarray]) -> Problem:
        """One wave's sub-problem: groups [lo, hi) plus the carried bin
        state, real existing bins at their RUNNING usage and every earlier
        wave's planned node as a fixed pre-initialized bin."""
        lat = self.lattice
        from .problem import ExistingBin
        existing = list(problem.existing)
        if pseudo_nodes:
            k = len(pseudo_nodes)
            p_type = np.array([lat.name_to_idx[n.instance_type]
                               for n in pseudo_nodes], np.int32)
            p_zone = np.array([lat.zones.index(n.zone)
                               for n in pseudo_nodes], np.int32)
            p_cap = np.array([lat.capacity_types.index(n.capacity_type)
                              for n in pseudo_nodes], np.int32)
            p_np = np.asarray(pseudo_np, np.int32)
            p_used = np.stack(pseudo_used).astype(np.float32)
            # a planned node's allocatable is its chosen type's, clamped by
            # its pool's kubelet ceiling: what the launch will deliver
            p_alloc = np.minimum(
                lat.alloc[p_type],
                problem.np_alloc_cap[p_np]).astype(np.float32)
            p_pm = (np.stack(pseudo_pm).astype(np.int32) if problem.A
                    else np.zeros((k, 0), np.int32))
            p_po = (np.stack(pseudo_po).astype(bool) if problem.A
                    else np.zeros((k, 0), bool))
            for i, n in enumerate(pseudo_nodes):
                existing.append(ExistingBin(
                    name=f"__wave:{i}__", node_pool=n.node_pool,
                    instance_type=n.instance_type, zone=n.zone,
                    capacity_type=n.capacity_type, used=p_used[i],
                    alloc_override=p_alloc[i]))
            e_used2 = np.concatenate([e_used, p_used])
            e_alloc2 = np.concatenate([problem.e_alloc, p_alloc])
            e_type2 = np.concatenate([problem.e_type, p_type])
            e_zone2 = np.concatenate([problem.e_zone, p_zone])
            e_cap2 = np.concatenate([problem.e_cap, p_cap])
            e_np2 = np.concatenate([problem.e_np, p_np])
            e_pm2 = np.concatenate([e_pm, p_pm])
            e_po2 = np.concatenate([e_po, p_po])
        else:
            e_used2, e_alloc2 = e_used, problem.e_alloc
            e_type2, e_zone2 = problem.e_type, problem.e_zone
            e_cap2, e_np2 = problem.e_cap, problem.e_np
            e_pm2, e_po2 = e_pm, e_po
        return replace(
            self._wave_slice(problem, lo, hi),
            existing=existing, e_used=e_used2, e_alloc=e_alloc2,
            e_type=e_type2, e_zone=e_zone2, e_cap=e_cap2, e_np=e_np2,
            e_pm=e_pm2, e_po=e_po2)

    # ---- host-FFD fallback (bottom rung of the ladder) ----

    def solve_host_ffd(self, problem: Problem) -> NodePlan:
        """Pure-host sequential FFD (solver/oracle.py) decoded into a
        NodePlan. No device dependency, no shape ceilings: the bottom rung
        of the degradation ladder."""
        from .oracle import ffd_oracle
        t0 = time.perf_counter()
        plat = problem.lattice
        oracle = ffd_oracle(problem)
        existing_assignments: Dict[str, List[str]] = {}
        new_bins = []
        for b in oracle.bins:
            if not b.pods:
                continue
            if b.is_existing:
                existing_assignments.setdefault(
                    problem.existing[b.existing_idx].name, []).extend(b.pods)
            else:
                new_bins.append(b)
        nodes: List[PlannedNode] = []
        if new_bins:
            feasible = self._feasible_sets_batch(
                problem,
                np.stack([b.tmask for b in new_bins]),
                np.stack([b.zmask for b in new_bins]),
                np.stack([b.cmask for b in new_bins]))
            for b, (t, z, c), (ftypes, fzones, fcaps) in zip(
                    new_bins, oracle.chosen, feasible):
                pname, extra = _pool_out(problem.node_pools[b.np_idx])
                nodes.append(PlannedNode(
                    node_pool=pname, extra_labels=extra,
                    instance_type=plat.names[t], zone=plat.zones[z],
                    capacity_type=plat.capacity_types[c],
                    price_per_hour=float(plat.price[t, z, c]),
                    pods=list(b.pods),
                    feasible_types=ftypes, feasible_zones=fzones,
                    feasible_capacity_types=fcaps))
        return NodePlan(
            new_nodes=nodes, existing_assignments=existing_assignments,
            unschedulable=dict(oracle.unschedulable),
            new_node_cost=oracle.new_node_cost,
            solve_seconds=time.perf_counter() - t0, device_seconds=0.0,
            warnings=list(problem.warnings), solver_path="host-ffd")

    # ---- decode ----

    def _decode_prep(self, problem: Problem) -> Dict[str, object]:
        """Host decode inputs that do not depend on the device result."""
        with trace.span("decode.prep"):
            return {
                "pool_out": [_pool_out(p) for p in problem.node_pools],
                "existing_names": [b.name for b in problem.existing],
            }

    def _decode(self, problem: Problem, dec: _DecodeSet, device_s: float,
                prep: Optional[Dict[str, object]] = None) -> NodePlan:
        if prep is None:
            prep = self._decode_prep(problem)
        pool_out = prep["pool_out"]
        existing_names = prep["existing_names"]
        lat = self.lattice
        assign = dec.assign
        leftover = dec.leftover
        fixed = dec.fixed
        np_id = dec.np_id

        unschedulable = dict(problem.unschedulable)
        existing_assignments: Dict[str, List[str]] = {}
        new_bins: Dict[int, PlannedNode] = {}
        # the feasible sets of every new bin that received pods, in one
        # vectorized pass
        used = assign[: problem.G].sum(axis=0) > 0
        live_rows = np.nonzero(used & ~fixed)[0]
        feasible = self._feasible_sets_batch(
            problem,
            np.unpackbits(dec.tmask_p[live_rows], axis=1)[:, : lat.T].astype(bool),
            np.unpackbits(dec.zmask_p[live_rows], axis=1)[:, : lat.Z].astype(bool),
            np.unpackbits(dec.cmask_p[live_rows], axis=1)[:, : lat.C].astype(bool),
        )
        feasible_for = dict(zip(live_rows.tolist(), feasible))

        fixed_l = fixed.tolist()
        np_id_l = np_id.tolist()
        chosen_t = dec.chosen_t.tolist()
        chosen_z = dec.chosen_z.tolist()
        chosen_c = dec.chosen_c.tolist()
        chosen_price = dec.chosen_price.tolist()
        leftover_l = leftover.tolist()

        for gi, group in enumerate(problem.groups):
            names = group.pod_names
            cursor = 0
            row = assign[gi]
            bs = np.nonzero(row)[0]
            for b, n in zip(bs.tolist(), row[bs].tolist()):
                n = int(n)
                pod_slice = names[cursor: cursor + n]
                cursor += n
                if fixed_l[b]:
                    existing_assignments.setdefault(
                        existing_names[b], []).extend(pod_slice)
                else:
                    node = new_bins.get(b)
                    if node is None:
                        ftypes, fzones, fcaps = feasible_for[b]
                        pname, extra = pool_out[np_id_l[b]]
                        node = PlannedNode(
                            node_pool=pname, extra_labels=dict(extra),
                            instance_type=lat.names[chosen_t[b]],
                            zone=lat.zones[chosen_z[b]],
                            capacity_type=lat.capacity_types[chosen_c[b]],
                            price_per_hour=float(chosen_price[b]),
                            feasible_types=ftypes, feasible_zones=fzones,
                            feasible_capacity_types=fcaps,
                        )
                        new_bins[b] = node
                    node.pods.extend(pod_slice)
            if leftover_l[gi]:
                msg = unplaced_reason(group)
                for name in names[cursor: cursor + int(leftover_l[gi])]:
                    unschedulable[name] = msg

        new_nodes = [new_bins[b] for b in sorted(new_bins)]
        cost = float(sum(n.price_per_hour for n in new_nodes))
        return NodePlan(new_nodes=new_nodes, existing_assignments=existing_assignments,
                        unschedulable=unschedulable, new_node_cost=cost,
                        solve_seconds=0.0, device_seconds=device_s)

    def _feasible_sets_batch(self, problem: Problem, tm: np.ndarray,
                             zm: np.ndarray, cm: np.ndarray):
        """Vectorized feasible sets for L bins at once: [L,T],[L,Z],[L,C]
        masks → per-bin (types cheapest-first, zones, captypes) tuples.
        Bins are bucketed by their full mask pattern, so the T-wide price
        argsort runs once per pattern; same-pattern bins share one result."""
        lat = self.lattice
        L = tm.shape[0]
        if L == 0:
            return []
        avail_np = problem.lattice.available                  # [T,Z,C]
        p_all = np.where(avail_np, problem.lattice.price, np.inf)
        # two-level bucketing: the [T,nz,nc] reductions run once per OUTER
        # (zone,captype) pattern; the T-wide argsort once per type mask
        outer: Dict[bytes, Dict[bytes, List[int]]] = {}
        for l in range(L):
            outer.setdefault(zm[l].tobytes() + cm[l].tobytes(), {}) \
                .setdefault(tm[l].tobytes(), []).append(l)
        out: List[tuple] = [None] * L                          # type: ignore[list-item]
        names, zone_names, cap_names = lat.names, lat.zones, lat.capacity_types
        for zc_groups in outer.values():
            first = next(iter(zc_groups.values()))[0]
            z, c = zm[first], cm[first]
            best = np.full(lat.T, np.inf)                      # [T]
            av_tz = np.zeros((lat.T, lat.Z), bool)
            av_tc = np.zeros((lat.T, lat.C), bool)
            if z.any() and c.any():
                sub = p_all[:, z][:, :, c]                     # [T,nz,nc]
                best = sub.min(axis=(1, 2))
                sub_av = avail_np[:, z][:, :, c]
                av_tz[:, z] = sub_av.any(axis=2)
                av_tc[:, c] = sub_av.any(axis=1)
            for idxs in zc_groups.values():
                t_mask = tm[idxs[0]]
                bpt = np.where(t_mask, best, np.inf)           # [T]
                # argsort puts inf (infeasible) types last, so the first
                # n_fin entries of order are exactly the feasible types
                order = np.argsort(bpt, kind="stable")
                nf = min(int(np.isfinite(bpt).sum()), MAX_FLEXIBLE_TYPES)
                shared = (
                    tuple(names[t] for t in order[:nf].tolist()),
                    tuple(zone_names[zi]
                          for zi, v in enumerate(t_mask @ av_tz) if v),
                    tuple(cap_names[ci]
                          for ci, v in enumerate(t_mask @ av_tc) if v),
                )
                for l in idxs:
                    out[l] = shared
        return out

    def _feasible_sets(self, problem: Problem, tmask_row: np.ndarray,
                       zmask_row: np.ndarray, cmask_row: np.ndarray):
        """One bin's feasible offering sets, cheapest type first."""
        return self._feasible_sets_batch(
            problem, tmask_row[None], zmask_row[None], cmask_row[None])[0]

    # ---- pod-axis sharded solve (the mesh path) ----
    #
    # The pod axis splits into D shards: each packs its slice of every
    # group (parallel/sharded.py, one batched pass on this device or one
    # on each rank's card, parallel/ranks.py), the
    # totals reduce over shards, and a host-side refinement dissolves
    # under-filled tail bins (at most one per group per shard) back into
    # one small seeded merge pack. The merge's size is O(groups x shards),
    # whatever the pod count.

    MERGE_FILL_THRESHOLD = 0.85  # dissolve new bins filled below this fraction

    def _solve_sharded(self, problem: Problem, mesh, t0: float,
                       gbuf: Optional[torch.Tensor] = None,
                       overlap=None) -> NodePlan:
        """The mesh path: the pod-axis sharded pack and the tail-bin merge,
        with the single-device solve's pipelining contract. The fused
        inputs ride the resident cache, keyed by shard count so that a
        mesh-shape change never delta-hits, the result copy starts at
        dispatch, and the wave planner's ``overlap`` hook runs inside the
        compute window. ``gbuf`` is an already-uploaded fused group+pool
        buffer from the wave prefetch."""
        from ..parallel.sharded import (replicated_sharding, shard_groups,
                                        sharded_pack, split_counts)

        D = int(mesh.devices.size)
        pipelined = self.pipeline
        stages = StageTimer()
        G = _bucket(problem.G, _G_BUCKETS)
        B = self._b_budget_sharded(problem, D)
        if problem.E > B:
            # shard 0's existing bins alone overflow the bin-table ceiling
            # (checked before anything is built, as on one device)
            if self.faults is not None and self.faults.b_limit:
                self.faults.note("b_exhausted")
            raise SolverCapacityError(
                f"{problem.E} existing bins exceed the bin-table ceiling "
                f"B={B}", axis="B")

        repl = replicated_sharding(mesh) if pipelined else None
        if gbuf is None:
            with stages.span("build"):
                fused_np = self._fused_inputs_np(problem, G)
            with stages.span("upload"):
                # ("g", D, G, size): the mesh's whole-problem resident
                # entry, which a steady-state delta pass block-diffs
                try:
                    gbuf = self._stage_upload(("g", D, G, fused_np.size),
                                              fused_np, pipelined)
                except RuntimeError as e:
                    raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                            cause=e) from e
        alloc_r, avail, price = self._mesh_inputs(problem, mesh)

        count_pad = np.zeros((G,), np.int32)
        count_pad[: problem.G] = problem.count
        pin = np.zeros((G,), bool)
        keep = np.zeros((G,), bool)
        if problem.A:
            pin[: problem.G] = problem.g_need.any(axis=1)
        keep[: problem.G] = problem.single_bin
        keep |= pin
        count_split = split_counts(count_pad, D, keep_whole=keep,
                                   pin_shard0=pin)
        # per-shard load balance of this split (max/mean; the
        # karpenter_solver_shard_imbalance_ratio gauge reads it)
        load = shard_groups(count_split).astype(np.float64)
        self._mesh_imbalance = (float(load.max() / load.mean())
                                if load.mean() > 0 else 1.0)

        lat = self.lattice
        A = max(problem.A, 1)
        NP = max(problem.NP, 1)
        overlap_pending = overlap
        while True:
            compute_ms0 = stages.ms.get("compute", 0.0)
            try:
                init_dev = None
                if problem.E:
                    with stages.span("build"):
                        init_np = self._fused_init_np(problem, B)
                    with stages.span("upload"):
                        key = ("i", D, B, init_np.size)
                        init_dev = (self._resident.upload(key, init_np,
                                                          sharding=repl)
                                    if pipelined
                                    else self._stage_upload(key, init_np,
                                                            False))
                self._maybe_inject_device_fault()
                _count_scan(G, problem.G, G)
                with trace.span("solver.pack_sharded"), \
                        stages.span("compute"):
                    # the [D,G] split ships from the host here (the
                    # microloop derives it on the device instead)
                    self._account_link("upload", count_split.nbytes)
                    clock = DeviceTimer(self.device)
                    sp = sharded_pack(mesh, alloc_r, avail, price, gbuf,
                                      init_dev, problem.E, count_split,
                                      B, G, lat.T, lat.Z, lat.C, NP, A,
                                      ranks=self._mesh_ranks(mesh))
                    clock.stop()
                    if not pipelined:
                        self._sync()
                # stream the stacked per-shard result out the moment the
                # pack finishes; the host work below fills the wait
                pending = fetch_async(sp.packed) if pipelined else None
            except (SolverError, KernelBuildError):
                raise
            except RuntimeError as e:
                raise SolverDeviceError(
                    f"{type(e).__name__}: {e}", cause=e) from e
            # host work outside the device-error wrap, as on the
            # single-device path: wave k+1's input build is internal-error
            # when it fails, never device weather
            if overlap_pending is not None:
                overlap_pending()
                overlap_pending = None
            try:
                with stages.span("download"):
                    # one [D,B+n,W] buffer: one device→host copy for all
                    # shards
                    packed = (pending.wait() if pipelined
                              else sp.packed.cpu().numpy())
            except RuntimeError as e:
                raise SolverDeviceError(
                    f"{type(e).__name__}: {e}", cause=e) from e
            self._account_link("fetch", packed.nbytes)
            device_s = clock.seconds()
            with stages.span("decode"):
                decs = _unpack_sharded(packed, G, lat.T, lat.Z, lat.C, A)
            leftover = np.stack([dec.leftover for dec in decs])     # [D,G]
            next_open = np.array([dec.next_open for dec in decs])    # [D]
            overflowed = bool(((leftover.sum(axis=1) > 0)
                               & (next_open >= B)).any())
            if overflowed:
                nb, grew = _grow_bucket(B)
                if grew and nb <= self._b_ceiling():
                    B = nb
                    continue
                # the single-device path's exhaustion contract: the ladder
                # degrades to the host FFD rather than decoding a plan that
                # drops the spilled pods
                if self.faults is not None and self.faults.b_limit:
                    self.faults.note("b_exhausted")
                raise SolverCapacityError(
                    f"sharded bin table exhausted at B={B} with "
                    f"{int(leftover.sum())} pod(s) left over", axis="B")
            break

        with stages.span("decode"):
            plan = self._decode_sharded(problem, float(sp.total_cost), decs,
                                        count_split, device_s)
        plan.solve_seconds = time.perf_counter() - t0
        plan.warnings = list(problem.warnings)
        plan.stage_ms = stages.ms
        plan.pipelined = pipelined
        plan.mesh_devices = D
        plan.shard_imbalance = self._mesh_imbalance
        # the mesh pack has its own cost-model entry (the key carries D),
        # so it never pollutes the single-device (G, B) baseline
        costmodel.model().observe_solve(
            costmodel.shape_key(G, B, mesh_devices=D),
            stages.ms.get("compute", 0.0) - compute_ms0)
        self.pipeline_stats["mesh_solves"] += 1
        if pipelined:
            self.pipeline_stats["async_solves"] += 1
        return plan

    def _stacked_masks(self, decs: List[_DecodeSet],
                       items: List[Tuple[int, int]]):
        """Unpack the (shard, bin) rows in ``items`` into stacked [L,T]/
        [L,Z]/[L,C] boolean masks, one unpackbits per shard."""
        lat = self.lattice
        by_shard: Dict[int, List[int]] = {}
        for i, (d, _b) in enumerate(items):
            by_shard.setdefault(d, []).append(i)
        tm = np.zeros((len(items), lat.T), bool)
        zm = np.zeros((len(items), lat.Z), bool)
        cm = np.zeros((len(items), lat.C), bool)
        for d, idxs in by_shard.items():
            rows = np.array([items[i][1] for i in idxs])
            tm[idxs] = decs[d].tmask(rows, lat.T)
            zm[idxs] = decs[d].zmask(rows, lat.Z)
            cm[idxs] = decs[d].cmask(rows, lat.C)
        return tm, zm, cm

    def _decode_sharded(self, problem: Problem, raw_cost: float,
                        decs: List[_DecodeSet],
                        count_split: np.ndarray, device_s: float,
                        merge_ctx: Optional[Dict] = None) -> NodePlan:
        lat = self.lattice
        D = count_split.shape[0]

        # -- walk each group's contiguous per-shard name slices through the
        # per-shard bin tables (the single-device cursor decode)
        bins_content: Dict[Tuple[int, int], List[Tuple[int, List[str]]]] = {}
        spill_names: Dict[int, List[str]] = {}    # group idx -> no shard placed
        unschedulable = dict(problem.unschedulable)
        existing_assignments: Dict[str, List[str]] = {}
        for gi, group in enumerate(problem.groups):
            names = group.pod_names
            start = 0
            for d in range(D):
                share = int(count_split[d, gi])
                shard_names = names[start: start + share]
                start += share
                cursor = 0
                for b in np.nonzero(decs[d].assign[gi])[0]:
                    n = int(decs[d].assign[gi, b])
                    bins_content.setdefault((d, int(b)), []).append(
                        (gi, shard_names[cursor: cursor + n]))
                    cursor += n
                # a shard's leftover gets a second chance in the merge
                # (other shards' bins and existing capacity may hold it)
                spill = shard_names[cursor: cursor + int(decs[d].leftover[gi])]
                if spill:
                    spill_names.setdefault(gi, []).extend(spill)

        # -- classify bins: existing (fixed, shard 0), kept new, dissolved
        kept: List[Tuple[int, int, List[Tuple[int, List[str]]]]] = []
        tail_names: Dict[int, List[str]] = {gi: list(v)
                                            for gi, v in spill_names.items()}
        for (d, b), content in sorted(bins_content.items()):
            if decs[d].fixed[b]:
                name = problem.existing[b].name
                for _, pod_names in content:
                    existing_assignments.setdefault(name, []).extend(pod_names)
                continue
            alloc_t = lat.alloc[int(decs[d].chosen_t[b])]
            with np.errstate(divide="ignore", invalid="ignore"):
                frac = np.where(alloc_t > 0, decs[d].cum[b] / alloc_t, 0.0)
            if float(np.max(frac, initial=0.0)) < self.MERGE_FILL_THRESHOLD:
                for gi, pod_names in content:
                    tail_names.setdefault(gi, []).extend(pod_names)
            else:
                kept.append((d, b, content))

        def raw_plan() -> NodePlan:
            """No-merge plan: every new bin becomes a node as packed;
            spilled pods (no shard placed them) go unschedulable."""
            nodes: List[PlannedNode] = []
            assigns = {k: list(v) for k, v in existing_assignments.items()}
            unsched = dict(unschedulable)
            new_entries = [(db, content)
                           for db, content in sorted(bins_content.items())
                           if not decs[db[0]].fixed[db[1]]]
            tm, zm, cm = self._stacked_masks(decs,
                                             [db for db, _ in new_entries])
            feasible = self._feasible_sets_batch(problem, tm, zm, cm)
            for ((d, b), content), (ftypes, fzones, fcaps) in zip(
                    new_entries, feasible):
                dec = decs[d]
                pname, extra = _pool_out(problem.node_pools[int(dec.np_id[b])])
                node = PlannedNode(
                    node_pool=pname, extra_labels=extra,
                    instance_type=lat.names[int(dec.chosen_t[b])],
                    zone=lat.zones[int(dec.chosen_z[b])],
                    capacity_type=lat.capacity_types[int(dec.chosen_c[b])],
                    price_per_hour=float(dec.chosen_price[b]),
                    feasible_types=ftypes, feasible_zones=fzones,
                    feasible_capacity_types=fcaps,
                )
                for _, pod_names in content:
                    node.pods.extend(pod_names)
                nodes.append(node)
            for gi, pool in spill_names.items():
                msg = unplaced_reason(problem.groups[gi])
                for name in pool:
                    unsched[name] = msg
            cost = float(sum(n.price_per_hour for n in nodes))
            return NodePlan(new_nodes=nodes, existing_assignments=assigns,
                            unschedulable=unsched, new_node_cost=cost,
                            solve_seconds=0.0, device_seconds=device_s)

        if not tail_names:
            return raw_plan()

        merged = self._merge_solve(problem, decs, kept, tail_names,
                                   existing_assignments, unschedulable,
                                   device_s, merge_ctx=merge_ctx)
        # the merge is a refinement: take it when it schedules at least as
        # many pods and does not raise cost; otherwise keep the raw packing.
        # The comparison reads the aggregates (raw_cost is the pack's float32
        # live-bin price sum, in the reference's summation order), so the
        # raw decode only materializes when it wins
        raw_unsched = len(unschedulable) + sum(len(v) for v in spill_names.values())
        if (len(merged.unschedulable) < raw_unsched
                or (len(merged.unschedulable) == raw_unsched
                    and merged.new_node_cost <= raw_cost + 1e-6)):
            return merged
        return raw_plan()

    def _merge_solve(self, problem: Problem, decs: List[_DecodeSet], kept,
                     tail_names, existing_assignments: Dict[str, List[str]],
                     unschedulable: Dict[str, str], device_s: float,
                     merge_ctx: Optional[Dict] = None):
        """Re-pack dissolved tail bins + spilled pods in one single-device
        refinement pack seeded with the existing bins (fixed) and the kept
        bins (open, re-priced at finalization).

        The merge-count group buffer AND the seeded bin table ride ONE
        upload (ops/binpack.py ``pack_packed_seeded``). ``merge_ctx`` is
        the microloop's retention seam: ``reuse`` (result bytes, B2) skips
        the device work on a fingerprint-unchanged pass (identical shard
        results give identical merge inputs and result; only the pod
        NAMES decode differently); ``ran``/``result`` hand the fresh
        result back for the next pass's reuse."""
        lat = self.lattice
        E = problem.E
        K = len(kept)
        G = _bucket(problem.G, _G_BUCKETS)
        A = max(problem.A, 1)

        merge_count = np.zeros((G,), np.int32)
        for gi, pool in tail_names.items():
            merge_count[gi] = len(pool)
        tail_total = int(merge_count.sum())
        # the bin budget honors per-bin caps (hostname spread and
        # anti-affinity can force one bin per pod)
        caps = np.minimum(problem.max_per_bin.astype(np.int64),
                          np.maximum(merge_count[: problem.G].astype(np.int64), 1))
        capped_bins = int(np.ceil(merge_count[: problem.G]
                                  / np.maximum(caps, 1)).sum())
        b_needed = E + K + min(tail_total, capped_bins + 64)
        B2 = _bucket(b_needed, _B_BUCKETS, clamp=True)

        reuse = merge_ctx.get("reuse") if merge_ctx else None
        if reuse is not None:
            buf, B2 = reuse
            mdec = _unpack_decode_set(buf, G, lat.T, lat.Z, lat.C, A,
                                      lean=True)
            merge_ctx["reused"] = True
        else:
            fused_np = self._fused_inputs_np(problem, G,
                                             count_override=merge_count)
            avail, price = self._device_avail_price(problem)
            k_tm, k_zm, k_cm = self._stacked_masks(
                decs, [(d, b) for d, b, _ in kept])
            while True:
                seed_np = self._merge_seed_np(problem, decs, kept, B2,
                                              k_tm, k_zm, k_cm)
                combined = np.concatenate([fused_np, seed_np])
                try:
                    comb_dev = self._upload(combined)
                    _count_scan(G, problem.G, G)
                    with trace.span("solver.pack_merge"):
                        clock = DeviceTimer(self.device)
                        out = binpack.pack_packed_seeded(
                            self._alloc, avail, price, comb_dev,
                            int(fused_np.size), B2, G, lat.T, lat.Z, lat.C,
                            max(problem.NP, 1), A, lean=True)
                        clock.stop()
                    buf = out.cpu().numpy()
                except (SolverError, KernelBuildError):
                    raise
                except RuntimeError as e:
                    raise SolverDeviceError(
                        f"{type(e).__name__}: {e}", cause=e) from e
                self._account_link("fetch", buf.nbytes)
                device_s += clock.seconds()
                mdec = _unpack_decode_set(buf, G, lat.T, lat.Z, lat.C, A,
                                          lean=True)
                overflowed = (mdec.leftover.sum() > 0) and mdec.next_open >= B2
                if overflowed:
                    B2, grew = _grow_bucket(B2)
                    if grew:
                        # the retry re-stages and re-fetches: 2 more legs,
                        # counted so the per-pass bound can excuse them
                        self.pipeline_stats["micro_merge_regrows"] += 1
                        continue
                break
            if merge_ctx is not None:
                merge_ctx["ran"] = True
                merge_ctx["result"] = (buf, B2)

        return self._merge_decode(problem, mdec, mdec.leftover, mdec.assign,
                                  kept, tail_names, existing_assignments,
                                  unschedulable, device_s)

    def _merge_seed_np(self, problem: Problem, decs: List[_DecodeSet],
                       kept, B2: int, k_tm: np.ndarray, k_zm: np.ndarray,
                       k_cm: np.ndarray) -> np.ndarray:
        """The merge's seeded bin table as ONE host uint8 buffer
        (ops/binpack.seed_layout): rows [0,E) are the existing bins at
        their post-pack shard-0 state (fixed), rows [E,E+K) the kept new
        bins from all shards (open, re-priced at finalization)."""
        lat = self.lattice
        E = problem.E
        K = len(kept)
        layout, total = binpack.seed_layout(B2, lat.T, lat.Z, lat.C, R,
                                            max(problem.A, 1))
        buf = np.zeros((total,), np.uint8)
        v: Dict[str, np.ndarray] = {}
        for f in layout:
            n = int(np.prod(f.shape)) * np.dtype(f.dtype).itemsize
            view = buf[f.offset: f.offset + n].view(f.dtype).reshape(f.shape)
            if f.fill != 0:
                view.fill(f.fill)
            v[f.name] = view
        if E:
            d0 = decs[0]
            e_rows = np.arange(E)
            v["s_cum"][:E] = d0.cum[:E]
            v["s_tmask"][:E] = d0.tmask(e_rows, lat.T)
            v["s_zmask"][:E] = d0.zmask(e_rows, lat.Z)
            v["s_cmask"][:E] = d0.cmask(e_rows, lat.C)
            v["s_np"][:E] = d0.np_id[:E]
            v["s_npods"][:E] = d0.npods[:E]
            v["s_open"][:E] = 1
            v["s_fixed"][:E] = 1
            v["s_alloc"][:E] = d0.alloc_cap[:E]
            v["s_pm"][:E] = d0.pm[:E]
            v["s_po"][:E] = d0.po[:E]
        for i, (d, b, _content) in enumerate(kept):
            r = E + i
            dec = decs[d]
            v["s_cum"][r] = dec.cum[b]
            v["s_tmask"][r] = k_tm[i]
            v["s_zmask"][r] = k_zm[i]
            v["s_cmask"][r] = k_cm[i]
            v["s_np"][r] = dec.np_id[b]
            v["s_npods"][r] = dec.npods[b]
            v["s_open"][r] = 1
            v["s_pm"][r] = dec.pm[b]
            v["s_po"][r] = dec.po[b]
        v["s_next"][0] = E + K
        return buf

    def _merge_decode(self, problem: Problem, mdec: _DecodeSet,
                      leftover2: np.ndarray, assign2: np.ndarray, kept,
                      tail_names, existing_assignments: Dict[str, List[str]],
                      unschedulable: Dict[str, str],
                      device_s: float) -> NodePlan:
        """Decode the merged table into the refinement NodePlan."""
        lat = self.lattice
        E = problem.E
        m_np_id = mdec.np_id
        m_ct = mdec.chosen_t
        m_cz = mdec.chosen_z
        m_cc = mdec.chosen_c
        m_cp = mdec.chosen_price
        m_open = mdec.open
        m_fixed = mdec.fixed

        assigns = {k: list(v) for k, v in existing_assignments.items()}
        unsched = dict(unschedulable)
        node_for_row: Dict[int, PlannedNode] = {}

        def node_at(row: int) -> PlannedNode:
            node = node_for_row.get(row)
            if node is None:
                # masks unpack per materialized node only: B2 can be
                # thousands of rows with a handful of live merge bins
                rows1 = np.array([row])
                ftypes, fzones, fcaps = self._feasible_sets(
                    problem, mdec.tmask(rows1, lat.T)[0],
                    mdec.zmask(rows1, lat.Z)[0], mdec.cmask(rows1, lat.C)[0])
                pname, extra = _pool_out(problem.node_pools[int(m_np_id[row])])
                node = PlannedNode(
                    node_pool=pname, extra_labels=extra,
                    instance_type=lat.names[int(m_ct[row])],
                    zone=lat.zones[int(m_cz[row])],
                    capacity_type=lat.capacity_types[int(m_cc[row])],
                    price_per_hour=float(m_cp[row]),
                    feasible_types=ftypes, feasible_zones=fzones,
                    feasible_capacity_types=fcaps,
                )
                node_for_row[row] = node
            return node

        # kept bins keep their original pods even if the merge adds none
        for i, (_d, _b, content) in enumerate(kept):
            node = node_at(E + i)
            for _gi, pod_names in content:
                node.pods.extend(pod_names)

        for gi in range(problem.G):
            pool = tail_names.get(gi, [])
            if not pool:
                continue
            cursor = 0
            for b in np.nonzero(assign2[gi])[0]:
                n = int(assign2[gi, b])
                pod_slice = pool[cursor: cursor + n]
                cursor += n
                if m_fixed[b]:
                    assigns.setdefault(problem.existing[b].name,
                                       []).extend(pod_slice)
                else:
                    node_at(int(b)).pods.extend(pod_slice)
            if int(leftover2[gi]):
                msg = unplaced_reason(problem.groups[gi])
                for name in pool[cursor: cursor + int(leftover2[gi])]:
                    unsched[name] = msg

        # any remaining open new bin that took merge pods (kept bins are
        # materialized above; the lean buffer has no npods, but merge-added
        # pods are exactly the assign2 columns)
        live_rows = np.nonzero(m_open & ~m_fixed
                               & (assign2[: problem.G].sum(axis=0) > 0))[0]
        for row in live_rows:
            node_at(int(row))
        new_nodes = [node_for_row[r] for r in sorted(node_for_row)
                     if node_for_row[r].pods]
        cost = float(sum(n.price_per_hour for n in new_nodes))
        return NodePlan(new_nodes=new_nodes, existing_assignments=assigns,
                        unschedulable=unsched, new_node_cost=cost,
                        solve_seconds=0.0, device_seconds=device_s)

    # ---- the steady-state delta solve and its microloop ----

    @_locked
    def solve_delta(self, problem: Problem, dirty_groups: Sequence[int] = (),
                    mesh=None, overlap=None) -> NodePlan:
        """The steady-state delta-solve entry point. The problem arrived
        via solver/incremental.py, so its fused input buffers differ from
        the previous pass's only in the dirty-group blocks: the
        device-resident reconcile MICROLOOP (:meth:`_solve_micro`) ships
        exactly those blocks as one in-place scatter, dispatches against
        the resident problem state, and fetches the plan back only when
        the on-device changed-plan fingerprint says it moved. A pass
        outside the microloop's envelope (a group axis past the group
        ceiling, a bin-table overflow), or one whose device work fails
        (an injected fault included), re-solves through the standard
        ladder on the same device (pipelined) and counts ``micro_aborts``;
        a failure first drops every retained device buffer. Forces the
        pipelined path for the call. Plans are identical to :meth:`solve`
        of the same problem.

        ``overlap`` (zero-arg callable) is the admission-bookkeeping seam:
        it runs inside the device compute window (between dispatch and the
        fingerprint sync), at most once per call; on the fallback it runs
        only after the fallback solve lands. ``mesh`` (None = the Solver's
        own) shards every pass as :meth:`solve` does."""
        mesh = self.mesh if mesh is None else self._check_mesh(mesh)
        with trace.span("solver.solve_delta", groups=problem.G,
                        dirty=len(dirty_groups)) as sp:
            pre_hits = self._resident.hits
            pre_legs = (self.link_stats["upload_legs"]
                        + self.link_stats["fetch_legs"])
            was_pipelined = self.pipeline
            self.pipeline = True
            overlap_once = [overlap] if overlap is not None else []

            def run_overlap():
                if overlap_once:
                    fn = overlap_once.pop()
                    fn()
                    self.pipeline_stats["overlapped_admission"] += 1

            try:
                try:
                    plan = self._solve_micro(problem, mesh=mesh,
                                             overlap=run_overlap)
                    self.pipeline_stats["micro_solves"] += 1
                except _MicroIneligible:
                    self.pipeline_stats["micro_aborts"] += 1
                    plan = self._solve_problem(problem, mesh=mesh)
                    # only after the fallback lands: a failing pass must not
                    # record admission bookkeeping for a dropped wave
                    run_overlap()
                except Exception:
                    # the retained device state may be half-written (the
                    # scatter is in place): rebuild from scratch rather than
                    # re-dispatch against it, and let the standard ladder
                    # own retry and fallback. Counted and logged, never
                    # silent
                    _LOG.warning("microloop pass failed; dropping the resident "
                                 "state and re-solving", exc_info=True)
                    self.pipeline_stats["micro_aborts"] += 1
                    self._invalidate_device_state()
                    plan = self._solve_problem(problem, mesh=mesh)
                    run_overlap()
            finally:
                self.pipeline = was_pipelined
            self.pipeline_stats["delta_solves"] += 1
            self.pipeline_stats["delta_dirty_groups"] += len(dirty_groups)
            self.pipeline_stats["micro_last_legs"] = (
                self.link_stats["upload_legs"]
                + self.link_stats["fetch_legs"] - pre_legs)
            if self._resident.hits > pre_hits:
                self.pipeline_stats["resident_problem_hits"] += 1
            else:
                self.pipeline_stats["resident_problem_misses"] += 1
            sp.set(path=plan.solver_path, degraded=plan.degraded,
                   resident_hit=self._resident.hits > pre_hits,
                   legs=self.pipeline_stats["micro_last_legs"])
            return plan

    def _solve_micro(self, problem: Problem, mesh=None,
                     overlap=None) -> NodePlan:
        """One steady-state reconcile pass against device-RESIDENT problem
        state.

        The whole fused problem (groups + pools and, when present, the
        existing-bin table) lives as ONE resident device buffer; the pass
        block-diffs against it and ships exactly the dirty blocks in one
        in-place scatter upload (leg 1). The pack dispatches against the
        updated resident state: on a mesh, against slices of it, with the
        per-shard count split derived on the device
        (parallel/sharded.py ``device_split_counts``), so no split bytes
        cross the link. Admission bookkeeping and decode prep run while it
        computes; the only mandatory sync is the O(1) changed-plan
        fingerprint, and the plan buffer is fetched (leg 2) only when it
        says the packing moved; an unchanged plan re-decodes the retained
        host bytes against the current pod names. A mesh pass whose plan
        moved pays two more legs for the tail-bin merge, which an
        unchanged pass reuses.

        Raises :class:`_MicroIneligible` outside the envelope (a group
        axis above the group ceiling, co-located or shard-0 pinned groups
        on a mesh, bin-table overflow), and ``SolverDeviceError`` when the
        device work fails."""
        t0 = time.perf_counter()
        if problem.G == 0:
            raise _MicroIneligible("empty")
        if problem.G > self._g_ceiling():
            raise _MicroIneligible("wave-scale G")
        lat = self.lattice
        D = int(mesh.devices.size) if mesh is not None else 1
        sharded = D > 1
        NP, A = max(problem.NP, 1), max(problem.A, 1)
        if sharded and (bool(problem.single_bin.any())
                        or (problem.A and bool(problem.g_need.any()))):
            # co-location and shard-0 pinning need the host split planner
            raise _MicroIneligible("pinned groups on mesh")
        stages = StageTimer()
        G = _bucket(problem.G, _G_BUCKETS)
        fresh = None
        if sharded:
            B = self._b_budget_sharded(problem, D)
        else:
            fresh, B = self._b_budget_single(problem, G)
        if problem.E > B:
            raise _MicroIneligible("existing bins past the bin-table ceiling")

        with stages.span("build"):
            fused_np = self._fused_inputs_np(problem, G)
            g_size = int(fused_np.size)
            combined_np = (np.concatenate(
                [fused_np, self._fused_init_np(problem, B)])
                if problem.E else fused_np)
        repl = None
        if sharded:
            from ..parallel.ranks import Resident
            from ..parallel.sharded import (device_split_counts,
                                            replicated_sharding,
                                            sharded_pack)
            repl = replicated_sharding(mesh)
        # the resident problem identity: shard count, group/bin buckets
        # and exact byte length — any drift is a cold re-upload, and the
        # retained fingerprint state keys on the same tuple
        key = ("m", D, G, B, int(combined_np.size))
        ms = self._micro
        if ms is not None and (
                ms.key != key
                or ms.lattice is not problem.lattice
                or ms.price_version != problem.lattice.price_version):
            # layout drift, a new (ICE-masked) lattice view, or a reprice:
            # the retained result was solved against other inputs
            ms = None
        compute_ms0 = stages.ms.get("compute", 0.0)
        sp_res = None
        try:
            with stages.span("upload"):
                comb_dev = self._resident.upload(key, combined_np,
                                                 sharding=repl, donate=True)
            self._maybe_inject_device_fault()
            _count_scan(G, problem.G, G if sharded else problem.G)
            if sharded:
                alloc_r, avail, price = self._mesh_inputs(problem, mesh)
                gslice = comb_dev[:g_size]
                islice = comb_dev[g_size:] if problem.E else None
                count_off = next(
                    f.offset for f in binpack.group_layout(
                        G, lat.T, lat.Z, lat.C, NP, A, R)[0]
                    if f.name == "count")
                ranks = self._mesh_ranks(mesh)
                resident = None
                if ranks is not None:
                    # the ranks keep their copy of the combined buffer
                    # and take only what this pass's upload changed
                    rkey, before, after, payload = self._resident.last_change
                    resident = Resident(
                        key=(self._serial,) + tuple(rkey), combined=comb_dev,
                        g_size=g_size, before=before, after=after,
                        payload=payload, block=self._resident.block)
                with trace.span("solver.pack_micro"), \
                        stages.span("compute"):
                    clock = DeviceTimer(self.device)
                    csplit = device_split_counts(gslice, D, count_off, G)
                    sp_res = sharded_pack(
                        mesh, alloc_r, avail, price, gslice, islice,
                        problem.E, csplit, B, G, lat.T, lat.Z, lat.C, NP, A,
                        resident=resident, ranks=ranks)
                    clock.stop()
                new_dev = sp_res.packed
            else:
                avail, price = self._device_avail_price(problem)
                with trace.span("solver.pack_micro"), \
                        stages.span("compute"):
                    clock = DeviceTimer(self.device)
                    if problem.E:
                        new_dev = binpack.pack_packed_combined(
                            self._alloc, avail, price, comb_dev, g_size,
                            problem.E, B, G, lat.T, lat.Z, lat.C, NP, A,
                            lean=True, n_groups=problem.G)
                    else:
                        new_dev = binpack.pack_packed_efused(
                            self._alloc, avail, price, comb_dev, None, 0, B,
                            G, lat.T, lat.Z, lat.C, NP, A, lean=True,
                            n_groups=problem.G)
                    clock.stop()
        except (SolverError, KernelBuildError):
            raise
        except RuntimeError as e:
            raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                    cause=e) from e
        # host work rides the in-flight dispatch: the caller's admission
        # bookkeeping and the plan-independent decode prep (the sharded
        # decode builds its own)
        if overlap is not None:
            overlap()
        prep = None if sharded else self._decode_prep(problem)
        try:
            with stages.span("download"):
                # the one mandatory sync: the O(1) changed-plan fingerprint
                changed = plan_changed(new_dev, ms.prev_dev if ms else None)
                self.pipeline_stats["micro_tiny_syncs"] += 1
                if changed:
                    buf = fetch_async(new_dev).wait()
                    self._account_link("fetch", buf.nbytes)
                    self.pipeline_stats["micro_fetches"] += 1
                else:
                    buf = ms.prev_host
                    self.pipeline_stats["micro_skipped_syncs"] += 1
                if changed and sharded:
                    # the merge comparison's summed raw cost: fetched once
                    # here (O(1)), reused by every skipped-sync pass
                    prev_cost = float(sp_res.total_cost)
                    self.pipeline_stats["micro_tiny_syncs"] += 1
        except RuntimeError as e:
            raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                    cause=e) from e
        device_s = clock.seconds()
        if ms is None:
            ms = _MicroState(key=key)
        self._micro = ms
        ms.lattice = problem.lattice
        ms.price_version = problem.lattice.price_version
        ms.prev_dev = new_dev
        if changed:
            ms.prev_host = buf
            ms.prev_merge = None
            if sharded:
                ms.prev_cost = prev_cost

        if sharded:
            plan = self._micro_decode_sharded(problem, ms, buf, changed,
                                              G, B, D, stages, device_s)
        else:
            with stages.span("decode"):
                dec = _unpack_decode_set(buf, G, lat.T, lat.Z, lat.C, A,
                                         lean=True)
            if (dec.leftover.sum() > 0) and dec.next_open >= B:
                # bin-table overflow: the standard solve owns growth
                self._micro = None
                raise _MicroIneligible("bin-table overflow")
            needed = _bucket(max(dec.next_open, problem.E + 1, 1),
                             _B_BUCKETS, clamp=True)
            self._b_hint[G] = (fresh, needed)
            with stages.span("decode"):
                plan = self._decode(problem, dec, device_s, prep=prep)
        plan.solve_seconds = time.perf_counter() - t0
        plan.warnings = list(problem.warnings)
        plan.stage_ms = stages.ms
        plan.pipelined = True
        plan.mesh_devices = D
        if sharded:
            plan.shard_imbalance = self._mesh_imbalance
            self.pipeline_stats["mesh_solves"] += 1
        costmodel.model().observe_solve(
            costmodel.shape_key(G, B, mesh_devices=D),
            stages.ms.get("compute", 0.0) - compute_ms0)
        self.pipeline_stats["async_solves"] += 1
        return plan

    def _micro_decode_sharded(self, problem: Problem, ms: _MicroState,
                              buf: np.ndarray, changed: bool, G: int,
                              B: int, D: int, stages: StageTimer,
                              device_s: float) -> NodePlan:
        """Mesh tail of the microloop: per-shard decode and the (possibly
        reused) merge refinement, equal to :meth:`_solve_sharded`'s."""
        from ..parallel.sharded import shard_groups, split_counts
        lat = self.lattice
        A = max(problem.A, 1)
        with stages.span("decode"):
            decs = _unpack_sharded(buf, G, lat.T, lat.Z, lat.C, A)
        leftover = np.stack([dec.leftover for dec in decs])
        next_open = np.array([dec.next_open for dec in decs])
        if bool(((leftover.sum(axis=1) > 0) & (next_open >= B)).any()):
            self._micro = None
            raise _MicroIneligible("sharded bin-table overflow")
        # the host mirror of the device-derived balanced split (the same
        # formula: the microloop left if pinning was in play), for pod-name
        # slicing and the imbalance gauge
        count_pad = np.zeros((G,), np.int32)
        count_pad[: problem.G] = problem.count
        count_split = split_counts(count_pad, D)
        load = shard_groups(count_split).astype(np.float64)
        self._mesh_imbalance = (float(load.max() / load.mean())
                                if load.mean() > 0 else 1.0)
        merge_ctx = {"reuse": None if changed else ms.prev_merge}
        with stages.span("decode"):
            plan = self._decode_sharded(problem, ms.prev_cost,
                                        decs, count_split, device_s,
                                        merge_ctx=merge_ctx)
        if merge_ctx.get("ran"):
            ms.prev_merge = merge_ctx["result"]
            self.pipeline_stats["micro_merge_solves"] += 1
        elif merge_ctx.get("reused"):
            self.pipeline_stats["micro_merge_skips"] += 1
        return plan

    # ---- warmup (the boot bucket ladder) ----

    # the shapes a production operator's first real passes hit: G=16..128
    # covers batches up to ~128 scheduling signatures (a 50k-pod wave of
    # 30 deployment shapes is G=31, bucket 32); B up to 2048 covers plans
    # up to ~2k nodes
    WARM_G_BUCKETS: Sequence[int] = (16, 32, 64)
    WARM_B_BUCKETS: Sequence[int] = (32, 128, 512)
    BOOT_G_BUCKETS: Sequence[int] = (16, 32, 64, 96, 128)
    BOOT_B_BUCKETS: Sequence[int] = (32, 128, 512, 1024, 2048)

    def warmup(self, node_pools_count: int = 1, affinity_classes: int = 1,
               g_buckets: Sequence[int] = WARM_G_BUCKETS,
               b_buckets: Sequence[int] = WARM_B_BUCKETS,
               probes: bool = False,
               background: bool = False,
               aot: bool = False,
               on_done=None):
        """Run the solve's device path once for each warm (G, B) bucket.

        Nothing is compiled at run time here, but a process's first solve
        still pays a cold cost on the card: the first launch of each torch
        kernel the scan uses (CUDA loads a kernel's module at its first
        use), the caching allocator's first pools of each size, the pinned
        host buffers of the result fetch, the cheapest-offering kernel's
        library load. Each (G, B) bucket,
        without and with an existing-bin buffer, goes once through
        ``pack_packed_efused`` (which launches the kernel) from zero-filled
        fused buffers, and its result comes back through ``fetch_async``;
        with ``probes``, ``pack_probe_fused`` runs too at the first two
        probe buckets K. ``node_pools_count`` and ``affinity_classes`` size
        the pool and affinity axes of the buffers, as a real problem's.

        ``aot=True`` (the CLI passes it with a compile cache directory,
        ``enable_persistent_compile_cache``) first builds every kernel
        source into the build directory (the CUDA libraries on the card,
        the native referee everywhere), so the first real solve loads them,
        and records each shape's analysis in the device cost model
        (solver/costmodel.py; ``binpack.pack_analysis``), taking its peak
        on the card from the allocator over the shape's run. The shapes
        still execute: a torch pack has no ahead-of-time form to load.

        Each shape runs under the solve lock, so a real solve that arrives
        mid-warmup waits for the shape in flight. ``background=True`` runs
        the ladder on a daemon thread named ``solver-warmup`` and returns
        it, started. ``on_done`` (no arguments) fires once when the ladder
        ends, whether it succeeded or not; the Operator uses it to close
        the SLO warmup window (introspect/slo.py), and a callback that
        raises does not kill the thread.
        """
        if background:
            t = threading.Thread(
                target=self.warmup, name="solver-warmup", daemon=True,
                kwargs=dict(node_pools_count=node_pools_count,
                            affinity_classes=affinity_classes,
                            g_buckets=g_buckets, b_buckets=b_buckets,
                            probes=probes, aot=aot, on_done=on_done))
            t.start()
            return t
        try:
            lat = self.lattice
            NP = max(node_pools_count, 1)
            A = max(affinity_classes, 1)
            dev = self.device

            on_card = dev.type == "cuda"
            if aot:
                self.build_kernels()

            def run_shape(pack) -> int:
                """Runs ``pack``; returns the bytes it allocated at its
                peak on the card (0 elsewhere)."""
                with self._solve_lock:
                    ctx = (torch.cuda.device(dev) if on_card
                           else contextlib.nullcontext())
                    with ctx:
                        if on_card:
                            base = torch.cuda.memory_allocated(dev)
                            torch.cuda.reset_peak_memory_stats(dev)
                        fetch_async(pack()).wait()
                        if on_card:
                            return torch.cuda.max_memory_allocated(dev) - base
                return 0

            for G in g_buckets:
                _, g_total = binpack.group_layout(G, lat.T, lat.Z, lat.C,
                                                  NP, A, R)
                gbuf = torch.zeros((g_total,), dtype=torch.uint8, device=dev)
                for B in b_buckets:
                    _, i_total = binpack.init_layout(B, R, A)
                    ibuf = torch.zeros((i_total,), dtype=torch.uint8,
                                       device=dev)
                    peaks = [run_shape(lambda init=init, B=B:
                                       binpack.pack_packed_efused(
                                           self._alloc, self._avail,
                                           self._price, gbuf, init, 0, B,
                                           G, lat.T, lat.Z, lat.C, NP, A,
                                           lean=True))
                             for init in (None, ibuf)]
                    an = self._analysis(G, B, NP, A) if aot else None
                    if an is not None:
                        if on_card:
                            # the card's own peak: what the run without
                            # existing bins allocated (its result among
                            # it), beside its resident arguments
                            an = an._replace(temp_size_in_bytes=max(
                                peaks[0] - an.output_size_in_bytes, 0))
                        costmodel.model().record_compiled(
                            costmodel.shape_key(G, B), an)
                    if probes:
                        for K in self._K_BUCKETS[:2]:
                            run_shape(lambda K=K, B=B:
                                      binpack.pack_probe_fused(
                                          self._alloc, self._avail,
                                          self._price,
                                          gbuf.expand(K, -1).contiguous(),
                                          ibuf.expand(K, -1).contiguous(),
                                          torch.zeros((K,), dtype=torch.int32,
                                                      device=dev),
                                          B, G, lat.T, lat.Z, lat.C, NP, A))
        finally:
            if on_done is not None:
                try:
                    on_done()
                except Exception:   # noqa: BLE001
                    pass   # a callback bug must not kill the warmup thread
        return None

    def build_kernels(self) -> None:
        """Build every kernel source this Solver loads into the build
        directory (``enable_persistent_compile_cache`` moves it): the CUDA
        libraries on the card (``KernelBuildError`` where one does not
        build) and the native referee (absent without g++). A library
        this process already loaded from elsewhere is built there too."""
        import subprocess
        from ..native import build as native_build
        if self.device.type == "cuda":
            from ..ops import cuda_build
            for name in cuda_build.sources():
                cuda_build.build(name)
        try:
            native_build.build()
        except (OSError, subprocess.SubprocessError):
            pass   # no g++: the referee's callers use the Python oracle

    def _analysis(self, G: int, B: int, NP: int, A: int):
        """``binpack.pack_analysis`` at this lattice and shape, or None
        where the trace fails (the shape then has no model)."""
        lat = self.lattice
        try:
            return binpack.pack_analysis(G, B, lat.T, lat.Z, lat.C, NP, A,
                                         self._alloc.shape[1], lean=True)
        except Exception:   # noqa: BLE001
            # a shape that cannot be traced has no model; capture and the
            # ladder go on with the next
            _LOG.warning("no analysis of G%d_B%d", G, B, exc_info=True)
            return None

    def capture_cost_model(self, node_pools_count: int = 1,
                           affinity_classes: int = 1,
                           g_buckets: Sequence[int] = WARM_G_BUCKETS,
                           b_buckets: Sequence[int] = WARM_B_BUCKETS) -> int:
        """Fill the device cost model (solver/costmodel.py) for the given
        bucket ladder from each shape's analysis (``binpack.pack_analysis``:
        a trace on the meta device; no kernel launches and nothing runs on
        the card or the host). It reads only the lattice's shapes, so it
        takes no solve lock and runs beside the boot ladder. Returns the
        shapes captured."""
        NP = max(node_pools_count, 1)
        A = max(affinity_classes, 1)
        captured = 0
        for G in g_buckets:
            for B in b_buckets:
                an = self._analysis(G, B, NP, A)
                if an is not None and costmodel.model().record_compiled(
                        costmodel.shape_key(G, B), an):
                    captured += 1
        return captured

    # ---- profiling ----

    def start_profiling(self, log_dir: str) -> None:
        """Open a ``torch.profiler`` session (CPU activity, and CUDA's on
        the card); every trace span is then a range beside the kernels it
        launched, the device pack calls among them (``solver.pack``,
        ``solver.pack_micro``, ``solver.pack_probe``,
        ``solver.pack_sharded``, ``solver.pack_merge``) and each step of
        the scan (``pack.step``). :meth:`stop_profiling` writes the trace
        under ``log_dir``."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        self._profile_dir = log_dir
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def stop_profiling(self) -> Optional[str]:
        """Close the session and write its Chrome trace where the
        reference's profiler puts a run, ``<log_dir>/plugins/profile/<run>/``
        (``<run>`` the stop time); returns the file's path (None when no
        session was open)."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        prof.stop()
        run = os.path.join(self._profile_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S")
                           + f"_{time.time_ns() % 10 ** 9:09d}")
        os.makedirs(run, exist_ok=True)
        path = os.path.join(run, f"solver-{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path

    # ---- batched what-if probes ----

    _K_BUCKETS = (4, 8, 16, 32)
    # each probe's fused rows are padded to a multiple of this many bytes,
    # so the [K,·] stack unpacks in place (4-byte fields stay aligned)
    _PROBE_ROW_ALIGN = 16

    def _probe_stack(self, rows: Sequence[np.ndarray]) -> torch.Tensor:
        """Equal-length rows as ONE [K,·] uint8 upload, each padded to a
        multiple of ``_PROBE_ROW_ALIGN`` bytes."""
        n = rows[0].size
        width = -(-n // self._PROBE_ROW_ALIGN) * self._PROBE_ROW_ALIGN
        buf = np.zeros((len(rows), width), np.uint8)
        for k, r in enumerate(rows):
            buf[k, :n] = r
        return torch.from_numpy(buf).to(self.device)

    @_locked
    def probe_batch(self, problems: Sequence[Problem]) -> List[ProbeResult]:
        """K consolidation what-ifs in ONE batched device pass.

        Every problem is padded to a shared (K, G, B) bucket, stacked along
        a leading probe axis, and handed to the batched pack
        (ops/binpack.pack_probe_fused): one [K,·] group upload, one [K,·]
        existing-bin upload, one cheapest-offering launch over the K·B
        bins, and one [K,6] result back. The disruption controller's
        prefix ladder + single-node scan ride this; the chosen probe is
        then re-solved exactly once for its real NodePlan. A device error
        raises ``SolverDeviceError``; nothing falls back. ``last_probe``
        keeps the last dispatch's buckets and raw [K,6] summary."""
        if not problems:
            raise ValueError("probe_batch needs at least one problem")
        if any(p.lattice is not problems[0].lattice for p in problems):
            raise ValueError("a probe batch must share one lattice view")
        K = len(problems)
        if K > self._K_BUCKETS[-1]:
            raise ValueError(f"probe batch {K} exceeds {self._K_BUCKETS[-1]}")
        lat = self.lattice
        real_g = max(p.G for p in problems)
        G = _bucket(real_g, _G_BUCKETS)
        A = max(max((p.A for p in problems), default=0), 1)
        NP = max(max((p.NP for p in problems), default=0), 1)
        b_needed = max(p.E + min(int(p.count.sum()),
                                 self._estimate_bins(p) + 64)
                       for p in problems)
        B = _bucket(max(b_needed, max(p.E for p in problems) + 1),
                    _B_BUCKETS, clamp=True)
        # pad K with repeats of problem 0 so the batch shapes stay bucketed
        Kp = _bucket(K, self._K_BUCKETS, clamp=True)
        idx = list(range(K)) + [0] * (Kp - K)
        with trace.span("solver.pack_probe", probes=K, groups=G) as sp:
            # the host's staging (each probe's fused rows, their [K,·]
            # stacks and uploads) and its wait for the [K,6] summary
            with trace.span("probe.stage"):
                gbuf_np = [self._fused_inputs_np(problems[i], G, A, NP)
                           for i in idx]
            try:
                with trace.span("probe.stage"):
                    avail, price = self._device_avail_price(problems[0])
                    gbufs = self._probe_stack(gbuf_np)
                    n_existing = torch.from_numpy(np.array(
                        [problems[i].E for i in idx],
                        np.int32)).to(self.device)
                while True:
                    with trace.span("probe.stage"):
                        ibufs = (self._probe_stack(
                            [self._fused_init_np(problems[i], B, A)
                             for i in idx])
                            if any(p.E for p in problems) else None)
                    _count_scan(G, real_g, real_g)
                    clock = DeviceTimer(self.device)
                    out = binpack.pack_probe_fused(
                        self._alloc, avail, price, gbufs, ibufs, n_existing,
                        B, G, lat.T, lat.Z, lat.C, NP, A, n_groups=real_g)
                    clock.stop()
                    with trace.span("probe.wait"):
                        summ = binpack.ProbeSummary(*out.cpu().numpy().T)
                    device_s = clock.seconds()
                    if bool((summ.overflow[:K] > 0).any()):
                        B, grew = _grow_bucket(B)
                        if grew:
                            continue
                    break
            except KernelBuildError:
                raise
            except RuntimeError as e:
                # kernel launch failure, device OOM, transfer failure
                raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                        cause=e) from e
            sp.set(bins=B, padded=Kp)
        self.last_probe = {"K": K, "padded": Kp, "G": G, "B": B,
                           "summary": np.stack(summ, axis=1)[:K]}
        out: List[ProbeResult] = []
        for k in range(K):
            nn = int(summ.n_new[k])
            cc = int(summ.cap_c[k])
            out.append(ProbeResult(
                feasible=(int(summ.leftover[k]) == 0
                          and not bool(summ.overflow[k])
                          and not problems[k].unschedulable),
                n_new=nn,
                new_cost=float(summ.new_cost[k]),
                new_cap_type=(lat.capacity_types[cc]
                              if nn > 0 and 0 <= cc < lat.C else None),
                flex=int(summ.flex[k]),
                device_seconds=device_s))
        return out
