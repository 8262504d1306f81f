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

``solve_relaxed``, ``solve`` and ``solve_delta`` open the JAX package's
trace spans (``solver.solve_relaxed``, ``solver.solve``,
``solver.solve_delta``, and a ``stage.*`` span per stage timer), and a
problem built with ``explain=True`` carries its constraint-elimination
ledgers into the unplaced reasons.

``probe_batch`` answers K consolidation what-ifs in one batched device
pass (ops/binpack.py ``pack_probe_fused``) on the Solver's own device,
with no fallback: a device error raises ``SolverDeviceError``.

What the JAX package does beyond these paths raises
``NotImplementedError`` when reached, and nothing falls back to anything:
the degradation ladder's host-FFD rung (a device error surfaces as
``SolverDeviceError``), the wave split of a group axis above the largest
bucket, and the sharded mesh solve and its microloop tail. Absent without
raising: fault injection and the device cost model.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..apis.resources import R
from ..device import DeviceLike, resolve_device
from ..errors import SolverCapacityError, SolverDeviceError, SolverError
from ..lattice.tensors import Lattice
from ..ops import binpack
from . import taxonomy
from .explain import unplaced_reason
from .pipeline import (ResidentInputCache, StageTimer, fetch_async,
                       plan_changed)
from .problem import Problem

_LOG = logging.getLogger(__name__)

_G_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 512, 1024, 4096)
_B_BUCKETS = (32, 128, 512, 1024, 2048, 8192)


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
    # degradation-ladder provenance, kept field for field with the JAX
    # package's NodePlan so both serialize alike; this path always
    # reports the primary rung
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
    it into a buffer of its own."""

    key: Tuple
    prev_dev: Optional[torch.Tensor] = None
    prev_host: Optional[np.ndarray] = None
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


def _locked(fn):
    """Serialize a Solver entry point on the instance's solve lock
    (re-entrant: solve_relaxed → solve nests fine)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._solve_lock:
            return fn(self, *args, **kwargs)
    return wrapper


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch solver; only the "
        f"single-device solve is")


class Solver:
    """Holds the lattice resident on one device; solves padded problems.

    ``device`` None means ``cuda`` and raises when CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch path on the CPU. ``pipeline``
    picks the overlapped path (default) or the strictly sequential one.
    Thread-safe: every public solve entry point serializes on an internal
    RLock."""

    # the steady-state delta path (IncrementalProblemBuilder +
    # solve_delta) runs in this process, on this Solver's device
    supports_delta = True

    def __init__(self, lattice: Lattice, device: DeviceLike = None,
                 pipeline: bool = True):
        self.device = resolve_device(device)
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
        self._solve_lock = threading.RLock()
        # per group-bucket: (fresh-estimate bucket, bucket actually needed)
        # of the last solve; a same-or-larger fresh estimate starts at the
        # size that worked (each overflow retry costs a full device pass)
        self._b_hint: Dict[int, Tuple[int, int]] = {}
        # content-keyed memo of _estimate_bins' per-group fit caps
        self._est_cache: Dict[bytes, np.ndarray] = {}
        # the overlapped solve path: resident input deltas, the result
        # copy started at dispatch, decode prep while the card computes.
        # Off = the strictly sequential path
        self.pipeline = pipeline
        self._resident = ResidentInputCache(device=dev)
        # proof that the overlap and the microloop engaged; the keys are
        # the JAX package's, so both report alike (the mesh and merge
        # counters stay 0 here: the mesh is not ported)
        self.pipeline_stats: Dict[str, int] = {
            "async_solves": 0,       # device solves that dispatched async
            "prefetched_waves": 0,   # wave inputs uploaded during compute
            # the steady-state delta path: passes it carried, group rows
            # it re-tensorized, and whether the resident entry was warm
            "delta_solves": 0,
            "delta_dirty_groups": 0,
            "resident_problem_hits": 0,
            "resident_problem_misses": 0,
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
        # device-state invalidation
        self._micro: Optional[_MicroState] = None
        # the last probe_batch dispatch: its buckets and raw [K,6] summary
        self.last_probe: Optional[Dict[str, object]] = None

    def set_pipeline(self, enabled: bool) -> None:
        """Toggle the overlapped solve path (thread-safe)."""
        with self._solve_lock:
            self.pipeline = bool(enabled)

    def _account_link(self, direction: str, nbytes: int) -> None:
        """One host↔device transfer crossed the link (see link_stats)."""
        self.link_stats[direction + "_legs"] += 1
        self.link_stats[direction + "_bytes"] += int(nbytes)

    def _invalidate_device_state(self) -> None:
        """Drop every retained device buffer: the resident input entries
        and the microloop's retained result. One helper so no recovery
        path can forget a layer."""
        self._resident.invalidate()
        self._micro = None

    def stats(self) -> Dict[str, object]:
        """Introspection snapshot (counter reads only; never takes the
        solve lock, so it never queues behind an in-flight solve)."""
        out: Dict[str, object] = {
            "pipeline": bool(self.pipeline),
            "est_cache_entries": len(self._est_cache),
            "b_hint_entries": len(self._b_hint),
            "micro_engaged": self._micro is not None,
        }
        for k, v in self.pipeline_stats.items():
            out[k] = v
        for k, v in self.link_stats.items():
            out["link_" + k] = v
        for k, v in self._resident.stats().items():
            out["resident_" + k] = v
        return out

    _EST_CACHE_MAX = 128

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

        if mesh is not None:
            raise _not_ported("the sharded mesh solve")
        lattice = lattice if lattice is not None else self.lattice
        depth = {p.name: relaxation_depth(p) for p in pods}
        relax: Dict[str, int] = {}
        # every round increments at least one pod's level, so sum-of-depths
        # bounds termination; capped to keep a pathological wave sane
        max_rounds = min(1 + sum(depth.values()), 64)
        best = None
        total_solve = total_device = 0.0
        stage_total: Dict[str, float] = {}
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
            plan = self.solve(problem)
            total_solve += plan.solve_seconds
            total_device += plan.device_seconds
            for k, v in plan.stage_ms.items():
                stage_total[k] = stage_total.get(k, 0.0) + v
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
        best.stage_ms = stage_total
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
        """Solve one built problem into a NodePlan on this Solver's device.

        Raises ``SolverDeviceError`` when the device call fails and
        ``NotImplementedError`` where the JAX package would leave the
        primary path (wave split, host-FFD rung, mesh)."""
        t0 = time.perf_counter()
        if mesh is not None:
            raise _not_ported("the sharded mesh solve")
        if problem.G == 0:
            return NodePlan([], {}, dict(problem.unschedulable), 0.0,
                            time.perf_counter() - t0, 0.0)
        if problem.G > _G_BUCKETS[-1]:
            raise _not_ported(
                f"the wave split of {problem.G} groups (above the largest "
                f"group bucket {_G_BUCKETS[-1]})")
        try:
            return self._solve_device(problem, t0)
        except SolverCapacityError as e:
            raise _not_ported(
                f"the host-FFD rung of the degradation ladder (reached: {e})"
            ) from e

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
        return fresh, min(B, _B_BUCKETS[-1])

    def _stage_upload(self, key: Tuple, buf: np.ndarray,
                      pipelined: bool) -> torch.Tensor:
        """One fused upload: through the resident cache on the pipelined
        path, whole and synchronised on the sequential one."""
        if pipelined:
            return self._resident.upload(key, buf)
        dev = self._upload(buf)
        self._sync()
        return dev

    def _solve_device(self, problem: Problem,
                      t0: Optional[float] = None) -> NodePlan:
        """The primary path: one bucketed device pack. Raises
        SolverCapacityError when the bin table cannot grow past its top
        bucket and SolverDeviceError when the device call fails.

        The pipelined variant (``self.pipeline``) overlaps host work with
        the in-flight pack: the group and init buffers ride the resident
        cache, nothing synchronises between dispatch and fetch, the result
        copy starts right after dispatch (solver/pipeline.py
        ``fetch_async``) and decode prep fills the wait. So its
        ``compute`` stage is the host's issue time and ``download`` holds
        the wait for the card; the sequential variant synchronises after
        each stage, so there ``compute`` is the device time."""
        t0 = time.perf_counter() if t0 is None else t0
        pipelined = self.pipeline
        stages = StageTimer()
        G = _bucket(problem.G, _G_BUCKETS)
        fresh, B = self._b_budget_single(problem, G)
        lat = self.lattice
        NP, A = max(problem.NP, 1), max(problem.A, 1)

        with stages.span("build"):
            fused_np = self._fused_inputs_np(problem, G)
        # the group buffer is uploaded once across overflow regrows and
        # the (small) existing-bin buffer once per dispatch, except on the
        # sequential path with existing bins, where groups + bins ride one
        # combined upload per dispatch (the bin table grows with B)
        use_efused = pipelined or problem.E == 0
        gbuf = None
        avail, price = self._device_avail_price(problem)
        prep = None
        while True:
            td = time.perf_counter()
            try:
                if use_efused:
                    if gbuf is None:
                        with stages.span("upload"):
                            # ("g", G, size): the whole-problem resident
                            # entry a steady-state solve delta-refreshes
                            gbuf = self._stage_upload(
                                ("g", G, fused_np.size), fused_np, pipelined)
                    init_dev = None
                    if problem.E:
                        with stages.span("build"):
                            init_np = self._fused_init_np(problem, B)
                        with stages.span("upload"):
                            init_dev = self._stage_upload(
                                ("i", B, init_np.size), init_np, pipelined)
                    with stages.span("compute"):
                        dev_buf = binpack.pack_packed_efused(
                            self._alloc, avail, price, gbuf, init_dev,
                            problem.E, B, G, lat.T, lat.Z, lat.C, NP, A,
                            lean=True)
                        if not pipelined:
                            self._sync()
                else:
                    with stages.span("build"):
                        init_np = self._fused_init_np(problem, B)
                        combined_np = np.concatenate([fused_np, init_np])
                    with stages.span("upload"):
                        combined = self._upload(combined_np)
                        self._sync()
                    with stages.span("compute"):
                        dev_buf = binpack.pack_packed_combined(
                            self._alloc, avail, price, combined,
                            len(fused_np), problem.E, B,
                            G, lat.T, lat.Z, lat.C, NP, A, lean=True)
                        self._sync()
                # start streaming the result the moment the pack finishes;
                # the host fills the wait below
                pending = fetch_async(dev_buf) if pipelined else None
            except SolverError:
                raise
            except RuntimeError as e:
                # kernel launch failure, device OOM, transfer failure
                raise SolverDeviceError(
                    f"{type(e).__name__}: {e}", cause=e) from e
            # host work outside the device-error wrap: a bug here must not
            # pass for a device fault
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
            device_s = time.perf_counter() - td
            with stages.span("decode"):
                dec = _unpack_decode_set(buf, G, lat.T, lat.Z, lat.C, A,
                                         lean=True)
            overflowed = (dec.leftover.sum() > 0) and dec.next_open >= B
            if overflowed:
                nb, grew = _grow_bucket(B)
                if grew:
                    B = nb
                    continue
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
        if pipelined:
            # once per completed solve, not per overflow-regrow dispatch
            self.pipeline_stats["async_solves"] += 1
        return plan

    # ---- host-FFD solve (on request only) ----

    def solve_host_ffd(self, problem: Problem) -> NodePlan:
        """Pure-host sequential FFD (solver/oracle.py) decoded into a
        NodePlan. Runs only when a caller asks for it: no solve falls back
        to it."""
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
        outside the microloop's envelope, or one whose device work fails,
        re-solves through :meth:`solve` on the same device (pipelined)
        and counts ``micro_aborts``; a failure first drops every retained
        device buffer. Forces the pipelined path for the call. Plans are
        identical to :meth:`solve` of the same problem.

        ``overlap`` (zero-arg callable) is the admission-bookkeeping seam:
        it runs inside the device compute window (between dispatch and the
        fingerprint sync), at most once per call; on the fallback it runs
        only after the fallback solve lands."""
        if mesh is not None:
            raise _not_ported("the sharded mesh solve")
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
                    plan = self._solve_micro(problem, overlap=run_overlap)
                    self.pipeline_stats["micro_solves"] += 1
                except _MicroIneligible:
                    self.pipeline_stats["micro_aborts"] += 1
                    plan = self._solve_problem(problem)
                    # only after the fallback lands: a failing pass must not
                    # record admission bookkeeping for a dropped wave
                    run_overlap()
                except Exception:
                    # the retained device state may be half-written (the
                    # scatter is in place): rebuild from scratch rather than
                    # re-dispatch against it; the standard solve raises if
                    # the device fails again. Counted and logged, never silent
                    _LOG.warning("microloop pass failed; dropping the resident "
                                 "state and re-solving", exc_info=True)
                    self.pipeline_stats["micro_aborts"] += 1
                    self._invalidate_device_state()
                    plan = self._solve_problem(problem)
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

    def _solve_micro(self, problem: Problem, overlap=None) -> NodePlan:
        """One steady-state reconcile pass against device-RESIDENT problem
        state.

        The whole fused problem (groups + pools and, when present, the
        existing-bin table) lives as ONE resident device buffer; the pass
        block-diffs against it and ships exactly the dirty blocks in one
        in-place scatter upload (leg 1). The pack dispatches against the
        updated resident state; admission bookkeeping and decode prep run
        while it computes; the only mandatory sync is the O(1) changed-plan
        fingerprint, and the plan buffer is fetched (leg 2) only when it
        says the packing moved — an unchanged plan re-decodes the retained
        host bytes against the current pod names.

        Raises :class:`_MicroIneligible` outside the envelope (a group
        axis above the largest bucket, bin-table overflow)."""
        t0 = time.perf_counter()
        if problem.G == 0:
            raise _MicroIneligible("empty")
        if problem.G > _G_BUCKETS[-1]:
            raise _MicroIneligible("wave-scale G")
        lat = self.lattice
        NP, A = max(problem.NP, 1), max(problem.A, 1)
        stages = StageTimer()
        G = _bucket(problem.G, _G_BUCKETS)
        fresh, B = self._b_budget_single(problem, G)

        with stages.span("build"):
            fused_np = self._fused_inputs_np(problem, G)
            g_size = int(fused_np.size)
            combined_np = (np.concatenate(
                [fused_np, self._fused_init_np(problem, B)])
                if problem.E else fused_np)
        # the resident problem identity: device count, group/bin buckets
        # and exact byte length — any drift is a cold re-upload, and the
        # retained fingerprint state keys on the same tuple
        key = ("m", 1, G, B, int(combined_np.size))
        ms = self._micro
        if ms is not None and (
                ms.key != key
                or ms.lattice is not problem.lattice
                or ms.price_version != problem.lattice.price_version):
            # layout drift, a new (ICE-masked) lattice view, or a reprice:
            # the retained result was solved against other inputs
            ms = None
        try:
            with stages.span("upload"):
                comb_dev = self._resident.upload(key, combined_np,
                                                 donate=True)
            td = time.perf_counter()
            avail, price = self._device_avail_price(problem)
            with stages.span("compute"):
                if problem.E:
                    new_dev = binpack.pack_packed_combined(
                        self._alloc, avail, price, comb_dev, g_size,
                        problem.E, B, G, lat.T, lat.Z, lat.C, NP, A,
                        lean=True)
                else:
                    new_dev = binpack.pack_packed_efused(
                        self._alloc, avail, price, comb_dev, None, 0, B,
                        G, lat.T, lat.Z, lat.C, NP, A, lean=True)
        except SolverError:
            raise
        except RuntimeError as e:
            raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                    cause=e) from e
        # host work rides the in-flight dispatch: the caller's admission
        # bookkeeping and the plan-independent decode prep
        if overlap is not None:
            overlap()
        prep = self._decode_prep(problem)
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
        except RuntimeError as e:
            raise SolverDeviceError(f"{type(e).__name__}: {e}",
                                    cause=e) from e
        device_s = time.perf_counter() - td
        if ms is None:
            ms = _MicroState(key=key)
        self._micro = ms
        ms.lattice = problem.lattice
        ms.price_version = problem.lattice.price_version
        ms.prev_dev = new_dev
        if changed:
            ms.prev_host = buf

        with stages.span("decode"):
            dec = _unpack_decode_set(buf, G, lat.T, lat.Z, lat.C, A,
                                     lean=True)
        if (dec.leftover.sum() > 0) and dec.next_open >= B:
            # bin-table overflow: the standard solve owns growth
            self._micro = None
            raise _MicroIneligible("bin-table overflow")
        needed = _bucket(max(dec.next_open, problem.E + 1, 1), _B_BUCKETS,
                         clamp=True)
        self._b_hint[G] = (fresh, needed)
        with stages.span("decode"):
            plan = self._decode(problem, dec, device_s, prep=prep)
        plan.solve_seconds = time.perf_counter() - t0
        plan.warnings = list(problem.warnings)
        plan.stage_ms = stages.ms
        plan.pipelined = True
        self.pipeline_stats["async_solves"] += 1
        return plan

    # ---- batched what-if probes ----

    _K_BUCKETS = (4, 8, 16, 32)
    # each probe's fused rows are padded to a multiple of this many bytes,
    # so the [K,·] stack unpacks in place (4-byte fields stay aligned)
    _PROBE_ROW_ALIGN = 16

    def _g_ceiling(self) -> int:
        """Effective group-axis ceiling: the largest group bucket."""
        return _G_BUCKETS[-1]

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
        G = _bucket(max(p.G for p in problems), _G_BUCKETS)
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
        gbuf_np = [self._fused_inputs_np(problems[i], G, A, NP) for i in idx]
        with trace.span("solver.pack_probe", probes=K, groups=G) as sp:
            try:
                avail, price = self._device_avail_price(problems[0])
                gbufs = self._probe_stack(gbuf_np)
                n_existing = torch.from_numpy(np.array(
                    [problems[i].E for i in idx], np.int32)).to(self.device)
                while True:
                    ibufs = (self._probe_stack(
                        [self._fused_init_np(problems[i], B, A) for i in idx])
                        if any(p.E for p in problems) else None)
                    td = time.perf_counter()
                    summ = binpack.ProbeSummary(*binpack.pack_probe_fused(
                        self._alloc, avail, price, gbufs, ibufs, n_existing,
                        B, G, lat.T, lat.Z, lat.C, NP, A).cpu().numpy().T)
                    device_s = time.perf_counter() - td
                    if bool((summ.overflow[:K] > 0).any()):
                        B, grew = _grow_bucket(B)
                        if grew:
                            continue
                    break
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
