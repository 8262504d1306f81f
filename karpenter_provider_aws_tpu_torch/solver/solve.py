"""Host-facing Solve() API, single device, sequential path.

The port of the JAX package's ``solver/solve.py`` for one device: shape
bucketing and padding, one fused uint8 upload, the grouped-FFD pack
(ops/binpack.py) with its cheapest-offering kernel, one fused result
buffer back, the bin-table overflow regrow, and the NodePlan decode. The
decoded plan equals the JAX package's, field for field.

What the JAX package does beyond this path raises ``NotImplementedError``
when reached, and nothing falls back to anything: the degradation ladder's
host-FFD rung (a device error surfaces as ``SolverDeviceError``), the wave
split of a group axis above the largest bucket, the pipelined path and the
delta solve, batched what-if probes, the sharded mesh solve, tracing
spans and explain builds.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..apis.resources import R
from ..device import DeviceLike, resolve_device
from ..errors import SolverCapacityError, SolverDeviceError, SolverError
from ..lattice.tensors import Lattice
from ..ops import binpack
from . import taxonomy
from .explain import unplaced_reason
from .pipeline import StageTimer
from .problem import Problem

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
        f"single-device sequential solve is")


class Solver:
    """Holds the lattice resident on one device; solves padded problems.

    ``device`` None means ``cuda`` and raises when CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch path on the CPU. Thread-safe:
    every public solve entry point serializes on an internal RLock."""

    def __init__(self, lattice: Lattice, device: DeviceLike = None,
                 pipeline: bool = False):
        if pipeline:
            raise _not_ported("the pipelined solve path (pipeline=True)")
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
        # host↔device transfers: a LEG is a fused upload or a result fetch
        self.link_stats: Dict[str, int] = {
            "upload_legs": 0, "upload_bytes": 0,
            "fetch_legs": 0, "fetch_bytes": 0,
        }

    def _account_link(self, direction: str, nbytes: int) -> None:
        self.link_stats[direction + "_legs"] += 1
        self.link_stats[direction + "_bytes"] += int(nbytes)

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

    def _solve_device(self, problem: Problem,
                      t0: Optional[float] = None) -> NodePlan:
        """The primary path: one bucketed device pack. Raises
        SolverCapacityError when the bin table cannot grow past its top
        bucket and SolverDeviceError when the device call fails."""
        t0 = time.perf_counter() if t0 is None else t0
        stages = StageTimer()
        G = _bucket(problem.G, _G_BUCKETS)
        fresh, B = self._b_budget_single(problem, G)
        lat = self.lattice
        NP, A = max(problem.NP, 1), max(problem.A, 1)

        with stages.span("build"):
            fused_np = self._fused_inputs_np(problem, G)
        # no existing bins: the group buffer is the only upload, made once
        # across overflow regrows; with existing bins, groups + bins ride
        # one combined upload per dispatch (the bin table grows with B)
        gbuf = None
        avail, price = self._device_avail_price(problem)
        while True:
            td = time.perf_counter()
            try:
                if problem.E == 0:
                    if gbuf is None:
                        with stages.span("upload"):
                            gbuf = self._upload(fused_np)
                            self._sync()
                    with stages.span("compute"):
                        dev_buf = binpack.pack_packed_efused(
                            self._alloc, avail, price, gbuf, None, 0, B,
                            G, lat.T, lat.Z, lat.C, NP, A, lean=True)
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
                with stages.span("download"):
                    buf = dev_buf.cpu().numpy()
                    self._account_link("fetch", buf.nbytes)
            except SolverError:
                raise
            except RuntimeError as e:
                # kernel launch failure, device OOM, transfer failure
                raise SolverDeviceError(
                    f"{type(e).__name__}: {e}", cause=e) from e
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
            plan = self._decode(problem, dec, device_s)
        plan.solve_seconds = time.perf_counter() - t0
        plan.warnings = list(problem.warnings)
        plan.stage_ms = stages.ms
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

    # ---- not ported ----

    def solve_delta(self, problem: Problem, dirty_groups=(), mesh=None,
                    overlap=None) -> NodePlan:
        raise _not_ported("the steady-state delta solve and its microloop")

    def probe_batch(self, problems, existing_counts=None):
        raise _not_ported("batched consolidation what-if probes")
