"""One shard per card: a mesh's pod shards as the ranks of a process group.

The reference runs its sharded pack as one ``shard_map`` program from one
process, and XLA issues each device's slice of the work. Here a mesh of D
shards on W ranks (parallel/mesh.py ``SolverMesh.ranks``) is W processes,
one per card, so that each card's scan is issued by a process of its own:

- **Rank 0** is the Solver's process and card. It starts ranks 1..W-1 as
  worker processes with the ``spawn`` start method (CUDA may already be
  initialised in the Operator), once per process and per (device, W):
  :func:`acquire` shares the set among the Solvers of the process.
- **The group.** Every rank joins one process group: ``nccl`` when the
  device is ``cuda``, ``gloo`` when it is ``cpu`` (the backend follows the
  device; there is no switch). Rendezvous is a file in a private temporary
  directory. Every collective has the group's finite timeout, and rank 0
  waits on each with that deadline while it watches the workers, so a
  rank that dies or stalls raises :class:`RanksLost` (a RuntimeError, which
  the Solver reports as a device error) and never hangs the solve longer.
- **The protocol of a pack** (:meth:`Ranks.pack`). Rank 0 sends each worker
  a small header over its pipe: the op, B, G, T, Z, C, NP, A, E, the
  buffer sizes and the worker's block of shards. Then, in this order:
  the lattice trio is broadcast when the worker does not hold it yet
  (again only when the Solver's lattice view or its price version
  changes: the tensors' identity is the key); the fused group buffer and
  the init buffer are broadcast, or, for the microloop's resident
  combined buffer, only its delta; each rank gets its block of rows of
  the [D,G] count split (a scatter), or derives it from the buffer as
  the microloop does; each rank packs its shards (parallel/sharded.py
  ``local_pack``: a vmapped ``_scan`` and one cheapest-offering launch);
  and rank 0 gathers the decode buffers, the per-shard float32 costs and
  each rank's node, leftover and kernel-launch counts. Uneven blocks are
  padded for the gather and the padding is stripped.
- **The reduction keeps the reference's bits.** The float32 cost is never
  all-reduced (NCCL's ring order would change the merge decision): rank
  0 sums the gathered [D] vector of per-shard costs in shard order, as
  the batched pack does. Nodes and leftover pods are integer sums.
- **Launches.** Each worker's kernel launches reach rank 0 with its
  result and are added to ``offering_argmin.LAUNCHES`` there
  (``note_rank_launches``), so a count read on rank 0 sees every card's.
- **Lifetime.** A worker exits when its pipe closes, when rank 0 asks it
  to, or when its parent process goes (it polls its parent's pid), so no
  worker outlives a killed Operator or a finished test. A set whose rank
  failed is broken for good: the Solver that used it raises on each later
  solve, and the next :func:`acquire` starts a fresh set.

Rank 0 blocks until the gathers complete: the pack's result is on its
card when :meth:`Ranks.pack` returns. Nothing here imports JAX; a worker
imports this module, the mesh, the sharded pack and the kernel's wrapper.
"""

from __future__ import annotations

import atexit
import collections
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.clock import WALL
from .mesh import rank_blocks

# seconds a collective, or the group's rendezvous, may take before the
# rank that waits on it gives up
GROUP_TIMEOUT_S = 60.0
# seconds for the workers to start, import the port and join the group
SPAWN_TIMEOUT_S = 180.0
# lattice trios and resident buffers a worker keeps (rank 0 evicts)
MAX_HELD = 8
# how often a worker checks that its parent is alive (s)
PARENT_POLL_S = 0.5

_U8 = torch.uint8
_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32


class RanksLost(RuntimeError):
    """A rank of the group died, raised, or missed the group's timeout;
    the set is broken and every later pack on it raises at once."""


class Resident(NamedTuple):
    """The microloop's resident combined buffer on rank 0's card and the
    last change to it (solver/pipeline.py ``ResidentInputCache.last_change``):
    the ranks keep their own copy and take only the delta."""

    key: Tuple                          # the Solver's resident key
    combined: torch.Tensor              # the whole buffer (u8, rank 0)
    g_size: int                         # bytes of the group+pool part
    before: Optional[int]               # serial the delta applies to
    after: int                          # serial of the content now
    payload: Optional[torch.Tensor]     # the delta: rows + int32 index
    block: int                          # bytes a row


def _make_group(device_type: str, store_path: str, rank: int, size: int,
                timeout: float):
    """This rank's process group: NCCL for cards, gloo for the CPU. NCCL's
    own watchdog gets twice the timeout: rank 0 gives up at ``timeout``
    and aborts the group first, so the watchdog, which would end the
    process, stays a backstop for the workers."""
    td = datetime.timedelta(seconds=timeout)
    store = dist.FileStore(store_path, size)
    store.set_timeout(td)
    if device_type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = 2 * td
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, td)


def _count_offset(G: int, T: int, Z: int, C: int, NP: int, A: int,
                  R: int) -> int:
    from ..ops import binpack
    return next(f.offset for f in binpack.group_layout(
        G, T, Z, C, NP, A, R)[0] if f.name == "count")


def _bcast(pg, t: torch.Tensor):
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    return pg.broadcast([t], opts)


def _scatter(pg, out: torch.Tensor, inputs):
    opts = dist.ScatterOptions()
    opts.rootRank = 0
    return pg.scatter([out], [inputs] if inputs is not None else [], opts)


def _gather(pg, outputs, t: torch.Tensor):
    opts = dist.GatherOptions()
    opts.rootRank = 0
    return pg.gather([outputs] if outputs is not None else [], [t], opts)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` along its first axis."""
    if x.shape[0] == n:
        return x.contiguous()
    pad = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


# ---- the worker (ranks 1..W-1) ----

def _watch_parent(parent: int) -> None:
    while True:
        WALL.sleep(PARENT_POLL_S)
        if os.getppid() != parent:
            os._exit(3)


class _Worker:
    """A worker rank's state: its group, the lattice trios and resident
    buffers rank 0 told it to keep."""

    def __init__(self, device: torch.device, pg):
        self.device = device
        self.pg = pg
        self.lattices: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.resident: Dict[Tuple, torch.Tensor] = {}

    def _recv(self, shape, dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=self.device)
        _bcast(self.pg, t).wait()
        return t

    def pack(self, h: dict) -> None:
        from ..ops import offering_argmin
        from .sharded import device_split_counts, local_pack
        dev, pg = self.device, self.pg
        for s in h["evict_slots"]:
            self.lattices.pop(s, None)
        if h["lattice"] is not None:
            self.lattices[h["slot"]] = tuple(
                self._recv(shape, getattr(torch, dtype))
                for shape, dtype in h["lattice"])
        alloc, avail, price = self.lattices[h["slot"]]
        res = h["resident"]
        if res is None:
            gbuf = self._recv((h["gbuf"],), _U8)
            init = self._recv((h["init"],), _U8) if h["init"] else None
        else:
            for k in res["evict"]:
                self.resident.pop(k, None)
            total, block = res["total"], res["block"]
            if res["mode"] == "full":
                nblk = -(-total // block)
                buf = torch.zeros((nblk * block,), dtype=_U8, device=dev)
                _bcast(pg, buf[:total]).wait()
                self.resident[res["key"]] = buf
            elif res["mode"] == "delta":
                k = res["rows"]
                pay = self._recv((k * block + 4 * k,), _U8)
                rows = pay[: k * block].view(k, block)
                idx = pay[k * block:].view(_I32).long()
                buf = self.resident[res["key"]]
                buf.view(-1, block).index_copy_(0, idx, rows)
            comb = self.resident[res["key"]][:total]
            gbuf = comb[: res["g_size"]]
            init = comb[res["g_size"]:] if h["E"] else None
        lo, hi, bmax = h["lo"], h["hi"], h["bmax"]
        G = h["G"]
        if h["split"] == "scatter":
            out = torch.empty((bmax, G), dtype=_I32, device=dev)
            _scatter(pg, out, None).wait()
            counts = out[: hi - lo]
        else:
            off = _count_offset(G, h["T"], h["Z"], h["C"], h["NP"], h["A"],
                                alloc.shape[1])
            counts = device_split_counts(gbuf, h["D"], off, G)[lo:hi]
        launched = offering_argmin.LAUNCHES
        packed, cost, nodes, leftover = local_pack(
            alloc, avail, price, gbuf, init, 0, counts.contiguous(), h["B"],
            G, h["T"], h["Z"], h["C"], h["NP"], h["A"])
        launched = offering_argmin.LAUNCHES - launched
        ints = torch.stack([nodes.to(_I64), leftover.to(_I64),
                            torch.full((), launched, dtype=_I64,
                                       device=dev)])
        for t in (_pad_rows(packed, bmax), _pad_rows(cost, bmax), ints):
            _gather(pg, None, t).wait()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _worker_main(rank: int, size: int, device: str, store_path: str,
                 timeout: float, threads: int, conn, parent: int,
                 build_dir: str) -> None:
    """A worker rank: join the group, then run rank 0's ops until its pipe
    closes, it is told to stop, or its parent goes. It loads the kernel
    library from rank 0's ``build_dir`` (a spawned process starts with
    the package's default)."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True,
                     name="solver-rank-parent").start()
    try:
        conn.send(("started", os.getpid()))
        from ..ops import cuda_build
        cuda_build.set_build_dir(build_dir)
        torch.set_num_threads(max(1, threads))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        worker = _Worker(dev, _make_group(dev.type, store_path, rank, size,
                                          timeout))
        # what the worker runs, imported before it says it is ready; the
        # names it loaded and its build directory go to rank 0
        # (``Ranks.worker_modules``, ``Ranks.worker_build_dirs``)
        from ..ops import offering_argmin  # noqa: F401
        from . import sharded  # noqa: F401
        conn.send(("ready", (sorted(sys.modules),
                             str(cuda_build.BUILD_DIR))))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg.get("op") != "pack":
            break
        try:
            worker.pack(msg)
        except BaseException:
            try:
                conn.send(("error", traceback.format_exc()))
            except OSError:
                pass
            break
    os._exit(0)


# ---- rank 0 ----

_REGISTRY: Dict[Tuple, "Ranks"] = {}
_REGISTRY_LOCK = threading.RLock()
_ALL: List["Ranks"] = []


class Ranks:
    """Rank 0's handle on a set of W ranks for Solvers on ``device``.

    ``devices`` are the ranks' devices (rank 0's first); ``timeout`` the
    group timeout in seconds. Thread-safe: packs serialize on the set's
    lock. Stats: ``spawn_ms`` (start to every rank ready), ``packs``,
    ``last`` (the last pack's broadcast and gathered bytes, shards and
    launches per rank)."""

    def __init__(self, devices: List[torch.device], timeout: float):
        self.devices = list(devices)
        self.device = self.devices[0]
        self.size = len(self.devices)
        self.timeout = float(timeout)
        self.broken: Optional[str] = None
        self.packs = 0
        self.last: Dict[str, object] = {}
        # the module names each worker had loaded when it joined
        self.worker_modules: List[List[str]] = []
        # the build directory each worker loads the kernel library from
        self.worker_build_dirs: List[str] = []
        self._lock = threading.Lock()
        self._slots: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()
        self._next_slot = 0
        self._resident: "collections.OrderedDict[Tuple, int]" = \
            collections.OrderedDict()
        self._procs, self._conns = [], []
        self._pg = None
        self._dir = tempfile.mkdtemp(prefix="solver-ranks-")
        _ALL.append(self)
        t0 = time.perf_counter()
        try:
            self._start()
        except BaseException as e:
            self._break(f"the ranks did not start: {e}")
            raise
        self.spawn_ms = (time.perf_counter() - t0) * 1e3

    # -- lifecycle --

    def _start(self) -> None:
        from ..ops import cuda_build
        if self.device.type == "cuda":
            # one build for every rank: the workers load the library this
            # process built (ops/cuda_build.py writes it atomically), from
            # this process's build directory, which they are told
            cuda_build.build("offering_argmin")
        build_dir = str(cuda_build.BUILD_DIR)
        store = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        threads = torch.get_num_threads()
        for rank in range(1, self.size):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main, name=f"solver-rank-{rank}", daemon=True,
                args=(rank, self.size, str(self.devices[rank]), store,
                      self.timeout, threads, theirs, os.getpid(),
                      build_dir))
            p.start()
            theirs.close()
            self._procs.append(p)
            self._conns.append(ours)
        # every worker imports the port before the group's clock starts
        deadline = WALL.monotonic() + SPAWN_TIMEOUT_S
        self._expect("started", deadline, f"in {SPAWN_TIMEOUT_S} s")
        self._pg = _make_group(self.device.type, store, 0, self.size,
                               self.timeout)
        ready = self._expect("ready", WALL.monotonic() + self.timeout,
                             f"within the group timeout of {self.timeout} s")
        self.worker_modules = [mods for mods, _ in ready]
        self.worker_build_dirs = [d for _, d in ready]

    def _expect(self, what: str, deadline: float, within: str) -> list:
        """Each worker's next message, which must be ``what``: its detail
        in rank order."""
        out = []
        for r, conn in enumerate(self._conns, start=1):
            while not conn.poll(0.05):
                p = self._procs[r - 1]
                if not p.is_alive():
                    raise RanksLost(f"rank {r} exited (code {p.exitcode}) "
                                    f"before it was {what}")
                if WALL.monotonic() > deadline:
                    raise RanksLost(f"rank {r} was not {what} {within}")
            kind, detail = conn.recv()
            if kind != what:
                raise RanksLost(f"rank {r} failed to start:\n{detail}")
            out.append(detail)
        return out

    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def live_pids(self) -> List[int]:
        return [p.pid for p in self._procs if p.is_alive()]

    def close(self, timeout: float = 10.0) -> None:
        """Stop the workers (each asked, then killed if it lingers) and
        drop the group."""
        with _REGISTRY_LOCK:
            for k, v in list(_REGISTRY.items()):
                if v is self:
                    del _REGISTRY[k]
        for conn in self._conns:
            try:
                conn.send({"op": "stop"})
            except OSError:
                pass
        deadline = WALL.monotonic() + timeout
        for p in self._procs:
            p.join(max(0.0, deadline - WALL.monotonic()))
        self._reap(abort=self.broken is not None)
        if self.broken is None:
            self.broken = "closed"

    def _reap(self, abort: bool) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        for conn in self._conns:
            conn.close()
        self._conns = []
        # the held lattices: a closed set keeps no Solver's tensors alive
        self._slots.clear()
        self._resident.clear()
        pg, self._pg = self._pg, None
        if pg is not None and self.device.type == "cuda":
            stop = getattr(pg, "abort" if abort else "shutdown", None)
            if stop is not None:
                try:
                    stop()
                except Exception:
                    pass
        shutil.rmtree(self._dir, ignore_errors=True)

    def _break(self, why: str) -> None:
        if self.broken is None:
            self.broken = why
        with _REGISTRY_LOCK:
            for k, v in list(_REGISTRY.items()):
                if v is self:
                    del _REGISTRY[k]
        self._reap(abort=True)

    def _check_alive(self) -> None:
        for r, (p, conn) in enumerate(zip(self._procs, self._conns), start=1):
            if conn.poll():
                try:
                    kind, what = conn.recv()
                except (EOFError, OSError):
                    p.join(1.0)
                    raise RanksLost(f"rank {r} exited (code {p.exitcode})")
                raise RanksLost(f"rank {r} failed: {what}")
            if not p.is_alive():
                raise RanksLost(f"rank {r} exited (code {p.exitcode})")

    def _wait(self, works) -> None:
        """Wait for ``works`` within the group timeout, watching every
        worker: a dead or failed rank raises at once."""
        deadline = WALL.monotonic() + self.timeout
        for w in works:
            while not w.is_completed():
                self._check_alive()
                if WALL.monotonic() > deadline:
                    raise RanksLost(f"a collective missed the group timeout "
                                    f"of {self.timeout} s")
                WALL.sleep(0.0002)
            try:
                w.wait()
            except Exception as e:
                # name the rank behind a failed collective where one is gone
                self._check_alive()
                raise RanksLost(f"a collective failed: {type(e).__name__}: "
                                f"{e}") from e

    # -- the pack --

    def _lattice(self, alloc, avail, price):
        """(slot, tensors to broadcast or None, slots to evict)."""
        key = (id(alloc), id(avail), id(price))
        hit = self._slots.get(key)
        if hit is not None:
            self._slots.move_to_end(key)
            return hit[0], None, []
        slot = self._next_slot
        self._next_slot += 1
        evict = []
        while len(self._slots) >= MAX_HELD:
            evict.append(self._slots.popitem(last=False)[1][0])
        # the tensors themselves are held, so an id is never reused stale
        self._slots[key] = (slot, (alloc, avail, price))
        return slot, (alloc, avail, price), evict

    def _resident_mode(self, res: Resident):
        """('none' | 'delta' | 'full', keys to evict) for ``res``."""
        held = self._resident.get(res.key)
        evict = []
        if held is None:
            while len(self._resident) >= MAX_HELD:
                evict.append(self._resident.popitem(last=False)[0])
            mode = "full"
        elif held == res.after:
            mode = "none"
        elif res.payload is not None and held == res.before:
            mode = "delta"
        else:
            mode = "full"
        self._resident[res.key] = res.after
        self._resident.move_to_end(res.key)
        return mode, evict

    def pack(self, mesh, alloc, avail, price, gbuf, init_buf, n_existing,
             counts, B, G, T, Z, C, NP, A, resident=None):
        """The sharded pack of ``mesh`` over these ranks (the module
        docstring); returns parallel/sharded.py's ``ShardedPack`` on rank
        0's card. Raises :class:`RanksLost` when a rank fails."""
        with self._lock:
            if self.broken is not None:
                raise RanksLost(f"the solver's ranks are lost: {self.broken}")
            try:
                return self._pack(mesh, alloc, avail, price, gbuf, init_buf,
                                  n_existing, counts, B, G, T, Z, C, NP, A,
                                  resident)
            except BaseException as e:
                # a failure anywhere leaves the ranks out of step
                why = (str(e) if isinstance(e, RanksLost)
                       else f"{type(e).__name__}: {e}")
                self._break(why)
                if not isinstance(e, Exception):
                    raise
        # raised outside the handler, so that no frame of the failed pack
        # (nor the group's work objects it held) outlives the group
        raise RanksLost(why)

    def _pack(self, mesh, alloc, avail, price, gbuf, init_buf, n_existing,
              counts, B, G, T, Z, C, NP, A, resident):
        from ..ops import offering_argmin
        from .sharded import ShardedPack, _seq_sum, local_pack
        D, W, pg = int(mesh.shards), self.size, self._pg
        if int(mesh.ranks) != W:
            raise ValueError(f"a mesh on {mesh.ranks} ranks cannot run on "
                             f"a set of {W}")
        blocks = rank_blocks(D, W)
        bmax = blocks[0][1] - blocks[0][0]
        slot, lat, evict_slots = self._lattice(alloc, avail, price)
        head = {"op": "pack", "D": D, "bmax": bmax, "B": B, "G": G, "T": T,
                "Z": Z, "C": C, "NP": NP, "A": A, "E": int(n_existing or 0),
                "slot": slot, "evict_slots": evict_slots,
                "lattice": None if lat is None else [
                    (tuple(t.shape), str(t.dtype).rpartition(".")[2])
                    for t in lat],
                "resident": None, "gbuf": 0, "init": 0}
        sent: List[torch.Tensor] = list(lat or ())
        if resident is None:
            head["gbuf"] = int(gbuf.numel())
            head["init"] = int(init_buf.numel()) if init_buf is not None \
                else 0
            head["split"] = "scatter"
            sent += [gbuf] + ([init_buf] if init_buf is not None else [])
        else:
            mode, evict = self._resident_mode(resident)
            rows = 0
            if mode == "full":
                sent.append(resident.combined)
            elif mode == "delta":
                rows = (resident.payload.numel()) // (resident.block + 4)
                sent.append(resident.payload)
            head["resident"] = {
                "key": resident.key, "mode": mode, "evict": evict,
                "total": int(resident.combined.numel()),
                "block": resident.block, "rows": rows,
                "g_size": resident.g_size}
            head["split"] = "derive"
        self._check_alive()
        for r, conn in enumerate(self._conns, start=1):
            conn.send(dict(head, lo=blocks[r][0], hi=blocks[r][1]))
        works = [_bcast(pg, t.contiguous()) for t in sent]
        lo0, hi0 = blocks[0]
        if head["split"] == "scatter":
            inputs = [_pad_rows(counts[lo:hi], bmax) for lo, hi in blocks]
            out = torch.empty((bmax, G), dtype=_I32, device=self.device)
            works.append(_scatter(pg, out, inputs))
        self._wait(works)
        launched = offering_argmin.LAUNCHES
        packed, cost, nodes, leftover = local_pack(
            alloc, avail, price, gbuf, init_buf, n_existing,
            counts[lo0:hi0].contiguous(), B, G, T, Z, C, NP, A)
        launched = offering_argmin.LAUNCHES - launched
        ints = torch.stack([nodes.to(_I64), leftover.to(_I64),
                            torch.full((), launched, dtype=_I64,
                                       device=self.device)])
        outs = [[torch.empty_like(x) for _ in range(W)]
                for x in (packed, cost, ints)]
        self._wait([_gather(pg, o, x) for o, x in
                    zip(outs, (packed, cost, ints))])
        sizes = [hi - lo for lo, hi in blocks]
        stacked = torch.cat([p[:n] for p, n in zip(outs[0], sizes)])
        costs = torch.cat([c[:n] for c, n in zip(outs[1], sizes)])
        tallies = torch.stack(outs[2])                       # [W,3] i64
        per_rank = tallies[:, 2].tolist()
        offering_argmin.note_rank_launches(int(sum(per_rank[1:])))
        self.packs += 1
        self.last = {
            "bcast_bytes": sum(t.numel() * t.element_size() for t in sent)
            + (bmax * G * 4 * (W - 1) if head["split"] == "scatter" else 0),
            "gather_bytes": sum(x.numel() * x.element_size()
                                for x in (packed, cost, ints)) * (W - 1),
            "shards": sizes, "launches": [int(n) for n in per_rank],
            "resident": head["resident"] and head["resident"]["mode"]}
        return ShardedPack(packed=stacked, total_cost=_seq_sum(costs),
                           total_nodes=tallies[:, 0].sum().to(_I32),
                           total_leftover=tallies[:, 1].sum().to(_I32))


def acquire(mesh, device) -> Ranks:
    """The process's live rank set for ``mesh`` on rank 0's ``device``,
    started on first use (or after the last one broke), with the group
    timeout ``GROUP_TIMEOUT_S``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.type, dev.index, int(mesh.ranks))
    with _REGISTRY_LOCK:
        rs = _REGISTRY.get(key)
        if rs is None or rs.broken is not None:
            rs = Ranks(mesh.rank_devices(dev), GROUP_TIMEOUT_S)
            _REGISTRY[key] = rs
        return rs


def shutdown_all() -> None:
    """Close every rank set this process started."""
    for rs in list(_ALL):
        if rs.broken is None or rs.live_pids():
            rs.close()


def live_workers() -> List[int]:
    """Pids of this process's worker ranks still alive."""
    return [pid for rs in _ALL for pid in rs.live_pids()]


atexit.register(shutdown_all)
