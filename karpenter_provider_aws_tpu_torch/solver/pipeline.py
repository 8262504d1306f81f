"""Pipelined-solve support: stage timing, the asynchronous result fetch,
the on-device plan fingerprint and device-resident input deltas.

The port of the JAX package's ``solver/pipeline.py`` for one device:

- ``StageTimer`` names the five stages of a device solve (build / upload /
  compute / download / decode) and accumulates wall-clock per stage, so
  ``NodePlan.stage_ms`` says where a solve's time went. On the sequential
  path the solver synchronises the card at the end of ``compute``, which
  makes ``compute`` the device time and ``download`` the copy alone. On
  the pipelined path nothing waits before the fetch: ``compute`` is the
  host's time to issue the pack, and ``download`` holds the wait for the
  card as well as the copy.

- ``fetch_async`` starts the device→host copy of a result right after
  dispatch, into pinned host memory, so the host can run decode prep while
  the card computes; ``PendingFetch.wait`` blocks on the copy's event.

- ``plan_changed`` is the microloop's changed-plan fingerprint: an exact
  on-device inequality reduction between two result buffers, one bool
  crossing to the host instead of a whole plan.

- ``ResidentInputCache`` keeps device-resident copies of the fused input
  buffers (solver/solve.py ``_fused_inputs_np`` / ``_fused_init_np``),
  refreshed by block delta. It keeps the last host copy per (kind,
  bucket, layout-size) key, block-diffs the new buffer against it, and
  ships only the changed blocks, which ``index_copy_`` applies to the
  resident copy. Correctness never depends on the key: the diff runs
  against the actual previous content, so a key collision only costs a
  full re-upload, never a wrong solve.

The solver owns one cache and uses it only when its ``pipeline`` switch is
on; the sequential path never touches it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..device import DeviceLike, resolve_device

# the five stages of a device solve, in pipeline order; NodePlan.stage_ms
# uses exactly these names
STAGES = ("build", "upload", "compute", "download", "decode")


class StageTimer:
    """Accumulates wall-clock milliseconds per named stage.

    ``with timer.span("upload"): ...`` adds the block's duration to the
    stage; repeated spans (overflow retries) accumulate.
    """

    __slots__ = ("ms",)

    def __init__(self):
        self.ms: Dict[str, float] = {}

    def span(self, stage: str):
        return _Span(self, stage)

    def add(self, stage: str, seconds: float) -> None:
        self.ms[stage] = self.ms.get(stage, 0.0) + seconds * 1000.0

    def merge(self, other_ms: Dict[str, float]) -> None:
        for k, v in other_ms.items():
            self.ms[k] = self.ms.get(k, 0.0) + v


class _Span:
    __slots__ = ("_timer", "_stage", "_t0", "_ts")

    def __init__(self, timer: StageTimer, stage: str):
        self._timer = timer
        self._stage = stage

    def __enter__(self):
        # when tracing is on, every stage interval doubles as a trace
        # span nested under the ambient solve span; disabled, this is the
        # shared no-op singleton (no allocation)
        self._ts = trace.span("stage." + self._stage).__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.add(self._stage, time.perf_counter() - self._t0)
        self._ts.__exit__(*exc)
        return False


class PendingFetch:
    """A result copy in flight to the host (see :func:`fetch_async`)."""

    __slots__ = ("_host", "_event")

    def __init__(self, host: torch.Tensor, event=None):
        self._host = host
        self._event = event

    def wait(self) -> np.ndarray:
        """Block until the copy has landed; the host bytes as numpy. The
        array keeps its own buffer alive: no later fetch reuses it."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def fetch_async(dev_buf: torch.Tensor) -> PendingFetch:
    """Start the device→host copy of a result buffer without blocking.

    On CUDA the copy goes into a fresh pinned host buffer on the current
    stream, behind the kernels that produce ``dev_buf``, and a CUDA event
    marks its end. A failed copy raises here or in ``wait``; nothing is
    swallowed. On the CPU it is a plain copy."""
    if dev_buf.device.type == "cpu":
        return PendingFetch(dev_buf.clone())
    with torch.cuda.device(dev_buf.device):
        host = torch.empty(dev_buf.shape, dtype=dev_buf.dtype, pin_memory=True)
        host.copy_(dev_buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return PendingFetch(host, event)


def _apply_blocks(base2d: torch.Tensor, rows: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Scatter changed blocks into a copy of the resident buffer."""
    return base2d.clone().index_copy_(0, idx, rows)


def _apply_blocks_donated(base2d: torch.Tensor, rows: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Scatter changed blocks into the resident buffer IN PLACE: the
    buffer keeps one device address across passes. Safe because every
    launch is on one stream: the pack that read the previous content was
    queued before this scatter. The caller's views of the buffer see the
    new content."""
    return base2d.index_copy_(0, idx, rows)


def _differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Changed-plan fingerprint: exact on-device inequality reduction
    between this pass's fused result buffer and the retained previous one
    (a bool scalar on the device)."""
    return torch.ne(a, b).any()


def plan_changed(new_buf: Optional[torch.Tensor],
                 prev_buf: Optional[torch.Tensor]) -> bool:
    """Host-side wrapper over :func:`_differs`; ``.item()`` is the one O(1)
    sync of a skipped-fetch pass. A shape mismatch is trivially changed,
    with no device work at all."""
    if prev_buf is None or new_buf.shape != prev_buf.shape:
        return True
    return bool(_differs(new_buf, prev_buf).item())


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ResidentInputCache:
    """Device-resident fused input buffers refreshed by block delta.

    ``upload(key, buf)`` returns a device uint8 vector with exactly
    ``buf``'s content. The first upload under a key (or a layout-size
    change) ships the whole buffer; later uploads diff against the retained
    host copy in ``block``-byte blocks and ship only the changed blocks,
    padded to a power-of-two count (duplicate indices write identical
    rows), with their int32 index vector in the same transfer. A mostly
    changed buffer (more than half the blocks) re-uploads whole.

    ``device`` None means ``cuda``, as for the Solver.
    """

    def __init__(self, max_entries: int = 128, block: int = 4096,
                 device: DeviceLike = None):
        self._entries: Dict[Tuple, Tuple[np.ndarray, torch.Tensor]] = {}
        self._max_entries = max_entries
        self._block = block
        self.device = resolve_device(device)
        self.hits = 0            # uploads served by delta (incl. no-op)
        self.misses = 0          # full uploads (cold key or bulk change)
        self.blocks_shipped = 0  # delta blocks that crossed the link
        self.blocks_resident = 0  # blocks delta uploads did NOT ship
        self.bytes_shipped = 0   # bytes that crossed the link (full
                                 # uploads + delta blocks + their index)
        # link-leg accounting hook: the owning Solver installs a
        # callable(direction, nbytes) called once per transfer that
        # crosses to the device (a delta upload with no changed block
        # calls nothing)
        self.account: Optional[Callable[[str, int], None]] = None

    def _ship(self, nbytes: int) -> None:
        self.bytes_shipped += int(nbytes)
        if self.account is not None:
            self.account("upload", int(nbytes))

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "blocks_shipped": self.blocks_shipped,
                "blocks_resident": self.blocks_resident,
                "bytes_shipped": self.bytes_shipped}

    def headroom_probe(self) -> Dict[str, float]:
        """Residency occupancy. ``kind="ring"``: full by design, since at
        capacity cold keys take the admission bypass (plain uploads, never
        thrash)."""
        return {"depth": float(len(self._entries)),
                "capacity": float(self._max_entries),
                "kind": "ring"}

    def upload(self, key: Tuple, buf: np.ndarray, sharding=None,
               donate: bool = False) -> torch.Tensor:
        """``donate=True`` applies the delta scatter in place on the
        resident buffer (one device allocation for the key's life);
        otherwise the scatter writes a new buffer and the entry moves to
        it. ``sharding`` (a mesh placement) is not ported."""
        if sharding is not None:
            raise NotImplementedError(
                "mesh-placed resident buffers are not ported to the PyTorch "
                "solver; only the single-device cache is")
        total = int(buf.size)
        nblk = -(-total // self._block)
        padded = np.zeros((nblk, self._block), np.uint8)
        padded.reshape(-1)[:total] = buf
        ent = self._entries.get(key)
        if ent is None or ent[0].shape[0] != nblk:
            dev2d = self._store(key, padded)
            self.misses += 1
            self._ship(padded.size)
            return dev2d.reshape(-1)[:total]
        prev, dev2d = ent
        changed = np.nonzero((padded != prev).any(axis=1))[0]
        if changed.size > nblk // 2:
            dev2d = self._store(key, padded)
            self.misses += 1
            self._ship(padded.size)
            return dev2d.reshape(-1)[:total]
        if changed.size:
            k = _pow2(int(changed.size))
            idx = np.empty((k,), np.int32)
            idx[: changed.size] = changed
            idx[changed.size:] = changed[0]
            # the rows and their index ride ONE transfer; the int32 index
            # sits after the rows at a 4-byte-aligned offset
            payload = np.empty((k * self._block + idx.nbytes,), np.uint8)
            payload[: k * self._block] = padded[idx].reshape(-1)
            payload[k * self._block:] = idx.view(np.uint8)
            apply = _apply_blocks_donated if donate else _apply_blocks
            try:
                pay = torch.from_numpy(payload).to(self.device, copy=True)
                rows = pay[: k * self._block].view(k, self._block)
                idx_d = pay[k * self._block:].view(torch.int32).long()
                dev2d = apply(dev2d, rows, idx_d)
            except Exception:
                if donate:
                    # an in-place scatter may have half-written the base:
                    # drop the entry so no later upload deltas against it
                    self._entries.pop(key, None)
                raise
            self.blocks_shipped += int(changed.size)
            self._ship(payload.nbytes)
            self._entries[key] = (padded, dev2d)
        self.hits += 1
        self.blocks_resident += nblk - int(changed.size)
        return dev2d.reshape(-1)[:total]

    def _store(self, key: Tuple, padded: np.ndarray) -> torch.Tensor:
        # always a copy: on the CPU a shared buffer would let an in-place
        # scatter write into the retained host copy the next diff reads
        dev2d = torch.from_numpy(padded).to(self.device, copy=True)
        if key in self._entries or len(self._entries) < self._max_entries:
            self._entries[key] = (padded, dev2d)
        # else: admission bypass. A cold key at capacity uploads without
        # residency rather than evicting, so a cyclic working set larger
        # than max_entries cannot evict the entry needed next every time,
        # nor churn out the steady-state entries; invalidate() resets it.
        return dev2d

    def invalidate(self) -> None:
        self._entries.clear()
