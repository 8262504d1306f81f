"""Cheapest-offering finalization: the CUDA kernel's wrapper and its plain
PyTorch version.

The pack finalization answers, per bin: over every (type, zone,
capacity-type) offering the bin's masks still allow, which is cheapest?
This is the port of the JAX package's Pallas TPU kernel
(``karpenter_provider_aws_tpu/ops/offering_argmin.py``,
``cheapest_offering_pallas``) and of its XLA form. The kernel is
``csrc/offering_argmin.cu`` (hand-written for sm_90a; its source note
states its bound and design), built by ``nvcc`` at first use and called
through ctypes on the current CUDA stream.

Layout (no padding, unlike the TPU kernel's 128-lane tiles):
``tmask [B,T]`` bool/u8, ``zcmask [B,ZC]`` bool/u8 with ``zc = z*C + c``,
``price [T,ZC]`` f32 pre-masked to +inf where an offering is unavailable.
Returns ``(best_v [B] f32, best_i [B] i32)`` with the flat index
``t*ZC + zc``; ties go to the lowest index and a bin with no finite
allowed offering gets ``(+inf, 0)``.

``cheapest_offering`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. Meta tensors (the pack's analysis,
``binpack.pack_analysis``) get empty outputs of the kernel's shapes and
no work; the call's bytes (``call_bytes``) and compares go to the
analysis running on the thread. ``LAUNCHES`` counts kernel launches:
this process's, and those its mesh's worker ranks made on their cards
(parallel/ranks.py reports them with ``note_rank_launches``). ``CALLS``
counts this process's calls by shape ``(B, T, ZC)``, the plain version's
too, so that ``call_bytes`` prices the work the finalization did.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from . import cuda_build

# kernel launches made by cheapest_offering (the plain version never counts)
LAUNCHES = 0
# calls of cheapest_offering by shape (B, T, ZC), on the card and the CPU
CALLS: Dict[Tuple[int, int, int], int] = {}

_MAX_ZC = 4096   # the kernel's shared-memory layout holds up to this many cells

# the analysis running on this thread (``note(flops, nbytes)``), if any
ANALYSIS = threading.local()


def call_bytes(B: int, T: int, ZC: int) -> int:
    """Bytes one call must move: each input read once (the masks as bytes,
    the f32 price panel), each output (f32 value, i32 index) written once."""
    return B * T + B * ZC + T * ZC * 4 + B * 8


def cheapest_offering_ref(tmask: torch.Tensor, zcmask: torch.Tensor,
                          price: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: materializes the [B,T,ZC] masked price."""
    B, T = tmask.shape
    allowed = tmask.bool()[:, :, None] & zcmask.bool()[:, None, :]
    inf = torch.full((), float("inf"), dtype=price.dtype, device=price.device)
    cost = torch.where(allowed, price[None, :, :], inf)
    flat = cost.reshape(B, -1)
    best = torch.argmin(flat, dim=1)       # first minimum, as jnp.argmin
    return flat.gather(1, best[:, None])[:, 0], best.to(torch.int32)


def note_rank_launches(n: int) -> None:
    """Add launches that worker ranks of this process's mesh made, each
    counted by the rank's own wrapper where it launched (parallel/ranks.py
    gathers them with the rank's result)."""
    global LAUNCHES
    LAUNCHES += int(n)


def _count_call(tmask: torch.Tensor, zcmask: torch.Tensor) -> None:
    key = (int(tmask.shape[0]), int(tmask.shape[1]), int(zcmask.shape[1]))
    CALLS[key] = CALLS.get(key, 0) + 1


def _meta_call(tmask: torch.Tensor, zcmask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The call on meta tensors: no work, the kernel's output shapes; the
    thread's analysis counts a compare per (bin, type, cell) and
    ``call_bytes``."""
    B, T = tmask.shape
    ZC = zcmask.shape[1]
    note = getattr(ANALYSIS, "note", None)
    if note is not None:
        note(B * T * ZC, call_bytes(B, T, ZC))
    return (torch.empty((B,), dtype=torch.float32, device="meta"),
            torch.empty((B,), dtype=torch.int32, device="meta"))


def _launcher():
    lib = cuda_build.load("offering_argmin")
    fn = lib.cheapest_offering_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _as_u8(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    if x.dtype != torch.uint8:
        raise TypeError(f"{name} must be bool or uint8, got {x.dtype}")
    return x


def cheapest_offering(tmask: torch.Tensor, zcmask: torch.Tensor,
                      price: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_v [B] f32, best_i [B] i32) per bin; see the module note.

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    or raise: there is no fallback. Meta tensors are checked as CUDA
    tensors are, then counted and given empty outputs (``_meta_call``)."""
    global LAUNCHES
    if tmask.device.type == "cpu":
        _count_call(tmask, zcmask)
        return cheapest_offering_ref(tmask, zcmask, price)
    if tmask.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {tmask.device}")
    if tmask.dim() != 2 or zcmask.dim() != 2 or price.dim() != 2:
        raise ValueError("tmask, zcmask and price must be 2-D")
    B, T = tmask.shape
    ZC = zcmask.shape[1]
    if zcmask.shape[0] != B or tuple(price.shape) != (T, ZC):
        raise ValueError(f"shape mismatch: tmask {tuple(tmask.shape)}, "
                         f"zcmask {tuple(zcmask.shape)}, "
                         f"price {tuple(price.shape)}")
    if zcmask.device != tmask.device or price.device != tmask.device:
        raise ValueError("tmask, zcmask and price must share one device")
    if price.dtype != torch.float32:
        raise TypeError(f"price must be float32, got {price.dtype}")
    if not (tmask.is_contiguous() and zcmask.is_contiguous()
            and price.is_contiguous()):
        raise ValueError("tmask, zcmask and price must be contiguous")
    if T == 0 or ZC == 0 or ZC > _MAX_ZC or T * ZC >= 2 ** 31:
        raise ValueError(f"unsupported extent T={T}, ZC={ZC}")
    tm, zc = _as_u8(tmask, "tmask"), _as_u8(zcmask, "zcmask")
    if tmask.device.type == "meta":
        return _meta_call(tm, zc)
    best_v = torch.empty((B,), dtype=torch.float32, device=tmask.device)
    best_i = torch.empty((B,), dtype=torch.int32, device=tmask.device)
    _count_call(tmask, zcmask)
    if B == 0:
        return best_v, best_i
    launch = _launcher()
    with torch.cuda.device(tmask.device):
        stream = torch.cuda.current_stream(tmask.device).cuda_stream
        err = launch(tm.data_ptr(), zc.data_ptr(), price.data_ptr(),
                     best_v.data_ptr(), best_i.data_ptr(), B, T, ZC, stream)
    if err != 0:
        raise RuntimeError(f"cheapest_offering kernel launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES += 1
    return best_v, best_i
