"""Carry the JAX package's state across to this package's tensors.

The JAX package keeps its lattice, its ``Problem`` fields and its fused
staging buffers as numpy arrays (or JAX arrays, which numpy reads). These
helpers turn them into this package's tensors on one explicit device, so
the same inputs can run through both packages. Nothing here imports the
JAX package: the objects are read by attribute name.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Type

import numpy as np
import torch

from .device import DeviceLike, resolve_device

# the Problem attributes that are arrays (solver/problem.py Problem)
PROBLEM_ARRAYS = (
    "req", "count", "g_type", "g_zone", "g_cap", "g_np", "max_per_bin",
    "g_spread", "single_bin", "g_match", "g_owner", "g_need",
    "strict_custom", "np_type", "np_zone", "np_cap", "ds_overhead",
    "np_alloc_cap", "e_used", "e_alloc", "e_type", "e_zone", "e_cap",
    "e_np", "e_pm", "e_po",
)


def tensor(a, device: DeviceLike = None) -> torch.Tensor:
    """One array (numpy, or anything numpy reads) as a tensor of the same
    dtype and shape on ``device``."""
    arr = np.array(np.asarray(a), order="C", copy=True)   # keeps 0-d shapes
    return torch.from_numpy(arr).to(resolve_device(device))


def lattice_tensors(lattice, device: DeviceLike = None):
    """(alloc [T,R] f32, available [T,Z,C] bool, price [T,Z,C] f32)."""
    return (tensor(lattice.alloc, device), tensor(lattice.available, device),
            tensor(lattice.price, device))


def problem_tensors(problem, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A Problem's array fields by attribute name."""
    return {k: tensor(getattr(problem, k), device) for k in PROBLEM_ARRAYS}


def fused_buffer(buf, device: DeviceLike = None) -> torch.Tensor:
    """A fused uint8 staging buffer (group_layout / init_layout bytes)."""
    arr = np.asarray(buf)
    if arr.dtype != np.uint8:
        raise TypeError(f"fused buffers are uint8, got {arr.dtype}")
    return tensor(arr, device)


def named_tensors(cls: Type[NamedTuple], obj, device: DeviceLike = None):
    """A NamedTuple of arrays (a GroupBatch, PoolParams or BinState of the
    JAX package) as this package's NamedTuple ``cls`` of tensors; fields
    are matched by name."""
    return cls(**{f: tensor(getattr(obj, f), device) for f in cls._fields})
