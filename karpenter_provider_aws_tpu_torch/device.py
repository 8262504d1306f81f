"""Where the port's tensors live.

Entry points run on the card unless the caller asks for the CPU: a device
of None means ``cuda``, and asking for CUDA on a machine without it raises.
There is no silent CPU path.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a torch.device (None = ``cuda``); raises RuntimeError
    when CUDA is asked for and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this solver runs on the card; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

