"""What the CI gates of this package (``tools/smoke_*.py``) share.

Each gate is the counterpart of the repository's ``tools/smoke_<name>.py``
with the same assertions, sizes, seeds, FakeClock steps and bounds, and
the same summary line, run as

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_<name> [--device cuda]

``--device`` (default ``cuda``) places every Solver the gate makes; on a
machine without a card the default raises, as every entry point of the
package does (no CPU path stands in for the card). Just before its summary
line each gate prints one JSON line, ``{"gate": ..., "device": ...,
"kernel_launches": ..., "solved": ...}``: the device label of its Solver
(``Solver.stats()["device"]``: ``cuda:<index> (<card>)`` or ``cpu``), the
cheapest-offering kernel's launches in the process (``offering_argmin
.LAUNCHES``, which counts only launches on the card) and whether the gate
solved. On the card a gate that solved and launched the kernel no time
fails.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional, Sequence

from ..device import resolve_device
from ..ops import offering_argmin


# the gates, by module (``tools/smoke_<name>.py`` of this package)
GATES = tuple(sorted(p.stem[len("smoke_"):]
                     for p in Path(__file__).parent.glob("smoke_*.py")))


def device_arg(argv: Optional[Sequence[str]], doc: Optional[str]):
    """The gate's ``--device`` as a torch.device (default ``cuda``; raises
    without CUDA). On the CPU torch runs one thread: the gates' problems
    are small, and a pool of threads per process only spins against the
    others (the sharded gate took 99 s with torch's default threads, 9 s
    with one, on an 8-core host beside one other gate)."""
    ap = argparse.ArgumentParser(
        description=(doc or "").strip().splitlines()[0] if doc else None)
    ap.add_argument("--device", default="cuda",
                    help="device of every Solver of the gate (default "
                         "cuda; raises without a card; 'cpu' runs the "
                         "plain PyTorch path)")
    device = resolve_device(ap.parse_args(argv).device)
    if device.type == "cpu":
        import torch
        torch.set_num_threads(1)
    return device


def small_lattice():
    """The gates' small-family lattice (m5 and c5 of the built-in
    catalog, as the reference gates build it)."""
    from ..lattice import build_catalog, build_lattice
    return build_lattice([s for s in build_catalog()
                          if s.family in ("m5", "c5")])


def report(name: str, device, solver_device: str, failures: List[str],
           solved: bool = True, kernel_launches: Optional[int] = None) -> None:
    """Print the gate's device line (``kernel_launches`` defaults to this
    process's), and add a failure when the gate ran on the card, solved,
    and launched the kernel no time."""
    if kernel_launches is None:
        kernel_launches = offering_argmin.LAUNCHES
    print(json.dumps({"gate": name, "device": solver_device,
                      "kernel_launches": kernel_launches,
                      "solved": solved}), flush=True)
    if device.type == "cuda" and solved and kernel_launches < 1:
        failures.append(f"solved on {solver_device} but the kernel never "
                        "launched")
