"""Stage timing of a device solve.

``StageTimer`` names the five stages of a device solve (build / upload /
compute / download / decode) and accumulates wall-clock per stage, so
``NodePlan.stage_ms`` can say where a solve's time went. Only the
sequential path is ported, so no stage overlaps another here: the solver
synchronises the card at the end of the compute stage, which makes
``compute`` the kernel time and ``download`` the result copy alone.
"""

from __future__ import annotations

import time
from typing import Dict

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


class _Span:
    __slots__ = ("_timer", "_stage", "_t0")

    def __init__(self, timer: StageTimer, stage: str):
        self._timer = timer
        self._stage = stage

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.add(self._stage, time.perf_counter() - self._t0)
        return False
