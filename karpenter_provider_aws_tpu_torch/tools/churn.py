"""The operator churn loop that ``bench_explain`` and ``bench_headroom``
time: an Operator on a FakeClock, ``n_pods`` pods, one warmup pass, then
``n_passes`` timed passes with ~1 % new pods before each."""

from __future__ import annotations

import gc
import time


def operator_churn(n_pods: int, n_passes: int, device=None, setup=None,
                   gauges: bool = False):
    """Runs the loop and returns (the Operator, the sorted pass times in
    seconds). ``setup(op)`` runs once before any pod is added; with
    ``gauges`` each timed pass is ``provision_once`` + ``emit_gauges``,
    else ``provision_once`` alone."""
    from ..apis import Pod
    from ..cloud import FakeCloud
    from ..lattice import build_lattice
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock

    clock = FakeClock()
    op = Operator(options=Options(registration_delay=0.5),
                  lattice=build_lattice(), cloud=FakeCloud(clock),
                  clock=clock, device=device)
    if setup is not None:
        setup(op)
    serial = 0

    def add(n):
        nonlocal serial
        for _ in range(n):
            serial += 1
            op.cluster.add_pod(Pod(name=f"b{serial}",
                                   requests={"cpu": "250m",
                                             "memory": "512Mi"}))

    def one_pass():
        op.provisioner.provision_once()
        if gauges:
            op.emit_gauges()

    add(n_pods)
    # warmup: the first pass pays the cold start and cold caches
    one_pass()
    clock.step(1.0)
    times = []
    for _ in range(n_passes):
        # ~1% churn per pass: the steady-state shape the delta path and
        # the ledger copy-on-write patching serve
        add(max(n_pods // 100, 1))
        gc.collect()
        t0 = time.perf_counter()
        one_pass()
        times.append(time.perf_counter() - t0)
        clock.step(1.0)
    times.sort()
    return op, times


def p50_p90_ms(times) -> dict:
    return {"e2e_p50_ms": round(times[len(times) // 2] * 1000.0, 3),
            "e2e_p90_ms": round(times[int(len(times) * 0.9)] * 1000.0, 3)}
