"""Measurement helpers for the port's kernels on the card.

``chip_smoke.py`` and ``profile_solve.py`` use them: the card's name and
power limit, device times from CUDA events, the card's launch floor, a
kernel call's bound, the exact comparison of a kernel with its plain
version, the kernel inputs a main-path call passes, and a call's device
time and idle share under the profiler.
"""

from __future__ import annotations

import statistics
import subprocess
import time

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
# float32 instructions outside the tensor cores: 132 SMs x 128 lanes x
# 1.98 GHz. The data sheet's 67 TFLOP/s counts each FMA as two operations;
# a compare is one instruction.
H100_F32_INSTR_PER_S = 33.5e12


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_times_ms(fn, n: int = 100, sleep_cycles: int = 400_000_000):
    """Per-call device time of ``fn`` (ms): n calls enqueued behind a
    device sleep, one CUDA event between each, median of the gaps; and the
    seconds the host then waited for the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(sleep_cycles)
    ev[0].record()
    for i in range(n):
        fn()
        ev[i + 1].record()
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    waited = time.perf_counter() - t_host
    times = [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]
    return statistics.median(times), waited


def launch_floor_ms(device, n: int = 100) -> float:
    """Device time of the smallest launch: a one-element in-place add."""
    import torch
    x = torch.zeros(1, device=device)
    return device_times_ms(lambda: x.add_(1.0), n)[0]


def bound(tm, zc, pr):
    """(bound_ms, "bytes" or "operations", bytes, compares) of one call:
    each input read once and each output written once at the card's
    memory rate, against the compares these inputs need (the allowed
    (type, cell) pairs) at its float32 instruction rate."""
    import torch
    B, T = tm.shape
    ZC = zc.shape[1]
    nbytes = B * T + B * ZC + T * ZC * 4 + B * 8
    n_ops = int((tm.bool().sum(dim=1).to(torch.int64)
                 * zc.bool().sum(dim=1).to(torch.int64)).sum())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_INSTR_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, n_ops)


def check_exact(name: str, got, want) -> float:
    """Raises unless indices and finite values are equal and the kernel's
    value is not finite where the plain one is not; returns the largest
    absolute difference of finite values (0.0 when equal)."""
    import torch
    (gv, gi), (wv, wi) = got, want
    torch.cuda.synchronize()
    if gv.shape != wv.shape or gi.dtype != torch.int32 or gv.dtype != torch.float32:
        raise AssertionError(f"{name}: shape/dtype {tuple(gv.shape)} {gv.dtype} "
                             f"{gi.dtype} vs {tuple(wv.shape)}")
    if not torch.equal(gi, wi):
        bad = int((gi != wi).sum())
        raise AssertionError(f"{name}: {bad} index mismatches")
    fin = torch.isfinite(wv)
    if not torch.equal(gv[fin], wv[fin]) or bool(torch.isfinite(gv[~fin]).any()):
        raise AssertionError(f"{name}: value mismatch")
    return float((gv[fin] - wv[fin]).abs().max()) if bool(fin.any()) else 0.0


def on_device(case, device):
    import torch
    return tuple(torch.from_numpy(a).to(device) for a in case)


def captured_kernel_inputs(run):
    """Runs ``run()`` with the pack's kernel call wrapped; returns its
    result and copies of every (tmask, zcmask, price) the pack passed, in
    call order."""
    from .ops import binpack
    captured = []
    orig = binpack.cheapest_offering

    def capture(tm, zc, pr):
        captured.append((tm.clone(), zc.clone(), pr.clone()))
        return orig(tm, zc, pr)

    binpack.cheapest_offering = capture
    try:
        out = run()
    finally:
        binpack.cheapest_offering = orig
    return out, captured


def captured_main_path_inputs(solve):
    """Runs ``solve()`` with the pack's kernel call wrapped; returns its
    result and copies of the last (tmask, zcmask, price) the pack passed."""
    out, captured = captured_kernel_inputs(solve)
    if not captured:
        raise AssertionError("the solve never reached the kernel's call")
    return out, captured[-1]


def profiled_device_ms(run):
    """(wall ms, summed device ms of every kernel, kernel launches) of one
    ``run()`` under ``torch.profiler``, synchronised at both ends. The
    device's idle share of the call is 1 - device / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # kernel records only: an aten op's own row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    return (wall_ms, sum(dev_us(e) for e in events) / 1e3,
            sum(e.count for e in events))
