#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (karpenter_provider_aws_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the package's CUDA source (csrc/offering_argmin.cu) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases (ties, all-infeasible
   bins, ragged T, ZC above one 128-lane tile); indices and finite values
   must be exactly equal. Times come from CUDA events, median of 100
   launches queued behind a device sleep so that no host gap is timed;
4. main path: the north-star wave (50k pods x the real 759-type catalog,
   3 NodePools) through ``Solver(lattice).solve_relaxed`` on ``cuda``.
   Kernel launch counts are zeroed just before one solve and read just
   after; the plan must place every pod, cost within 1.02x of the port's
   own FFD oracle, and equal the port's CPU plan node by node. Then the
   e2e p50 over 12 solves and the median stage times.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX and nothing of the JAX package, and checks that at the end.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
# float32 instructions outside the tensor cores: 132 SMs x 128 lanes x
# 1.98 GHz. The data sheet's 67 TFLOP/s counts each FMA as two operations;
# a compare is one instruction.
H100_F32_INSTR_PER_S = 33.5e12
SOLVES = 12


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _device_times_ms(fn, n: int = 100, sleep_cycles: int = 400_000_000):
    """Per-call device time of ``fn`` (ms): n calls enqueued behind a
    device sleep, one CUDA event between each, median of the gaps."""
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


def _kernel_cases(torch, dev):
    """(name, tmask, zcmask, price) edge cases for cheapest_offering."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand_case(B, T, ZC, p_t=0.4, p_zc=0.6, p_unavail=0.2):
        tm = torch.rand((B, T), generator=g) < p_t
        zc = torch.rand((B, ZC), generator=g) < p_zc
        pr = torch.rand((T, ZC), generator=g) + 0.01
        pr[torch.rand((T, ZC), generator=g) < p_unavail] = float("inf")
        return tm.to(dev), zc.to(dev), pr.to(dev)

    cases = [("random B=2048 T=759 ZC=10",) + rand_case(2048, 759, 10),
             ("ragged T=37 ZC=10",) + rand_case(300, 37, 10),
             ("ZC=130",) + rand_case(129, 200, 130)]
    # forced ties: every allowed offering costs the same
    tm, zc, _ = rand_case(512, 759, 10)
    cases.append(("ties", tm, zc, torch.full((759, 10), 2.5, device=dev)))
    # ties on a coarse price grid, so many bins have several minima
    tm, zc, pr = rand_case(2048, 759, 10)
    cases.append(("coarse-price ties", tm, zc, torch.floor(pr * 4) / 4))
    # all-infeasible bins: empty type masks, empty zc masks, all-inf prices
    tm, zc, pr = rand_case(256, 759, 10)
    tm[:64] = False
    zc[64:128] = False
    pr2 = pr.clone()
    pr2[:, :] = float("inf")
    cases.append(("all-infeasible (masks)", tm, zc, pr))
    cases.append(("all-infeasible (prices)", tm, zc, pr2))
    # the price panel above the 192 KB shared-memory chunk (streamed)
    cases.append(("streamed panel T=6000 ZC=10",) + rand_case(64, 6000, 10))
    return cases


def _check_pair(torch, name, got, want):
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


def _node_rows(plan):
    return [(n.node_pool, n.instance_type, n.zone, n.capacity_type,
             sorted(n.pods)) for n in plan.new_nodes]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return _fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        import karpenter_provider_aws_tpu_torch as port
    except ImportError as e:
        return _fail(f"the port package is not next to chip_smoke.py: {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        return _fail(f"imported the port from {port.__file__}, not from {HERE}")
    try:
        return _run(torch)
    except Exception:
        traceback.print_exc()
        return _fail("a phase failed (traceback above)")


def _run(torch) -> int:
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.ops import binpack, cuda_build
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    # ---- 1. card
    _phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card_line}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda")

    # ---- 2. build
    _phase("build")
    t = time.perf_counter()
    path = cuda_build.build("offering_argmin")
    build_s = time.perf_counter() - t
    print(f"built offering_argmin -> {os.path.relpath(path, HERE)}")
    for line in cuda_build.BUILD_LOGS.get("offering_argmin", "").splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")
    print(f"build seconds: {build_s:.3f}", flush=True)

    # ---- 3. kernels against their plain versions
    _phase("kernels")
    max_err = 0.0
    for name, tm, zc, pr in _kernel_cases(torch, dev):
        err = _check_pair(torch, name, oa.cheapest_offering(tm, zc, pr),
                          oa.cheapest_offering_ref(tm, zc, pr))
        max_err = max(max_err, err)
        print(f"cheapest_offering {name}: B={tm.shape[0]} T={tm.shape[1]} "
              f"ZC={zc.shape[1]} exact match", flush=True)

    # ---- 4. main path at full width
    _phase("main path: cfg5 (50k pods x real catalog)")
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config5_full_scale()
    print(f"lattice T={lattice.T} Z={lattice.Z} C={lattice.C}; "
          f"{len(pods)} pods, {len(pools)} pools", flush=True)
    solver = Solver(lattice)
    if solver.device.type != "cuda":
        raise AssertionError(f"Solver defaulted to {solver.device}")

    oa.LAUNCHES = 0
    t = time.perf_counter()
    plan = solver.solve_relaxed(pods, pools, existing=existing)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = {"cheapest_offering": oa.LAUNCHES}
    print(f"kernel launches in one solve: {launches}")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    placed = sum(len(n.pods) for n in plan.new_nodes) + sum(
        len(v) for v in plan.existing_assignments.values())
    print(f"plan: {len(plan.new_nodes)} nodes, ${plan.new_node_cost:.2f}/hr, "
          f"{placed} pods placed, {len(plan.unschedulable)} unschedulable, "
          f"cold solve {cold_s * 1e3:.1f} ms", flush=True)
    if plan.unschedulable or placed != len(pods) or len(pods) != 50000:
        raise AssertionError(f"placed {placed}/{len(pods)}, "
                             f"{len(plan.unschedulable)} unschedulable")

    problem = build_problem(pods, pools, lattice, existing=existing)
    t = time.perf_counter()
    oracle = ffd_oracle(problem)
    ratio = plan.new_node_cost / oracle.new_node_cost
    print(f"ffd oracle: {oracle.num_new_nodes} nodes, "
          f"${oracle.new_node_cost:.2f}/hr ({time.perf_counter() - t:.1f} s); "
          f"cost ratio {ratio:.6f}", flush=True)
    if not ratio <= 1.02:
        raise AssertionError(f"cost ratio {ratio} above 1.02")

    t = time.perf_counter()
    cpu_plan = Solver(lattice, device="cpu").solve_relaxed(
        pods, pools, existing=existing)
    print(f"cpu plan: {len(cpu_plan.new_nodes)} nodes "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    if _node_rows(plan) != _node_rows(cpu_plan) \
            or plan.existing_assignments != cpu_plan.existing_assignments:
        raise AssertionError("the card's plan differs from the CPU plan")
    print("card plan == cpu plan, node by node", flush=True)

    # e2e over repeated solves; the last one also captures the kernel's
    # main-path inputs for timing
    captured = []
    orig = binpack.cheapest_offering

    def capture(tm, zc, pr):
        captured.append((tm.clone(), zc.clone(), pr.clone()))
        return orig(tm, zc, pr)

    e2e, stages = [], {}
    for i in range(SOLVES):
        if i == SOLVES - 1:
            binpack.cheapest_offering = capture
        try:
            t = time.perf_counter()
            p = solver.solve_relaxed(pods, pools, existing=existing)
            torch.cuda.synchronize()
            e2e.append((time.perf_counter() - t) * 1e3)
        finally:
            binpack.cheapest_offering = orig
        for k, v in p.stage_ms.items():
            stages.setdefault(k, []).append(v)
        if len(p.new_nodes) != len(plan.new_nodes):
            raise AssertionError("a repeated solve changed the plan")
    stage_p50 = {k: round(statistics.median(v), 3) for k, v in stages.items()}
    print(f"cfg5 e2e p50 {statistics.median(e2e):.3f} ms over {SOLVES} solves "
          f"(min {min(e2e):.3f}, max {max(e2e):.3f}); stage p50 ms {stage_p50}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)

    # ---- kernel times at the main path's own inputs
    _phase("kernel timing at the main path's shapes")
    tm, zc, pr = captured[-1]
    max_err = max(max_err, _check_pair(
        torch, "main-path inputs", oa.cheapest_offering(tm, zc, pr),
        oa.cheapest_offering_ref(tm, zc, pr)))
    B, T = tm.shape
    ZC = zc.shape[1]
    ms, waited_k = _device_times_ms(lambda: oa.cheapest_offering(tm, zc, pr))
    plain_ms, waited_p = _device_times_ms(lambda: oa.cheapest_offering_ref(tm, zc, pr))
    nbytes = B * T + B * ZC + T * ZC * 4 + B * 8
    n_ops = int((tm.sum(dim=1).to(torch.int64) * zc.sum(dim=1).to(torch.int64)).sum())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_INSTR_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"cheapest_offering at B={B} T={T} ZC={ZC}: kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms (median of 100 device times; host waited "
          f"{waited_k * 1e3:.1f} / {waited_p * 1e3:.1f} ms after enqueue); "
          f"bound {bound_ms * 1e3:.4f} us ({nbytes} bytes, {n_ops} compares)",
          flush=True)

    # ---- nothing of JAX was loaded
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "karpenter_provider_aws_tpu"
                    or m.startswith("karpenter_provider_aws_tpu."))
    if leaked:
        raise AssertionError(f"modules of JAX or the JAX package loaded: {leaked[:5]}")

    print(json.dumps({"kernels": [{
        "name": "cheapest_offering", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/offering_argmin.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/offering_argmin.py:92",
        "launches": launches["cheapest_offering"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"B": B, "T": T, "ZC": ZC},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
