#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (karpenter_provider_aws_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the package's CUDA source (csrc/offering_argmin.cu) with nvcc,
   printing ptxas's registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   on every case of ``ops/offering_cases.py`` (the main path's shapes,
   ties, all-infeasible bins, unaligned rows, T of 1 to 6000, ZC of 1 to
   130, uint8 masks, sparse and dense bins); indices and finite values
   must be exactly equal;
4. main path: the north-star wave (50k pods x the real 759-type catalog,
   3 NodePools) through ``Solver(lattice).solve_relaxed`` on ``cuda``.
   Kernel launch counts are zeroed just before one solve and read just
   after; the plan must place every pod, cost within 1.02x of the port's
   own FFD oracle, and equal the port's CPU plan node by node. Then the
   e2e p50 over 12 solves and the median stage times;
5. kernel timing: the kernel and its plain version at the main path's
   own inputs (captured in the last solve) and at the dense largest bin
   bucket (B=8192), and the card's launch floor (a one-element in-place
   add), each the median of 100 device times from CUDA events, queued
   behind a device sleep so that no host gap is timed.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX and nothing of the JAX package, and checks that at the end.
"""

import json
import os
import statistics
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SOLVES = 12


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _kernel_cases(dev):
    """(name, tmask, zcmask, price) on the card for cheapest_offering:
    every case of ``ops/offering_cases.py``, made from numpy seeds."""
    from karpenter_provider_aws_tpu_torch.measure import on_device
    from karpenter_provider_aws_tpu_torch.ops import offering_cases
    for name, make in offering_cases.kernel_cases().items():
        yield (name,) + on_device(make(), dev)


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
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.ops import cuda_build, offering_cases
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    # ---- 1. card
    _phase("card")
    print(f"nvidia-smi: {measure.card_line()}")
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
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    print(f"build seconds: {build_s:.3f}", flush=True)

    # ---- 3. kernels against their plain versions
    _phase("kernels")
    max_err = 0.0
    for name, tm, zc, pr in _kernel_cases(dev):
        err = measure.check_exact(name, oa.cheapest_offering(tm, zc, pr),
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

    # e2e over repeated solves
    e2e, stages = [], {}
    for _ in range(SOLVES):
        t = time.perf_counter()
        p = solver.solve_relaxed(pods, pools, existing=existing)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t) * 1e3)
        for k, v in p.stage_ms.items():
            stages.setdefault(k, []).append(v)
        if len(p.new_nodes) != len(plan.new_nodes):
            raise AssertionError("a repeated solve changed the plan")
    stage_p50 = {k: round(statistics.median(v), 3) for k, v in stages.items()}
    print(f"cfg5 e2e p50 {statistics.median(e2e):.3f} ms over {SOLVES} solves "
          f"(min {min(e2e):.3f}, max {max(e2e):.3f}); stage p50 ms {stage_p50}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)

    # ---- 5. kernel times: the main path's own inputs, the dense largest
    # bucket, the launch floor
    _phase("kernel timing")
    _, main_inputs = measure.captured_main_path_inputs(
        lambda: solver.solve_relaxed(pods, pools, existing=existing))
    timed = {}
    for name, (tm, zc, pr) in (
            ("main path", main_inputs),
            ("dense", measure.on_device(offering_cases.dense_case(), dev))):
        max_err = max(max_err, measure.check_exact(
            f"{name} inputs", oa.cheapest_offering(tm, zc, pr),
            oa.cheapest_offering_ref(tm, zc, pr)))
        ms, waited_k = measure.device_times_ms(lambda: oa.cheapest_offering(tm, zc, pr))
        plain_ms, waited_p = measure.device_times_ms(
            lambda: oa.cheapest_offering_ref(tm, zc, pr))
        bound_ms, bound_by, nbytes, n_ops = measure.bound(tm, zc, pr)
        B, T = tm.shape
        ZC = zc.shape[1]
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "shape": {"B": B, "T": T, "ZC": ZC}}
        print(f"cheapest_offering, {name} B={B} T={T} ZC={ZC}: kernel {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms (median of 100 device times; host waited "
              f"{waited_k * 1e3:.1f} / {waited_p * 1e3:.1f} ms after enqueue); "
              f"bound {bound_ms * 1e3:.4f} us by {bound_by} ({nbytes} bytes, "
              f"{n_ops} compares)", flush=True)
    floor_ms = measure.launch_floor_ms(dev)
    print(f"launch floor (one-element in-place add): {floor_ms:.6f} ms", flush=True)

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
        **timed["main path"], "library_ms": None,
        "launch_floor_ms": floor_ms, "dense": timed["dense"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
