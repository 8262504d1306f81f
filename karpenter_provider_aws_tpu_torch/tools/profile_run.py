"""profile_run, for this package: the continuous-profiling artifact.

The counterpart of the repository's ``tools/profile_run.py``. It drives
the SAME 15k-pod API-mode workload twice, once with the sampling profiler
on (50 Hz) and once as an unprofiled control, through the full protocol
path (KubeClient writes -> admission -> informers -> provisioning passes
-> watch fan-out), with the Operator's Solver on ``--device`` (default
``cuda``), and records:

- the top write-path / watch-fan-out frames (the profile filtered to
  kube/writer.py, kube/apiserver.py, operator/sync.py, kube/informer.py)
  and the overall top frames,
- the top contended locks (wait p99 + owner-at-contention tags),
- the device cost model's measured-vs-best per shape,
- the profiler's overhead: the wall-time delta against the control run
  and the sampler's self-measured cost (the reference's <5 % bound),
- any burn-triggered captures the run produced.

    python -m karpenter_provider_aws_tpu_torch.tools.profile_run \\
        [--pods 15000] [--hz 50] [--device cuda] [--out PROF_gpu_r01.json]
"""

from __future__ import annotations

import argparse
import gc
import json
import time

WRITE_PATH_FILES = ("writer.py", "apiserver.py", "sync.py", "informer.py",
                    "client.py", "httpserver.py")
DEFAULT_OUT = "PROF_gpu_r01.json"
# the shared warmup: a small churn run, then the Solver's own bucket
# ladder up to the B buckets a 15k-pod run's growing existing-bin table
# reaches
WARMUP_PODS = 1000
WARMUP_G_BUCKETS = (16, 32)
WARMUP_B_BUCKETS = (32, 128, 512, 1024, 2048)


def real_lattice():
    from ..lattice import build_lattice
    from ..lattice.realdata import load_catalog
    return build_lattice(load_catalog(require_price=True))


def _api_operator(lattice, device, registration_delay):
    from ..kube import FakeAPIServer, KubeClient
    from ..operator import Operator, Options
    api = FakeAPIServer()
    op = Operator(options=Options(registration_delay=registration_delay,
                                  batch_idle_duration=0.05,
                                  batch_max_duration=0.5),
                  lattice=lattice, api_server=api, device=device)
    return KubeClient(api), op


SIZES = [(250, 512), (500, 1024), (1000, 2048), (2000, 4096)]


def run_workload(lattice, pods: int, profile: bool, hz: float = 50.0,
                 label: str = "", device=None):
    """One THREADED API-mode churn run (every controller on its own
    cadence): pod waves through the protocol (admission -> store -> watch
    -> informer thread -> mirror) while the provisioner, lifecycle and
    metrics threads run concurrently, so locks contend for real. Returns
    (wall_seconds, op, profiler)."""
    from .. import introspect
    from ..apis import Pod
    from ..introspect import SamplingProfiler
    from ..operator.runtime import ControllerRuntime, operator_specs

    client, op = _api_operator(lattice, device, registration_delay=0.1)
    prof = None
    if profile:
        prof = SamplingProfiler(hz=hz).start()
        introspect.set_profiler(prof)
    rt = ControllerRuntime(operator_specs(op)).start()
    t0 = time.perf_counter()
    created = 0
    wave = 0
    try:
        while created < pods:
            wave += 1
            n = min(1500, pods - created)
            for i in range(n):
                cpu, mem = SIZES[(created + i) % len(SIZES)]
                client.create_pod(Pod(
                    name=f"prof-{label}w{wave}-{i}",
                    requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}))
            created += n
            # let the threaded control plane mostly drain this wave
            # before the next (bounded): sustained back-to-back passes
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if len(op.cluster.pending_pods()) < 200:
                    break
                time.sleep(0.05)
        # full drain
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if not op.cluster.pending_pods():
                break
            time.sleep(0.1)
    finally:
        wall = time.perf_counter() - t0
        # pending at RUN END: nomination expiry against stopped
        # controllers would re-pend pods later
        op.final_pending = len(op.cluster.pending_pods())
        while not rt.stop():
            print("profile_run: waiting for a blocked controller...")
        if prof is not None:
            prof.stop()
    return wall, op, prof


def run_deterministic(lattice, pods: int, profile: bool, hz: float = 50.0,
                      label: str = "", device=None):
    """The overhead-measurement stratum: the SAME single-threaded API-mode
    pump (sync -> provision -> lifecycle -> sync, no sleeps, no thread
    scheduling) executes an identical operation sequence with and without
    the profiler sampling over it, so the wall-clock ratio measures the
    profiler, not workload scatter."""
    from .. import introspect
    from ..apis import Pod
    from ..introspect import SamplingProfiler

    client, op = _api_operator(lattice, device, registration_delay=0.0)
    prof = None
    if profile:
        prof = SamplingProfiler(hz=hz).start()
        introspect.set_profiler(prof)
    # GC symmetry: constructing this Operator released the previous run's
    # introspection providers; collect now and keep the collector off for
    # the measured window, so neither run drags the other's heap
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        created = 0
        wave = 0
        while created < pods:
            wave += 1
            n = min(1500, pods - created)
            for i in range(n):
                cpu, mem = SIZES[(created + i) % len(SIZES)]
                client.create_pod(Pod(
                    name=f"det-{label}w{wave}-{i}",
                    requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}))
            created += n
            for _ in range(60):
                op.sync_once()
                if op.cluster.pending_pods():
                    op.provisioner.provision_once()
                op.lifecycle.reconcile()
                op.sync_once()
                if not op.cluster.pending_pods():
                    break
            op.emit_gauges()
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    op.final_pending = len(op.cluster.pending_pods())
    if prof is not None:
        prof.stop()
    return wall, op, prof


def shared_warmup(lattice, device):
    """Whichever run goes FIRST would otherwise pay the first use of the
    scan's kernels and the allocator's first pools. A small churn run
    warms the protocol path, then the Solver's own bucket ladder runs up
    to the B buckets a 15k-pod run reaches."""
    print(f"profile_run: warmup run ({WARMUP_PODS} pods + solver ladder)...")
    warm_wall, warm_op, _ = run_deterministic(lattice, WARMUP_PODS,
                                              profile=False, label="warm",
                                              device=device)
    warm_op.solver.warmup(node_pools_count=len(warm_op.node_pools),
                          g_buckets=WARMUP_G_BUCKETS,
                          b_buckets=WARMUP_B_BUCKETS)
    print(f"profile_run: warmup {warm_wall:.1f}s")


def filtered_top(prof, files, n=10):
    """Top frames restricted to the given source files."""
    return [d for d in prof.top(400)
            if any(d["frame"].startswith(f + ":") for f in files)][:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=15000)
    ap.add_argument("--hz", type=float, default=50.0)
    ap.add_argument("--device", default="cuda",
                    help="the Operator's Solver device (default cuda; "
                         "raises without a card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from .. import introspect
    from ..bench import device_detail
    from ..device import resolve_device
    from ..introspect import contention
    from ..solver import costmodel

    device = resolve_device(args.device)
    lattice = real_lattice()
    shared_warmup(lattice, device)

    # ---- overhead stratum: deterministic pair, identical op sequence.
    # PROFILED first: warm-up residue lands on the profiled side, so the
    # measurement is an upper bound.
    print(f"profile_run: deterministic profiled run ({args.pods} pods, "
          f"{args.hz} Hz)...")
    det_p_wall, det_p_op, det_prof = run_deterministic(
        lattice, args.pods, profile=True, hz=args.hz, label="p",
        device=device)
    det_p_pass_p50 = det_p_op.slo.latency_percentiles()[0]
    det_p_nodes = len(det_p_op.cluster.nodes)
    det_p_pending = det_p_op.final_pending
    det_pstats = det_prof.stats()
    det_samples = det_prof.samples
    print(f"profile_run: det profiled {det_p_wall:.1f}s, "
          f"nodes={det_p_nodes}, samples={det_samples}")
    # drop this run's graph BEFORE the control run
    del det_p_op, det_prof
    print(f"profile_run: deterministic control run ({args.pods} pods)...")
    det_c_wall, det_c_op, _ = run_deterministic(
        lattice, args.pods, profile=False, label="c", device=device)
    det_c_pass_p50 = det_c_op.slo.latency_percentiles()[0]
    det_c_nodes = len(det_c_op.cluster.nodes)
    print(f"profile_run: det control {det_c_wall:.1f}s, "
          f"nodes={det_c_nodes}")
    del det_c_op
    if det_p_nodes != det_c_nodes:
        print(f"profile_run: WARNING det runs diverged ({det_p_nodes} vs "
              f"{det_c_nodes} nodes): overhead comparison weakened")
    control_wall, wall = det_c_wall, det_p_wall
    control_pass_p50, prof_pass_p50 = det_c_pass_p50, det_p_pass_p50

    # ---- attribution stratum: the THREADED runtime with the profiler on
    print(f"profile_run: threaded attribution run ({args.pods} pods, "
          f"{args.hz} Hz)...")
    # fresh contention accounting: the lock table describes THIS run
    contention.reset()
    thr_wall, op, prof = run_workload(lattice, args.pods, profile=True,
                                      hz=args.hz, label="t", device=device)
    print(f"profile_run: threaded {thr_wall:.1f}s, "
          f"nodes={len(op.cluster.nodes)}, samples={prof.samples}, "
          f"pending_at_end={op.final_pending}")

    overhead_pct = 100.0 * (wall - control_wall) / control_wall
    pstats = prof.stats()
    top_locks = [
        {"lock": name, "waitP99Ms": round(p99 * 1e3, 3), "contended": n,
         "owners": contention._stats_for(name).owner_tags}
        for name, p99, n in contention.top_waits(5)]
    bc = introspect.burn_capture()
    doc = {
        "artifact": "PROF_gpu_r01",
        "what": "15k-pod API-mode churn with the continuous-profiling "
                "layer on: write-path/watch-fan-out frame attribution, "
                "lock contention, device cost model, and measured "
                "profiler overhead vs an unprofiled control run",
        "pods": args.pods,
        "api_mode": True,
        "device": device_detail(device),
        "profiler": {
            "hz": args.hz,
            "threaded_run_samples": prof.samples,
            "threaded_unique_stacks": pstats["unique_stacks"],
            "dropped_stacks": pstats["dropped_stacks"],
            "self_measured_overhead_pct": pstats["overhead_pct"],
            "avg_sample_ms": pstats["avg_sample_ms"],
        },
        "overhead": {
            "methodology": "deterministic single-threaded API-mode pump "
                           "executing an IDENTICAL operation sequence "
                           "with/without the sampler; profiled run FIRST "
                           "after a shared warmup (churn + the solver's "
                           "bucket ladder), so residue, if any, lands on "
                           "the profiled side: an upper bound",
            "control_wall_seconds": round(control_wall, 2),
            "profiled_wall_seconds": round(wall, 2),
            "e2e_overhead_pct": round(overhead_pct, 2),
            "control_pass_p50_ms": round(control_pass_p50 * 1e3, 2),
            "profiled_pass_p50_ms": round(prof_pass_p50 * 1e3, 2),
            "pass_p50_overhead_pct": round(
                100.0 * (prof_pass_p50 - control_pass_p50)
                / control_pass_p50, 2) if control_pass_p50 else None,
            "det_runs_node_parity": det_p_nodes == det_c_nodes,
            "det_profiler_samples": det_samples,
            "det_self_measured_overhead_pct": det_pstats["overhead_pct"],
            "bound_pct": 5.0,
            "within_bound": overhead_pct < 5.0,
        },
        "top_frames_overall": prof.top(15),
        "top_frames_write_path": filtered_top(prof, WRITE_PATH_FILES),
        "top_contended_locks": top_locks,
        "contention": {k: v for k, v in contention.stats().items()
                       if not k.endswith("_acquisitions")},
        "device_cost_model": costmodel.model().summary(),
        "burn_captures": bc.doc() if bc is not None else {},
        "parity": {
            "det_control_nodes": det_c_nodes,
            "det_profiled_nodes": det_p_nodes,
            "det_pending_at_end": det_p_pending,
            "threaded_nodes": len(op.cluster.nodes),
            "threaded_wall_seconds": round(thr_wall, 2),
            "threaded_pending_at_end": op.final_pending,
        },
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"profile_run: wrote {args.out}")
    print(f"  e2e overhead {overhead_pct:+.2f}% (bound 5%), "
          f"self-measured {pstats['overhead_pct']:.2f}%")
    print("  top write-path frames:")
    for d in doc["top_frames_write_path"][:3]:
        print(f"    {d['frame']}  incl={d['inclusive']} self={d['self']}")
    print("  top contended locks:")
    for d in top_locks[:3]:
        print(f"    {d['lock']}  p99={d['waitP99Ms']}ms "
              f"contended={d['contended']}")
    introspect.set_profiler(None)
    ok = (overhead_pct < 5.0 and det_p_pending == 0
          and op.final_pending == 0)
    print(f"profile_run: {'OK' if ok else 'VIOLATED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
