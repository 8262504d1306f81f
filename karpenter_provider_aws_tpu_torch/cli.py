"""Standalone controller entrypoint.

The analog of the reference's `cmd/controller/main.go:32` (operator
construction + controller registration + serving) with the flag surface of
`pkg/operator/options/options.go:46-60`: every flag falls back to its env
var (CLUSTER_NAME, VM_MEMORY_OVERHEAD_PERCENT, INTERRUPTION_QUEUE, ...)
the way the reference's `env.WithDefault*` wiring does, and feature gates
take the reference's `--feature-gates Drift=true,...` form
(settings.md:40-47).

While the reconcile loop runs, the process serves:
- ``/metrics``  — the Prometheus text exposition of the registry
  (including the per-offering lattice gauge surface),
- ``/validate`` — the HTTP admission endpoint (POST an AdmissionReview-
  shaped document; schema + semantic validation answer allowed/denied —
  the reference serves the same contract from pkg/webhooks)
- ``/healthz`` and ``/readyz`` — liveness/readiness, mirroring the
  operator's AddHealthzCheck wiring (main.go:44).

The port of the JAX package's CLI, with one flag of its own: ``--device``
(default ``cuda``) is where the Solver's tensors live, passed to the
Operator; without CUDA it raises, and ``--device cpu`` runs the plain
PyTorch path. No environment variable replaces it.
``--compile-cache-dir`` (``COMPILE_CACHE_DIR``) is where the kernel
libraries and the native referee are built and loaded, so a restarted
process runs neither ``nvcc`` nor ``g++``. ``--warm-start`` runs the
Solver's boot bucket ladder on the card on a background thread while the
SLO warmup window is open (with a cache directory it builds every kernel
source first and records each shape's analysis), ``--profile`` fills the
device cost model from the ladder's analyses on a ``costmodel-capture``
thread, and ``--profile-dir`` writes a ``torch.profiler`` trace of the run
there on the way out. ``--mesh N`` runs N pod shards on
min(N, visible cards) ranks, one card each (parallel/ranks.py); on one
card, or the CPU, batched on the ``--device``.
``--sidecar-address`` also serves the Operator's Solver as a solver
sidecar, and ``--solver-address`` (``SOLVER_ADDRESSES``) delegates the
provisioning solves to a pool of sidecars (parallel/sidecar.py, pool.py).

A device error that takes the CUDA context (``errors.DeviceLostError``: a
sticky error such as a device-side assert) ends the run after its pass
with exit code ``EXIT_DEVICE_LOST`` (75), so that the deployment restarts
the process with a fresh context instead of failing every later pass.

Run it as ``python -m karpenter_provider_aws_tpu_torch [flags]`` or as the
``karpenter-tpu-controller-torch`` console script.
"""

from __future__ import annotations

import argparse
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from .errors import EXIT_DEVICE_LOST
from .operator import Operator, Options
from .webhooks import validate_wire

_GATES = {
    "Drift": "drift_enabled",
    "SpotToSpotConsolidation": "spot_to_spot_consolidation",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="karpenter-tpu-controller-torch",
        description="karpenter controller on one CUDA card (device-solved "
                    "scheduling over an instance-type lattice).")
    p.add_argument("--device", default="cuda",
                   help="Device of the solver's tensors: 'cuda' (default; "
                        "raises without CUDA) or 'cpu' (the plain PyTorch "
                        "path).")
    p.add_argument("--cluster-endpoint", default=None,
                   help="apiserver endpoint for node bootstrap userdata "
                        "(env CLUSTER_ENDPOINT; empty = discover from the "
                        "cloud network, the reference's EKS fallback)")
    p.add_argument("--assume-role-arn", default=None,
                   help="role to assume for cloud calls "
                        "(env ASSUME_ROLE_ARN; reference STS session "
                        "layering)")
    p.add_argument("--cluster-name", default=None,
                   help="The cluster name for resource discovery "
                        "(env CLUSTER_NAME).")
    p.add_argument("--vm-memory-overhead-percent", type=float, default=None,
                   help="VM memory overhead subtracted from every instance "
                        "type's memory (env VM_MEMORY_OVERHEAD_PERCENT, "
                        "default 0.075).")
    p.add_argument("--isolated-vpc", action="store_true", default=None,
                   help="Assume AWS services without a VPC endpoint are "
                        "unreachable; live on-demand pricing lookups are "
                        "skipped and static prices serve (ISOLATED_VPC)")
    p.add_argument("--reserved-enis", type=int, default=None,
                   help="ENIs excluded from max-pods math "
                        "(env RESERVED_ENIS).")
    p.add_argument("--batch-idle-duration", type=float, default=None,
                   help="Seconds of pod-arrival quiet before a scheduling "
                        "pass (env BATCH_IDLE_DURATION, default 1).")
    p.add_argument("--batch-max-duration", type=float, default=None,
                   help="Max seconds a scheduling batch may wait "
                        "(env BATCH_MAX_DURATION, default 10).")
    p.add_argument("--interruption-queue", default=None,
                   help="Interruption queue name; interruption handling is "
                        "disabled if not specified "
                        "(env INTERRUPTION_QUEUE).")
    p.add_argument("--termination-grace-period", type=float, default=None,
                   help="Seconds after which a terminating node force-drains "
                        "even PDB-blocked pods; unset waits forever "
                        "(env TERMINATION_GRACE_PERIOD).")
    p.add_argument("--feature-gates", default=None,
                   help="Comma-separated gates, e.g. "
                        "'Drift=true,SpotToSpotConsolidation=false'.")
    p.add_argument("--log-level", default="INFO",
                   choices=("DEBUG", "INFO", "WARNING", "ERROR"),
                   help="Structured log verbosity (key=value lines on the "
                        "karpenter.* loggers)")
    p.add_argument("--metrics-port", type=int, default=8000,
                   help="Port serving /metrics, /healthz, /readyz "
                        "(0 disables).")
    p.add_argument("--warm-start", action="store_true",
                   help="Run the Solver's boot (G, B) bucket ladder on the "
                        "--device on a background thread at start (the "
                        "SLO warmup window stays open until it ends), so "
                        "the first real pass does not pay the cold cost. "
                        "With --compile-cache-dir set, every kernel source "
                        "is built into it first and each shape's analysis "
                        "fills the device cost model.")
    p.add_argument("--compile-cache-dir", default=None,
                   help="Directory the CUDA kernel libraries (nvcc) and the "
                        "native referee (g++) are built into and loaded "
                        "from (env COMPILE_CACHE_DIR): each library's name "
                        "carries its source, flags and compiler version, "
                        "so a restarted process loads them without "
                        "building and another toolkit's are never served. "
                        "Empty builds in the package's own _build/.")
    p.add_argument("--profile-dir", default=None,
                   help="Profile every solve with torch.profiler (CPU and "
                        "CUDA activity, a named span per pack call) and "
                        "write the Chrome trace under this directory on "
                        "exit.")
    p.add_argument("--profile", action="store_true",
                   help="Run the whole-process wall-clock sampling "
                        "profiler (docs/reference/profiling.md): a daemon "
                        "thread samples every thread's stack at "
                        "--profile-hz into a bounded folded-stack store, "
                        "served at /debug/pprof/profile (folded / "
                        "Chrome-trace forms) on both the metrics server "
                        "and the REST apiserver; kpctl profile "
                        "capture|top|diff is the CLI. Lock/queue "
                        "contention accounting and the device cost model "
                        "report regardless; this flag adds the stack "
                        "sampler (<5%% overhead measured, zero when off).")
    p.add_argument("--profile-hz", type=float, default=50.0,
                   help="Sampling frequency for --profile (default 50).")
    p.add_argument("--profile-captures", type=int, default=8,
                   help="Burn-triggered profile+contention snapshots "
                        "retained (flight-recorder-style ring): a "
                        "sustained SLO burn or a grossly over-budget "
                        "pass captures evidence at /debug/pprof/captures.")
    p.add_argument("--trace", action="store_true",
                   help="Enable request-scoped tracing + the flight "
                        "recorder (docs/reference/tracing.md): causal "
                        "spans from REST admission to the device solve, "
                        "tail-sampled retention of degraded/slow/errored "
                        "traces, served at /debug/traces (REST apiserver "
                        "and metrics server) and exported by kpctl trace.")
    p.add_argument("--trace-ring", type=int, default=256,
                   help="Completed traces kept in the flight recorder's "
                        "ring before the oldest unretained one drops.")
    p.add_argument("--trace-retained", type=int, default=64,
                   help="Tail-retained traces (errored / degraded / over "
                        "budget) pinned past ring wrap-around.")
    p.add_argument("--trace-latency-budget-ms", type=float, default=1000.0,
                   help="End-to-end trace duration above which the flight "
                        "recorder tail-retains the trace as 'slow'.")
    p.add_argument("--sidecar-address", default=None,
                   help="Also serve the solver as a gRPC sidecar on this "
                        "address (e.g. unix:/run/karpenter/solver.sock or "
                        ":50051) so external controllers can Solve() "
                        "against the resident lattice.")
    p.add_argument("--mesh", default=None,
                   help="Device mesh for the sharded solver (env "
                        "SOLVER_MESH): an integer N splits every solve "
                        "(full, wave-split and the steady-state delta) "
                        "into N pod shards on min(N, visible cards) "
                        "ranks, a process per card in one NCCL group (on "
                        "one card, or the CPU, one batched pass on the "
                        "--device), then merges their tail bins; 'auto' "
                        "(default) plans the single-device path however "
                        "many cards are visible, since the mesh is slower "
                        "than one device even with a card per shard; "
                        "'off' or 1 pins the single-device path.")
    p.add_argument("--solver-address", default=None,
                   help="Delegate provisioning solves to a POOL of solver "
                        "sidecar processes: a comma-separated list of "
                        "gRPC addresses (python -m "
                        "karpenter_provider_aws_tpu_torch.parallel.sidecar; "
                        "env SOLVER_ADDRESSES, singular SOLVER_ADDRESS still "
                        "works). Each endpoint gets a circuit breaker "
                        "with health-checked half-open probation; solves "
                        "fail over to the least-loaded healthy endpoint, "
                        "and the local solver (on --device) is the final "
                        "rung only when the whole pool is dark "
                        "(docs/reference/solver-pool.md).")
    p.add_argument("--solver-solve-deadline", type=float, default=None,
                   help="Solve RPC deadline in seconds against pool "
                        "endpoints (env SOLVER_SOLVE_DEADLINE; 0 = "
                        "derive from the SLO latency budget x 50, i.e. "
                        "10 s at the 200 ms bar). A hung sidecar costs "
                        "at most one deadline before its breaker opens.")
    p.add_argument("--solver-health-deadline", type=float, default=None,
                   help="Health/liveness RPC deadline in seconds (env "
                        "SOLVER_HEALTH_DEADLINE, default 1.0): probes "
                        "against a hung sidecar answer in about a "
                        "second instead of a solve timeout.")
    p.add_argument("--duration", type=float, default=0.0,
                   help="Run for this many seconds then exit "
                        "(0 = run until SIGINT/SIGTERM).")
    p.add_argument("--step", type=float, default=1.0,
                   help="Seconds between reconcile passes "
                        "(single-threaded loop only).")
    p.add_argument("--async-runtime", action="store_true",
                   help="Run each controller on its own cadence in its own "
                        "thread (the controller-runtime analog with "
                        "MaxConcurrentReconciles-style concurrency) instead "
                        "of the deterministic single-threaded loop.")
    p.add_argument("--api-host", default="127.0.0.1",
                   help="Bind host for --api-port (default loopback). "
                        "Binding beyond loopback requires TLS + a bearer "
                        "token, or the explicit --api-insecure opt-out: "
                        "the REST surface is write-capable.")
    p.add_argument("--api-token-file", default=None,
                   help="File holding the bearer token every REST / "
                        "admission request must present "
                        "(Authorization: Bearer <token>; 401 otherwise).")
    p.add_argument("--api-tls-cert", default=None,
                   help="PEM certificate for serving the REST apiserver "
                        "and admission endpoint over HTTPS "
                        "(deploy/gen_certs.sh mints self-signed material).")
    p.add_argument("--api-tls-key", default=None,
                   help="PEM private key matching --api-tls-cert.")
    p.add_argument("--api-watch-queue-bound", type=int, default=None,
                   help="Per-watcher event queue bound on the REST "
                        "apiserver's watch hub (env API_WATCH_QUEUE_BOUND, "
                        "default 8192): a subscriber that overruns it is "
                        "dropped to 410/relist instead of growing an "
                        "unbounded queue (docs/reference/watch.md)")
    p.add_argument("--api-bookmark-every", type=int, default=None,
                   help="Deliveries between per-watcher BOOKMARK events "
                        "carrying the current resourceVersion (env "
                        "API_BOOKMARK_EVERY, default 256; 0 disables) — "
                        "keeps idle watchers' resume points fresh")
    p.add_argument("--headroom-high-water-fraction", type=float,
                   default=None,
                   help="Occupancy fraction at which a bounded queue "
                        "counts as saturating (env "
                        "HEADROOM_HIGH_WATER_FRACTION, default 0.9): "
                        "crossing it fires one burn-capture per episode "
                        "(docs/reference/headroom.md)")
    p.add_argument("--api-insecure", action="store_true",
                   help="Explicitly allow serving the write-capable REST "
                        "surface beyond loopback WITHOUT TLS + token.")
    p.add_argument("--api-port", type=int, default=0,
                   help="Serve the control plane's apiserver over HTTP "
                        "REST on this port (kube/httpserver.py: "
                        "list/watch/create/update/patch/delete + "
                        "binding/eviction subresources). The operator "
                        "runs in API mode: controllers write through "
                        "the client, informers feed the mirror, and "
                        "EXTERNAL agents drive the same seam over the "
                        "wire. 0 disables (direct mode).")
    p.add_argument("--leader-elect-lease-file", default=None,
                   help="Enable lease-based leader election over this "
                        "shared file (async runtime only): standby "
                        "replicas idle until the lease is won, mirroring "
                        "the reference's 2-replica client-go election.")
    return p


def options_from_args(args: argparse.Namespace) -> Options:
    overrides = {}
    if args.cluster_name is not None:
        overrides["cluster_name"] = args.cluster_name
    if args.cluster_endpoint is not None:
        overrides["cluster_endpoint"] = args.cluster_endpoint
    if args.assume_role_arn is not None:
        overrides["assume_role_arn"] = args.assume_role_arn
    if args.vm_memory_overhead_percent is not None:
        overrides["vm_memory_overhead_percent"] = args.vm_memory_overhead_percent
    if args.reserved_enis is not None:
        overrides["reserved_enis"] = args.reserved_enis
    if args.isolated_vpc:
        overrides["isolated_vpc"] = True
    if args.batch_idle_duration is not None:
        overrides["batch_idle_duration"] = args.batch_idle_duration
    if args.batch_max_duration is not None:
        overrides["batch_max_duration"] = args.batch_max_duration
    if args.interruption_queue is not None:
        overrides["interruption_queue"] = args.interruption_queue
    if args.termination_grace_period is not None:
        overrides["termination_grace_period"] = args.termination_grace_period
    if args.solver_address is not None:
        overrides["solver_address"] = args.solver_address
    if args.solver_solve_deadline is not None:
        overrides["solver_solve_deadline"] = args.solver_solve_deadline
    if args.solver_health_deadline is not None:
        overrides["solver_health_deadline"] = args.solver_health_deadline
    if args.mesh is not None:
        overrides["mesh"] = args.mesh
    if args.compile_cache_dir is not None:
        overrides["compile_cache_dir"] = args.compile_cache_dir
    if args.api_watch_queue_bound is not None:
        overrides["api_watch_queue_bound"] = args.api_watch_queue_bound
    if args.api_bookmark_every is not None:
        overrides["api_bookmark_every"] = args.api_bookmark_every
    if args.headroom_high_water_fraction is not None:
        overrides["headroom_high_water_fraction"] = \
            args.headroom_high_water_fraction
    for gate in (args.feature_gates or "").split(","):
        gate = gate.strip()
        if not gate:
            continue
        name, _, val = gate.partition("=")
        field = _GATES.get(name.strip())
        if field is None:
            raise SystemExit(
                f"unknown feature gate {name!r} (known: {sorted(_GATES)})")
        val = val.strip().lower()
        if val in ("true", "1", "yes"):
            overrides[field] = True
        elif val in ("false", "0", "no"):
            overrides[field] = False
        else:
            raise SystemExit(
                f"feature gate {name.strip()}: value {val!r} is not true/false")
    return Options.from_env(**overrides)


def start_server(op: Operator, port: int,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None) -> ThreadingHTTPServer:
    """Serve /metrics, /healthz, /readyz and POST /validate on a daemon
    thread; ``certfile``/``keyfile`` serve it all over HTTPS (the
    reference's webhook cert posture; the TLS handshake runs
    per-connection, kube/httpserver.py). The whole surface is
    deliberately token-free: metrics/health are the scrape/probe
    contract, and /validate must be callable by a kube-apiserver webhook
    client, which authenticates the SERVER via the caBundle but sends no
    bearer token — and validation is a pure function with nothing to
    protect. Port 0 binds an ephemeral port (server.server_address
    reports it)."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            # HTTP admission endpoint (reference pkg/webhooks/webhooks.go
            # serves knative-style admission). Two review dialects:
            # - native: {"kind": <plural>, "spec": <wire dict>} →
            #   {"allowed": bool, "causes": [...]}
            # - AdmissionReview v1 (what a real kube-apiserver POSTs per
            #   deploy/templates/webhooks.yaml): {"kind":
            #   "AdmissionReview", "request": {"uid", "resource":
            #   {"resource": <plural>}, "object": {"spec": ...}}} →
            #   the AdmissionReview response envelope.
            if self.path not in ("/validate", "/validate/"):
                self.send_error(404)
                return
            import json as _json
            try:
                length = int(self.headers.get("Content-Length", "0"))
                review = _json.loads(self.rfile.read(length) or b"{}")
                if review.get("kind") == "AdmissionReview":
                    req = review["request"]
                    uid = req.get("uid", "")
                    kind = req["resource"]["resource"]
                    obj = req["object"]
                    spec = dict(obj.get("spec", obj))
                    # real k8s objects carry name under metadata; the
                    # wire schema requires spec.name — fold it in
                    meta_name = obj.get("metadata", {}).get("name")
                    if "name" not in spec and meta_name:
                        spec["name"] = meta_name
                    wrap = "admissionreview"
                else:
                    uid, wrap = "", "native"
                    kind = review["kind"]
                    spec = review["spec"]
                if not isinstance(kind, str) or not isinstance(spec, dict):
                    raise ValueError("kind must be a string, spec an object")
            except Exception as e:
                # a malformed review is the CLIENT's fault: 400, never a
                # dropped connection
                self.send_error(400, f"bad review document: {e}")
                return
            try:
                causes = validate_wire(kind, spec)
            except Exception:
                # a bug in the validation chain is OUR fault: 500, and no
                # internal exception text leaks to the caller
                self.send_error(500, "validation error")
                return
            if wrap == "admissionreview":
                doc = {"apiVersion": "admission.k8s.io/v1",
                       "kind": "AdmissionReview",
                       "response": {"uid": uid, "allowed": not causes,
                                    **({"status": {"message": "; ".join(
                                        causes)}} if causes else {})}}
            else:
                doc = {"allowed": not causes, "causes": causes}
            body = _json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            encoding = None
            if self.path.startswith("/debug/statusz") or \
                    self.path.startswith("/debug/vars") or \
                    self.path.startswith("/debug/pprof") or \
                    self.path.startswith("/debug/explain") or \
                    self.path.startswith("/debug/headroom"):
                # the introspection surfaces (docs/reference/
                # introspection.md), mounted here like /debug/traces so
                # deployments without --api-port still reach them
                from urllib.parse import parse_qs as _pq
                from urllib.parse import urlparse as _up
                from . import introspect as _introspect
                url = _up(self.path)
                rendered = _introspect.debug_doc(url.path, _pq(url.query))
                if rendered is None:
                    self.send_error(404)
                    return
                body, ctype = rendered
                from .kube.httpserver import maybe_gzip
                body, encoding = maybe_gzip(
                    body, self.headers.get("Accept-Encoding"))
            elif self.path.startswith("/debug/traces"):
                # the flight recorder's read surface, also mounted here so
                # deployments without --api-port still reach their traces
                import json as _json
                from urllib.parse import parse_qs as _pq
                from urllib.parse import urlparse as _up
                from . import trace as _trace
                url = _up(self.path)
                rec = _trace.recorder()
                doc = (rec.debug_doc(url.path, _pq(url.query))
                       if rec is not None else None)
                if doc is None:
                    self.send_error(404, "no such trace (or tracing "
                                         "disabled; pass --trace)")
                    return
                body = _json.dumps(doc).encode()
                ctype = "application/json"
            elif self.path == "/metrics":
                body = op.metrics.render().encode()
                ctype = "text/plain; version=0.0.4"
                # the scrape grew with the per-offering gauge surface and
                # the new lock-wait histogram; Prometheus sends
                # Accept-Encoding: gzip on every scrape
                from .kube.httpserver import maybe_gzip
                body, encoding = maybe_gzip(
                    body, self.headers.get("Accept-Encoding"))
            elif self.path in ("/healthz", "/readyz"):
                # the reference's liveness probe is the cloud connectivity
                # check (main.go:44 cloud-provider healthz)
                try:
                    op.cloud.liveness_probe()
                    body, ctype = b"ok", "text/plain"
                except Exception as e:
                    self.send_error(503, str(e))
                    return
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            if encoding:
                self.send_header("Content-Encoding", encoding)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

    from .kube.httpserver import make_http_server
    server = make_http_server(("0.0.0.0", port), Handler, certfile, keyfile)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def warm_start(op: Operator, opts: Options):
    """``--warm-start``: the Solver's boot ladder on a ``solver-warmup``
    thread inside the SLO warmup window, ahead of time (kernel sources
    built into the cache, each shape's analysis recorded) when a compile
    cache directory is set. Returns the thread, started."""
    # the SLO warmup window opens now and closes when the ladder finishes:
    # latency recorded while the first shapes load the kernel and fill
    # the allocator is boot cost, not burn (introspect/slo.py)
    op.slo.begin_warmup()
    return op.solver.warmup(node_pools_count=len(op.node_pools),
                            g_buckets=op.solver.BOOT_G_BUCKETS,
                            b_buckets=op.solver.BOOT_B_BUCKETS,
                            probes=True, background=True,
                            aot=bool(opts.compile_cache_dir),
                            on_done=op.slo.end_warmup)


def device_lost(op: Operator) -> Optional[BaseException]:
    """The sticky device error that took the Operator's Solver, or None
    while its device works."""
    return op.solver.device_lost


def run_passes(op: Operator, stop: threading.Event,
               deadline: Optional[float], step: float) -> int:
    """The single-threaded loop: ``op.run_once()`` every ``step`` seconds
    until ``stop`` is set or the monotonic ``deadline`` passes. Returns 0,
    or EXIT_DEVICE_LOST right after the pass whose solve lost the device:
    every later pass would fail with solve-error on that context."""
    while not stop.is_set():
        op.run_once()
        if device_lost(op) is not None:
            return EXIT_DEVICE_LOST
        if deadline is not None and time.monotonic() >= deadline:
            break
        stop.wait(step)
    return 0


def main(argv: Optional[Sequence[str]] = None,
         stop_event: Optional[threading.Event] = None) -> int:
    """``stop_event`` is the programmatic SIGTERM: tests (which cannot
    signal a thread) set it to end the run early."""
    args = build_parser().parse_args(argv)
    from .utils.logging import configure as configure_logging
    configure_logging(args.log_level)
    opts = options_from_args(args)
    # before anything is served or built: without CUDA this raises
    from .device import resolve_device
    device = resolve_device(args.device)
    if args.trace:
        # before ANY server/operator construction so the first admitted
        # request is already traceable
        from . import trace
        from .trace import FlightRecorder
        trace.enable(FlightRecorder(
            ring=args.trace_ring, retained=args.trace_retained,
            latency_budget_ms=args.trace_latency_budget_ms))
    if args.profile:
        # likewise before the operator build: boot compile cost is
        # usually exactly what a profile is for
        from . import introspect
        introspect.enable_profiling(hz=args.profile_hz)
    api_token = None
    if args.api_token_file:
        api_token = open(args.api_token_file).read().strip()
        if not api_token:
            raise SystemExit(f"--api-token-file {args.api_token_file} "
                             "is empty")
    if bool(args.api_tls_cert) != bool(args.api_tls_key):
        raise SystemExit("--api-tls-cert and --api-tls-key go together")
    api_server = None
    api_httpd = None
    queue = None
    if args.api_port:
        # loopback names resolvable by the AF_INET server only
        loopback = args.api_host in ("127.0.0.1", "localhost")
        if (not loopback and not args.api_insecure
                and not (api_token and args.api_tls_cert)):
            raise SystemExit(
                "refusing to serve the write-capable REST surface on "
                f"{args.api_host} without TLS (--api-tls-cert/key) AND a "
                "bearer token (--api-token-file); pass --api-insecure to "
                "override explicitly")
        from .interruption.queue import FakeQueue
        from .kube import (FakeAPIServer, install_admission,
                           install_default_indexes)
        from .kube.httpserver import serve as serve_api
        # watch tuning rides the CONSTRUCTOR: this surface serves (and
        # accepts watch subscriptions, whose queue bound is frozen at
        # subscribe time) before the slow Operator build applies options
        api_server = FakeAPIServer(
            watch_queue_bound=opts.api_watch_queue_bound,
            bookmark_every=opts.api_bookmark_every)
        # admission/indexes are wired BEFORE the first byte is served:
        # objects written during the (slow) operator build face the same
        # 422-with-causes contract as every later write — and the
        # surface comes up BEFORE that build, so external agents connect
        # while the catalog and the Solver's resident lattice build. The interruption queue is built
        # here (injected into the Operator below) so its wire route
        # serves equally early.
        install_default_indexes(api_server)
        install_admission(api_server)
        if opts.interruption_queue:
            queue = FakeQueue(opts.interruption_queue)
        api_httpd = serve_api(api_server, args.api_port,
                              host=args.api_host, token=api_token,
                              certfile=args.api_tls_cert,
                              keyfile=args.api_tls_key,
                              queue=queue)
        from .utils.logging import get_logger
        get_logger("cli").info(
            "apiserver REST surface listening",
            port=api_httpd.server_address[1],
            tls=bool(args.api_tls_cert), auth=bool(api_token))
    op = Operator(options=opts, api_server=api_server,
                  interruption_queue=queue, device=device)
    # the introspection sampler (docs/reference/introspection.md): 1 Hz
    # ring series behind /debug/vars?series=1 and kpctl top. One provider
    # fan-out per second — off every hot path by construction.
    op.sampler.start(interval=1.0)
    op.burn_capture.resize(args.profile_captures)
    if args.profile:
        # the device cost model fills from the pack's analysis of the warm
        # ladder (a meta-device trace: nothing runs, no solve lock), so
        # measured-vs-modeled attribution works from the first real solve;
        # the ahead-of-time warmup records the same analyses
        capture_fn = getattr(op.solver, "capture_cost_model", None)
        if capture_fn is not None:   # RemoteSolver solves out-of-process
            threading.Thread(
                target=lambda: capture_fn(
                    node_pools_count=len(op.node_pools)),
                name="costmodel-capture", daemon=True).start()

    stop = stop_event or threading.Event()

    def _stop(signum, frame):
        stop.set()

    try:
        signal.signal(signal.SIGINT, _stop)
        signal.signal(signal.SIGTERM, _stop)
    except ValueError:
        pass  # not the main thread (tests drive main() directly)

    server = (start_server(op, args.metrics_port,
                           certfile=args.api_tls_cert,
                           keyfile=args.api_tls_key)
              if args.metrics_port else None)
    sidecar = None
    if args.sidecar_address:
        from .parallel.sidecar import serve as serve_sidecar
        sidecar = serve_sidecar(op.solver, args.sidecar_address)
    if args.warm_start:
        warm_start(op, opts)
    if args.profile_dir:
        op.solver.start_profiling(args.profile_dir)
    deadline = (time.monotonic() + args.duration) if args.duration > 0 else None
    runtime = None
    code = 0
    try:
        if args.async_runtime:
            from .operator.runtime import ControllerRuntime, operator_specs
            elector = None
            if args.leader_elect_lease_file:
                import os
                from .operator.leaderelection import FileLeaseStore, LeaderElector
                elector = LeaderElector(
                    FileLeaseStore(args.leader_elect_lease_file),
                    identity=f"{os.uname().nodename}-{os.getpid()}")
            elif api_server is not None:
                # API mode elects through the apiserver's coordination
                # lease (client-go semantics) with no extra wiring
                import os
                from .operator.leaderelection import (ApiLeaseStore,
                                                      LeaderElector)
                elector = LeaderElector(
                    ApiLeaseStore(api_server),
                    identity=f"{os.uname().nodename}-{os.getpid()}")
            runtime = ControllerRuntime(operator_specs(op),
                                        elector=elector).start()
            while not stop.is_set():
                if device_lost(op) is not None:
                    code = EXIT_DEVICE_LOST
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                stop.wait(0.2)
        else:
            code = run_passes(op, stop, deadline, args.step)
    finally:
        op.sampler.stop()
        if args.profile:
            from . import introspect
            prof = introspect.profiler_instance()
            if prof is not None:
                prof.stop()
        if runtime is not None:
            runtime.stop()
        if args.profile_dir:
            op.solver.stop_profiling()
        if sidecar is not None:
            sidecar.stop(grace=None)
        if server is not None:
            server.shutdown()
        if api_httpd is not None:
            api_httpd.shutdown()
    if code == EXIT_DEVICE_LOST:
        from .utils.logging import get_logger
        get_logger("cli").error(
            "the solver's device is lost; exiting for a restart",
            error=str(device_lost(op)), exit_code=code)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
