"""Solver sidecar: the host↔solver gRPC transport.

SURVEY §2.3 ("communication backend") and §7 ("calls the solver — gRPC
sidecar in-process first"): the device solver runs as a service so a
controller in another process — or another language; the wire format is
plain JSON (apis/serde.py) over unary gRPC — can ship cluster state in
and get NodePlans back. The reference's equivalent transport is the kube
API watch stream + SQS long-poll (pkg/providers/sqs/sqs.go:52-72); here
the hot path is the Solve RPC, and the lattice stays RESIDENT in the
sidecar process (SURVEY §7 hard part (d): ship only pod deltas, never the
700-type lattice).

Methods (all unary, raw-bytes payloads so no protoc codegen is needed):
- /karpenter.solver.v1.Solver/Solve   — pods+pools+state → NodePlan
- /karpenter.solver.v1.Solver/Health  — lattice shape + price version

Transport: any gRPC address. ``unix:`` sockets for the local sidecar
(no TCP hop), ``host:port`` when the solver pool lives across DCN. The
wire is this package's own unary gRPC (parallel/rpc.py), which speaks to
grpcio peers both ways; a message above 4 MiB fails with
RESOURCE_EXHAUSTED, as it does between grpcio peers.

The resident Solver runs on the card (``main``'s ``--device``, default
``cuda``); a Solve RPC launches its kernels there.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import trace
from ..apis import serde
from ..device import DeviceLike
from ..errors import EXIT_DEVICE_LOST
from ..solver.solve import NodePlan, Solver
from . import rpc

_SOLVE = "/karpenter.solver.v1.Solver/Solve"
_HEALTH = "/karpenter.solver.v1.Solver/Health"

# liveness deadline: the Health RPC answers from the resident lattice
# (no device work), so ~1 s bounds a probe against a hung process
HEALTH_TIMEOUT_SECONDS = 1.0


class SidecarProtocolError(RuntimeError):
    """The sidecar ANSWERED, but not with a NodePlan: the connection
    died after a partial body, or the body failed to decode (garbage
    JSON back). Distinct from rpc.RpcError — the transport worked —
    but it classifies exactly the same way at the call site: a sidecar
    failure that falls through the ladder (breaker failure + failover /
    local fallback), never a json.JSONDecodeError out of a provisioning
    pass."""


class SolverService:
    """Server-side request handling around a resident Solver.

    ``window`` (batcher/solve_window.py SolveWindow) fronts the Solve
    RPC with the device-batch admission window: concurrent RPCs coalesce
    into one back-to-back drain under a single solver-lock acquisition
    instead of paying the tunneled link serially, caller by caller."""

    def __init__(self, solver: Solver, window=None):
        # Solver is thread-safe (its public entry points serialize on an
        # internal RLock), so RPCs and in-process controller solves on the
        # same instance interleave safely
        self.solver = solver
        self.window = window
        self._mask_memo = None  # (key, view) — see _masked_lattice

    def solve(self, payload: bytes) -> bytes:
        req = json.loads(payload.decode())
        # trace context crosses the process boundary as a field in the
        # JSON body (the wire stays plain cross-language JSON — no gRPC
        # metadata dependency); the handler's span is the remote child of
        # the caller's span, marked svc=sidecar so a merged Perfetto
        # export shows which process ran what
        tc = req.get("traceContext")
        sp = trace.span("sidecar.solve", parent=tc, svc="sidecar",
                        pods=len(req.get("pods", ())))
        with sp:
            doc = self._solve(req)
        if tc and isinstance(sp, trace.Span):
            # ship this process's completed spans back in the response:
            # the CALLER's flight recorder then holds one connected tree
            # across the process boundary (SolverClient ingests them,
            # deduped by span id) — the sidecar is a leaf service with no
            # query surface of its own in the operator's deployment
            rec = trace.recorder()
            spans = rec.get(sp.trace_id) if rec is not None else None
            if spans:
                doc["traceSpans"] = [s.to_dict() for s in spans]
        return json.dumps(doc).encode()

    def _solve(self, req: dict) -> dict:
        from ..solver.topology import BoundPod

        pods = [serde.pod_from_dict(p) for p in req.get("pods", ())]
        pools = [serde.nodepool_from_dict(p)
                 for p in req.get("nodePools", ())]
        existing = [serde.existing_bin_from_dict(b)
                    for b in req.get("existing", ())]
        ds = [serde.pod_from_dict(p) for p in req.get("daemonsetPods", ())]
        bound = [BoundPod(pod=serde.pod_from_dict(b["pod"]),
                          node_name=b["nodeName"], zone=b.get("zone", ""),
                          capacity_type=b.get("capacityType", "on-demand"),
                          node_labels=dict(b.get("nodeLabels", {})))
                 for b in req.get("boundPods", ())]
        pvcs = {c["name"]: serde.pvc_from_dict(c)
                for c in req.get("pvcs", ())} or None
        scs = {s["name"]: serde.storage_class_from_dict(s)
               for s in req.get("storageClasses", ())} or None
        # null = unlimited axis (np.inf is not representable in strict
        # RFC 8259 JSON, and the wire must stay cross-language)
        headroom = {k: np.asarray([np.inf if x is None else x for x in v],
                                  np.float32)
                    for k, v in (req.get("poolHeadroom") or {}).items()} or None
        view = self._masked_lattice(req.get("unavailable"))
        entry = self.window if self.window is not None else self.solver
        plan = entry.solve_relaxed(
            pods, pools, lattice=view, existing=existing, daemonset_pods=ds,
            bound_pods=bound, pvcs=pvcs, storage_classes=scs,
            pool_headroom=headroom)
        return serde.plan_to_dict(plan)

    def _masked_lattice(self, unavailable):
        """Apply the caller's ICE'd offerings to the RESIDENT lattice.

        A remote caller (RemoteSolver) cannot ship its masked lattice view
        — the whole point of the sidecar is that the lattice never crosses
        the wire — so it ships the unavailable (capacityType, instanceType,
        zone) triples instead and the mask is rebuilt here. None/empty =
        the unmasked resident lattice (and solve_relaxed's ``lattice=None``
        default path)."""
        if not unavailable:
            return None
        from ..cache.unavailable import mask_from_entries
        from ..lattice.tensors import masked_view
        lat = self.solver.lattice
        key = (lat.price_version, tuple(sorted(map(tuple, unavailable))))
        if self._mask_memo is not None and self._mask_memo[0] == key:
            return self._mask_memo[1]
        view = masked_view(lat, mask_from_entries(lat, unavailable))
        # memoize ONE view: a steady operator re-sends the same ICE set
        # every pass, and view identity keys the solver's narrowing cache
        self._mask_memo = (key, view)
        return view

    def health(self, payload: bytes) -> bytes:
        lat = self.solver.lattice
        return json.dumps({
            "ok": True,
            "types": lat.T, "zones": lat.Z, "capacityTypes": lat.C,
            "priceVersion": lat.price_version,
            # the sidecar's mesh shape: a caller (and `kpctl top`
            # against the sidecar's own introspection) sees whether the
            # accelerator-resident solve is sharded and how wide
            "meshDevices": getattr(self.solver, "mesh_devices", 1),
        }).encode()


class _Handler(rpc.GenericRpcHandler):
    def __init__(self, service: SolverService):
        self._service = service

    def service(self, handler_call_details):
        if handler_call_details.method == _SOLVE:
            return rpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self._service.solve(req))
        if handler_call_details.method == _HEALTH:
            return rpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self._service.health(req))
        return None


def serve(solver: Solver, address: str = "unix:/tmp/karpenter-solver.sock",
          max_workers: int = 4, admission_window: bool = True) -> rpc.Server:
    """Start the sidecar on ``address``; returns the running server.

    ``admission_window`` fronts the Solve RPC with the device-batch
    coalescing window (batcher/solve_window.py) so concurrent RPC
    workers fuse into one device drain instead of serializing on the
    link; disable it for single-caller latency tests."""
    from concurrent.futures import ThreadPoolExecutor
    window = None
    if admission_window:
        from ..batcher import SolveWindow
        window = SolveWindow(solver)
        # the coalescing window reports occupancy/fusion counters to the
        # process's introspection registry (docs/reference/introspection.md)
        from .. import introspect
        introspect.registry().register("solve_window", window.stats)
        introspect.registry().register("solver", solver.stats)
    server = rpc.server(ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (_Handler(SolverService(solver, window=window)),))
    # add_insecure_port signals bind failure by returning 0, not raising
    # (unix: sockets return 1 on success)
    if server.add_insecure_port(address) == 0:
        raise RuntimeError(f"sidecar failed to bind {address!r}")
    server.start()
    return server


class SolverClient:
    """Thin client. ``solve()`` mirrors Solver.solve_relaxed's signature
    and returns a real NodePlan (decoded from the wire)."""

    def __init__(self, address: str = "unix:/tmp/karpenter-solver.sock",
                 timeout: float = 60.0,
                 health_timeout: float = HEALTH_TIMEOUT_SECONDS):
        self.address = address
        # bound the channel's OWN reconnect backoff: grpc's default
        # schedule grows toward 120 s after repeated failures, which
        # would push the first post-restart connection attempt far past
        # a 1 s health probe's wait_for_ready window — recovery would be
        # detected minutes late. ≤500 ms keeps at least one attempt
        # inside every probe deadline.
        self._channel = rpc.insecure_channel(address, options=[
            ("grpc.initial_reconnect_backoff_ms", 250),
            ("grpc.min_reconnect_backoff_ms", 250),
            ("grpc.max_reconnect_backoff_ms", 500),
        ])
        self._solve = self._channel.unary_unary(_SOLVE)
        self._health = self._channel.unary_unary(_HEALTH)
        self.timeout = timeout
        # liveness must NEVER share the solve deadline: a health probe
        # against a HUNG sidecar (accepts, stalls) has to answer in ~1 s
        # so kpctl and the pool's breaker probes are cheap — with the
        # old shared timeout it stalled a full solve timeout (60 s)
        self.health_timeout = health_timeout

    def solve(self, pods: Sequence, node_pools: Sequence,
              existing: Sequence = (), daemonset_pods: Sequence = (),
              bound_pods: Sequence = (), pvcs: Optional[Dict] = None,
              storage_classes: Optional[Dict] = None,
              pool_headroom: Optional[Dict] = None,
              unavailable: Sequence = ()) -> NodePlan:
        req = {
            "pods": [serde.pod_to_dict(p) for p in pods],
            "nodePools": [serde.nodepool_to_dict(p) for p in node_pools],
            "existing": [serde.existing_bin_to_dict(b) for b in existing],
            "daemonsetPods": [serde.pod_to_dict(p) for p in daemonset_pods],
            "boundPods": [
                {"pod": serde.pod_to_dict(b.pod), "nodeName": b.node_name,
                 "zone": b.zone, "capacityType": b.capacity_type,
                 "nodeLabels": dict(b.node_labels)}
                for b in bound_pods],
            "pvcs": [serde.pvc_to_dict(c)
                     for c in (pvcs or {}).values()],
            "storageClasses": [serde.storage_class_to_dict(s)
                               for s in (storage_classes or {}).values()],
            "poolHeadroom": ({k: [None if not math.isfinite(float(x))
                                  else float(x) for x in v]
                              for k, v in pool_headroom.items()}
                             if pool_headroom else None),
        }
        if unavailable:
            # the caller's ICE'd offerings, as (capacityType,
            # instanceType, zone) triples — the sidecar rebuilds the mask
            # over ITS resident lattice (SolverService._masked_lattice)
            req["unavailable"] = [list(o) for o in unavailable]
        tc = trace.capture()
        if tc:
            # propagate the caller's span as the RPC's remote parent so
            # the sidecar's device solve joins this trace across the
            # process boundary (docs/reference/tracing.md wire format)
            req["traceContext"] = tc
        resp = self._solve(json.dumps(req).encode(), timeout=self.timeout)
        # a response that is not a NodePlan document classifies as a
        # SIDECAR failure (SidecarProtocolError), exactly like an
        # RpcError: the caller's ladder/pool handles it — a junk body
        # must never surface as a JSONDecodeError out of a pass
        try:
            doc = json.loads(resp.decode())
            if not isinstance(doc, dict):
                raise ValueError(f"non-object response ({type(doc).__name__})")
        except (ValueError, UnicodeDecodeError) as e:
            raise SidecarProtocolError(
                f"sidecar {self.address} returned an undecodable "
                f"response: {e}") from e
        remote_spans = doc.pop("traceSpans", None)
        if remote_spans and tc:
            # the sidecar shipped its completed spans back: land them in
            # THIS process's flight recorder so /debug/traces serves one
            # connected tree across the process boundary
            rec = trace.recorder()
            if rec is not None:
                rec.ingest(remote_spans)
        try:
            return serde.plan_from_dict(doc)
        except (KeyError, TypeError, ValueError) as e:
            raise SidecarProtocolError(
                f"sidecar {self.address} returned a malformed plan "
                f"document: {type(e).__name__}: {e}") from e

    def health(self) -> Dict:
        # wait_for_ready: a probe against a just-restarted endpoint must
        # FORCE a reconnect attempt instead of failing fast out of the
        # channel's own TRANSIENT_FAILURE backoff — recovery detection
        # is this RPC's whole job, and the ~1 s deadline bounds it
        return json.loads(
            self._health(b"{}", timeout=self.health_timeout,
                         wait_for_ready=True).decode())

    def close(self) -> None:
        self._channel.close()


def classify_sidecar_failure(exc) -> str:
    """Sidecar RPC failure → bounded taxonomy code (solver/taxonomy.py):
    ``sidecar-hung`` for a deadline-class failure (the endpoint accepted
    and stalled — the failure mode that costs a whole solve deadline),
    ``sidecar-unreachable`` for everything else (connection refused /
    reset, junk response, mid-body death)."""
    from ..solver.taxonomy import SIDECAR_HUNG, SIDECAR_UNREACHABLE
    if isinstance(exc, rpc.RpcError) and hasattr(exc, "code"):
        if exc.code() == rpc.StatusCode.DEADLINE_EXCEEDED:
            return SIDECAR_HUNG
    return SIDECAR_UNREACHABLE


class RemoteSolver(Solver):
    """A Solver whose provisioning solves run in the solver SIDECAR
    process (``--solver-address``): the operator ships pod deltas + the
    ICE mask over the Solve RPC and the lattice stays resident next to
    the accelerator. Everything else — probe_batch (the disruption
    controller's vmapped what-ifs), lattice queries, warmup — stays on
    the LOCAL Solver this subclasses, so a sidecar outage degrades to the
    in-process ladder instead of stalling the control plane."""

    # provisioning solves belong to the sidecar: the provisioner's
    # steady-state delta path (an in-process resident-cache fast path)
    # would silently bypass the delegation, so it stays off here
    supports_delta = False

    def __init__(self, lattice, address: str, timeout: float = 60.0,
                 pipeline: bool = True, mesh=None, device: DeviceLike = None):
        # the planned mesh applies to the LOCAL fallback ladder; the
        # sidecar process plans its own (its stats/health report it).
        # ``device`` is the local Solver's (None = ``cuda``)
        super().__init__(lattice, device=device, pipeline=pipeline,
                         mesh=mesh)
        self.client = SolverClient(address, timeout=timeout)
        # the SIDECAR's mesh as observed from returned plans (the wire
        # carries meshDevices + shardImbalance per plan): the operator's
        # mesh gauges and kpctl top must describe the process that
        # actually solves — the sidecar while delegation works, THIS
        # process's local fallback the moment it doesn't (the
        # unreachable path resets the observation, so an outage never
        # keeps advertising a mesh nothing is solving on). Updated
        # lock-free from each solve — stats() must stay non-blocking,
        # so no health RPC from the introspection path.
        self._remote_mesh_devices = 0
        self._remote_mesh_solves = 0
        self._remote_mesh_imbalance = 0.0

    def stats(self) -> Dict[str, object]:
        out = super().stats()
        # mesh_solves is cumulative EVIDENCE (local fallback + every
        # sharded plan the sidecar returned) — it never goes backwards
        out["mesh_solves"] = (out.get("mesh_solves", 0)
                              + self._remote_mesh_solves)
        if self._remote_mesh_devices:
            out["mesh_devices"] = self._remote_mesh_devices
            # the imbalance of the mesh that actually solved — never the
            # local fallback's (which has run no sharded solve)
            out["mesh_shard_imbalance"] = round(
                self._remote_mesh_imbalance, 4)
        return out

    def _unavailable_entries(self, view) -> List:
        """Recover the ICE'd offerings from a masked lattice view by
        diffing availability against the base lattice — the provisioner
        hands solve_relaxed a VIEW (lattice/tensors.py masked_view), and
        the triples are what crosses the wire."""
        base = self.lattice
        if view is None or view is base:
            return []
        diff = base.available & ~view.available
        if not diff.any():
            return []
        return [(base.capacity_types[ci], base.names[ti], base.zones[zi])
                for ti, zi, ci in np.argwhere(diff)]

    def solve_relaxed(self, pods, node_pools, lattice=None, existing=(),
                      daemonset_pods=(), bound_pods=(), pvcs=None,
                      storage_classes=None, mesh=None,
                      pool_headroom=None, problem0=None) -> NodePlan:
        # problem0 is a LOCAL-build shortcut; the remote path ships pods
        # and rebuilds sidecar-side, so it is meaningful only for the
        # unreachable-fallback local solve below
        with trace.span("solver.remote", pods=len(pods),
                        address=self.client.address) as sp:
            try:
                plan = self.client.solve(
                    pods, node_pools, existing=existing,
                    daemonset_pods=daemonset_pods, bound_pods=bound_pods,
                    pvcs=pvcs, storage_classes=storage_classes,
                    pool_headroom=pool_headroom,
                    unavailable=self._unavailable_entries(lattice))
                sp.set(path=plan.solver_path, degraded=plan.degraded,
                       reason=plan.degraded_reason)
                self._remote_mesh_devices = plan.mesh_devices
                self._remote_mesh_imbalance = plan.shard_imbalance
                if plan.mesh_devices > 1:
                    self._remote_mesh_solves += 1
                return plan
            except (rpc.RpcError, SidecarProtocolError) as e:
                # the sidecar is down, hung, or talking garbage: the
                # local solver this subclasses is fully functional —
                # degrade to it (one more rung under the device ladder)
                # rather than failing the pass; provenance marks the
                # plan with the bounded taxonomy code so the flight
                # recorder tail-retains the trace and operators see WHY.
                # A mid-response failure (connection died after a
                # partial body / junk JSON back) arrives here as
                # SidecarProtocolError — never a JSONDecodeError out of
                # the pass.
                reason = classify_sidecar_failure(e)
                sp.set(degraded=True, reason=reason,
                       error=f"{type(e).__name__}: {e.code() if isinstance(e, rpc.RpcError) and hasattr(e, 'code') else e}")
        # delegation failed: the LOCAL solver is what solves now — stop
        # reporting the unreachable sidecar's mesh shape (stats falls
        # back to super()'s view until a delegated solve succeeds
        # again; the cumulative sharded-solve count stays)
        self._remote_mesh_devices = 0
        self._remote_mesh_imbalance = 0.0
        self._count_degraded(reason)
        plan = super().solve_relaxed(
            pods, node_pools, lattice=lattice, existing=existing,
            daemonset_pods=daemonset_pods, bound_pods=bound_pods,
            pvcs=pvcs, storage_classes=storage_classes, mesh=mesh,
            pool_headroom=pool_headroom, problem0=problem0)
        plan.degraded = True
        plan.degraded_reason = plan.degraded_reason or reason
        return plan


class ChaosSolverService(SolverService):
    """A SolverService with injectable failure modes — the server half
    of control-plane weather (weather/scenario.py ``SidecarOutage``) and
    the pool failover tests:

    - **hang**: the handler ACCEPTS the RPC and stalls until the mode
      clears (bounded far past any deadline) — the failure mode a
      connect error never exercises; the caller's deadline, not the
      sidecar, ends the wait;
    - **junk**: the handler answers with bytes that are not a NodePlan
      document — the mid-response/garbage failure SolverClient must
      classify as SidecarProtocolError, never leak as JSONDecodeError.
    """

    # hang cap: far past any sane deadline, bounded so a torn-down test
    # or soak can never leak a stalled worker thread forever
    HANG_CAP_SECONDS = 120.0

    def __init__(self, solver: Solver, window=None):
        super().__init__(solver, window)
        import threading
        self._hanging = False
        self._junk = False
        self._release = threading.Event()
        self._release.set()

    def set_hang(self, on: bool) -> None:
        if on:
            self._release.clear()
            self._hanging = True
        else:
            self._hanging = False
            self._release.set()

    def set_junk(self, on: bool) -> None:
        self._junk = bool(on)

    def _maybe_misbehave(self) -> Optional[bytes]:
        if self._hanging:
            # stall in small waits so set_hang(False) releases promptly;
            # the loop bound (not a deadline of our own) caps a leak
            waited = 0.0
            while self._hanging and waited < self.HANG_CAP_SECONDS:
                if self._release.wait(0.1):
                    break
                waited += 0.1
        if self._junk:
            return b"\x7bgarbage: this is not a NodePlan\x00"
        return None

    def solve(self, payload: bytes) -> bytes:
        bad = self._maybe_misbehave()
        return bad if bad is not None else super().solve(payload)

    def health(self, payload: bytes) -> bytes:
        # a hung PROCESS hangs everything, liveness included — that is
        # exactly what the split health deadline exists to bound
        bad = self._maybe_misbehave()
        return bad if bad is not None else super().health(payload)


class ChaosSidecar:
    """One controllable sidecar endpoint: serve/kill/restart on a fixed
    address plus the ChaosSolverService failure modes. The handle the
    weather simulator drives (``WeatherSimulator(sidecars=[...])``) and
    tools/soak.py ``--solver-pool`` / tools/smoke_pool.py manage."""

    def __init__(self, solver: Solver, address: str):
        self.solver = solver
        self.address = address
        self.service = ChaosSolverService(solver)
        self.server: Optional[rpc.Server] = None
        self.alive = False

    def start(self) -> "ChaosSidecar":
        from concurrent.futures import ThreadPoolExecutor
        server = rpc.server(ThreadPoolExecutor(max_workers=4))
        server.add_generic_rpc_handlers((_Handler(self.service),))
        if server.add_insecure_port(self.address) == 0:
            raise RuntimeError(f"chaos sidecar failed to bind "
                               f"{self.address!r}")
        server.start()
        self.server = server
        self.alive = True
        return self

    def kill(self) -> None:
        """The endpoint goes DARK (connection refused), releasing any
        hung handlers so worker threads never leak."""
        self.service.set_hang(False)
        if self.server is not None:
            self.server.stop(grace=None)
            self.server = None
        self.alive = False

    def restart(self) -> None:
        """Re-serve on the SAME address (the pool's endpoint list is
        fixed — recovery means the address answers again), with failure
        modes cleared: a restarted process comes back healthy."""
        self.service.set_hang(False)
        self.service.set_junk(False)
        if not self.alive:
            self.start()

    def set_hang(self, on: bool) -> None:
        self.service.set_hang(on)

    def set_junk(self, on: bool) -> None:
        self.service.set_junk(on)

    def restore(self) -> None:
        """Fair weather: alive, no failure modes."""
        self.restart()

    def stop(self) -> None:
        self.kill()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Standalone solver sidecar: ``python -m
    karpenter_provider_aws_tpu_torch.parallel.sidecar --address ADDR``.

    The deployment shape the paper's architecture implies — the device
    solver as its own accelerator-resident process, the operator's
    control loop elsewhere pointing at it via ``--solver-address``.
    ``--device`` (default ``cuda``, raising without CUDA) is where the
    resident Solver's tensors live; ``--compile-cache-dir`` (env
    ``COMPILE_CACHE_DIR``) where its kernel libraries are built and
    loaded, as in the Operator. Once the Solver has lost its device
    (``errors.DeviceLostError``: a sticky error took the CUDA context) the
    process stops serving and returns ``EXIT_DEVICE_LOST``, so that its
    deployment restarts it; the pool's breakers fail its callers over
    meanwhile."""
    import argparse
    import signal
    import threading

    p = argparse.ArgumentParser(
        prog="karpenter-solver-sidecar", description=main.__doc__)
    p.add_argument("--device", default="cuda",
                   help="Device of the resident solver's tensors: 'cuda' "
                        "(default; raises without CUDA) or 'cpu' (the plain "
                        "PyTorch path).")
    p.add_argument("--address", default="unix:/tmp/karpenter-solver.sock",
                   help="gRPC bind address (unix:/path or host:port)")
    p.add_argument("--catalog", default=None,
                   help="path to a real-data catalog JSON "
                        "(lattice/realdata.py schema); default = the "
                        "bundled reference catalog")
    p.add_argument("--synthetic-catalog", action="store_true",
                   help="use the generated synthetic catalog instead of "
                        "the bundled reference data")
    p.add_argument("--no-admission-window", action="store_true",
                   help="serve without the solve-coalescing window")
    p.add_argument("--mesh", default=None,
                   help="device mesh for the sharded solve (env "
                        "SOLVER_MESH; parallel/mesh.py plan_mesh): "
                        "'auto' (default), an integer shard count (the "
                        "shards on min(N, cards) ranks, one card each), "
                        "or 'off' — the "
                        "sidecar is the accelerator-resident process, so "
                        "this is where the mesh actually lives in a "
                        "--solver-address deployment")
    p.add_argument("--trace", action="store_true",
                   help="enable tracing: the Solve handler's span tree "
                        "ships back to callers in the RPC response")
    p.add_argument("--compile-cache-dir",
                   default=os.environ.get("COMPILE_CACHE_DIR", ""),
                   help="build and load the kernel libraries in this "
                        "directory (env COMPILE_CACHE_DIR; solver/solve.py "
                        "enable_persistent_compile_cache)")
    args = p.parse_args(argv)
    from ..device import resolve_device
    device = resolve_device(args.device)
    if args.compile_cache_dir:
        from ..solver.solve import enable_persistent_compile_cache
        enable_persistent_compile_cache(args.compile_cache_dir)

    if args.trace:
        from .. import trace as _trace
        _trace.enable()
        # every span this process opens is the sidecar's (a merged
        # Perfetto export renders it as its own process row)
        _trace.get_tracer().service = "sidecar"
    from ..lattice import build_lattice
    if args.synthetic_catalog:
        lattice = build_lattice()
    else:
        from ..lattice.realdata import load_catalog
        lattice = build_lattice(load_catalog(args.catalog,
                                             require_price=True))
    from .mesh import plan_mesh
    mesh_plan = plan_mesh(args.mesh or os.environ.get("SOLVER_MESH", "auto"),
                          device=device)
    solver = Solver(lattice, device=device, mesh=mesh_plan.mesh)
    server = serve(solver, args.address,
                   admission_window=not args.no_admission_window)
    print(f"solver sidecar serving on {args.address} "
          f"(T={lattice.T} Z={lattice.Z} C={lattice.C} "
          f"mesh={mesh_plan.devices} ranks={mesh_plan.ranks} "
          f"device={device})", flush=True)
    stop = threading.Event()
    try:
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass
    code = 0
    while not stop.wait(1.0):
        if solver.device_lost is not None:
            print(f"solver sidecar: the device is lost, exiting "
                  f"({solver.device_lost})", flush=True)
            code = EXIT_DEVICE_LOST
            break
    server.stop(grace=None)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
