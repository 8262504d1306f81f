"""Interruption-throughput benchmark, for this package.

The counterpart of the repository's ``tools/bench_interruption.py``
(after the reference's interruption benchmark: drain 100 / 1k / 5k / 15k
SQS messages through the controller, measuring messages/sec). The queue
is the in-memory FakeQueue with the same receive-10 / delete-on-handled
semantics, the claims are registered spot capacity, and the message mix
exercises all four parsed schemas (spot interruption, rebalance
recommendation, scheduled change, instance state-change). The Operator's
Solver sits on ``--device`` (default ``cuda``); the drain itself is host
work.

    python -m karpenter_provider_aws_tpu_torch.tools.bench_interruption \\
        [--api-mode] [--device cuda] [--out INTERRUPTION_gpu_r01.json] [depths...]

Prints one JSON line per depth (messages/sec through a full
receive→parse→handle→delete drain, plus handled/ICE'd counts) and writes
the lines as a JSON list to ``--out``. ``--api-mode`` drives the same
drain through the apiserver seam (claims created through the typed
client, informer-fed mirror, writer deletions).
"""

from __future__ import annotations

import argparse
import json
import time

from ..apis import NodePool
from ..apis.objects import NodeClaim, NodeClaimPhase
from ..cloud import FakeCloud
from ..interruption import (FakeQueue, rebalance_recommendation,
                            scheduled_change, spot_interruption, state_change)
from ..lattice import build_catalog, build_lattice
from ..operator import Operator, Options
from ..utils.clock import FakeClock

DEPTHS = (100, 1_000, 5_000, 15_000)
N_CLAIMS = 200
DEFAULT_OUT = "INTERRUPTION_gpu_r01.json"


def build_env(lattice, api_mode: bool = False, device=None):
    """An Operator on ``device`` (None = ``cuda``) reading a FakeQueue,
    with ``N_CLAIMS`` initialized spot claims."""
    clock = FakeClock()
    queue = FakeQueue("bench-interruptions")
    kw = {}
    if api_mode:
        from ..kube import FakeAPIServer
        kw["api_server"] = FakeAPIServer(clock=clock)
    env = Operator(options=Options(), lattice=lattice, cloud=FakeCloud(clock),
                   clock=clock, node_pools=[NodePool(name="default")],
                   interruption_queue=queue, device=device, **kw)
    zones = lattice.zones
    for i in range(N_CLAIMS):
        claim = NodeClaim(
            name=f"claim-{i}", node_pool="default",
            phase=NodeClaimPhase.INITIALIZED,
            provider_id=f"fake:///{zones[i % len(zones)]}/i-{i:08x}",
            instance_type="m5.xlarge", zone=zones[i % len(zones)],
            capacity_type="spot")
        if api_mode:
            env.kube.create_nodeclaim(claim)
        else:
            env.cluster.add_claim(claim)
    if api_mode:
        env.sync.sync_once()   # informer-feed the mirror
    return env


def seed_messages(env, depth: int) -> None:
    """Round-robin message mix over the claim fleet: 70% spot interruption,
    10% each rebalance / scheduled change / state change (the reference's
    four EventBridge schemas)."""
    for i in range(depth):
        iid = f"i-{i % N_CLAIMS:08x}"
        r = i % 10
        if r < 7:
            body = spot_interruption(iid)
        elif r == 7:
            body = rebalance_recommendation(iid)
        elif r == 8:
            body = scheduled_change(iid)
        else:
            body = state_change(iid, "stopping")
        env.interruption_queue.send(body)


def drain(env) -> int:
    """reconcile() until the queue is empty; returns messages handled.
    In API mode the informer pump runs inside the timed loop."""
    handled = 0
    while len(env.interruption_queue):
        n = env.interruption.reconcile()
        if env.sync is not None:
            env.sync.sync_once()
        if n == 0:
            break
        handled += n
    return handled


def run(depth: int, lattice, api_mode: bool = False, device=None) -> dict:
    env = build_env(lattice, api_mode=api_mode, device=device)
    seed_messages(env, depth)
    t0 = time.perf_counter()
    handled = drain(env)
    wall = time.perf_counter() - t0
    ice = sum(1 for _ in env.unavailable.entries())
    return {
        "metric": f"interruption_throughput_{depth}"
                  + ("_api" if api_mode else ""),
        "value": round(handled / wall, 1),
        "unit": "msgs/sec",
        "detail": {
            "messages": depth,
            "handled": handled,
            "remaining": len(env.interruption_queue),
            "wall_ms": round(wall * 1000.0, 1),
            "ice_entries": ice,
            "stratum": "api" if api_mode else "direct",
            "claims_drained": sum(
                1 for c in env.cluster.snapshot_claims()
                if c.deletion_timestamp is not None),
            "device": str(env.solver.device),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--api-mode", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the Operator's Solver device (default cuda; "
                         "raises without a card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("depths", nargs="*", type=int)
    args = ap.parse_args(argv)
    lattice = build_lattice([s for s in build_catalog()
                             if s.family in ("m5", "c5", "r5")])
    rows = []
    for depth in args.depths or DEPTHS:
        rows.append(run(depth, lattice, api_mode=args.api_mode,
                        device=args.device))
        print(json.dumps(rows[-1]), flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
