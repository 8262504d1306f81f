"""Live-debug dumpers + time-series monitor for soak/scale harnesses.

The analog of the reference's scale-stratum debug tooling:
test/pkg/debug/{events,node,nodeclaim,pod,monitor}.go (watch dumpers that
print state deltas while a long test runs) and
test/pkg/environment/aws/metrics.go:66-119 (the duration-metric pipeline
that records provisioning/deprovisioning time series for later analysis).

- ``snapshot(op)`` — one structured sample of the control plane.
- ``Monitor`` — samples on an interval (or on demand) into a list and
  writes a JSON time-series artifact; tools/soak.py records one per run.
- ``dump_state(op)`` — a full human-readable dump (nodes with their pods,
  claims with phases, recent events) for failure diagnosis; the soak
  harness and tests print it when an invariant breaks.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional


def _committed_cost_per_hour(op) -> float:
    """$/hr of live capacity: registered nodes + unregistered launched
    claims (the bill the cluster is running up right now)."""
    lat = op.lattice
    total = 0.0
    # index maps built once per snapshot: the per-node list.index()
    # linear scans this replaces ran inside EVERY Monitor sample — at
    # soak scale that is O(nodes x zones) per second for a lookup the
    # lattice answers in O(1)
    z_idx = {z: i for i, z in enumerate(lat.zones)}
    c_idx = {c: i for i, c in enumerate(lat.capacity_types)}

    def price(itype, zone, cap):
        ti = lat.name_to_idx.get(itype)
        zi = z_idx.get(zone)
        if ti is None or zi is None:
            return 0.0
        ci = c_idx.get(cap, 0)
        p = float(lat.price[ti, zi, ci])
        return p if p == p and p != float("inf") else 0.0

    from .apis import wellknown as wk
    counted = set()
    for node in op.cluster.snapshot_nodes():
        total += price(node.labels.get(wk.LABEL_INSTANCE_TYPE, ""),
                       node.labels.get(wk.LABEL_ZONE, ""),
                       node.labels.get(wk.LABEL_CAPACITY_TYPE, "on-demand"))
        if node.node_claim:
            counted.add(node.node_claim)
    for claim in op.cluster.snapshot_claims():
        if claim.name in counted or claim.deletion_timestamp:
            continue
        if claim.instance_type:
            total += price(claim.instance_type, claim.zone or "",
                           claim.capacity_type or "on-demand")
    return round(total, 4)


def snapshot(op) -> Dict:
    """One structured control-plane sample (cheap: locked snapshots).

    ``subsystems`` rides the introspection registry (introspect/): the
    same per-subsystem stats /debug/vars serves, so soak artifacts carry
    batcher occupancy, cache residency, writer throughput, watch
    fan-out, and SLO burn as first-class series instead of the handful
    of ad-hoc counters this module used to hand-pick."""
    cluster = op.cluster
    claims = cluster.snapshot_claims()
    s = {
        "t": round(time.time(), 3),
        "sim_t": round(op.clock.now(), 3),
        "pending_pods": len(cluster.pending_pods()),
        "bound_pods": sum(1 for p in cluster.snapshot_pods()
                          if p.node_name is not None),
        "nodes": len(cluster.nodes),
        "claims": len(claims),
        "claims_deleting": sum(1 for c in claims if c.deletion_timestamp),
        "cost_per_hour": _committed_cost_per_hour(op),
        "ice_entries": sum(1 for _ in op.unavailable.entries()),
    }
    try:
        from . import introspect
        s["subsystems"] = introspect.registry().collect()
    except Exception:
        pass   # observability must never kill the monitor
    return s


class Monitor:
    """Time-series sampler over an Operator (the monitor.go analog).

    ``sample()`` on demand (deterministic loops), or ``start(interval)``
    for a daemon thread (the threaded soak). ``write(path)`` emits the
    JSON artifact: {"samples": [...], "summary": {...}}.
    """

    def __init__(self, op):
        self.op = op
        self.samples: List[Dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> Dict:
        s = snapshot(self.op)
        with self._lock:
            self.samples.append(s)
        return s

    def start(self, interval: float = 1.0) -> "Monitor":
        def run():
            while not self._stop.is_set():
                try:
                    self.sample()
                except Exception:
                    pass   # the monitor must never kill the soak
                self._stop.wait(interval)
        self._stop.clear()
        self._thread = threading.Thread(target=run, name="debug-monitor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)

    def summary(self) -> Dict:
        with self._lock:
            if not self.samples:
                return {}
            peak_nodes = max(s["nodes"] for s in self.samples)
            peak_pending = max(s["pending_pods"] for s in self.samples)
            peak_cost = max(s["cost_per_hour"] for s in self.samples)
            out = {
                "samples": len(self.samples),
                "wall_seconds": round(self.samples[-1]["t"]
                                      - self.samples[0]["t"], 3),
                "peak_nodes": peak_nodes,
                "peak_pending_pods": peak_pending,
                "peak_cost_per_hour": peak_cost,
                "final": self.samples[-1],
            }
            # the SLO burn envelope over the run (introspect/slo.py):
            # peak burn is what a soak asserts the paper's bars against
            burns = [s["subsystems"]["slo"] for s in self.samples
                     if "slo" in s.get("subsystems", {})]
            if burns:
                out["peak_latency_burn"] = max(
                    b.get("latency_burn", 0.0) for b in burns)
                out["peak_cost_burn"] = max(
                    b.get("cost_burn", 0.0) for b in burns)
            # the contention envelope (introspect/contention.py): the
            # worst lock wait any sample saw, and which lock —
            # `kpctl soak` prints it next to the burn peaks
            peak_lock, peak_wait = None, 0.0
            for s in self.samples:
                cont = s.get("subsystems", {}).get("contention", {})
                for k, v in cont.items():
                    if k.endswith("_max_wait_ms") and isinstance(
                            v, (int, float)) and v > peak_wait:
                        peak_wait = v
                        peak_lock = k[: -len("_max_wait_ms")]
            if peak_lock is not None:
                out["peak_lock_wait_ms"] = round(peak_wait, 3)
                out["peak_lock_wait_lock"] = peak_lock
            return out

    def write(self, path: str) -> None:
        """Write the artifact; a ``.gz`` suffix gzips it. Soak series
        grew to hundreds of KB per run (SOAK_r06 is ~18k lines each) —
        compressed artifacts keep the repo and CI uploads sane, and
        every reader goes through load_timeseries, which takes both."""
        with self._lock:
            doc = {"samples": list(self.samples)}
        doc["summary"] = self.summary()
        if path.endswith(".gz"):
            import gzip
            with gzip.open(path, "wt") as f:
                json.dump(doc, f, separators=(",", ":"))
        else:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)


def load_timeseries(path: str) -> Dict:
    """Read a Monitor artifact, gzipped or plain. Sniffs the gzip magic
    rather than trusting the suffix, so renamed/downloaded artifacts
    still load; kpctl and the analysis tooling route through here."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"\x1f\x8b":
        import gzip
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path, "r") as f:
        return json.load(f)


def dump_state(op, max_events: int = 40) -> str:
    """Full human-readable control-plane dump for failure diagnosis (the
    debug-watcher analog: nodes with their pods, claims with phases, ICE
    entries, the recent event tail)."""
    cluster = op.cluster
    lines: List[str] = ["=== control-plane dump ==="]
    lines.append(f"clock: {op.clock.now():.1f}")
    pods_by_node = cluster.pods_by_node()
    lines.append(f"-- nodes ({len(cluster.nodes)}):")
    for node in cluster.snapshot_nodes():
        from .apis import wellknown as wk
        pods = pods_by_node.get(node.name, [])
        taints = ",".join(t.key for t in node.taints) or "-"
        lines.append(
            f"  {node.name} {node.labels.get(wk.LABEL_INSTANCE_TYPE)}"
            f"/{node.labels.get(wk.LABEL_ZONE)}"
            f"/{node.labels.get(wk.LABEL_CAPACITY_TYPE)} "
            f"ready={node.ready} taints={taints} pods={len(pods)}")
        for p in pods[:10]:
            lines.append(f"      {p.name}"
                         + (" [ds]" if p.is_daemonset else ""))
    lines.append(f"-- claims ({len(cluster.claims)}):")
    for c in cluster.snapshot_claims():
        lines.append(
            f"  {c.name} phase={c.phase.value} type={c.instance_type} "
            f"zone={c.zone} deleting={bool(c.deletion_timestamp)}")
    pending = cluster.pending_pods()
    lines.append(f"-- pending pods ({len(pending)}):")
    for p in pending[:20]:
        lines.append(f"  {p.name} requests={dict(p.requests)}")
    ice = list(op.unavailable.entries())
    lines.append(f"-- ICE entries ({len(ice)}):")
    for e in ice[:10]:
        lines.append(f"  {e}")
    try:
        events = op.recorder.events()[-max_events:]
        lines.append(f"-- recent events ({len(events)}):")
        for ev in events:
            lines.append(f"  [{ev.type}] {ev.object_kind}/{ev.object_name} "
                         f"{ev.reason}: {ev.message}")
    except Exception:
        pass
    return "\n".join(lines)
