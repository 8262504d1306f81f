"""CI smoke for zero-downtime operator handoff (ci.sh handoff gate), for
this package (the counterpart of the repository's ``tools/smoke_handoff.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_handoff [--device cuda]

Two REAL OS processes on a shared tmpdir, each this module run as

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_handoff --role leader|standby --dir D --device X

from the repository root, each with its Operator's Solver on ``--device``
(on the card both hold a context on ``cuda:0``): a leader operator
churning pods behind a FileLeaseStore lease + replication stream (unix
socket), and a warm standby applying snapshot + journal deltas into its
own mirror while pre-building through IncrementalProblemBuilder. The
parent SIGKILLs the leader mid-churn (kill -9: no lease release, no
goodbye) and asserts the things the handoff subsystem exists to prove:

1. the standby streams BEFORE the kill: snapshot applied, deltas > 0,
   prebuilds > 0 — and it is NOT leader (the lease holds it out),
2. after the kill the standby PROMOTES within the lease window (+ slack)
   with a rotated fence token, and CARRIES passes: provisioner passes
   grow, new pods get capacity (create_claim > 0), and the delta solve
   path engages on the replicated mirror (delta_solves > 0 — the warm
   standby was actually warm, not a cold rebuild),
3. zero duplicate launches: pods bound at promotion stay on their nodes
   (no relaunch of capacity the dead leader already provisioned), and
   every claim the first passes after the promotion launch holds pods,
   each of them pending at promotion (``convergence_fault``: the
   reference's check of no claim at all raced with the leader's churn),
4. the surfaces tell the story over live HTTP: the handoff introspection
   provider, a kpctl top LEADER/HANDOFF row, karpenter_operator_* gauges
   on a /metrics scrape that lints clean,
5. the lock-order witness is cycle-free in BOTH processes.

The children run on the wall clock (the Operator's default), read here
through ``utils/clock.WALL``. Unlike the reference's children, they set
no compile cache directory: both load the kernel library from the
package's build directory (the first to need it builds it there, and the
atomic rename makes a race harmless). Each child publishes its kernel
launches and its Solver's device through a ``smoke`` introspection
provider; the gate's launches are the leader's (read just before the
kill) plus the standby's.

Fast by design: small-family lattice, ~3 s lease.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import urllib.request
from pathlib import Path

from . import gate
from ..ops import offering_argmin
from ..utils.clock import WALL

REPO = Path(__file__).resolve().parents[2]
MODULE = "karpenter_provider_aws_tpu_torch.tools.smoke_handoff"

LEASE_DURATION = 3.0
PROMOTE_SLACK = 20.0      # lease window + election cadence + CI jitter


# ---------------------------------------------------------------- children

def _election_loop(elector, replica=None, period: float = 0.5) -> None:
    """The dedicated election thread (what ControllerRuntime registers as
    its leader-election controller): a slow pass must not cost the
    incumbent its lease. On a standby the same thread pumps the
    replication stream between ticks."""
    while True:
        if replica is not None and not elector.is_leader:
            replica.sync_once()
        elector.try_acquire_or_renew()
        WALL.sleep(period)


def _build_operator(device):
    from ..operator import Operator, Options
    return Operator(options=Options(registration_delay=0.5),
                    lattice=gate.small_lattice(), device=device)


def run_leader(workdir: Path, device) -> int:
    from .. import introspect
    from ..apis import Pod
    from ..cli import start_server
    from ..kube.writer import FencedWriteError
    from ..operator.leaderelection import FileLeaseStore, LeaderElector
    from ..state.replication import (ReplicationService, ReplicationSource,
                                     serve_replication)

    op = _build_operator(device)
    label = op.solver.stats()["device"]
    introspect.registry().register("smoke", lambda: {
        "kernel_launches": offering_argmin.LAUNCHES, "device": label})
    src = ReplicationSource(op.cluster)
    repl = serve_replication(ReplicationService(src),
                             f"unix:{workdir}/repl.sock")
    elector = LeaderElector(FileLeaseStore(str(workdir / "lease.json")),
                            "leader", lease_duration=LEASE_DURATION)
    op.wire_handoff(elector, source=src)
    threading.Thread(target=_election_loop, args=(elector,),
                     daemon=True).start()
    http = start_server(op, 0)
    (workdir / "leader.port").write_text(str(http.server_address[1]))
    serial = 0
    try:
        while True:   # until the parent SIGKILLs us (that's the point)
            if elector.is_leader:
                for _ in range(2):
                    serial += 1
                    op.cluster.add_pod(Pod(
                        name=f"lp{serial}",
                        requests={"cpu": "500m", "memory": "1Gi"}))
                try:
                    op.run_once(force_provision=True)
                except FencedWriteError:
                    pass   # demoted mid-pass: correctly fenced, go quiet
            src.tick()
            WALL.sleep(0.3)
    finally:
        repl.stop(0)
        http.shutdown()
    return 0


def run_standby(workdir: Path, device) -> int:
    from .. import introspect
    from ..apis import Pod
    from ..cli import start_server
    from ..cloud.fake import CloudInstance, parse_instance_id
    from ..operator.leaderelection import FileLeaseStore, LeaderElector
    from ..state.replication import ReplicationClient, StandbyReplica

    op = _build_operator(device)
    replica = StandbyReplica(
        op.cluster, ReplicationClient(f"unix:{workdir}/repl.sock"),
        prebuild=lambda: op.provisioner.warm_build())
    elector = LeaderElector(FileLeaseStore(str(workdir / "lease.json")),
                            "standby", lease_duration=LEASE_DURATION,
                            promotion_gate=replica.promotion_ready)

    smoke = {"promoted": False, "rebinds": 0, "bound_at_promotion": 0,
             "pending_at_promotion": [], "convergence_claims": 0,
             "convergence_pods": {}, "kernel_launches": 0,
             "device": op.solver.stats()["device"]}
    bound0 = {}
    claims0 = {}

    def on_promote() -> None:
        # adopt the dead leader's fleet: the mirror replicated its claims,
        # so materialize their instances in OUR cloud before any
        # controller lists it (otherwise GC reads the fleet as vanished
        # and the convergence passes relaunch everything — the exact
        # duplicate-launch failure this smoke gates on)
        for c in list(op.cluster.claims.values()):
            if not c.provider_id:
                continue
            iid = parse_instance_id(c.provider_id)
            op.cloud.instances[iid] = CloudInstance(
                id=iid, instance_type=c.instance_type or "m5.large",
                zone=c.zone or "us-west-2a",
                capacity_type=c.capacity_type or "on-demand",
                launch_time=c.launched_at or 0.0)
        bound0.update({p.name: p.node_name
                       for p in op.cluster.pods.values() if p.node_name})
        claims0.update(op.cluster.claims)   # name -> the mirror's object
        smoke["promoted"] = True
        smoke["bound_at_promotion"] = len(bound0)
        smoke["pending_at_promotion"] = sorted(
            p.name for p in op.cluster.pending_pods())
        introspect.registry().register("smoke", lambda: dict(smoke))

    elector.on_promote = on_promote          # wire_handoff chains onto it
    op.wire_handoff(elector, replica=replica)
    threading.Thread(target=_election_loop, args=(elector, replica),
                     daemon=True).start()
    http = start_server(op, 0)
    (workdir / "standby.port").write_text(str(http.server_address[1]))
    serial = 0
    passes = 0
    try:
        while True:
            # gate passes on the PROMOTE HOOK having finished (not bare
            # is_leader): the fleet adoption above must land before the
            # first pass lists the cloud
            if not smoke["promoted"]:
                pass   # the election thread streams + gates promotion
            else:
                passes += 1
                if passes > 3:   # first passes are pure convergence:
                    serial += 1  # nothing new to place, nothing launched
                    op.cluster.add_pod(Pod(
                        name=f"sp{serial}",
                        requests={"cpu": "500m", "memory": "1Gi"}))
                op.run_once(force_provision=True)
                if passes <= 3:
                    # the pods each claim of the convergence passes holds
                    # over the three passes: nominated to it at its launch,
                    # or bound since the promotion to its node (named as
                    # the claim). A new claim is a new object: its name
                    # may be one the leader used, since both processes
                    # number their claims from 1
                    held = smoke["convergence_pods"]
                    for name, claim in list(op.cluster.claims.items()):
                        if claims0.get(name) is claim:
                            continue
                        held[name] = sorted(set(held.get(name, ())) | {
                            p.name for p in op.cluster.nominated_pods(name)
                        } | {p.name for p in op.cluster.pods.values()
                             if p.node_name == name and p.name not in bound0})
                if passes == 3:
                    smoke["convergence_claims"] = \
                        op.writer.counts.get("create_claim", 0)
                smoke["rebinds"] = sum(
                    1 for name, node in bound0.items()
                    if (p := op.cluster.pods.get(name)) is not None
                    and p.node_name != node)
                smoke["kernel_launches"] = offering_argmin.LAUNCHES
                # whole or not at all: the parent reads it while this
                # loop rewrites it every pass
                tmp = workdir / "standby.status.json.tmp"
                tmp.write_text(json.dumps(smoke))
                os.replace(tmp, workdir / "standby.status.json")
            WALL.sleep(0.3)
    finally:
        http.shutdown()
    return 0


# ---------------------------------------------------------------- parent

def convergence_fault(status: dict):
    """The duplicate-launch check of the convergence passes, or None.

    The reference gate requires that the standby's first three passes
    launch no claim at all. That holds only when the last delta the
    standby applied carried no pod without capacity, and the leader adds
    two pods just before each of its passes: when the standby polls
    between the two, the pods arrive pending with no claim of the
    leader's in the mirror, and rightly get capacity after the promotion
    (seen on the CPU beside other load: 2 of 6 runs promoted with 2 such
    pods and launched 1 claim for them, every pod bound at promotion
    staying on its node). So the check is made on the claims themselves:
    every claim of those passes (``convergence_pods``: claim -> the pods
    nominated to it at its launch or bound to it since the promotion)
    holds at least one pod, and every pod it holds was pending at
    promotion. With no pod pending this is the reference's check of no
    claim at all; a claim launched for pods that were already bound fails
    it, and if they moved, so does ``rebinds``."""
    pending = set(status.get("pending_at_promotion", ()))
    held = status.get("convergence_pods", {})
    claims = status.get("convergence_claims", 0)
    if claims != len(held):
        return (f"{claims} claims launched during pure convergence passes, "
                f"{len(held)} of them in the mirror")
    for claim, pods in sorted(held.items()):
        if not pods:
            return (f"claim {claim} launched during pure convergence passes "
                    "holds no pod")
        bound = sorted(set(pods) - pending)
        if bound:
            return (f"claim {claim} launched during pure convergence passes "
                    f"— duplicate capacity for already-bound pods {bound} "
                    f"({len(pending)} pods were pending at promotion)")
    return None


def _fetch(base: str, path: str, timeout: float = 10.0):
    return urllib.request.urlopen(f"{base}{path}", timeout=timeout).read()


def _vars(base: str) -> dict:
    return json.loads(_fetch(base, "/debug/vars"))


def _wait(what: str, deadline: float, fn):
    """Poll ``fn`` until it returns a truthy value; raise past deadline."""
    while True:
        try:
            v = fn()
        except Exception:
            v = None
        if v:
            return v
        if WALL.now() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        WALL.sleep(0.25)


def _spawn(workdir: Path, role: str, device) -> subprocess.Popen:
    logf = open(workdir / f"{role}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", MODULE, "--role", role, "--dir",
         str(workdir), "--device", str(device)],
        cwd=str(REPO), stdout=logf, stderr=subprocess.STDOUT)


def run_parent(device) -> int:
    from ..metrics import lint_exposition
    from . import kpctl
    workdir = Path(tempfile.mkdtemp(prefix="smoke-handoff-"))
    failures = []
    leader = standby = None
    leader_launches = 0
    device_label = str(device)
    try:
        # phase 1: leader boots, wins the lease, provisions under churn
        leader = _spawn(workdir, "leader", device)
        port_a = int(_wait("leader port file", WALL.now() + 120,
                           lambda: (workdir / "leader.port").exists()
                           and (workdir / "leader.port").read_text()))
        base_a = f"http://127.0.0.1:{port_a}"
        doc_a = _wait("leader first passes", WALL.now() + 180, lambda: (
            lambda d: d if (d["providers"]["provisioner"].get("passes", 0)
                            >= 2 and d["providers"]["cluster"].get("nodes",
                                                                   0) > 0)
            else None)(_vars(base_a)))
        ho_a = doc_a["providers"].get("handoff", {})
        if not ho_a.get("leader"):
            failures.append(f"leader process not leading: {ho_a}")
        if ho_a.get("fence", 0) < 1:
            failures.append(f"leader fence never rotated up: {ho_a}")
        if doc_a["providers"].get("lockorder", {}).get("cycles", 1) != 0:
            failures.append("lock-order witness cycle in the LEADER")

        # phase 2: standby streams while the leader lives — and stays out
        standby = _spawn(workdir, "standby", device)
        port_b = int(_wait("standby port file", WALL.now() + 120,
                           lambda: (workdir / "standby.port").exists()
                           and (workdir / "standby.port").read_text()))
        base_b = f"http://127.0.0.1:{port_b}"
        ho_b = _wait("standby streaming", WALL.now() + 180, lambda: (
            lambda h: h if (h.get("replica_anchor", -1) >= 0
                            and h.get("replica_deltas", 0) > 0
                            and h.get("replica_prebuilds", 0) > 0)
            else None)(_vars(base_b)["providers"].get("handoff", {})))
        if ho_b.get("leader"):
            failures.append("standby leads while the leader is alive")
        if ho_b.get("replica_snapshots", 0) < 1:
            failures.append(f"standby never applied a snapshot: {ho_b}")

        # phase 3: kill -9 the leader mid-churn; standby must promote
        # within the lease window (+ slack) with a rotated fence
        leader_fence = ho_a.get("fence", 0)
        mine = _vars(base_a)["providers"].get("smoke", {})
        leader_launches = int(mine.get("kernel_launches", 0))
        device_label = mine.get("device", device_label)
        os.kill(leader.pid, signal.SIGKILL)
        leader.wait(15)
        t_kill = WALL.now()
        ho_b = _wait("standby promotion",
                     t_kill + LEASE_DURATION + PROMOTE_SLACK,
                     lambda: (lambda h: h if h.get("leader") else None)(
                         _vars(base_b)["providers"].get("handoff", {})))
        promote_latency = WALL.now() - t_kill
        if ho_b.get("fence", 0) <= leader_fence:
            failures.append(f"promotion did not rotate the fence "
                            f"(leader {leader_fence} -> {ho_b.get('fence')})")

        # phase 4: the promoted standby CARRIES passes — new pods get
        # capacity, the delta solve path engages on the replicated
        # mirror, and nothing already-bound is relaunched
        def _carrying():
            d = _vars(base_b)
            pr = d["providers"]
            ok = (pr["provisioner"].get("passes", 0) >= 5
                  and pr.get("writer", {}).get("create_claim", 0) > 0
                  and pr["solver"].get("delta_solves", 0) > 0)
            return d if ok else None
        doc_b = _wait("promoted standby carrying passes",
                      WALL.now() + 180, _carrying)
        status = json.loads((workdir / "standby.status.json").read_text())
        if not status.get("promoted"):
            failures.append(f"standby status never marked promoted: {status}")
        if status.get("bound_at_promotion", 0) <= 0:
            failures.append("vacuous handoff: no pods were bound at "
                            "promotion (leader never really worked)")
        if status.get("rebinds", 0) != 0:
            failures.append(f"{status['rebinds']} pods rebound after "
                            "promotion (duplicate launch territory)")
        fault = convergence_fault(status)
        if fault:
            failures.append(fault)

        # phase 5: the surfaces — kpctl rows, /metrics lint, lockorder
        top = "\n".join(kpctl._render_top(doc_b, base_b))
        leader_rows = [ln for ln in top.splitlines()
                       if ln.startswith("LEADER")]
        if not leader_rows or "leader" not in leader_rows[0]:
            failures.append(f"kpctl top LEADER row wrong: {leader_rows}")
        if not any(ln.startswith("HANDOFF") for ln in top.splitlines()):
            failures.append("kpctl top renders no HANDOFF row")
        scrape = _fetch(base_b, "/metrics").decode()
        for series in ("karpenter_operator_leader_state",
                       "karpenter_operator_handoff_fence_token",
                       "karpenter_operator_handoff_deltas",
                       "karpenter_operator_handoff_rebuilds"):
            if series not in scrape:
                failures.append(f"/metrics missing {series}")
        lint = lint_exposition(scrape)
        if lint:
            failures.append(f"live scrape lint: {lint[:3]}")
        if doc_b["providers"].get("lockorder", {}).get("cycles", 1) != 0:
            failures.append("lock-order witness cycle in the STANDBY")
        # the standby's launches after carrying (its status is written
        # after every pass)
        status = json.loads((workdir / "standby.status.json").read_text())
        if status.get("device") != device_label:
            failures.append(f"the two processes solved on different "
                            f"devices: {device_label} and "
                            f"{status.get('device')}")
    except Exception as e:  # noqa: BLE001 - any escape is the failure
        failures.append(f"{type(e).__name__}: {e}")
        status = {}
    finally:
        for proc in (leader, standby):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(15)
                except subprocess.TimeoutExpired:
                    proc.kill()

    gate.report("handoff", device, device_label, failures,
                kernel_launches=leader_launches
                + int(status.get("kernel_launches", 0)))
    if failures:
        print("handoff smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        for role in ("leader", "standby"):
            log = workdir / f"{role}.log"
            if log.exists():
                tail = log.read_text().splitlines()[-15:]
                print(f"  --- {role}.log tail ---")
                for ln in tail:
                    print(f"  {ln}")
        return 1
    print(f"handoff smoke: OK (promoted in {promote_latency:.1f}s, "
          f"fence {leader_fence}->{ho_b.get('fence')}, "
          f"deltas={ho_b.get('replica_deltas')}, "
          f"carried {status['bound_at_promotion']} bound pods, "
          f"0 rebinds, {status['convergence_claims']} convergence "
          f"launches)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", choices=("leader", "standby"))
    ap.add_argument("--dir")
    ap.add_argument("--device", default="cuda",
                    help="device of both processes' Solvers (default "
                         "cuda; raises without a card)")
    a = ap.parse_args(argv)
    device = gate.device_arg(["--device", a.device], None)
    if a.role == "leader":
        return run_leader(Path(a.dir), device)
    if a.role == "standby":
        return run_standby(Path(a.dir), device)
    return run_parent(device)


if __name__ == "__main__":
    raise SystemExit(main())
