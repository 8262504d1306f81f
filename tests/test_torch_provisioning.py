"""The PyTorch port's provisioning controller against the JAX package's,
on the CPU.

Each scenario builds a direct ``Provisioner`` in each package over its own
``ClusterState``, ``FakeCloud``, ``UnavailableOfferings``,
``CloudProvider``, ``Recorder`` and metrics ``Registry``, all on one
``FakeClock`` with the same start, with a ``LifecycleController`` to
register the launched claims; the port's Solver runs with
``device="cpu"``. The scenarios are the provisioner scenarios of the JAX
package's control-plane tests (claim fields, spot preference, ICE feedback
and relaunch, limits that downsize then block, a zero limit, the
reserved-pool fallback, the shared limit budget, max-pods density, the
second wave against the existing node cap, the batch idle/max/swap
window, the nodepool-hash annotation) plus a launch failure, a stuck pod's
``FailedScheduling`` dedup, and a 6-pass churn run on the delta path.

What must be equal: every ``ProvisionResult``'s counts, the created
claims (name, pool, type, zone, capacity type, pods, labels, taints,
requirements, annotations except the stage timings), FakeCloud's
instances, the Recorder's events, the explain ring's records (trace ids
and times masked), where every pod ended up, and the ``/metrics``
exposition with duration values masked, which must also pass the port's
``lint_exposition``. Tolerance: none.
"""

import re

import pytest

import test_torch_cases as cases

SCENARIO_FAMILIES = ("m5", "c5", "r5", "t3")
_LATTICES = {}


def _lattice(pkg):
    lat = _LATTICES.get(pkg)
    if lat is None:
        L = cases.mod(pkg, "lattice")
        lat = L.build_lattice([s for s in L.build_catalog()
                               if s.family in SCENARIO_FAMILIES])
        _LATTICES[pkg] = lat
    return lat


class Env:
    """One package's direct provisioning stack (the simulation stratum)."""

    delay = 1.0   # registration delay, seconds

    def __init__(self, pkg):
        m = lambda name: cases.mod(pkg, name)  # noqa: E731
        self.pkg = pkg
        self.A = m("apis")
        self.wk = m("apis.wellknown")
        self.O = m("apis.objects")
        self.lattice = _lattice(pkg)
        self.clock = m("utils.clock").FakeClock()
        self.cluster = m("state.cluster").ClusterState(self.clock)
        self.cloud = m("cloud").FakeCloud(self.clock)
        self.unavailable = m("cache.unavailable").UnavailableOfferings(self.clock)
        self.recorder = m("events").Recorder(self.clock)
        self.metrics = m("metrics").Registry()
        self.cloud_provider = m("cloudprovider.cloudprovider").CloudProvider(
            self.lattice, self.cloud, self.unavailable, self.recorder, self.clock)
        S = m("solver.solve")
        self.solver = (S.Solver(self.lattice) if pkg == cases.JAX_PKG
                       else S.Solver(self.lattice, device="cpu"))
        self.node_pools = {"default": self.A.NodePool(name="default")}
        self.provisioner = m("controllers.provisioning").Provisioner(
            self.cluster, self.solver, self.node_pools, self.cloud_provider,
            self.unavailable, recorder=self.recorder, clock=self.clock,
            metrics=self.metrics)
        self.lifecycle = m("controllers.lifecycle").LifecycleController(
            self.cluster, self.cloud_provider, recorder=self.recorder,
            clock=self.clock, registration_delay=self.delay,
            metrics=self.metrics)
        self.log = []

    def pods(self, n, cpu="500m", mem="1Gi", prefix="pod", **kw):
        return [self.A.Pod(name=f"{prefix}-{i}", requests={"cpu": cpu, "memory": mem},
                           **kw) for i in range(n)]

    def add(self, pods):
        for p in pods:
            self.cluster.add_pod(p)

    def provision(self):
        r = self.provisioner.provision_once()
        plan = r.plan
        self.log.append({
            "launched": r.launched, "launch_failures": r.launch_failures,
            "scheduled": r.pods_scheduled, "unschedulable": r.pods_unschedulable,
            "degraded": (r.degraded, r.degraded_reason),
            "claims": [c.name for c in r.created_claims],
            "plan": None if plan is None else _plan_row(plan),
        })
        return r

    def register(self):
        self.clock.step(self.delay)
        self.lifecycle.reconcile()

    def settle(self, max_rounds=20):
        for _ in range(max_rounds):
            if not self.cluster.pending_pods():
                break
            self.provision()
            self.register()
        self.register()


def _plan_row(plan):
    return {
        "new": sorted((n.node_pool, n.instance_type, n.zone, n.capacity_type,
                       round(n.price_per_hour, 6), tuple(n.pods),
                       tuple(n.feasible_types)) for n in plan.new_nodes),
        "existing": {k: sorted(v) for k, v in plan.existing_assignments.items()},
        "unschedulable": dict(plan.unschedulable),
        "cost": round(plan.new_node_cost, 6),
        "path": (plan.solver_path, plan.degraded, plan.waves),
    }


def _req_row(r):
    return (r.key, r.operator.value, tuple(sorted(map(str, r.values))), r.min_values)


def _masked_metrics(text):
    """The exposition with every duration series' values masked (their
    bucket counts, sums and counts follow the host's clock)."""
    out = []
    for line in text.splitlines():
        if not line.startswith("#") and ("duration" in line.split("{")[0]
                                         or "_seconds" in line.split("{")[0]):
            line = re.sub(r"\s\S+$", " X", line)
        out.append(line)
    return out


def observe(env):
    """Everything the scenario left behind, as plain data."""
    stage_key = env.wk.ANNOTATION_SOLVER_STAGE_MS
    claims = []
    by_node = env.cluster.pods_by_node(include_daemonsets=False)
    for c in sorted(env.cluster.claims.values(), key=lambda c: c.name):
        claims.append({
            "name": c.name, "pool": c.node_pool, "type": c.instance_type,
            "zone": c.zone, "capacity_type": c.capacity_type,
            "phase": c.phase.value,
            "pods": sorted([p.name for p in env.cluster.nominated_pods(c.name)]
                           + [p.name for p in by_node.get(c.name, [])]),
            "labels": sorted(c.labels.items()),
            "taints": [(t.key, t.value, str(t.effect)) for t in c.taints],
            "requirements": [_req_row(r) for r in c.requirements],
            "annotations": sorted((k, v) for k, v in c.annotations.items()
                                  if k != stage_key),
            "capacity": sorted(c.capacity.items()),
            "allocatable": sorted(c.allocatable.items()),
        })
    instances = [(i.id, i.instance_type, i.zone, i.capacity_type, i.state,
                  i.launch_time, i.price, sorted(i.tags.items()), i.private_ip)
                 for i in env.cloud.list_instances(include_terminated=True)]
    events = [(e.time, e.type, e.reason, e.object_kind, e.object_name, e.message)
              for e in env.recorder.events()]
    explain = []
    for rec in env.provisioner.explain._snapshot():
        d = rec.to_doc(full=True)
        d["traceId"] = d["t"] = None
        explain.append(d)
    stats = {k: v for k, v in env.provisioner.stats().items()
             if k != "last_pass_solve_ms"}
    text = env.metrics.render()
    return {
        "log": env.log, "claims": claims, "instances": instances,
        "events": events, "explain": explain, "stats": stats,
        "pods": sorted((p.name, p.node_name) for p in env.cluster.pods.values()),
        "nodes": sorted(env.cluster.nodes),
        "unavailable_seq": env.unavailable.seq_num,
        "metrics": _masked_metrics(text), "_text": text,
    }


# ---- the scenarios: each drives one Env --------------------------------------

def s_claim_fields(env):
    env.add(env.pods(1))
    env.provision()
    (claim,) = env.cluster.claims.values()
    assert claim.phase == env.O.NodeClaimPhase.LAUNCHED
    assert env.wk.ANNOTATION_NODECLASS_HASH in claim.annotations
    env.settle()


def s_spot_preferred(env):
    wk = env.wk
    env.node_pools.clear()
    env.node_pools["spotty"] = env.A.NodePool(name="spotty", requirements=[
        env.A.Requirement(wk.LABEL_CAPACITY_TYPE, env.A.Operator.IN,
                          ("spot", "on-demand"))])
    env.add(env.pods(1))
    env.provision()
    (claim,) = env.cluster.claims.values()
    assert claim.capacity_type == "spot"


def s_ice_relaunch(env):
    env.add(env.pods(1, cpu="1800m", mem="7Gi"))
    choice = env.provision().plan.new_nodes[0]
    env.cloud.set_capacity(choice.capacity_type, choice.instance_type, choice.zone, 0)
    env.add(env.pods(1, cpu="1800m", mem="7Gi", prefix="again"))
    r2 = env.provision()
    assert r2.launched == 1
    env.settle()


def s_limits_downsize_then_block(env):
    env.node_pools["default"].limits = {"cpu": "8"}
    env.add(env.pods(3, cpu="2", mem="1Gi"))
    assert env.provision().launched == 1
    env.add(env.pods(3, cpu="2", mem="1Gi", prefix="over"))
    r2 = env.provision()
    assert r2.launched == 0 and r2.pods_unschedulable == 3


def s_zero_limit(env):
    env.node_pools["default"].limits = {"cpu": 0}
    env.add(env.pods(1))
    r = env.provision()
    assert r.launched == 0 and r.pods_unschedulable == 1


def _on_demand(env):
    return env.A.Requirement(env.wk.LABEL_CAPACITY_TYPE, env.A.Operator.IN,
                             ("on-demand",))


def s_reserved_fallback(env):
    A, wk = env.A, env.wk
    env.node_pools.clear()
    for p in (A.NodePool(name="reserved-instance", weight=50, limits={"cpu": "8"},
                         requirements=[A.Requirement(wk.LABEL_INSTANCE_TYPE,
                                                     A.Operator.IN, ("c5.2xlarge",)),
                                       _on_demand(env)]),
              A.NodePool(name="default", requirements=[_on_demand(env)])):
        env.node_pools[p.name] = p
    env.add([A.Pod(name=f"p{i}", requests={"cpu": "2", "memory": "2Gi"})
             for i in range(10)])
    env.settle()
    pools = {c.node_pool for c in env.cluster.claims.values()}
    assert pools == {"reserved-instance", "default"}


def s_shared_limit_budget(env):
    A = env.A
    env.node_pools.clear()
    for p in (A.NodePool(name="paused", weight=50, limits={"cpu": "0"},
                         requirements=[A.Requirement("tier", A.Operator.IN, ("gold",)),
                                       _on_demand(env)]),
              A.NodePool(name="default", limits={"cpu": "8"},
                         requirements=[_on_demand(env)])):
        env.node_pools[p.name] = p
    env.add([A.Pod(name=f"gen{i}", requests={"cpu": "2", "memory": "2Gi"})
             for i in range(4)])
    env.add([A.Pod(name=f"gold{i}", requests={"cpu": "2", "memory": "2Gi"},
                   node_selector={"tier": "gold"}) for i in range(2)])
    env.settle()
    assert not any(c.node_pool == "paused" for c in env.cluster.claims.values())


def s_max_pods_density(env):
    env.node_pools["default"] = env.A.NodePool(
        name="default", kubelet=env.O.KubeletSpec(max_pods=4),
        requirements=[_on_demand(env)])
    env.add(env.pods(10, cpu="100m", mem="128Mi"))
    env.settle()
    assert len(env.cluster.nodes) >= 3


def s_second_wave_node_cap(env):
    env.node_pools["default"] = env.A.NodePool(
        name="default", kubelet=env.O.KubeletSpec(max_pods=3),
        requirements=[_on_demand(env)])
    env.add(env.pods(3, cpu="100m", mem="128Mi"))
    env.settle()
    env.add(env.pods(2, cpu="100m", mem="128Mi", prefix="wave2"))
    env.settle()
    assert len(env.cluster.nodes) == 2


def s_batch_window(env):
    """Idle window, a same-count swap that is still an arrival, and the
    max window under a steady trickle of arrivals."""
    p = env.provisioner
    ready = []
    env.add(env.pods(1, prefix="a"))
    ready.append(p.batch_ready())
    env.clock.step(0.6)
    env.cluster.delete_pod("a-0")
    env.add(env.pods(1, prefix="b"))
    ready.append(p.batch_ready())
    env.clock.step(0.6)
    ready.append(p.batch_ready())
    env.clock.step(0.6)
    ready.append(p.batch_ready())
    env.provision()
    for i in range(14):
        env.add(env.pods(1, prefix=f"trickle{i}"))
        ready.append(p.batch_ready())
        env.clock.step(0.9)
    env.log.append({"ready": ready, "stats": {
        k: v for k, v in p.stats().items() if k != "last_pass_solve_ms"}})
    assert ready[:4] == [False, False, False, True] and True in ready[4:]
    env.provision()


def s_nodepool_hash(env):
    env.add(env.pods(1))
    env.provision()
    env.settle()
    env.node_pools["default"].labels["team"] = "new"
    env.add(env.pods(1, prefix="after"))
    env.provision()
    hashes = {c.annotations[env.wk.ANNOTATION_NODEPOOL_HASH]
              for c in env.cluster.claims.values()}
    assert len(hashes) == 2


def s_launch_failure(env):
    env.add(env.pods(2, cpu="3", mem="4Gi"))
    env.cloud.inject_error(RuntimeError("injected launch failure"))
    r = env.provision()
    assert r.launch_failures == 1
    env.settle()


def s_failed_scheduling_dedup(env):
    env.add(env.pods(1, cpu="500", mem="1Gi", prefix="huge"))
    env.add(env.pods(4))
    for _ in range(3):
        env.provision()
        env.register()
    assert len(env.recorder.events(reason="FailedScheduling")) == 1
    env.cluster.delete_pod("huge-0")
    env.cluster.add_pod(env.pods(1, cpu="500", mem="1Gi", prefix="huge")[0])
    env.provision()
    assert len(env.recorder.events(reason="FailedScheduling")) == 2


SCENARIOS = {
    "claim_fields": s_claim_fields,
    "spot_preferred": s_spot_preferred,
    "ice_relaunch": s_ice_relaunch,
    "limits_downsize_then_block": s_limits_downsize_then_block,
    "zero_limit": s_zero_limit,
    "reserved_fallback": s_reserved_fallback,
    "shared_limit_budget": s_shared_limit_budget,
    "max_pods_density": s_max_pods_density,
    "second_wave_node_cap": s_second_wave_node_cap,
    "batch_window": s_batch_window,
    "nodepool_hash": s_nodepool_hash,
    "launch_failure": s_launch_failure,
    "failed_scheduling_dedup": s_failed_scheduling_dedup,
}

_RUNS = {}


def _scenario(name):
    if name not in _RUNS:
        out = []
        for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
            env = Env(pkg)
            SCENARIOS[name](env)
            out.append(observe(env))
        _RUNS[name] = out
    return _RUNS[name]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("part", ["log", "claims", "instances", "events",
                                  "explain", "pods", "metrics", "stats"])
def test_scenario_equal(scenario, part):
    j, t = _scenario(scenario)
    assert t[part] == j[part]
    if part == "stats":
        assert (t["nodes"], t["unavailable_seq"]) == (j["nodes"], j["unavailable_seq"])


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_exposition_lints_clean(scenario):
    _, t = _scenario(scenario)
    lint = cases.mod(cases.TORCH_PKG, "metrics").lint_exposition
    assert lint(t["_text"]) == []
    assert "karpenter_nodeclaims_created_total" in t["_text"]


# ---- the steady state: 6 churned passes on the delta path --------------------

def _churn_run(pkg):
    """Provision a cfg10-shaped wave from empty, register it, then 6 passes
    in which bound pods leave and new ones arrive (every 3rd pass churns
    nothing): batch-window polls, ``provision_once``, registration."""
    import numpy as np
    env = Env(pkg)
    shapes = cases.CHURN_SHAPES
    env.add([env.A.Pod(name=f"w{i}", requests={"cpu": shapes[i % 4][0],
                                               "memory": shapes[i % 4][1]})
             for i in range(120)])
    env.provision()
    env.register()
    rng = np.random.default_rng(14)
    serial = 0
    rows = []
    for k in range(6):
        if k % 3 != 2:
            bound = sorted(p.name for p in env.cluster.pods.values() if p.node_name)
            gone = rng.choice(len(bound), size=4, replace=False)
            for i in sorted(int(g) for g in gone):
                env.cluster.delete_pod(bound[i])
            for _ in range(4):
                serial += 1
                cpu, mem = shapes[int(rng.integers(4))]
                env.cluster.add_pod(env.A.Pod(name=f"n{serial}",
                                              requests={"cpu": cpu, "memory": mem}))
        for _ in range(2):
            env.provisioner.batch_ready()
            env.clock.step(0.6)
        env.provision()
        env.register()
        rows.append({
            "inc": env.provisioner.inc_builder.incremental_builds,
            "full": env.provisioner.inc_builder.full_builds,
            "reason": env.provisioner.inc_builder.last_reason,
            "delta": env.solver.pipeline_stats["delta_solves"],
            "micro": env.solver.pipeline_stats["micro_solves"],
            "aborts": env.solver.pipeline_stats["micro_aborts"],
            "link": dict(env.solver.link_stats),
            "pending": len(env.cluster.pending_pods()),
        })
    obs = observe(env)
    obs["rows"] = rows
    return obs


def _churn():
    if "churn" not in _RUNS:
        _RUNS["churn"] = (_churn_run(cases.JAX_PKG), _churn_run(cases.TORCH_PKG))
    return _RUNS["churn"]


@pytest.mark.parametrize("part", ["log", "rows", "claims", "events", "explain",
                                  "pods", "metrics", "stats"])
def test_churn_run_equal(part):
    j, t = _churn()
    assert t[part] == j[part]


def test_churn_run_takes_the_delta_path():
    _, t = _churn()
    last = t["rows"][-1]
    assert last["inc"] > 0 and last["delta"] > 0 and last["aborts"] == 0
    assert last["pending"] == 0
    # a pass with nothing pending returns before the build: the cold wave
    # and the 4 churned passes take from the coalescer, which every
    # batch-window poll fed
    assert t["stats"]["journal_takes"] == 5
    assert t["stats"]["journal_ticks"] == 12


# ---- the card smoke's provisioner phase, rehearsed small on the CPU ----------

RATE_PASSES, SMALL_PASSES = 4, 8


def _steady_rehearsal():
    """``chip_smoke.py``'s provisioner steady state at a small size on the
    CPU: a stratified 400-pod slice of cfg10 provisioned from empty, 4
    passes of cfg10's churn rate and 8 passes of the delta smoke's small
    churn, each churned pass refereed by a scratch build's sequential
    solve (pod by pod where the pass rebuilt in full)."""
    if "steady" not in _RUNS:
        from karpenter_provider_aws_tpu_torch import workloads
        from karpenter_provider_aws_tpu_torch.solver import Solver
        lat = _lattice(cases.TORCH_PKG)
        pods, pools, shapes = workloads.config10_steady_state()
        stack = workloads.ProvisionerStack(lat, pools, Solver(lat, device="cpu"))
        for p in pods[::50]:
            stack.cluster.add_pod(p)
        first, _ = stack.provision()
        stack.register()
        referee = Solver(lat, device="cpu", pipeline=False)
        rows = []
        for churn, passes in ((workloads.ProvisionerChurn(shapes), RATE_PASSES),
                              (workloads.SmallChurn(shapes), SMALL_PASSES)):
            for k in range(passes):
                _, added, nochurn = churn.churn(stack.cluster, k)
                for _ in range(2):
                    stack.provisioner.batch_ready()
                    stack.clock.step(0.6)
                ref = (None if nochurn
                       else referee.solve(workloads.referee_problem(stack)))
                builds = stack.provisioner.inc_builder.incremental_builds
                result, _ = stack.provision()
                full = stack.provisioner.inc_builder.incremental_builds == builds
                digests = None if nochurn else tuple(
                    workloads.plan_digest(plan, stack.cluster.pods, exact=full)
                    for plan in (result.plan, ref))
                stack.register()
                rows.append((nochurn, len(added), result, digests,
                             dict(stack.timing),
                             stack.provisioner.inc_builder.last_reason))
        _RUNS["steady"] = (first, rows, stack)
    return _RUNS["steady"]


class TestSmokeRehearsal:
    def test_first_wave_places_everything(self):
        first, _, stack = _steady_rehearsal()
        assert first.pods_unschedulable == 0 and first.launch_failures == 0
        assert first.launched == len(first.created_claims) > 0
        assert not first.degraded

    @pytest.mark.parametrize("k", range(RATE_PASSES + SMALL_PASSES))
    def test_pass_equals_its_scratch_referee(self, k):
        _, rows, _ = _steady_rehearsal()
        nochurn, added, result, digests, timing, _ = rows[k]
        if nochurn:
            assert result.plan is None and added == 0
            return
        assert not result.degraded and result.pods_unschedulable == 0
        assert digests[0] == digests[1]
        assert set(timing) >= {"build", "launch_loop"}

    def test_delta_path_engaged_and_cluster_converged(self):
        """cfg10's churn rate rebuilds in full on every pass: the previous
        pass's placements, the deletions and the arrivals are all
        journal-touched (bulk churn at full size), and arrivals bring
        shapes the last build never grouped (at this size). The small
        churn rides the delta path."""
        _, rows, stack = _steady_rehearsal()
        assert {r[5] for r in rows[:RATE_PASSES]} <= {"bulk-churn", "new-signature"}
        st = stack.solver.pipeline_stats
        assert st["delta_solves"] > 0 and st["micro_aborts"] == 0
        assert stack.provisioner.inc_builder.incremental_builds > 0
        assert not stack.cluster.pending_pods()
        assert stack.provisioner.stats()["journal_ticks"] == \
            2 * (RATE_PASSES + SMALL_PASSES)
