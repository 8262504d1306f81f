"""The PyTorch port's consolidation engine against the JAX package's, on
the CPU.

Each scenario of the JAX package's ``tests/test_consolidation.py`` is
replayed on a consolidation stack of each package: the port's
``workloads.ConsolidationStack`` (its Solver on the CPU) and the JAX
package's controllers wired the same way (``test_torch_cases``
``JaxConsolidationStack``). Both run on a ``FakeClock`` with the same
start, over the same slice of the synthetic catalog. Each replay keeps the
original test's own checks, on both packages, and then requires the two
packages to agree on what they decided: the claims (type, zone, capacity
type, phase, deletion), the nodes, where every pod is bound, the
in-flight disruption actions with their replacements, FakeCloud's
instances, the engine's counters and skip-ledger codes, the recorder's
events, and each checkpoint the scenario logs along the way. Savings in
$/hr are held within 1e-5 relative (the probes' float32 cost sums run in
another order); everything else must be equal.

The JAX package's ``FaultInjector(g_limit=1)`` (the host-fallback case)
has no port; on the port side the same ceiling is set by replacing the
Solver's ``_g_ceiling``.
"""

import math
import types

import pytest

import test_torch_cases as cases

REL = 1e-5
FAMILIES = ("m5", "c5")


class Env:
    """One package's consolidation stack plus that package's API modules;
    attributes not found here are the stack's."""

    def __init__(self, pkg, families=FAMILIES, pools=None, disruption=None,
                 clock_start=None, **opts):
        m = lambda name: cases.mod(pkg, name)  # noqa: E731
        self.pkg = pkg
        self.A = m("apis")
        self.wk = m("apis.wellknown")
        self.O = m("apis.objects")
        self.taxonomy = m("solver.taxonomy")
        self.lattice = cases.family_lattice(pkg, families)
        if pools is None:
            d = (self.O.NodePoolDisruption(**disruption) if disruption
                 else self.O.NodePoolDisruption())
            pools = [self.A.NodePool(name="default", disruption=d, requirements=[
                self.A.Requirement(self.wk.LABEL_CAPACITY_TYPE,
                                   self.A.Operator.IN, ("on-demand",))])]
        else:
            pools = pools(self)
        opts.setdefault("registration_delay", 1.0)
        self.stack = cases.consolidation_stack(pkg, self.lattice, pools,
                                               clock_start=clock_start, **opts)
        self.log = []

    def __getattr__(self, name):
        return getattr(self.stack, name)

    @property
    def jax(self):
        return self.pkg == cases.JAX_PKG

    def pods(self, n, cpu="500m", mem="1Gi", prefix="pod", **kw):
        return [self.A.Pod(name=f"{prefix}-{i}",
                           requests={"cpu": cpu, "memory": mem}, **kw)
                for i in range(n)]

    def anti(self, key, value):
        return [self.O.PodAffinityTerm(topology_key=self.wk.LABEL_HOSTNAME,
                                       label_selector=((key, value),), anti=True)]

    def spread_pods(self, n, cpu="500m", mem="1Gi", prefix="sp", start=0):
        """One pod per node via hostname self-anti-affinity on the group."""
        return [self.A.Pod(name=f"{prefix}-{i}", labels={"grp": prefix},
                           requests={"cpu": cpu, "memory": mem},
                           pod_affinity=self.anti("grp", prefix))
                for i in range(start, start + n)]

    def add(self, pods):
        for p in pods:
            self.cluster.add_pod(p)

    def snap(self, tag):
        """Log a checkpoint of the decisions so far."""
        self.log.append((tag, observe(self)))


def observe(env):
    st = env.stack
    eng = st.disruption.engine
    stats = eng.stats()
    return {
        "claims": sorted((c.name, c.node_pool, c.instance_type, c.zone,
                          c.capacity_type, c.phase.value,
                          c.deletion_timestamp is not None)
                         for c in st.cluster.snapshot_claims()),
        "nodes": sorted(st.cluster.nodes),
        "pods": sorted((p.name, p.node_name) for p in st.cluster.snapshot_pods()),
        "in_flight": [(a.reason, list(a.claims), list(a.replacements))
                      for a in st.disruption._in_flight],
        "instances": sorted((i.id, i.instance_type, i.zone, i.capacity_type,
                             i.state) for i in st.cloud.instances.values()),
        "counters": {k: v for k, v in stats.items() if k != "savings_per_hour"},
        "savings": stats["savings_per_hour"],
        "ledger": {n: d["code"] for n, d in eng.ledger_doc().items()},
        "events": [(e.time, e.type, e.reason, e.object_kind, e.object_name,
                    e.message) for e in st.recorder.events()],
    }


def assert_same(j, t, where="final"):
    """The port's observation equals the JAX package's (savings within
    REL)."""
    for k in j:
        if k == "savings":
            assert t[k] == pytest.approx(j[k], rel=REL, abs=1e-9), f"{where}: {k}"
        else:
            assert t[k] == j[k], f"{where}: {k} differs"


def replay(scenario, **env_kw):
    """Run ``scenario(env)`` on both packages' stacks and require the same
    decisions; returns the two environments (JAX, port)."""
    envs = []
    extras = []
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        env = Env(pkg, **env_kw)
        extras.append(scenario(env))
        envs.append(env)
    j, t = envs
    assert [tag for tag, _ in t.log] == [tag for tag, _ in j.log]
    for (tag, jo), (_, to) in zip(j.log, t.log):
        assert_same(jo, to, tag)
    assert_same(observe(j), observe(t))
    assert extras[1] == extras[0]
    return j, t


# ---- scenarios of tests/test_consolidation.py, one function each ----

def overprovisioned(env, n=4, consolidate_after=5.0):
    """n oversized nodes each pinned non-empty by one tiny anti-affine
    pod: emptiness can't claim them, consolidation can."""
    for p in env.spread_pods(n, cpu="3", mem="6Gi", prefix="big"):
        env.cluster.add_pod(p)
    env.settle(max_rounds=30)
    assert len(env.cluster.nodes) == n
    for i in range(n):
        env.cluster.delete_pod(f"big-{i}")
    for i in range(n):
        env.cluster.add_pod(env.A.Pod(
            name=f"tiny-{i}", labels={"grp": "big"},
            requests={"cpu": "250m", "memory": "256Mi"},
            pod_affinity=env.anti("grp", "big")))
    env.settle(max_rounds=10)
    assert len(env.cluster.nodes) == n
    env.clock.step(consolidate_after + 1.0)
    env.snap("overprovisioned")


OVERPROVISIONED = {"disruption": {"consolidation_policy": "WhenUnderutilized",
                                  "consolidate_after": 5.0}}


def singles(env):
    return [[c] for c in env.cluster.claims.values()]


def probe_rows(verdicts):
    return [(v.probe.feasible, v.probe.n_new, round(v.probe.new_cost, 5),
             v.probe.new_cap_type, v.probe.flex, round(v.removed_price, 6),
             v.cached, v.host) for v in verdicts]


def sc_pending_churn_served_from_cache(env):
    overprovisioned(env)
    eng = env.disruption.engine
    sets = singles(env)
    v1 = eng.probe(sets)
    assert eng.counters["vmapped_whatifs"] == 1
    assert eng.counters["batched_candidates"] == len(sets)
    assert not any(v.cached for v in v1)
    v2 = eng.probe(sets)
    assert all(v.cached for v in v2)
    assert eng.counters["vmapped_whatifs"] == 1
    assert eng.counters["fp_unchanged"] == len(sets)
    env.cluster.add_pod(env.A.Pod(name="pending-only",
                                  requests={"cpu": "100m", "memory": "64Mi"}))
    v3 = eng.probe(sets)
    assert all(v.cached for v in v3)
    assert eng.counters["vmapped_whatifs"] == 1
    assert [v.probe for v in v3] == [v.probe for v in v1]
    return [probe_rows(v) for v in (v1, v2, v3)]


def sc_bin_change_invalidates(env):
    overprovisioned(env)
    eng = env.disruption.engine
    sets = singles(env)
    eng.probe(sets)
    assert all(v.cached for v in eng.probe(sets))
    env.cluster.delete_pod("tiny-0")
    v = eng.probe(sets)
    assert not any(x.cached for x in v)
    assert eng.counters["cache_invalidations"] == 1
    assert eng.counters["vmapped_whatifs"] == 2
    return probe_rows(v)


def sc_price_and_unavailability_invalidate(env):
    overprovisioned(env)
    eng = env.disruption.engine
    sets = singles(env)
    eng.probe(sets)
    env.unavailable.mark_unavailable(
        "InsufficientInstanceCapacity", "on-demand", "m5.large",
        env.lattice.zones[0])
    assert not any(v.cached for v in eng.probe(sets))
    assert eng.counters["cache_invalidations"] == 1
    assert all(v.cached for v in eng.probe(sets))
    env.solver.lattice.price_version += 1
    v = eng.probe(sets)
    assert not any(x.cached for x in v)
    assert eng.counters["cache_invalidations"] == 2
    return probe_rows(v)


def sc_wave_scale_set_flagged_and_counted(env):
    for i in range(4):
        env.cluster.add_pod(env.A.Pod(name=f"p-{i}", requests={
            "cpu": f"{500 + 10 * i}m", "memory": "1Gi"}))
    env.settle()
    assert len(env.cluster.claims) == 1
    eng = env.disruption.engine
    eng._cache.clear()
    dispatches = eng.counters["vmapped_whatifs"]
    if env.jax:
        from karpenter_provider_aws_tpu.solver.faults import FaultInjector
        env.solver.inject_faults(FaultInjector(g_limit=1))
    else:
        env.solver._g_ceiling = lambda: 1
    try:
        v = eng.probe(singles(env))
        assert v[0].host and not v[0].cached
        assert eng.counters["host_fallbacks"] == 1
        assert eng.counters["vmapped_whatifs"] == dispatches
        assert not eng._cache
    finally:
        if env.jax:
            env.solver.inject_faults(None)
        else:
            del env.solver._g_ceiling
    return probe_rows(v)


def sc_referee_accepts_within_envelope(env):
    overprovisioned(env, n=2)
    eng = env.disruption.engine
    claim = next(iter(env.cluster.claims.values()))
    ok, ratio = eng.referee([claim], types.SimpleNamespace(new_node_cost=0.0))
    assert ok
    assert eng.counters["referee_checks"] == 1
    assert eng.counters["referee_rejects"] == 0
    return ok, round(ratio, 6)


def sc_referee_rejects_outside_envelope(env):
    overprovisioned(env, n=2)
    eng = env.disruption.engine
    claim = next(iter(env.cluster.claims.values()))
    ok, ratio = eng.referee([claim], types.SimpleNamespace(new_node_cost=1e9))
    assert not ok and ratio > 1.02
    assert eng.counters["referee_rejects"] == 1
    return ok, float(f"{ratio:.6g}")


def sc_note_skip_lockstep(env):
    eng = env.disruption.engine
    eng.note_skip("node-a", env.taxonomy.NOT_CONSOLIDATABLE_PDB,
                  "pdb web-pdb prevents pod evictions")
    st = eng.stats()
    assert st["skip_not_consolidatable_pdb"] == 1
    doc = eng.ledger_doc()["node-a"]
    assert doc["code"] == env.taxonomy.NOT_CONSOLIDATABLE_PDB
    assert "web-pdb" in doc["detail"]
    entry = eng.audit.find_node("node-a")
    assert entry and entry["code"] == env.taxonomy.NOT_CONSOLIDATABLE_PDB
    return doc, {k: entry[k] for k in ("code", "detail")}


def sc_unknown_code_rejected(env):
    with pytest.raises(AssertionError):
        env.disruption.engine.note_skip("n", "not-a-real-code")


def sc_note_accept_clears_ledger(env):
    eng = env.disruption.engine
    eng.note_skip("node-b", env.taxonomy.CONSOLIDATION_NO_SAVINGS)
    eng.note_accept([types.SimpleNamespace(name="node-b")], 0.25)
    assert "node-b" not in eng.ledger_doc()
    assert eng.counters["nodes_consolidated"] == 1
    assert eng.counters["savings_per_hour"] == pytest.approx(0.25)


def sc_taxonomy_codes_declared(env):
    t = env.taxonomy
    codes = (t.NOT_CONSOLIDATABLE_PDB, t.NOT_CONSOLIDATABLE_BUDGET,
             t.CONSOLIDATION_NO_SAVINGS, t.CONSOLIDATION_WEATHER_HOLD,
             t.CONSOLIDATION_SPOT_GUARD)
    for code in codes:
        assert code in t.CODES
    return codes


def sc_hold_blocks_then_resumes(env):
    overprovisioned(env)
    eng = env.disruption.engine
    eng.weather_advisory = lambda: {"hold": True, "reason": "spot-crash"}
    before = set(env.cluster.claims)
    for _ in range(3):
        env.disruption._reconcile_once()
    assert set(env.cluster.claims) == before
    assert eng.counters["weather_holds"] >= 1
    assert eng.stats()["skip_consolidation_weather_hold"] >= len(before)
    codes = {d["code"] for d in eng.ledger_doc().values()}
    assert codes == {env.taxonomy.CONSOLIDATION_WEATHER_HOLD}
    env.snap("held")
    eng.weather_advisory = lambda: {"hold": False, "reason": ""}
    assert env.disruption._reconcile_once()
    assert eng.counters["accepted"] >= 1


def sc_broken_advisory_never_wedges(env):
    eng = env.disruption.engine

    def boom():
        raise RuntimeError("advisory down")

    eng.weather_advisory = boom
    assert eng.weather_hold() == ""


def sc_zero_budget_codes_and_refuses(env):
    overprovisioned(env)
    pool = env.node_pools["default"]
    pool.disruption.budgets = [env.O.DisruptionBudget(nodes="0")]
    before = set(env.cluster.claims)
    for _ in range(2):
        env.disruption._reconcile_once()
    assert set(env.cluster.claims) == before
    assert not env.disruption._in_flight
    st = env.disruption.engine.stats()
    assert st["skip_not_consolidatable_budget"] >= 1
    assert st["vmapped_whatifs"] >= 1
    env.snap("zero budget")
    pool.disruption.budgets = [env.O.DisruptionBudget(nodes="1")]
    assert env.disruption._reconcile_once()
    assert env.disruption.engine.counters["accepted"] == 1


def sc_new_candidate_jumps_the_scan_window(env):
    ca = 60.0
    for p in env.spread_pods(3, prefix="sp"):
        env.cluster.add_pod(p)
    env.settle(max_rounds=30)
    assert len(env.cluster.claims) == 3
    env.disruption.MAX_SINGLE_PROBES = 1
    env.clock.step(ca + 1.0)
    old = set(env.cluster.claims)
    for _ in range(3):
        assert not env.disruption._reconcile_once()
    assert env.disruption._covered == old
    orig_reconcile = env.disruption.reconcile
    env.disruption.reconcile = lambda: None
    try:
        env.cluster.add_pod(env.spread_pods(1, prefix="sp", start=3)[0])
        env.settle(max_rounds=30)
    finally:
        env.disruption.reconcile = orig_reconcile
    new_name = (set(env.cluster.claims) - old).pop()
    new_claim = env.cluster.claims[new_name]
    for _ in range(3):
        env.disruption._reconcile_once()
    assert env.disruption._covered == old
    env.snap("re-covered")
    ref = new_claim.initialized_at or new_claim.created_at
    remaining = (ref + ca) - env.clock.now()
    assert remaining > 0, "premise broken: new claim already eligible"
    env.clock.step(remaining + 0.5)
    env.disruption._reconcile_once()
    assert env.disruption._covered == {new_name}
    return sorted(env.disruption._covered)


def pdb_blocked(env):
    for p in env.spread_pods(3, prefix="web"):
        env.cluster.add_pod(p)
    env.settle(max_rounds=30)
    assert len(env.cluster.nodes) == 3
    env.clock.step(6.0)
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="web-pdb", label_selector={"grp": "web"}, max_unavailable=0))


def sc_pdb_one_event_and_skip_per_episode(env):
    pdb_blocked(env)
    nodes = set(env.cluster.nodes)
    for _ in range(4):
        env.disruption._reconcile_once()
    events = env.recorder.events(reason="Unconsolidatable")
    assert len(events) == len(nodes)
    st = env.disruption.engine.stats()
    assert st["skip_not_consolidatable_pdb"] == len(nodes)
    ledger = env.disruption.engine.ledger_doc()
    assert set(ledger) == nodes
    assert all(d["code"] == env.taxonomy.NOT_CONSOLIDATABLE_PDB
               for d in ledger.values())


def sc_pdb_rearm_on_pdb_change(env):
    pdb_blocked(env)
    nodes = set(env.cluster.nodes)
    for _ in range(2):
        env.disruption._reconcile_once()
    assert len(env.recorder.events(reason="Unconsolidatable")) == len(nodes)
    env.cluster.delete_pdb("web-pdb")
    env.disruption._reconcile_once()
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="web-pdb", label_selector={"grp": "web"}, max_unavailable=0))
    for _ in range(2):
        env.disruption._reconcile_once()
    assert len(env.recorder.events(reason="Unconsolidatable")) == 2 * len(nodes)
    assert env.disruption.engine.stats()[
        "skip_not_consolidatable_pdb"] == 2 * len(nodes)


def sc_pdb_rearm_on_pod_churn(env):
    pdb_blocked(env)
    for _ in range(2):
        env.disruption._reconcile_once()
    node = next(iter(env.cluster.nodes))
    victim = next(p for p in env.cluster.snapshot_pods()
                  if p.node_name == node and not p.is_daemonset)
    before = len(env.recorder.events(reason="Unconsolidatable"))
    env.cluster.delete_pod(victim.name)
    env.disruption._reconcile_once()
    env.snap("victim gone")
    env.cluster.add_pod(env.A.Pod(
        name="web-again", labels={"grp": "web"},
        requests={"cpu": "250m", "memory": "256Mi"},
        pod_affinity=env.anti("grp", "web")))
    env.settle(max_rounds=10)
    for _ in range(2):
        env.disruption._reconcile_once()
    assert len(env.recorder.events(reason="Unconsolidatable")) == before + 1


ZERO_BUDGET_CONSOLIDATION = "zero-budget"


def _env_kw(kind):
    if kind == "overprovisioned":
        return OVERPROVISIONED
    if kind == "frontier":
        return {"disruption": {"consolidation_policy": "WhenUnderutilized",
                               "consolidate_after": 60.0}}
    if kind == ZERO_BUDGET_CONSOLIDATION:
        return {"pools": lambda e: [e.A.NodePool(
            name="default",
            disruption=e.O.NodePoolDisruption(
                consolidation_policy="WhenUnderutilized", consolidate_after=5.0,
                budgets=[e.O.DisruptionBudget(nodes="0")]),
            requirements=[e.A.Requirement(e.wk.LABEL_CAPACITY_TYPE,
                                          e.A.Operator.IN, ("on-demand",))])]}
    return {}


# name -> (scenario, env kind); the names are the JAX package's tests
SCENARIOS = {
    "TestZeroLegCache::test_pending_churn_served_from_cache":
        (sc_pending_churn_served_from_cache, "overprovisioned"),
    "TestZeroLegCache::test_bin_change_invalidates":
        (sc_bin_change_invalidates, "overprovisioned"),
    "TestZeroLegCache::test_price_and_unavailability_invalidate":
        (sc_price_and_unavailability_invalidate, "overprovisioned"),
    "TestHostFallback::test_wave_scale_set_flagged_and_counted":
        (sc_wave_scale_set_flagged_and_counted, "plain"),
    "TestReferee::test_accepts_within_envelope":
        (sc_referee_accepts_within_envelope, "overprovisioned"),
    "TestReferee::test_rejects_outside_envelope":
        (sc_referee_rejects_outside_envelope, "overprovisioned"),
    "TestSkipLedger::test_note_skip_lockstep": (sc_note_skip_lockstep, "plain"),
    "TestSkipLedger::test_unknown_code_rejected":
        (sc_unknown_code_rejected, "plain"),
    "TestSkipLedger::test_note_accept_clears_ledger":
        (sc_note_accept_clears_ledger, "plain"),
    "TestSkipLedger::test_taxonomy_codes_declared":
        (sc_taxonomy_codes_declared, "plain"),
    "TestWeatherGate::test_hold_blocks_then_resumes":
        (sc_hold_blocks_then_resumes, "overprovisioned"),
    "TestWeatherGate::test_broken_advisory_never_wedges":
        (sc_broken_advisory_never_wedges, "plain"),
    "TestBudgetPacing::test_zero_budget_codes_and_refuses":
        (sc_zero_budget_codes_and_refuses, "overprovisioned"),
    "TestFrontierReverification::test_new_candidate_jumps_the_scan_window":
        (sc_new_candidate_jumps_the_scan_window, "frontier"),
    "TestPdbDedupRearm::test_one_event_and_skip_per_episode":
        (sc_pdb_one_event_and_skip_per_episode, ZERO_BUDGET_CONSOLIDATION),
    "TestPdbDedupRearm::test_rearm_on_pdb_change":
        (sc_pdb_rearm_on_pdb_change, ZERO_BUDGET_CONSOLIDATION),
    "TestPdbDedupRearm::test_rearm_on_pod_churn":
        (sc_pdb_rearm_on_pod_churn, ZERO_BUDGET_CONSOLIDATION),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equal_to_jax(name):
    scenario, kind = SCENARIOS[name]
    replay(scenario, **_env_kw(kind))


def test_scenarios_cover_the_jax_tests():
    """Every test of the JAX package's test_consolidation.py has its replay."""
    import ast
    import pathlib
    src = pathlib.Path(__file__).with_name("test_consolidation.py").read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ClassDef):
            names |= {f"{node.name}::{f.name}" for f in node.body
                      if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")}
    assert names == set(SCENARIOS)


# ---- cfg4's fleet, cut down: the path chip_smoke.py drives at full size ----

CFG4_NODES = 30


def priced_cost(stack):
    """$/hr of the running instances whose offering the catalog prices."""
    return sum(i.price for i in stack.cloud.instances.values()
               if i.state == "running" and math.isfinite(i.price))


def test_config4_fleet_cut_down_equal_to_jax(monkeypatch):
    """``workloads.config4_fleet_stack`` over the first 30 nodes of cfg4 (90
    pods) on the m5/c5/r5/t3 catalog, and the same fleet seeded into the JAX
    package's controllers, through 6 passes as ``chip_smoke.py`` runs them
    (batch-window polls, ``run_once``, the registration delay) and a final
    provisioning: the same removals, bindings, events and counters every
    pass; the fleet seeds as registered nodes with their pods bound and
    their instances at the bins' own offerings; every accepted removal was
    refereed; the fleet's $/hr never rises; nothing is left pending."""
    import bench
    from karpenter_provider_aws_tpu_torch import workloads

    def cut(fn):
        def make(lattice):
            pods, pools, existing = fn(lattice)
            return pods[: 3 * CFG4_NODES], pools, existing[:CFG4_NODES]
        return make

    monkeypatch.setattr(workloads, "config4_consolidation_repack",
                        cut(workloads.config4_consolidation_repack))
    families = ("m5", "c5", "r5", "t3")
    envs = []
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat = cases.family_lattice(pkg, families)
        if pkg == cases.TORCH_PKG:
            stack = workloads.config4_fleet_stack(
                lat, cases.mod(pkg, "solver.solve").Solver(lat, device="cpu"))
        else:
            pods, _, existing = cut(bench.config4_consolidation_repack)(lat)
            O = cases.mod(pkg, "apis.objects")
            pool = O.NodePool(name="default", disruption=O.NodePoolDisruption(
                consolidation_policy="WhenUnderutilized",
                consolidate_after=workloads.CFG4_CONSOLIDATE_AFTER))
            stack = cases.consolidation_stack(pkg, lat, [pool],
                                              spot_to_spot_consolidation=True)
            stack.seed_fleet(existing, pods)
        env = Env.__new__(Env)
        env.pkg, env.stack, env.log = pkg, stack, []
        envs.append(env)
    for env in envs:
        st = env.stack
        assert len(st.cluster.nodes) == len(st.cluster.claims) == CFG4_NODES
        assert st.cluster.pod_phase_counts()["bound"] == 3 * CFG4_NODES
        assert sorted((c.instance_type, c.zone, c.capacity_type)
                      for c in st.cluster.claims.values()) == sorted(
            (i.instance_type, i.zone, i.capacity_type)
            for i in st.cloud.instances.values())
        st.clock.step(workloads.CFG4_CONSOLIDATE_AFTER + 1.0)
        costs, refereed, accepted = [], [], []
        eng = st.disruption.engine
        orig_referee, orig_accept = eng.referee, eng.note_accept

        def referee(removed, plan, _o=orig_referee, **kw):
            ok, ratio = _o(removed, plan, **kw)
            refereed.append((sorted(c.name for c in removed), ok))
            return ok, ratio

        def note_accept(removed, savings, _o=orig_accept):
            accepted.append(sorted(c.name for c in removed))
            return _o(removed, savings)

        eng.referee, eng.note_accept = referee, note_accept
        for k in range(6):
            for _ in range(2):
                st.provisioner.batch_ready()
                st.clock.step(0.6)
            costs.append(priced_cost(st))
            st.run_once()
            st.clock.step(st.registration_delay + 0.1)
            env.snap(f"pass {k}")
        if st.cluster.pending_pods():
            st.provisioner.provision_once()
        costs.append(priced_cost(st))
        assert not st.cluster.pending_pods()
        assert accepted and all((a, True) in refereed for a in accepted)
        assert all(b <= a for a, b in zip(costs, costs[1:])), costs
        assert costs[-1] < costs[0]
        assert eng.counters["host_fallbacks"] == 0
    j, t = envs
    for (tag, jo), (_, to) in zip(j.log, t.log):
        assert_same(jo, to, tag)
    assert_same(observe(j), observe(t))
