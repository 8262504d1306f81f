"""The PyTorch port's disruption and termination controllers against the
JAX package's, on the CPU.

Each scenario of the JAX package's ``tests/test_disruption.py`` and
``tests/test_pdb.py`` (PDB allowance, do-not-disrupt candidacy, the
PDB-paced drain, daemonsets under a drain, the force-drain backstop) is
replayed on a consolidation stack of each
package (``test_torch_consolidation.Env``): the original test's checks run
on both, and the two packages must agree on the claims, nodes, pod
bindings, in-flight actions, FakeCloud's instances, engine counters,
skip-ledger codes and events (savings within 1e-5 relative). Pure
functions (the cron parser, the NodePool template hash) are compared on
the same inputs.

The JAX package's NodePool admission checks in ``TestScheduledBudgets``
(``webhooks.validate_node_pool``) are left to the Operator's slice, which
ports the webhooks: ``test_webhook_requires_schedule_with_duration`` is not
replayed, and of ``test_review_regressions`` only the cron half is.

One scenario, the multi-node repack, also runs against the JAX package's
``Operator`` itself: the stack leaves out the Operator's nodeclass,
pricing, tagging, interruption and garbage-collection controllers, and
the decisions must not change for it.
"""

import pytest

import test_torch_cases as cases
from test_torch_consolidation import Env, replay

DISRUPTION_FAMILIES = ("m5", "c5", "r5", "t3")
PDB_FAMILIES = ("m5", "c5", "t3")


def on_demand_pool(env, **disruption):
    return [env.A.NodePool(
        name="default", disruption=env.O.NodePoolDisruption(**disruption),
        requirements=[env.A.Requirement(env.wk.LABEL_CAPACITY_TYPE,
                                        env.A.Operator.IN, ("on-demand",))])]


def big_and_small(env):
    return (env.pods(1, cpu="14", mem="24Gi", prefix="big")
            + env.pods(1, cpu="250m", mem="256Mi", prefix="small"))


def running_cost(env):
    return sum(i.price for i in env.cloud.instances.values()
               if i.state == "running")


# ---- tests/test_disruption.py ----

def sc_empty_node_deleted_after_consolidate_after(env):
    env.add(env.pods(4))
    env.settle()
    assert len(env.cluster.claims) >= 1
    env.snap("settled")
    for p in list(env.cluster.pods):
        env.cluster.delete_pod(p)
    env.clock.step(31)
    env.run_once()
    env.run_once()
    assert not env.cluster.claims
    assert all(i.state == "terminated" for i in env.cloud.instances.values())


def sc_empty_node_kept_before_window(env):
    env.add(env.pods(2))
    env.settle()
    for p in list(env.cluster.pods):
        env.cluster.delete_pod(p)
    env.clock.step(30)
    env.run_once()
    env.run_once()
    assert env.cluster.claims, "node deleted before consolidate_after elapsed"


def sc_multi_node_repack(env):
    big = [env.A.Pod(name=f"b{i}", labels={"app": "spread"},
                     requests={"cpu": "3", "memory": "6Gi"},
                     pod_affinity=env.anti("app", "spread")) for i in range(6)]
    env.add(big)
    env.settle()
    nodes_before = len(env.cluster.nodes)
    assert nodes_before == 6
    cost_before = running_cost(env)
    for p in list(env.cluster.pods):
        env.cluster.delete_pod(p)
    env.add(env.pods(6, cpu="250m", mem="256Mi", prefix="tiny"))
    env.settle()
    env.clock.step(11)
    env.snap("repacked pods")
    for i in range(40):
        env.run_once()
        env.clock.step(2)
        if i % 10 == 9:
            env.snap(f"pass {i}")
    assert len(env.cluster.nodes) < nodes_before
    assert running_cost(env) < cost_before
    assert all(p.node_name for p in env.cluster.pods.values())


def sc_single_node_cheaper_replacement(env):
    env.add(big_and_small(env))
    env.settle()
    assert len(env.cluster.nodes) == 1
    big_type = next(iter(env.cluster.claims.values())).instance_type
    env.cluster.delete_pod("big-0")
    env.clock.step(11)
    for _ in range(30):
        env.run_once()
        env.clock.step(2)
    assert all(p.node_name for p in env.cluster.pods.values())
    (claim,) = env.cluster.claims.values()
    lat = env.solver.lattice
    assert (lat.price[lat.name_to_idx[claim.instance_type]].min()
            < lat.price[lat.name_to_idx[big_type]].min())
    return claim.instance_type


def sc_replacement_launches_before_drain(env):
    env.add(big_and_small(env))
    env.settle()
    env.cluster.delete_pod("big-0")
    env.clock.step(6)
    env.disruption.reconcile()
    assert len(env.cluster.claims) == 2, "replacement should coexist with original"
    assert env.cluster.pods["small-0"].node_name is not None


def sc_consolidation_never_when_policy_empty(env):
    env.add(big_and_small(env))
    env.settle()
    env.cluster.delete_pod("big-0")
    env.clock.step(60)
    for _ in range(10):
        env.run_once()
        env.clock.step(2)
    (claim,) = env.cluster.claims.values()
    assert claim.phase == env.O.NodeClaimPhase.INITIALIZED


def spot_pools(env):
    return [env.A.NodePool(
        name="default",
        requirements=[env.A.Requirement(env.wk.LABEL_CAPACITY_TYPE,
                                        env.A.Operator.IN, ("spot",))],
        disruption=env.O.NodePoolDisruption(consolidate_after=5.0))]


def sc_spot_to_spot_blocked_without_gate(env):
    env.add(big_and_small(env))
    env.settle()
    big_claim = next(iter(env.cluster.claims.values()))
    env.cluster.delete_pod("big-0")
    env.clock.step(6)
    for _ in range(10):
        env.run_once()
        env.clock.step(2)
    assert big_claim.name in env.cluster.claims


def sc_spot_to_spot_allowed_with_gate_and_flexibility(env):
    env.add(big_and_small(env))
    env.settle()
    big_claim = next(iter(env.cluster.claims.values()))
    env.cluster.delete_pod("big-0")
    env.clock.step(6)
    for _ in range(30):
        env.run_once()
        env.clock.step(2)
    assert big_claim.name not in env.cluster.claims


def sc_drifted_claim_replaced(env):
    env.add(env.pods(2))
    env.settle()
    (claim,) = env.cluster.claims.values()
    env.node_classes["default"].user_data = "#!/bin/bash new"
    for _ in range(20):
        env.run_once()
        env.clock.step(2)
    claims = list(env.cluster.claims.values())
    assert claims and all(c.name != claim.name for c in claims)
    assert all(p.node_name for p in env.cluster.pods.values())


def sc_drift_disabled_gate(env):
    env.add(env.pods(2))
    env.settle()
    (claim,) = env.cluster.claims.values()
    env.node_classes["default"].user_data = "#!/bin/bash new"
    for _ in range(10):
        env.run_once()
        env.clock.step(2)
    assert claim.name in env.cluster.claims


def sc_expiration_replaces_old_nodes(env):
    env.add(env.pods(2))
    env.settle()
    (claim,) = env.cluster.claims.values()
    env.clock.step(101)
    for _ in range(20):
        env.run_once()
        env.clock.step(2)
    claims = list(env.cluster.claims.values())
    assert claims and all(c.name != claim.name for c in claims)
    assert all(p.node_name for p in env.cluster.pods.values())


def sc_budget_caps_parallel_empty_deletes(env):
    env.add(env.pods(3, cpu="2", mem="4Gi", labels={"app": "a"},
                     pod_affinity=env.anti("app", "a")))
    env.settle()
    assert len(env.cluster.claims) == 3
    for p in list(env.cluster.pods):
        env.cluster.delete_pod(p)
    env.clock.step(6)
    env.disruption.reconcile()
    queued = sum(len(a.claims) for a in env.disruption._in_flight)
    assert queued <= 1, "budget of 1 must cap parallel disruption"
    return queued


def sc_pricing_refresh_invalidates_failed_fingerprint(env):
    fp1 = env.disruption._fingerprint()
    env.solver.lattice.price_version += 1
    assert env.disruption._fingerprint() != fp1
    # the fingerprints themselves hold the same fields in both packages
    return repr(fp1)


def sc_replacement_respects_pool_limits(env):
    env.add(big_and_small(env))
    env.settle()
    assert len(env.cluster.nodes) == 1
    (claim,) = env.cluster.claims.values()
    env.node_pools["default"].limits = {
        "cpu": str(int(claim.capacity["cpu"] / 1000.0))}
    env.cluster.delete_pod("big-0")
    env.clock.step(6)
    for _ in range(10):
        env.run_once()
        env.clock.step(2)
    assert claim.name in env.cluster.claims
    assert not env.disruption._in_flight
    assert all(p.node_name for p in env.cluster.pods.values())


def sc_zero_budget_blocks_all(env):
    env.add(env.pods(2))
    env.settle()
    for p in list(env.cluster.pods):
        env.cluster.delete_pod(p)
    env.clock.step(10)
    for _ in range(5):
        env.run_once()
        env.clock.step(2)
    assert env.cluster.claims, "0% budget must block disruption entirely"


def anti_spread(env):
    return [env.A.Pod(name=f"b{i}", labels={"app": "spread"},
                      requests={"cpu": "3", "memory": "6Gi"},
                      pod_affinity=env.anti("app", "spread")) for i in range(6)]


def sc_consolidation_pass_is_one_probe_plus_one_exact_solve(env):
    env.add(anti_spread(env))
    env.settle()
    assert len(env.cluster.nodes) == 6
    for p in list(env.cluster.pods):
        env.cluster.delete_pod(p)
    env.add([env.A.Pod(name=f"t{i}", labels={"app": "spread"},
                       requests={"cpu": "250m", "memory": "256Mi"},
                       pod_affinity=env.anti("app", "spread")) for i in range(6)])
    env.settle()
    assert all([q for q in env.cluster.pods.values() if q.node_name == n]
               for n in env.cluster.nodes), "expected one pod per node"
    env.clock.step(11)
    calls = {"probe": 0, "solve": 0}
    orig_probe, orig_solve = env.solver.probe_batch, env.solver.solve

    def probe(problems):
        calls["probe"] += 1
        return orig_probe(problems)

    def solve(problem, mesh=None):
        calls["solve"] += 1
        return orig_solve(problem, mesh=mesh)

    env.solver.probe_batch, env.solver.solve = probe, solve
    try:
        env.disruption.reconcile()
    finally:
        env.solver.probe_batch, env.solver.solve = orig_probe, orig_solve
    assert env.disruption._in_flight, "consolidation should have begun"
    assert calls["probe"] == 1
    assert calls["solve"] <= 2, calls
    return calls


def sc_failed_search_cache_expires_with_consolidate_after_window(env):
    env.add(big_and_small(env))
    env.settle()
    env.cluster.delete_pod("big-0")
    env.disruption.reconcile()
    assert not env.disruption._in_flight
    env.snap("inside the window")
    env.clock.step(11)
    env.disruption.reconcile()
    assert env.disruption._in_flight, \
        "consolidation blocked by a stale negative cache"


def cron(env):
    return cases.mod(env.pkg, "utils.cron").Cron


def sc_cron_matching(env):
    Cron = cron(env)
    c = Cron("0 0 * * *")
    assert c.matches(0.0)
    assert not c.matches(60.0)
    assert Cron("*/15 * * * *").matches(15 * 60)
    assert not Cron("*/15 * * * *").matches(16 * 60)
    assert Cron("* * * * 4").matches(0.0)
    assert not Cron("* * * * 5").matches(0.0)
    assert c.in_window(1800.0, 3600.0)
    assert not c.in_window(7200.0, 3600.0)
    with pytest.raises(ValueError):
        Cron("not a cron")
    with pytest.raises(ValueError):
        Cron("99 * * * *")
    # the same verdicts over a sweep of schedules and instants
    out = []
    for expr in ("0 0 * * *", "*/15 * * * *", "0 9 * * 1-5", "30 2 1 * *",
                 "0 0/6 * * *", "5-10/2 * * 2,4 *"):
        c = Cron(expr)
        out.append((expr, [c.matches(t) for t in range(0, 8 * 86400, 1740)],
                    [c.in_window(t, 3600.0) for t in range(0, 3 * 86400, 2900)]))
    return out


def scheduled_pools(env):
    return [env.A.NodePool(
        name="default",
        requirements=[env.A.Requirement(env.wk.LABEL_CAPACITY_TYPE,
                                        env.A.Operator.IN, ("on-demand",))],
        disruption=env.O.NodePoolDisruption(
            consolidate_after=5.0,
            budgets=[env.O.DisruptionBudget(nodes="0", schedule="0 0 * * *",
                                            duration=3600.0)]))]


def sc_budget_constrains_only_in_window(env):
    ctrl = env.disruption
    pool = env.node_pools["default"]
    assert (ctrl._allowed_disruptions(pool, "Underutilized") == 0
            or not env.cluster.claims)
    for i in range(4):
        env.cluster.add_pod(env.A.Pod(name=f"p{i}", requests={
            "cpu": "800m", "memory": "1536Mi"}))
    env.settle()
    assert ctrl._allowed_disruptions(pool, "Underutilized") == 0
    env.clock.step(2 * 3600)
    allowed = ctrl._allowed_disruptions(pool, "Underutilized")
    assert allowed > 0
    return allowed


def sc_consolidation_resumes_after_window(env):
    for i in range(4):
        env.cluster.add_pod(env.A.Pod(name=f"p{i}", requests={
            "cpu": "800m", "memory": "1536Mi"}))
    env.settle()
    for i in range(1, 4):
        env.cluster.delete_pod(f"p{i}")
    before = set(env.cluster.claims)
    env.clock.step(6)
    for _ in range(10):
        env.run_once()
        env.clock.step(3)
    assert set(env.cluster.claims) == before, "freeze window violated"
    env.snap("frozen")
    env.clock.step(2 * 3600)
    for _ in range(20):
        env.run_once(force_provision=bool(env.cluster.pending_pods()))
        env.clock.step(3)
    assert set(env.cluster.claims) != before, \
        "search never re-armed after the budget window closed"


def sc_review_regressions(env):
    # the cron half; the zero-duration admission check is the webhooks'
    with pytest.raises(ValueError):
        cron(env)("0, 0 * * *")


def sc_step_syntax_vixie_semantics(env):
    Cron = cron(env)
    c = Cron("0 0/6 * * *")
    assert c.hour == {0, 6, 12, 18}
    assert Cron("0/15 * * * *").minute == {0, 15, 30, 45}
    return sorted(c.hour), sorted(Cron("0/15 * * * *").minute)


def prov(env):
    return cases.mod(env.pkg, "controllers.provisioning")


def sc_formula_change_restamps_instead_of_rolling(env):
    wk = env.wk
    env.add(env.pods(2))
    env.settle()
    (claim,) = env.cluster.claims.values()
    claim.annotations[wk.ANNOTATION_NODEPOOL_HASH] = "old-formula-hash"
    claim.annotations.pop(wk.ANNOTATION_NODEPOOL_HASH_VERSION, None)
    env.disruption._reconcile_drift()
    assert not claim.deletion_timestamp, "upgrade rolled the node"
    assert claim.annotations[wk.ANNOTATION_NODEPOOL_HASH] == \
        prov(env).nodepool_hash(env.node_pools["default"])
    assert claim.annotations[wk.ANNOTATION_NODEPOOL_HASH_VERSION] == \
        prov(env).NODEPOOL_HASH_VERSION
    env.snap("restamped")
    env.node_pools["default"].labels["rollme"] = "yes"
    env.disruption._reconcile_drift()
    assert any(a.reason == "Drifted" for a in env.disruption._in_flight)
    return claim.annotations[wk.ANNOTATION_NODEPOOL_HASH]


def sc_startup_taints_participate_in_hash(env):
    pool = env.A.NodePool(name="st")
    before = prov(env).nodepool_hash(pool)
    pool.startup_taints = [env.O.Taint(key="node.example.com/setup",
                                       value="pending", effect="NoSchedule")]
    after = prov(env).nodepool_hash(pool)
    assert after != before
    return before, after


def sc_slice_fields_hash_order_insensitively(env):
    A, O, wk = env.A, env.O, env.wk
    t1 = O.Taint(key="a", value="1", effect="NoSchedule")
    t2 = O.Taint(key="b", value="2", effect="NoExecute")
    r1 = A.Requirement(wk.LABEL_ZONE, A.Operator.IN, ("us-west-2a", "us-west-2b"))
    r2 = A.Requirement(wk.LABEL_CAPACITY_TYPE, A.Operator.IN, ("spot",))
    p_fwd = A.NodePool(name="x", taints=[t1, t2], startup_taints=[t2, t1],
                       requirements=[r1, r2])
    r1_rev = A.Requirement(wk.LABEL_ZONE, A.Operator.IN,
                           ("us-west-2b", "us-west-2a"))
    p_rev = A.NodePool(name="x", taints=[t2, t1], startup_taints=[t1, t2],
                       requirements=[r2, r1_rev])
    h = prov(env).nodepool_hash
    assert h(p_fwd) == h(p_rev)
    return h(p_fwd)


def sc_what_if_survives_candidate_node_deletion(env):
    env.add(env.pods(4))
    env.settle()
    claim = next(iter(env.cluster.claims.values()))
    node = env.cluster.node_for_claim(claim.name)
    assert node is not None
    env.cluster.evict_node(node.name)
    plan, removed_cost = env.disruption._what_if([claim])
    assert plan is not None
    assert removed_cost == 0.0
    assert not plan.new_nodes
    return sorted(plan.unschedulable), plan.existing_assignments


# ---- tests/test_pdb.py ----

def sc_max_unavailable_math(env):
    env.add(spread(env, 3, "web"))
    env.settle()
    pdb = env.O.PodDisruptionBudget(name="web-pdb", label_selector={"grp": "web"},
                                    max_unavailable=1)
    env.cluster.add_pdb(pdb)
    assert env.cluster._pdb_allowance(pdb) == 1
    evicted = env.cluster.unbind_pods_on(next(iter(env.cluster.nodes)))
    assert len(evicted) == 1
    assert env.cluster._pdb_allowance(pdb) == 0
    return [p.name for p in evicted]


def sc_min_available_math(env):
    env.add(spread(env, 3, "db"))
    env.settle()
    pdb = env.O.PodDisruptionBudget(name="db-pdb", label_selector={"grp": "db"},
                                    min_available=2)
    env.cluster.add_pdb(pdb)
    assert env.cluster._pdb_allowance(pdb) == 1


def spread(env, n, prefix, labels=None, **kw):
    return [env.A.Pod(name=f"{prefix}-{i}", labels={"grp": prefix, **(labels or {})},
                      requests={"cpu": "500m", "memory": "1Gi"},
                      pod_affinity=env.anti("grp", prefix), **kw)
            for i in range(n)]


def sc_drain_paced_by_budget_then_completes(env):
    for i in range(4):
        env.cluster.add_pod(env.A.Pod(name=f"svc-{i}", labels={"app": "svc"},
                                      requests={"cpu": "250m", "memory": "512Mi"}))
    env.settle()
    assert len(env.cluster.nodes) == 1
    victim_claim = next(iter(env.cluster.claims.values()))
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="svc-pdb", label_selector={"app": "svc"}, max_unavailable=1))
    env.termination.delete_claim(victim_claim.name)
    env.termination.reconcile()
    assert sum(1 for p in env.cluster.pods.values() if p.node_name) == 3
    assert victim_claim.name in env.cluster.claims
    assert any(e.reason == "DrainBlocked" for e in env.recorder.events())
    env.snap("first drain pass")
    for _ in range(30):
        env.run_once(force_provision=bool(env.cluster.pending_pods()))
        env.clock.step(2)
        if victim_claim.name not in env.cluster.claims:
            break
    assert victim_claim.name not in env.cluster.claims
    env.settle()
    assert sum(1 for p in env.cluster.pods.values() if p.node_name is not None) == 4


def sc_daemonsets_exempt_from_budget(env):
    env.add(spread(env, 2, "logging"))
    env.settle()
    node = next(iter(env.cluster.nodes))
    env.cluster.add_pod(env.A.Pod(name="ds-agent", labels={"grp": "logging"},
                                  is_daemonset=True, node_name=node,
                                  requests={"cpu": "100m"}))
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="log-pdb", label_selector={"grp": "logging"}, max_unavailable=1))
    evicted, blocked = env.cluster.drain_node(node)
    assert all(not p.is_daemonset for p in evicted + blocked)
    claim_name = env.cluster.nodes[node].node_claim
    env.termination.delete_claim(claim_name)
    for _ in range(5):
        env.termination.reconcile()
        if node not in env.cluster.nodes:
            break
    assert "ds-agent" not in env.cluster.pods
    return sorted(p.name for p in evicted), sorted(p.name for p in blocked)


def consolidatable(env, pod_kw=None):
    """One node sized for 4 pods, then 3 deleted: single-node consolidation
    would replace it with a cheaper shape unless something blocks it."""
    for i in range(4):
        env.cluster.add_pod(env.A.Pod(
            name=f"tiny-{i}", labels={"grp": "tiny"},
            requests={"cpu": "800m", "memory": "1536Mi"}, **(pod_kw or {})))
    env.settle()
    assert len(env.cluster.claims) == 1
    for i in range(1, 4):
        env.cluster.delete_pod(f"tiny-{i}")


def run_disruption(env, rounds=10):
    env.clock.step(6)
    for _ in range(rounds):
        env.run_once(force_provision=bool(env.cluster.pending_pods()))
        env.clock.step(3)


def sc_pod_annotation_blocks_candidacy(env):
    consolidatable(env, pod_kw={"annotations": {
        env.wk.ANNOTATION_DO_NOT_DISRUPT: "true"}})
    before = set(env.cluster.claims)
    run_disruption(env)
    assert set(env.cluster.claims) == before


def sc_nodepool_annotation_propagates_and_blocks(env):
    consolidatable(env)
    for c in env.cluster.claims.values():
        assert c.annotations.get(env.wk.ANNOTATION_DO_NOT_DISRUPT) == "true"
    before = set(env.cluster.claims)
    run_disruption(env)
    assert set(env.cluster.claims) == before


def sc_node_annotation_blocks_candidacy(env):
    consolidatable(env)
    for node in env.cluster.nodes.values():
        node.annotations[env.wk.ANNOTATION_DO_NOT_DISRUPT] = "true"
    before = set(env.cluster.claims)
    run_disruption(env)
    assert set(env.cluster.claims) == before


def sc_zero_allowance_pdb_blocks_candidacy(env):
    consolidatable(env)
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="tiny-pdb", label_selector={"grp": "tiny"}, max_unavailable=0))
    before = set(env.cluster.claims)
    run_disruption(env)
    assert set(env.cluster.claims) == before
    events = env.recorder.events(reason="Unconsolidatable")
    assert events
    assert len(events) <= len(before)


def sc_without_blockers_consolidation_proceeds(env):
    consolidatable(env)
    before = set(env.cluster.claims)
    run_disruption(env, rounds=20)
    assert set(env.cluster.claims) != before


def sc_grace_period_unblocks_stuck_termination(env):
    for i in range(2):
        env.cluster.add_pod(env.A.Pod(name=f"p-{i}", labels={"app": "stuck"},
                                      requests={"cpu": "500m", "memory": "1Gi"}))
    env.settle()
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="frozen", label_selector={"app": "stuck"}, max_unavailable=0))
    victim = next(iter(env.cluster.claims.values()))
    node = env.cluster.node_for_claim(victim.name).name
    env.cluster.add_pod(env.A.Pod(name="ds-on-stuck", is_daemonset=True,
                                  node_name=node, requests={"cpu": "100m"}))
    env.termination.delete_claim(victim.name)
    env.termination.reconcile()
    assert victim.name in env.cluster.claims
    env.clock.step(61)
    env.termination.reconcile()
    assert victim.name not in env.cluster.claims
    assert env.recorder.events(reason="ForceDrained")
    assert "ds-on-stuck" not in env.cluster.pods


def sc_drain_blocked_event_published_once_per_episode(env):
    for i in range(2):
        env.cluster.add_pod(env.A.Pod(name=f"p-{i}", labels={"app": "stuck"},
                                      requests={"cpu": "500m", "memory": "1Gi"}))
    env.settle()
    env.cluster.add_pdb(env.O.PodDisruptionBudget(
        name="frozen", label_selector={"app": "stuck"}, max_unavailable=0))
    victim = next(iter(env.cluster.claims.values()))
    env.termination.delete_claim(victim.name)
    for _ in range(20):
        env.termination.reconcile()
    assert len(env.recorder.events(reason="DrainBlocked")) == 1


def sc_daemonset_do_not_disrupt_pins_node(env):
    for i in range(4):
        env.cluster.add_pod(env.A.Pod(name=f"tiny-{i}", labels={"grp": "tiny"},
                                      requests={"cpu": "800m", "memory": "1536Mi"}))
    env.settle()
    assert len(env.cluster.claims) == 1
    node = next(iter(env.cluster.nodes))
    env.cluster.add_pod(env.A.Pod(
        name="ds-pinned", is_daemonset=True, node_name=node,
        annotations={env.wk.ANNOTATION_DO_NOT_DISRUPT: "true"},
        requests={"cpu": "100m"}))
    for i in range(1, 4):
        env.cluster.delete_pod(f"tiny-{i}")
    before = set(env.cluster.claims)
    env.clock.step(6)
    for _ in range(10):
        env.run_once(force_provision=bool(env.cluster.pending_pods()))
        env.clock.step(3)
    assert set(env.cluster.claims) == before


def _pools(**disruption):
    return {"pools": lambda e: on_demand_pool(e, **disruption)}


def _budget_pool(nodes, **disruption):
    return {"pools": lambda e: [e.A.NodePool(name="default",
                                             disruption=e.O.NodePoolDisruption(
                                                 budgets=[e.O.DisruptionBudget(nodes=nodes)],
                                                 **disruption))]}


def _pdb_pool(**pool_kw):
    return {"families": PDB_FAMILIES, "pools": lambda e: [e.A.NodePool(
        name="default",
        requirements=[e.A.Requirement(e.wk.LABEL_CAPACITY_TYPE, e.A.Operator.IN,
                                      ("on-demand",))],
        disruption=e.O.NodePoolDisruption(consolidate_after=5.0),
        **({k: v(e) if callable(v) else v for k, v in pool_kw.items()}))]}


D = {"families": DISRUPTION_FAMILIES}

# name -> (scenario, stack options); the names are the JAX package's tests
SCENARIOS = {
    "test_disruption.py::TestEmptiness::test_empty_node_deleted_after_consolidate_after":
        (sc_empty_node_deleted_after_consolidate_after, {**D, **_pools(consolidate_after=30.0)}),
    "test_disruption.py::TestEmptiness::test_empty_node_kept_before_window":
        (sc_empty_node_kept_before_window, {**D, **_pools(consolidate_after=300.0)}),
    "test_disruption.py::TestConsolidation::test_multi_node_repack":
        (sc_multi_node_repack, {**D, **_pools(consolidate_after=10.0)}),
    "test_disruption.py::TestConsolidation::test_single_node_cheaper_replacement":
        (sc_single_node_cheaper_replacement, {**D, **_pools(consolidate_after=10.0)}),
    "test_disruption.py::TestConsolidation::test_replacement_launches_before_drain":
        (sc_replacement_launches_before_drain, {**D, **_pools(consolidate_after=5.0)}),
    "test_disruption.py::TestConsolidation::test_consolidation_never_when_policy_empty":
        (sc_consolidation_never_when_policy_empty,
         {**D, **_pools(consolidate_after=5.0, consolidation_policy="WhenEmpty")}),
    "test_disruption.py::TestSpotGuard::test_spot_to_spot_blocked_without_gate":
        (sc_spot_to_spot_blocked_without_gate, {**D, "pools": spot_pools}),
    "test_disruption.py::TestSpotGuard::test_spot_to_spot_allowed_with_gate_and_flexibility":
        (sc_spot_to_spot_allowed_with_gate_and_flexibility,
         {**D, "pools": spot_pools, "spot_to_spot_consolidation": True}),
    "test_disruption.py::TestDriftAndExpiration::test_drifted_claim_replaced":
        (sc_drifted_claim_replaced, {**D, **_pools()}),
    "test_disruption.py::TestDriftAndExpiration::test_drift_disabled_gate":
        (sc_drift_disabled_gate,
         {**D, "pools": lambda e: [e.A.NodePool(name="default")],
          "drift_enabled": False}),
    "test_disruption.py::TestDriftAndExpiration::test_expiration_replaces_old_nodes":
        (sc_expiration_replaces_old_nodes, {**D, **_pools(expire_after=100.0)}),
    "test_disruption.py::TestBudgets::test_budget_caps_parallel_empty_deletes":
        (sc_budget_caps_parallel_empty_deletes, {**D, **_budget_pool("1", consolidate_after=5.0)}),
    "test_disruption.py::TestBudgets::test_pricing_refresh_invalidates_failed_fingerprint":
        (sc_pricing_refresh_invalidates_failed_fingerprint, {**D, **_pools(consolidate_after=5.0)}),
    "test_disruption.py::TestBudgets::test_replacement_respects_pool_limits":
        (sc_replacement_respects_pool_limits, {**D, **_pools(consolidate_after=5.0)}),
    "test_disruption.py::TestBudgets::test_zero_budget_blocks_all":
        (sc_zero_budget_blocks_all, {**D, **_budget_pool("0", consolidate_after=5.0)}),
    "test_disruption.py::TestBatchedWhatIfs::test_consolidation_pass_is_one_probe_plus_one_exact_solve":
        (sc_consolidation_pass_is_one_probe_plus_one_exact_solve,
         {**D, **_pools(consolidate_after=10.0)}),
    "test_disruption.py::TestBatchedWhatIfs::test_failed_search_cache_expires_with_consolidate_after_window":
        (sc_failed_search_cache_expires_with_consolidate_after_window,
         {**D, **_pools(consolidate_after=10.0)}),
    "test_disruption.py::TestScheduledBudgets::test_cron_matching": (sc_cron_matching, D),
    "test_disruption.py::TestScheduledBudgets::test_budget_constrains_only_in_window":
        (sc_budget_constrains_only_in_window,
         {**D, "pools": scheduled_pools, "clock_start": 12 * 86400.0}),
    "test_disruption.py::TestScheduledBudgets::test_consolidation_resumes_after_window":
        (sc_consolidation_resumes_after_window,
         {**D, "pools": scheduled_pools, "clock_start": 12 * 86400.0}),
    "test_disruption.py::TestScheduledBudgets::test_review_regressions":
        (sc_review_regressions, D),
    "test_disruption.py::TestScheduledBudgets::test_step_syntax_vixie_semantics":
        (sc_step_syntax_vixie_semantics, D),
    "test_disruption.py::TestHashVersionMigration::test_formula_change_restamps_instead_of_rolling":
        (sc_formula_change_restamps_instead_of_rolling, {**D, **_pools(consolidate_after=300.0)}),
    "test_disruption.py::TestHashVersionMigration::test_startup_taints_participate_in_hash":
        (sc_startup_taints_participate_in_hash, D),
    "test_disruption.py::TestHashVersionMigration::test_slice_fields_hash_order_insensitively":
        (sc_slice_fields_hash_order_insensitively, D),
    "test_disruption.py::TestWhatIfNodeVanishRace::test_what_if_survives_candidate_node_deletion":
        (sc_what_if_survives_candidate_node_deletion, {**D, **_pools()}),
    "test_pdb.py::TestPdbAllowance::test_max_unavailable_math":
        (sc_max_unavailable_math, _pdb_pool()),
    "test_pdb.py::TestPdbAllowance::test_min_available_math":
        (sc_min_available_math, _pdb_pool()),
    "test_pdb.py::TestPdbDrain::test_drain_paced_by_budget_then_completes":
        (sc_drain_paced_by_budget_then_completes, _pdb_pool()),
    "test_pdb.py::TestPdbDrain::test_daemonsets_exempt_from_budget":
        (sc_daemonsets_exempt_from_budget, _pdb_pool()),
    "test_pdb.py::TestDoNotDisrupt::test_pod_annotation_blocks_candidacy":
        (sc_pod_annotation_blocks_candidacy, _pdb_pool()),
    "test_pdb.py::TestDoNotDisrupt::test_nodepool_annotation_propagates_and_blocks":
        (sc_nodepool_annotation_propagates_and_blocks,
         _pdb_pool(annotations=lambda e: {e.wk.ANNOTATION_DO_NOT_DISRUPT: "true"})),
    "test_pdb.py::TestDoNotDisrupt::test_node_annotation_blocks_candidacy":
        (sc_node_annotation_blocks_candidacy, _pdb_pool()),
    "test_pdb.py::TestDoNotDisrupt::test_zero_allowance_pdb_blocks_candidacy":
        (sc_zero_allowance_pdb_blocks_candidacy, _pdb_pool()),
    "test_pdb.py::TestDoNotDisrupt::test_without_blockers_consolidation_proceeds":
        (sc_without_blockers_consolidation_proceeds, _pdb_pool()),
    "test_pdb.py::TestForceDrainBackstop::test_grace_period_unblocks_stuck_termination":
        (sc_grace_period_unblocks_stuck_termination,
         {"families": PDB_FAMILIES, "termination_grace_period": 60.0,
          "pools": lambda e: [e.A.NodePool(name="default", requirements=[
              e.A.Requirement(e.wk.LABEL_CAPACITY_TYPE, e.A.Operator.IN,
                              ("on-demand",))])]}),
    "test_pdb.py::TestForceDrainBackstop::test_drain_blocked_event_published_once_per_episode":
        (sc_drain_blocked_event_published_once_per_episode, _pdb_pool()),
    "test_pdb.py::TestForceDrainBackstop::test_daemonset_do_not_disrupt_pins_node":
        (sc_daemonset_do_not_disrupt_pins_node, _pdb_pool()),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equal_to_jax(name):
    scenario, kw = SCENARIOS[name]
    replay(scenario, **kw)


def _jax_tests(filename):
    import ast
    import pathlib
    src = pathlib.Path(__file__).with_name(filename).read_text()
    out = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ClassDef):
            out |= {f"{filename}::{node.name}::{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")}
    return out


# the admission check of the webhooks, which the Operator's slice ports
NOT_REPLAYED = {
    "test_disruption.py::TestScheduledBudgets::test_webhook_requires_schedule_with_duration",
}


def test_scenarios_cover_the_jax_tests():
    """Every test of the JAX package's test_disruption.py and test_pdb.py
    has its replay here, or is named in NOT_REPLAYED."""
    want = _jax_tests("test_disruption.py") | _jax_tests("test_pdb.py")
    assert want == set(SCENARIOS) | NOT_REPLAYED


def _operator_env(lattice):
    from karpenter_provider_aws_tpu.apis import NodePool, Operator as ReqOp, Requirement
    from karpenter_provider_aws_tpu.apis import wellknown as wk
    from karpenter_provider_aws_tpu.apis.objects import NodePoolDisruption
    from karpenter_provider_aws_tpu.cloud import FakeCloud
    from karpenter_provider_aws_tpu.operator import Operator, Options
    from karpenter_provider_aws_tpu.utils.clock import FakeClock
    clock = FakeClock()
    pool = NodePool(name="default",
                    disruption=NodePoolDisruption(consolidate_after=10.0),
                    requirements=[Requirement(wk.LABEL_CAPACITY_TYPE, ReqOp.IN,
                                              ("on-demand",))])
    return Operator(options=Options(registration_delay=1.0), lattice=lattice,
                    cloud=FakeCloud(clock), clock=clock, node_pools=[pool])


def decisions(stack_or_operator):
    """What the disruption controller decided: claims by name with their
    offerings and deletion, the nodes, the pod bindings, the in-flight
    actions, the engine's counters and the running instances."""
    o = stack_or_operator
    eng = o.disruption.engine
    return {
        "claims": sorted((c.name, c.instance_type, c.zone, c.capacity_type,
                          c.deletion_timestamp is not None)
                         for c in o.cluster.snapshot_claims()),
        "nodes": sorted(o.cluster.nodes),
        "pods": sorted((p.name, p.node_name) for p in o.cluster.snapshot_pods()),
        "in_flight": [(a.reason, list(a.claims), list(a.replacements))
                      for a in o.disruption._in_flight],
        "counters": {k: v for k, v in eng.stats().items() if k != "savings_per_hour"},
        "running": sorted((i.instance_type, i.zone, i.capacity_type)
                          for i in o.cloud.instances.values() if i.state == "running"),
    }


def test_multi_node_repack_equal_to_the_jax_operator():
    """The stack against the JAX package's whole Operator: the controllers
    the stack leaves out do not change the disruption decisions."""

    class OperatorEnv(Env):
        def __init__(self):
            self.pkg = cases.JAX_PKG
            m = lambda name: cases.mod(self.pkg, name)  # noqa: E731
            self.A, self.wk, self.O = m("apis"), m("apis.wellknown"), m("apis.objects")
            self.taxonomy = m("solver.taxonomy")
            self.lattice = cases.family_lattice(self.pkg, DISRUPTION_FAMILIES)
            self.stack = _operator_env(self.lattice)
            self.log = []

    op = OperatorEnv()
    sc_multi_node_repack(op)
    port = Env(cases.TORCH_PKG, families=DISRUPTION_FAMILIES,
               **_pools(consolidate_after=10.0))
    sc_multi_node_repack(port)
    assert [tag for tag, _ in port.log] == [tag for tag, _ in op.log]
    for (tag, a), (_, b) in zip(op.log, port.log):
        for k in ("claims", "nodes", "pods", "in_flight", "counters", "ledger"):
            assert b[k] == a[k], f"{tag}: {k}"
    assert decisions(port) == decisions(op)
    assert port.disruption.engine.stats()["savings_per_hour"] == pytest.approx(
        op.disruption.engine.stats()["savings_per_hour"], rel=1e-5)
