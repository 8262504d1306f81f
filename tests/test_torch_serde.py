"""The port's wire format (``apis/serde.py``) against the JAX package's,
in both directions, on the CPU.

Objects cross the seam as serde dicts: an apiserver's store, the REST
surface and the solver sidecar's wire all carry them, so two packages
agree only if each reads what the other writes and writes back the same
dict. For every kind serde carries (pods, NodePools with their status,
NodeClasses, NodeClaims, nodes, PDBs, leases, PVCs, storage classes,
requirements, existing bins and NodePlans), the same object is built
from each package's classes, written by one package, read by the other
and written again: the two dicts must be equal as JSON text (key order,
float formatting and all). A plan solved by each package on the same
seeded problem also crosses both ways, and ``plan_semantic_dict`` of a
port plan equals the JAX function's on the same plan. Tolerance: none.
"""

import json

import numpy as np
import pytest

import test_torch_cases as cases
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

PKGS = (cases.JAX_PKG, cases.TORCH_PKG)


def _objects(pkg):
    """kind -> [objects] built from ``pkg``'s classes, the same in both."""
    A, O = cases.mod(pkg, "apis"), cases.mod(pkg, "apis.objects")
    wk = cases.mod(pkg, "apis.wellknown")
    P = cases.mod(pkg, "solver.problem")
    R = cases.mod(pkg, "apis.resources").R
    req = A.Requirement(wk.LABEL_INSTANCE_TYPE, A.Operator.IN,
                        ("m5.large", "c5.large"), min_values=2)
    taint = O.Taint(key="dedicated", value="gpu", effect=O.TaintEffect.NO_SCHEDULE)
    pods = [
        A.Pod(name="plain", requests={"cpu": "250m", "memory": "512Mi"}),
        A.Pod(name="rich", namespace="team", labels={"app": "w"},
              annotations={"a": "1"}, requests={"cpu": 1.5, "memory": "2Gi"},
              node_selector={wk.LABEL_OS: "linux"}, required_affinity=[req],
              preferred_affinity=[O.PreferredRequirement(requirement=req,
                                                         weight=7)],
              tolerations=[O.Toleration(key="dedicated", operator="Equal",
                                        value="gpu",
                                        effect=O.TaintEffect.NO_SCHEDULE),
                           O.Toleration(key="any", operator="Exists")],
              topology_spread=[O.TopologySpreadConstraint(
                  max_skew=1, topology_key=wk.LABEL_ZONE,
                  label_selector=(("app", "w"),))],
              pod_affinity=[O.PodAffinityTerm(
                  topology_key=wk.LABEL_HOSTNAME,
                  label_selector=(("app", "w"),), anti=True)],
              volume_claims=["data"], node_name="n1", owner="rs-1",
              priority=10, deletion_timestamp=1000001.5),
    ]
    pool = A.NodePool(
        name="rich", weight=50, labels={"team": "a"}, requirements=[req],
        taints=[taint], startup_taints=[taint],
        limits={"cpu": "1000", "memory": "1000Gi"},
        disruption=O.NodePoolDisruption(
            consolidation_policy="WhenEmpty", consolidate_after=30.0,
            budgets=[O.DisruptionBudget(nodes="10%"),
                     O.DisruptionBudget(nodes="5", schedule="0 9 * * 1-5",
                                        duration=28800.0)]),
        kubelet=O.KubeletSpec(max_pods=58))
    pool.status_resources = {"cpu": "12", "memory": "48Gi"}
    nc = O.NodeClass(
        name="rich", role="r", tags={"team": "a"}, user_data="#!/bin/sh",
        subnet_selector_terms=[O.NodeClassSelectorTerm(tags=(("env", "p"),))],
        security_group_selector_terms=[O.NodeClassSelectorTerm(id="sg-1")],
        ami_selector_terms=[O.NodeClassSelectorTerm(name="al2023*")],
        block_device_mappings=[{"device_name": "/dev/xvda",
                                "root_volume": True, "volume_size_mib": 20480}],
        metadata_options=O.MetadataOptions(http_tokens="optional"),
        detailed_monitoring=True, associate_public_ip=False)
    claim = O.NodeClaim(
        name="c1", node_pool="rich", requirements=[req],
        resource_requests={"cpu": 2.0}, labels={"a": "b"}, taints=[taint],
        phase=O.NodeClaimPhase.LAUNCHED, max_pods=58, provider_id="aws:///z/i-1",
        internal_ip="10.0.0.7", instance_type="m5.large", zone="us-west-2a",
        capacity_type="spot", image_id="ami-1", capacity={"cpu": 2000.0},
        allocatable={"cpu": 1930.0}, created_at=1000000.0,
        launched_at=1000000.25, deletion_timestamp=None)
    node = O.Node(name="n1", provider_id="aws:///z/i-1", internal_ip="10.0.0.7",
                  labels={wk.LABEL_ZONE: "us-west-2a"}, taints=[taint],
                  capacity={"cpu": 2000.0}, allocatable={"cpu": 1930.0},
                  ready=True, created_at=1000000.125, node_pool="rich",
                  node_claim="c1")
    pdbs = [O.PodDisruptionBudget(name="pdb", label_selector={"app": "w"},
                                  max_unavailable=1, namespace="team"),
            O.PodDisruptionBudget(name="min", min_available=2)]
    lease = O.Lease(name="n1", owner_node="n1", created_at=1000000.0)
    pvc = O.PersistentVolumeClaim(name="data", storage_class="gp3",
                                  bound_zone="us-west-2a")
    sc = O.StorageClass(name="gp3", zones=("us-west-2a", "us-west-2b"))
    used = np.arange(R, dtype=np.float32) * 0.5
    alloc = np.full((R,), np.nan, np.float32)
    alloc[0] = 1930.0
    bins = [P.ExistingBin(name="n1", node_pool="rich", instance_type="m5.large",
                          zone="us-west-2a", capacity_type="spot", used=used,
                          alloc_override=alloc, labels={"a": "b"}),
            P.ExistingBin(name="n2", node_pool="rich", instance_type="c5.large",
                          zone="us-west-2b", capacity_type="on-demand",
                          used=used[::-1].copy())]
    return {"pod": pods, "nodepool": [pool, A.NodePool(name="plain")],
            "nodeclass": [nc, O.NodeClass(name="plain", role="r")],
            "nodeclaim": [claim, O.NodeClaim(name="c0", node_pool="p",
                                             created_at=1000000.0)],
            "node": [node], "pdb": pdbs, "lease": [lease], "pvc": [pvc],
            "storage_class": [sc], "requirement": [req],
            "existing_bin": bins}


def _roundtrip(writer, reader, kind, obj):
    """``writer``'s dict of ``obj``, and what ``reader`` reads from it and
    writes again, as JSON text."""
    w, r = cases.mod(writer, "apis.serde"), cases.mod(reader, "apis.serde")
    d = getattr(w, f"{kind}_to_dict")(obj)
    back = getattr(r, f"{kind}_to_dict")(getattr(r, f"{kind}_from_dict")(
        json.loads(json.dumps(d))))
    return json.dumps(d), json.dumps(back)


KINDS = ("pod", "nodepool", "nodeclass", "nodeclaim", "node", "pdb", "lease",
         "pvc", "storage_class", "requirement", "existing_bin")


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_each_kind_crosses_both_ways(kind, writer, reader):
    objs = _objects(writer)[kind]
    other = _objects(reader)[kind]
    assert objs
    for a, b in zip(objs, other):
        written, rewritten = _roundtrip(writer, reader, kind, a)
        assert rewritten == written
        # and the reader's own object writes the same dict
        own = cases.mod(reader, "apis.serde")
        assert json.dumps(getattr(own, f"{kind}_to_dict")(b)) == written


def test_nodepool_status_crosses_both_ways():
    out = {}
    for pkg in PKGS:
        serde = cases.mod(pkg, "apis.serde")
        pool = _objects(pkg)["nodepool"][0]
        out[pkg] = json.dumps(serde.nodepool_status_to_dict(pool))
        for other in PKGS:
            o = cases.mod(other, "apis.serde")
            bare = _objects(other)["nodepool"][1]
            applied = o.nodepool_apply_status(bare, json.loads(out[pkg]))
            assert json.dumps(o.nodepool_status_to_dict(applied)) == out[pkg]
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG]


def _plans():
    """Each package's plan of one seeded problem (cases.build's
    ``anti_wide`` case), the port's on the CPU."""
    plans = {}
    for pkg in PKGS:
        lat, pods, pools, _ = cases.build(pkg, "anti_wide")
        S = cases.mod(pkg, "solver")
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        plans[pkg] = S.Solver(lat, **kw).solve_relaxed(pods, pools)
    return plans


def test_plans_cross_both_ways_and_mean_the_same():
    plans = _plans()
    j, t = plans[cases.JAX_PKG], plans[cases.TORCH_PKG]
    assert j.new_nodes
    JS, TS = (cases.mod(p, "apis.serde") for p in PKGS)
    for writer, reader, plan in ((JS, TS, j), (TS, JS, t)):
        d = json.loads(json.dumps(writer.plan_to_dict(plan)))
        again = reader.plan_to_dict(reader.plan_from_dict(d))
        assert json.dumps(again) == json.dumps(writer.plan_to_dict(plan))
    # the same plan, read by either package's semantic view
    for plan in (j, t):
        assert json.dumps(TS.plan_semantic_dict(plan)) \
            == json.dumps(JS.plan_semantic_dict(plan))
    # and the two packages' plans of the same problem mean the same
    assert json.dumps(TS.plan_semantic_dict(t)) \
        == json.dumps(JS.plan_semantic_dict(j))
