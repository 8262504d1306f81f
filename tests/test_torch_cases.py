"""Shared inputs of the PyTorch-port parity tests (no tests of its own).

Each case builds the same pods, NodePools, existing bins and bound pods
from one of the two packages' own API classes, picked by package name, so
the JAX package (``karpenter_provider_aws_tpu``) and the port
(``karpenter_provider_aws_tpu_torch``) see identical inputs. Random
choices come from numpy generators with fixed seeds.
"""

import importlib

import numpy as np

JAX_PKG = "karpenter_provider_aws_tpu"
TORCH_PKG = "karpenter_provider_aws_tpu_torch"

FAMILIES = ("m5", "c5", "m6g", "t3")

_LATTICES = {}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def small_lattice(pkg: str):
    """The m5/c5/m6g/t3 slice of the synthetic catalog (cached)."""
    lat = _LATTICES.get(pkg)
    if lat is None:
        L = mod(pkg, "lattice")
        lat = L.build_lattice([s for s in L.build_catalog()
                               if s.family in FAMILIES])
        _LATTICES[pkg] = lat
    return lat


def case_generic(pkg, lat):
    """cfg1-style: cpu/mem requests only, one pool."""
    A = mod(pkg, "apis")
    shapes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi")]
    pods = [A.Pod(name=f"p{i}", requests={"cpu": shapes[i % 4][0],
                                          "memory": shapes[i % 4][1]})
            for i in range(60)]
    return pods, [A.NodePool(name="default")], {}


def case_selectors_taints(pkg, lat):
    """cfg2-style: selectors, taints/tolerations, three weighted pools."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    O = mod(pkg, "apis.objects")
    pools = [
        A.NodePool(name="default"),
        A.NodePool(name="batch", taints=[O.Taint(key="dedicated", value="batch")],
                   labels={"team": "batch"}),
        A.NodePool(name="arm", weight=10, requirements=[
            A.Requirement(wk.LABEL_ARCH, A.Operator.IN, ("arm64",))]),
    ]
    rng = np.random.default_rng(2)
    pods = []
    for i in range(150):
        r = rng.random()
        req = {"cpu": f"{int(rng.choice([250, 500, 1000, 2000]))}m",
               "memory": f"{int(rng.choice([512, 1024, 2048, 4096]))}Mi"}
        if r < 0.55:
            pods.append(A.Pod(name=f"gen{i}", requests=req))
        elif r < 0.8:
            pods.append(A.Pod(name=f"sel{i}", requests=req, node_selector={
                wk.LABEL_INSTANCE_CATEGORY: str(rng.choice(["m", "c"]))}))
        else:
            pods.append(A.Pod(name=f"tol{i}", requests=req,
                              node_selector={"team": "batch"},
                              tolerations=[O.Toleration(key="dedicated",
                                                        value="batch")]))
    return pods, pools, {}


def case_affinity(pkg, lat):
    """cfg3-style: hostname anti-affinity (both directions), hostname
    self-affinity (single-bin groups), hostname spread caps, zone spread."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    O = mod(pkg, "apis.objects")
    host = wk.LABEL_HOSTNAME
    pods = []
    pods += [A.Pod(name=f"w{i}", labels={"app": "web"},
                   requests={"cpu": "250m", "memory": "256Mi"},
                   pod_affinity=[O.PodAffinityTerm(
                       topology_key=host, label_selector=(("app", "redis"),),
                       anti=True)]) for i in range(6)]
    pods += [A.Pod(name=f"r{i}", labels={"app": "redis"},
                   requests={"cpu": "250m", "memory": "256Mi"})
             for i in range(6)]
    pods += [A.Pod(name=f"s{i}", labels={"app": "single"},
                   requests={"cpu": "500m", "memory": "1Gi"},
                   pod_affinity=[O.PodAffinityTerm(
                       topology_key=host, anti=True,
                       label_selector=(("app", "single"),))])
             for i in range(5)]
    pods += [A.Pod(name=f"pair{i}", labels={"app": "pair"},
                   requests={"cpu": "500m", "memory": "512Mi"},
                   pod_affinity=[O.PodAffinityTerm(
                       topology_key=host, label_selector=(("app", "pair"),))])
             for i in range(4)]
    pods += [A.Pod(name=f"hs{i}", labels={"app": "hs"},
                   requests={"cpu": "100m", "memory": "128Mi"},
                   topology_spread=[O.TopologySpreadConstraint(
                       max_skew=2, topology_key=host,
                       label_selector=(("app", "hs"),))])
             for i in range(9)]
    pods += [A.Pod(name=f"zs{i}", labels={"app": "zs"},
                   requests={"cpu": "1", "memory": "2Gi"},
                   topology_spread=[O.TopologySpreadConstraint(
                       max_skew=1, topology_key=wk.LABEL_ZONE,
                       label_selector=(("app", "zs"),))])
             for i in range(12)]
    return pods, [A.NodePool(name="default")], {}


def case_existing(pkg, lat):
    """cfg4-style: existing nodes (spot and on-demand) with bound pods,
    a presence requirement one existing node satisfies, and new pods."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    O = mod(pkg, "apis.objects")
    P = mod(pkg, "solver.problem")
    T = mod(pkg, "solver.topology")
    R = mod(pkg, "apis.resources").R
    rng = np.random.default_rng(4)
    cands = ("m5.2xlarge", "m5.xlarge", "c5.2xlarge")
    existing, bound = [], []
    for i in range(8):
        itype = str(rng.choice(cands))
        cap = "spot" if rng.random() < 0.5 else "on-demand"
        zone = lat.zones[int(rng.integers(len(lat.zones)))]
        used = np.zeros((R,), np.float32)
        used[0] = float(rng.choice([0, 500, 1500]))
        existing.append(P.ExistingBin(name=f"node-{i}", node_pool="default",
                                      instance_type=itype, zone=zone,
                                      capacity_type=cap, used=used))
    bound.append(T.BoundPod(pod=A.Pod(name="cache-0", labels={"app": "cache"}),
                            node_name="node-3", zone=existing[3].zone))
    pods = [A.Pod(name=f"p{i}", requests={"cpu": "500m", "memory": "1Gi"})
            for i in range(40)]
    pods += [A.Pod(name=f"f{i}", labels={"app": "follower"},
                   requests={"cpu": "250m", "memory": "256Mi"},
                   pod_affinity=[O.PodAffinityTerm(
                       topology_key=wk.LABEL_HOSTNAME,
                       label_selector=(("app", "cache"),))])
             for i in range(3)]
    pods += [A.Pod(name=f"big{i}", requests={"cpu": "6", "memory": "20Gi"})
             for i in range(4)]
    return pods, [A.NodePool(name="default")], {"existing": existing,
                                                "bound_pods": bound}


def case_relax(pkg, lat):
    """Preferred affinity the pool forbids: the first round leaves pods
    unschedulable and the relaxation round places them."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    pool = A.NodePool(name="default", requirements=[
        A.Requirement(wk.LABEL_ZONE, A.Operator.NOT_IN, (lat.zones[1],))])
    pref = A.PreferredRequirement(
        A.Requirement(wk.LABEL_ZONE, A.Operator.IN, (lat.zones[1],)), weight=1)
    pods = [A.Pod(name=f"p{i}", requests={"cpu": "1", "memory": "2Gi"},
                  preferred_affinity=[pref]) for i in range(6)]
    pods += [A.Pod(name=f"q{i}", requests={"cpu": "500m", "memory": "1Gi"})
             for i in range(5)]
    return pods, [pool], {}


def case_anti_wide(pkg, lat):
    """One node per pod (hostname self-anti-affinity) for more pods than
    the smallest bin buckets hold, beside three existing nodes: an
    undersized bin estimate must overflow and regrow."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    O = mod(pkg, "apis.objects")
    P = mod(pkg, "solver.problem")
    R = mod(pkg, "apis.resources").R
    existing = [P.ExistingBin(name=f"e{i}", node_pool="default",
                              instance_type="m5.xlarge", zone=lat.zones[i],
                              capacity_type="on-demand",
                              used=np.zeros((R,), np.float32))
                for i in range(3)]
    pods = [A.Pod(name=f"a{i}", labels={"app": "solo"},
                  requests={"cpu": "250m", "memory": "512Mi"},
                  pod_affinity=[O.PodAffinityTerm(
                      topology_key=wk.LABEL_HOSTNAME, anti=True,
                      label_selector=(("app", "solo"),))])
            for i in range(150)]
    return pods, [A.NodePool(name="default")], {"existing": existing}


def random_inputs(pkg, lat, seed):
    """A seeded random mix: request shapes, selectors, two pools, a few
    existing nodes with bound pods, hostname anti-affinity, hostname
    spread and self-affinity groups."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    O = mod(pkg, "apis.objects")
    P = mod(pkg, "solver.problem")
    T = mod(pkg, "solver.topology")
    R = mod(pkg, "apis.resources").R
    rng = np.random.default_rng(seed)
    host = wk.LABEL_HOSTNAME
    pools = [A.NodePool(name="default"),
             A.NodePool(name="arm", weight=10, requirements=[
                 A.Requirement(wk.LABEL_ARCH, A.Operator.IN, ("arm64",))])]
    existing, bound = [], []
    for i in range(int(rng.integers(0, 5))):
        used = np.zeros((R,), np.float32)
        used[0] = float(rng.choice([0, 250, 1000]))
        existing.append(P.ExistingBin(
            name=f"n{i}", node_pool="default",
            instance_type=str(rng.choice(["m5.xlarge", "c5.2xlarge", "m5.2xlarge"])),
            zone=lat.zones[int(rng.integers(lat.Z))],
            capacity_type=str(rng.choice(["spot", "on-demand"])), used=used))
        if rng.random() < 0.5:
            bound.append(T.BoundPod(pod=A.Pod(name=f"b{i}", labels={"app": "g0"}),
                                    node_name=f"n{i}", zone=existing[-1].zone))
    pods = []
    for g in range(int(rng.integers(3, 9))):
        req = {"cpu": f"{int(rng.choice([100, 250, 500, 1000, 2000, 4000]))}m",
               "memory": f"{int(rng.choice([128, 512, 1024, 4096, 8192]))}Mi"}
        kind = rng.random()
        kw = {"labels": {"app": f"g{g}"}}
        if kind < 0.15:
            kw["pod_affinity"] = [O.PodAffinityTerm(
                topology_key=host, anti=True, label_selector=(("app", f"g{g}"),))]
        elif kind < 0.3:
            kw["topology_spread"] = [O.TopologySpreadConstraint(
                max_skew=int(rng.integers(1, 4)), topology_key=host,
                label_selector=(("app", f"g{g}"),))]
        elif kind < 0.4:
            kw["pod_affinity"] = [O.PodAffinityTerm(
                topology_key=host, label_selector=(("app", f"g{g}"),))]
        elif kind < 0.5:
            kw["pod_affinity"] = [O.PodAffinityTerm(
                topology_key=host, anti=True, label_selector=(("app", "g0"),))]
        elif kind < 0.65:
            kw["node_selector"] = {wk.LABEL_INSTANCE_CATEGORY: str(rng.choice(["m", "c"]))}
        n = int(rng.integers(1, 40)) if kind >= 0.4 else int(rng.integers(1, 8))
        pods += [A.Pod(name=f"g{g}-{i}", requests=req, **kw) for i in range(n)]
    return pods, pools, {"existing": existing, "bound_pods": bound}


CASES = {
    "generic": case_generic,
    "selectors_taints": case_selectors_taints,
    "affinity": case_affinity,
    "existing": case_existing,
    "relax": case_relax,
    "anti_wide": case_anti_wide,
}


def build(pkg: str, case: str):
    """(lattice, pods, pools, build_problem kwargs) of ``case`` in ``pkg``;
    ``random-<seed>`` names a seeded random mix."""
    lat = small_lattice(pkg)
    if case.startswith("random-"):
        pods, pools, kw = random_inputs(pkg, lat, int(case.split("-", 1)[1]))
    else:
        pods, pools, kw = CASES[case](pkg, lat)
    return lat, pods, pools, kw


def problem(pkg: str, case: str):
    lat, pods, pools, kw = build(pkg, case)
    return mod(pkg, "solver.problem").build_problem(pods, pools, lat, **kw)


CHURN_SHAPES = (("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi"))


def churn_sequence(pkg: str, lat, seed: int = 7, steps: int = 14):
    """A seeded steady-state churn sequence over the m5/c5 slice, built
    from ``pkg``'s own classes: yields ``(pods, pools, existing, dirty,
    touched)`` per step, the cold full build first. Steps add and remove
    pending pods, move existing-bin usage, churn nothing, and hit the
    builder's gates: a revision skew, bulk churn, a new signature, a pod
    with an unknown resource, a pool change and a count mismatch. Each
    step's objects are new lists; the pods themselves are shared across
    steps as a cluster mirror shares them."""
    A = mod(pkg, "apis")
    P = mod(pkg, "solver.problem")
    R = mod(pkg, "apis.resources").R
    DirtySet = mod(pkg, "state.cluster").DirtySet
    rng = np.random.default_rng(seed)
    serial = 0

    def pod(shape):
        nonlocal serial
        serial += 1
        cpu, mem = CHURN_SHAPES[shape]
        return A.Pod(name=f"c{serial}", requests={"cpu": cpu, "memory": mem})

    pods = [pod(i % 4) for i in range(120)]
    existing = []
    for i, t in enumerate(("m5.xlarge", "m5.2xlarge", "c5.xlarge", "c5.2xlarge")):
        used = np.zeros((R,), np.float32)
        used[0] = 500.0 * i
        existing.append(P.ExistingBin(name=f"node-{i}", node_pool="default",
                                      instance_type=t, zone=lat.zones[i % lat.Z],
                                      capacity_type="on-demand", used=used))
    pools = [A.NodePool(name="default")]
    rev = 0
    yield list(pods), pools, list(existing), DirtySet(since=-1, rev=0, full=True), {}
    kinds = ["churn", "churn", "none", "skew", "churn", "bulk", "churn",
             "newsig", "churn", "unknown", "pool", "churn", "mismatch", "churn"]
    for kind in kinds[:steps]:
        touched, bins, since = {}, False, rev
        if kind in ("churn", "bulk", "mismatch"):
            n_gone = int(rng.integers(1, 4)) if kind != "bulk" else 80
            gone = set(int(i) for i in rng.choice(len(pods), size=n_gone,
                                                  replace=False))
            touched.update({pods[i].name: ("gone", None) for i in gone})
            pods = [p for i, p in enumerate(pods) if i not in gone]
            for _ in range(int(rng.integers(1, 5))):
                p = pod(int(rng.integers(4)))
                pods.append(p)
                touched[p.name] = ("pending", p)
            if kind == "mismatch":
                # a pending pod the journal never reported
                pods.append(pod(0))
            b = existing[int(rng.integers(len(existing)))]
            u = b.used.copy()
            u[0] += 250.0
            b.used = u
            bins = True
        elif kind == "skew":
            since = rev + 3
        elif kind == "newsig":
            p = A.Pod(name="odd-1", requests={"cpu": "7777m", "memory": "3Gi"})
            pods.append(p)
            touched[p.name] = ("pending", p)
        elif kind == "unknown":
            p = A.Pod(name="weird-1", requests={"cpu": "1", "example.com/foo": 1})
            pods.append(p)
            touched[p.name] = ("pending", p)
        elif kind == "pool":
            pools = [A.NodePool(name="default", labels={"rev": "r2"})]
        rev += 1
        yield (list(pods), pools, list(existing),
               DirtySet(since=since, rev=rev, pods=set(touched), bins=bins),
               touched)


CLUSTER_TYPES = ("m5.xlarge", "m5.2xlarge", "c5.xlarge", "c5.2xlarge", "m6g.xlarge")


def cluster_contents(pkg: str, lat, seed: int = 3):
    """Seeded cluster-state contents built from ``pkg``'s own classes, the
    cluster-mirror counterpart of ``churn_sequence``: NodePools, registered
    nodes with their claims, launched claims that have not registered yet,
    one claim being deleted, pods bound to nodes, daemonset pods on every
    node, pods nominated to the in-flight claims, and pending pods. Returns
    a dict of lists; ``populate`` loads it into a ``ClusterState``."""
    A = mod(pkg, "apis")
    wk = mod(pkg, "apis.wellknown")
    O = mod(pkg, "apis.objects")
    res = mod(pkg, "apis.resources")
    rng = np.random.default_rng(seed)
    t0 = 1_000_000.0
    pools = [A.NodePool(name="default", limits={"cpu": "400"}),
             A.NodePool(name="arm", weight=10, requirements=[
                 A.Requirement(wk.LABEL_ARCH, A.Operator.IN, ("arm64",))])]

    def shape(itype):
        ti = lat.name_to_idx[itype]
        return (res.vec_to_resources(lat.capacity[ti]),
                res.vec_to_resources(lat.alloc[ti]))

    def labels(itype, zone, cap, pool):
        return {**lat.labels[lat.name_to_idx[itype]],
                wk.LABEL_INSTANCE_TYPE: itype, wk.LABEL_ZONE: zone,
                wk.LABEL_CAPACITY_TYPE: cap, wk.LABEL_NODEPOOL: pool}

    nodes, claims, inflight = [], [], []
    for i in range(int(rng.integers(5, 9)) + 3):
        itype = str(rng.choice(CLUSTER_TYPES))
        pool = "arm" if itype.startswith("m6g") else "default"
        zone = lat.zones[int(rng.integers(lat.Z))]
        cap_t = str(rng.choice(["spot", "on-demand"]))
        capacity, alloc = shape(itype)
        claim = O.NodeClaim(
            name=f"{pool}-{i:05d}", node_pool=pool,
            labels=labels(itype, zone, cap_t, pool),
            phase=O.NodeClaimPhase.LAUNCHED, provider_id=f"sim:///{zone}/i-{i:08x}",
            instance_type=itype, zone=zone, capacity_type=cap_t,
            capacity=capacity, allocatable=alloc,
            created_at=t0 - 100.0, launched_at=t0 - 99.0)
        claims.append(claim)
        if i < 3:
            # launched, not registered yet: an in-flight bin
            inflight.append(claim.name)
            continue
        claim.phase = O.NodeClaimPhase.INITIALIZED
        claim.registered_at = claim.initialized_at = t0 - 90.0
        if i == 3:
            claim.deletion_timestamp = t0 - 5.0
            claim.phase = O.NodeClaimPhase.TERMINATING
        nodes.append(O.Node(
            name=claim.name, provider_id=claim.provider_id,
            labels=dict(claim.labels), capacity=dict(capacity),
            allocatable=dict(alloc), ready=True, created_at=t0 - 90.0,
            node_pool=pool, node_claim=claim.name))
    pods, ds, nominated = [], [], []
    for node in nodes:
        ds.append(A.Pod(name=f"ds-{node.name}", requests={"cpu": "100m", "memory": "128Mi"},
                        is_daemonset=True, owner="daemonset/agent",
                        node_name=node.name))
    serial = 0
    for node in nodes:
        for _ in range(int(rng.integers(0, 6))):
            serial += 1
            cpu, mem = CHURN_SHAPES[int(rng.integers(4))]
            pods.append(A.Pod(name=f"b{serial}", requests={"cpu": cpu, "memory": mem},
                              labels={"app": f"a{serial % 3}"}, node_name=node.name))
    for name in inflight:
        for _ in range(int(rng.integers(1, 4))):
            serial += 1
            pods.append(A.Pod(name=f"n{serial}", requests={"cpu": "250m", "memory": "512Mi"}))
            nominated.append((pods[-1].name, name))
    for _ in range(int(rng.integers(10, 30))):
        serial += 1
        cpu, mem = CHURN_SHAPES[int(rng.integers(4))]
        kw = {}
        if rng.random() < 0.2:
            kw["node_selector"] = {wk.LABEL_ARCH: "arm64"}
        pods.append(A.Pod(name=f"p{serial}", requests={"cpu": cpu, "memory": mem}, **kw))
    return {"pools": pools, "nodes": nodes, "claims": claims, "pods": pods,
            "daemonset_pods": ds, "nominated": nominated}


def populate(pkg: str, contents, clock=None):
    """A ``ClusterState`` of ``pkg`` holding ``cluster_contents`` (claims,
    nodes, daemonset pods, pods, then the nominations), on ``clock`` or a
    new ``FakeClock``."""
    clock = clock or mod(pkg, "utils.clock").FakeClock()
    cluster = mod(pkg, "state.cluster").ClusterState(clock)
    for c in contents["claims"]:
        cluster.add_claim(c)
    for n in contents["nodes"]:
        cluster.add_node(n)
    for p in contents["daemonset_pods"] + contents["pods"]:
        cluster.add_pod(p)
    for p, target in contents["nominated"]:
        cluster.nominate(p, target)
    return cluster


# ---- the consolidation stack of either package ----

_FAMILY_LATTICES = {}


def family_lattice(pkg: str, families):
    """The synthetic catalog cut to ``families`` (cached per package)."""
    key = (pkg, tuple(families))
    lat = _FAMILY_LATTICES.get(key)
    if lat is None:
        L = mod(pkg, "lattice")
        lat = L.build_lattice([s for s in L.build_catalog()
                               if s.family in families])
        _FAMILY_LATTICES[key] = lat
    return lat


class JaxConsolidationStack:
    """The JAX package's controllers wired as the port's
    ``workloads.ConsolidationStack`` wires its own (the JAX package has no
    such stack; its Operator wires the same controllers and more): one
    ``ClusterState``, ``FakeCloud``, ``UnavailableOfferings``,
    ``CloudProvider``, ``Recorder``, metrics ``Registry`` and
    ``DirectWriter`` on one clock, the ``Provisioner``, the
    ``LifecycleController``, the ``TerminationController`` and the
    ``DisruptionController``, run in the Operator's order."""

    def __init__(self, lattice, pools, solver, clock=None,
                 registration_delay=2.0, drift_enabled=True,
                 spot_to_spot_consolidation=False,
                 termination_grace_period=None):
        m = lambda name: mod(JAX_PKG, name)  # noqa: E731
        self.lattice = lattice
        self.solver = solver
        self.clock = clock if clock is not None else m("utils.clock").FakeClock()
        self.registration_delay = registration_delay
        self.cluster = m("state.cluster").ClusterState(self.clock)
        self.writer = m("kube.writer").DirectWriter(self.cluster, self.clock)
        self.cloud = m("cloud").FakeCloud(self.clock)
        self.unavailable = m("cache.unavailable").UnavailableOfferings(self.clock)
        self.recorder = m("events").Recorder(self.clock)
        self.metrics = m("metrics").Registry()
        self.cloud_provider = m("cloudprovider.cloudprovider").CloudProvider(
            lattice, self.cloud, self.unavailable, self.recorder, self.clock)
        self.node_classes = self.cloud_provider.node_classes
        self.node_pools = {p.name: p for p in pools}
        self.provisioner = m("controllers.provisioning").Provisioner(
            self.cluster, solver, self.node_pools, self.cloud_provider,
            self.unavailable, recorder=self.recorder, clock=self.clock,
            metrics=self.metrics, writer=self.writer)
        self.lifecycle = m("controllers.lifecycle").LifecycleController(
            self.cluster, self.cloud_provider, recorder=self.recorder,
            clock=self.clock, registration_delay=registration_delay,
            metrics=self.metrics, writer=self.writer)
        self.termination = m("controllers.termination").TerminationController(
            self.cluster, self.cloud_provider, self.recorder, self.clock,
            metrics=self.metrics,
            termination_grace_period=termination_grace_period,
            writer=self.writer)
        self.disruption = m("controllers.disruption").DisruptionController(
            self.cluster, solver, self.node_pools, self.cloud_provider,
            self.provisioner, self.termination, self.unavailable,
            self.recorder, self.clock, drift_enabled=drift_enabled,
            spot_to_spot_consolidation=spot_to_spot_consolidation,
            metrics=self.metrics, writer=self.writer)

    def seed_fleet(self, existing, pods):
        """``workloads.ConsolidationStack.seed_fleet`` with this package's
        classes."""
        from karpenter_provider_aws_tpu.cloud.fake import LaunchOverride
        from karpenter_provider_aws_tpu.solver.solve import PlannedNode
        per = len(pods) // len(existing)
        for p in pods:
            self.cluster.add_pod(p)
        lat = self.lattice
        for i, b in enumerate(existing):
            names = [p.name for p in pods[i * per: (i + 1) * per]]
            claim = self.provisioner._make_claim(PlannedNode(
                node_pool=b.node_pool, instance_type=b.instance_type,
                zone=b.zone, capacity_type=b.capacity_type,
                price_per_hour=0.0, pods=names,
                feasible_types=(b.instance_type,), feasible_zones=(b.zone,),
                feasible_capacity_types=(b.capacity_type,)))
            self.writer.create_claim(claim)
            price = float(lat.price[lat.name_to_idx[b.instance_type],
                                    lat.zones.index(b.zone),
                                    lat.capacity_types.index(b.capacity_type)])
            fleet = self.cloud.create_fleet([LaunchOverride(
                instance_type=b.instance_type, zone=b.zone,
                capacity_type=b.capacity_type, price=price)])
            self.cloud_provider._instance_to_claim(fleet.instance, claim)
            self.writer.update_claim_status(claim)
            for n in names:
                self.cluster.nominate(n, claim.name)
        self.clock.step(self.registration_delay + 0.1)
        self.lifecycle.reconcile()

    def run_once(self, force_provision=False):
        if force_provision or self.provisioner.batch_ready():
            self.provisioner.provision_once()
        self.lifecycle.reconcile()
        self.disruption.reconcile()
        self.termination.reconcile()

    def settle(self, max_rounds=50, step=1.0):
        for i in range(max_rounds):
            self.run_once(force_provision=bool(self.cluster.pending_pods()))
            if not self.cluster.pending_pods() and all(
                    self.cluster.node_for_claim(c.name) is not None
                    for c in self.cluster.snapshot_claims()
                    if not c.deletion_timestamp):
                return i + 1
            self.clock.step(step)
        return max_rounds


def consolidation_stack(pkg: str, lattice, pools, clock_start=None, **opts):
    """The consolidation stack of ``pkg`` over ``lattice`` and ``pools``:
    the port's ``workloads.ConsolidationStack`` with a CPU Solver, or its
    JAX-package twin; ``opts`` are the stack's keyword options."""
    clock = (mod(pkg, "utils.clock").FakeClock() if clock_start is None
             else mod(pkg, "utils.clock").FakeClock(start=clock_start))
    S = mod(pkg, "solver.solve")
    if pkg == JAX_PKG:
        return JaxConsolidationStack(lattice, pools, S.Solver(lattice),
                                     clock=clock, **opts)
    return mod(pkg, "workloads").ConsolidationStack(
        lattice, pools, S.Solver(lattice, device="cpu"), clock=clock, **opts)
