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
