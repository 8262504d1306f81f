"""The benchmark workloads, for this package.

Copies of the repository's ``bench.py`` generators ``config1``–``config5``
and ``config10`` with the same seeds, written against this package's own
API objects, so ``chip_smoke.py`` and the tests can build them without the
JAX package. ``config1``–``config5`` return ``(pods, node_pools,
existing_bins)``; the same seed gives the same pods, pools and bins as
``bench.py``.

``config5_full_scale`` is the north-star wave: 50k pending pods over the
real 759-type catalog (``real_lattice``) and three NodePools.

``config10_steady_state`` with ``SteadyStateChurn`` is the steady-state
reconcile cluster of ``bench.py``'s microloop harness
(``run_microloop_config``): 20k pods, 120 partly used existing nodes, and
12 passes of about 1.5 % of the pods leaving and 1.5 % arriving.
"""

import numpy as np


def real_lattice():
    """The lattice over the real EC2 catalog (lattice/data), priced types
    only, as ``bench.py`` builds it."""
    from .lattice import build_lattice
    from .lattice.realdata import load_catalog
    return build_lattice(load_catalog(None, require_price=True))


def _pools_default():
    from .apis import NodePool
    return [NodePool(name="default")]


def config1_parity():
    """100 generic pods, cpu/mem requests only, single NodePool."""
    from .apis import Pod
    shapes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi")]
    pods = [Pod(name=f"p{i}", requests={"cpu": shapes[i % 4][0], "memory": shapes[i % 4][1]})
            for i in range(100)]
    return pods, _pools_default(), []


def config2_selectors_taints():
    """5k pods with nodeSelector + taints/tolerations across 3 NodePools."""
    from .apis import NodePool, Operator, Pod, Requirement
    from .apis import wellknown as wk
    from .apis.objects import Taint, Toleration
    pools = [
        NodePool(name="default"),
        NodePool(name="batch", taints=[Taint(key="dedicated", value="batch")],
                 labels={"team": "batch"}),
        NodePool(name="arm", weight=10, requirements=[
            Requirement(wk.LABEL_ARCH, Operator.IN, ("arm64",))]),
    ]
    rng = np.random.default_rng(2)
    pods = []
    for i in range(5000):
        r = rng.random()
        cpu = int(rng.choice([250, 500, 1000, 2000]))
        mem = int(rng.choice([512, 1024, 2048, 4096]))
        req = {"cpu": f"{cpu}m", "memory": f"{mem}Mi"}
        if r < 0.55:
            pods.append(Pod(name=f"gen{i}", requests=req))
        elif r < 0.8:
            cat = str(rng.choice(["m", "c", "r"]))
            pods.append(Pod(name=f"sel{i}", requests=req,
                            node_selector={wk.LABEL_INSTANCE_CATEGORY: cat}))
        else:
            pods.append(Pod(name=f"tol{i}", requests=req,
                            node_selector={"team": "batch"},
                            tolerations=[Toleration(key="dedicated", value="batch")]))
    return pods, pools, []


def config3_affinity_spread():
    """10k pods with podAntiAffinity + topologySpread (zone/hostname)."""
    from .apis import Pod
    from .apis import wellknown as wk
    from .apis.objects import (PodAffinityTerm,
                                                         TopologySpreadConstraint)
    pods = []
    # 200 singleton services: hostname anti-affinity, one replica per node
    for i in range(200):
        pods.append(Pod(
            name=f"anti{i}", requests={"cpu": "500m", "memory": "1Gi"},
            labels={"app": "singleton"},
            pod_affinity=[PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME, anti=True,
                                          label_selector=(("app", "singleton"),))]))
    # 7 deployments zone-spread (maxSkew 1), 1400 replicas each
    for d in range(7):
        for i in range(1400):
            pods.append(Pod(
                name=f"zs{d}-{i}", requests={"cpu": "1", "memory": "2Gi"},
                labels={"app": f"web{d}"},
                topology_spread=[TopologySpreadConstraint(
                    max_skew=1, topology_key=wk.LABEL_ZONE,
                    label_selector=((("app", f"web{d}")),))]))
    return pods, _pools_default(), []


def config4_consolidation_repack(lattice=None):
    """500 under-utilized nodes → repack; spot + on-demand price mix.

    The disruption controller's what-if shape (reference
    test/suites/scale/deprovisioning_test.go): the candidates' pods are
    re-offered as pending against the empty candidate nodes; the solve
    shows how few nodes (existing or cheaper-new) can host them.
    """
    from .apis import Pod
    from .lattice import build_lattice
    from .solver.problem import ExistingBin
    if lattice is None:
        lattice = build_lattice()
    # candidate node types: the synthetic trio when present, else (real
    # catalogs) the cheapest general-purpose multi-vCPU types available
    cands = [n for n in ("m5.2xlarge", "m5.xlarge", "c5.2xlarge")
             if n in lattice.name_to_idx]
    if len(cands) < 3:
        from .apis.resources import RESOURCE_AXES
        gpuish = [RESOURCE_AXES.index(a) for a in RESOURCE_AXES
                  if "gpu" in a or "neuron" in a or "gaudi" in a]
        pool = [(s_.od_price, s_.name) for s_ in lattice.specs
                if s_.od_price > 0 and s_.vcpus >= 4
                and not any(lattice.capacity[lattice.name_to_idx[s_.name], ax]
                            for ax in gpuish)]
        cands = [n for _, n in sorted(pool)[:3]] or list(lattice.names[:3])
    rng = np.random.default_rng(4)
    existing = []
    pods = []
    for i in range(500):
        itype = str(rng.choice(cands))
        cap = "spot" if rng.random() < 0.5 else "on-demand"
        zone = lattice.zones[int(rng.integers(len(lattice.zones)))]
        ti = lattice.name_to_idx[itype]
        existing.append(ExistingBin(
            name=f"node-{i}", node_pool="default", instance_type=itype,
            zone=zone, capacity_type=cap,
            used=np.zeros_like(lattice.alloc[ti])))
        # ~20% utilization: 3 small pods per 8-vCPU node
        for j in range(3):
            pods.append(Pod(name=f"p{i}-{j}",
                            requests={"cpu": "500m", "memory": "1Gi"}))
    return pods, _pools_default(), existing


def config5_full_scale():
    """50k pending pods × full catalog, GPU/Neuron + pinned capacity."""
    from .apis import NodePool, Operator, Pod, Requirement
    from .apis import wellknown as wk
    rng = np.random.default_rng(0)
    pods = []
    shapes = []
    for s in range(30):
        cpu = int(rng.choice([100, 250, 500, 1000, 2000, 4000]))
        mem = int(rng.choice([256, 512, 1024, 2048, 4096, 8192]))
        sel = {}
        r = rng.random()
        if r < 0.2:
            sel[wk.LABEL_INSTANCE_CATEGORY] = str(rng.choice(["m", "c", "r"]))
        elif r < 0.3:
            sel[wk.LABEL_CAPACITY_TYPE] = "on-demand"
        elif r < 0.35:
            sel[wk.LABEL_ARCH] = "arm64"
        shapes.append(({"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, sel))
    counts = rng.multinomial(48600, np.ones(30) / 30)
    for s, ((req, sel), n) in enumerate(zip(shapes, counts)):
        pods += [Pod(name=f"s{s}-{i}", requests=req, node_selector=sel) for i in range(n)]
    pods += [Pod(name=f"gpu-{i}", requests={"cpu": "4", "memory": "16Gi", "nvidia.com/gpu": 1})
             for i in range(1000)]
    pods += [Pod(name=f"neuron-{i}", requests={"cpu": "4", "memory": "8Gi",
                                               "aws.amazon.com/neuron": 1})
             for i in range(400)]
    pools = [
        NodePool(name="default"),
        NodePool(name="arm", weight=10, requirements=[
            Requirement(wk.LABEL_ARCH, Operator.IN, ("arm64",))]),
        NodePool(name="gpu", weight=20, requirements=[
            Requirement(wk.LABEL_INSTANCE_GPU_COUNT, Operator.GT, ("0",))]),
    ]
    return pods, pools, []



def config10_steady_state():
    """The steady-state reconcile shape (``bench.config10_steady_state``,
    seed 10): 20,000 pods in 24 deployment shapes over the real catalog, a
    quarter of the shapes with an instance-category selector, one default
    NodePool. Returns ``(pods, node_pools, shapes)``; ``shapes`` are the
    (requests, node_selector) pairs the churn draws arriving pods from."""
    from .apis import Pod
    from .apis import wellknown as wk
    rng = np.random.default_rng(10)
    shapes = []
    for s in range(24):
        cpu = int(rng.choice([250, 500, 1000, 2000]))
        mem = int(rng.choice([512, 1024, 2048, 4096]))
        sel = ({wk.LABEL_INSTANCE_CATEGORY: str(rng.choice(["m", "c", "r"]))}
               if rng.random() < 0.25 else {})
        shapes.append(({"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, sel))
    counts = rng.multinomial(20000, np.ones(24) / 24)
    pods = []
    for s, ((req, sel), n) in enumerate(zip(shapes, counts)):
        pods += [Pod(name=f"st{s}-{i}", requests=req, node_selector=sel)
                 for i in range(n)]
    return pods, _pools_default(), shapes


# the microloop harness's pass schedule (bench.py DELTA_PASSES,
# DELTA_CHURN_FRACTION, MICRO_NOCHURN_EVERY)
STEADY_PASSES = 12
STEADY_CHURN_FRACTION = 0.015   # ~1.5% leave + ~1.5% arrive per pass
STEADY_NOCHURN_EVERY = 4        # every 4th pass churns nothing


class SteadyStateChurn:
    """cfg10's existing nodes and churn, as ``bench.run_microloop_config``
    makes them from one generator (seed 14): first 120 existing nodes at
    20 % usage over the 4 cheapest non-accelerator types with at least 8
    vCPUs, then, per pass, ``churn``.

    ``pods`` and ``existing`` are the current cluster; ``churn`` changes
    them in place and returns what a cluster journal would report."""

    def __init__(self, lattice, pods, shapes, seed: int = 14):
        from .apis.resources import RESOURCE_AXES
        from .solver.problem import ExistingBin
        self._rng = rng = np.random.default_rng(seed)
        self.pods = list(pods)
        self.shapes = shapes
        self._serial = 0
        gpuish = [RESOURCE_AXES.index(a) for a in RESOURCE_AXES
                  if "gpu" in a or "neuron" in a or "gaudi" in a]
        cand_pool = [(s_.od_price, s_.name) for s_ in lattice.specs
                     if s_.od_price > 0 and s_.vcpus >= 8
                     and not any(lattice.capacity[lattice.name_to_idx[s_.name], ax]
                                 for ax in gpuish)]
        cands = [n for _, n in sorted(cand_pool)[:4]] or list(lattice.names[:4])
        self.existing = []
        for i in range(120):
            itype = cands[int(rng.integers(len(cands)))]
            ti = lattice.name_to_idx[itype]
            used = (lattice.alloc[ti] * 0.2).astype(np.float32)
            self.existing.append(ExistingBin(
                name=f"node-{i}", node_pool="default", instance_type=itype,
                zone=lattice.zones[int(rng.integers(len(lattice.zones)))],
                capacity_type="on-demand", used=used))

    def churn(self, pass_i: int):
        """Pass ``pass_i``: unless it is a no-churn pass, about 1.5 % of
        the pods leave, as many arrive (drawn from ``shapes``) and two
        existing nodes gain 0.25 of their first resource. Returns
        ``(touched, nochurn)``: ``touched`` maps each churned pod name to
        ``("gone", None)`` or ``("pending", pod)``."""
        from .apis import Pod
        nochurn = (pass_i % STEADY_NOCHURN_EVERY) == STEADY_NOCHURN_EVERY - 1
        if nochurn:
            return {}, True
        rng = self._rng
        pods = self.pods
        k = max(1, int(len(pods) * STEADY_CHURN_FRACTION))
        gone_idx = set(int(i) for i in rng.choice(len(pods), size=k,
                                                  replace=False))
        removed = [pods[i] for i in gone_idx]
        self.pods = [p for i, p in enumerate(pods) if i not in gone_idx]
        added = []
        for _ in range(k):
            self._serial += 1
            req, sel = self.shapes[int(rng.integers(len(self.shapes)))]
            added.append(Pod(name=f"churn-{self._serial}", requests=req,
                             node_selector=sel))
        self.pods += added
        for b in rng.choice(len(self.existing), size=2, replace=False):
            u = self.existing[int(b)].used.copy()
            u[0] += 0.25
            self.existing[int(b)].used = u
        touched = {p.name: ("gone", None) for p in removed}
        touched.update({p.name: ("pending", p) for p in added})
        return touched, False


def steady_state_passes(solver, lattice, pools, churn: SteadyStateChurn,
                        passes: int = STEADY_PASSES):
    """The pass loop of ``bench.run_microloop_config`` with this package's
    objects: a cold full build, ``solve`` and a priming ``solve_delta``,
    then ``passes`` passes of ``churn``, the incremental build and
    ``solve_delta`` (``solve`` where the builder fell back to a full
    build). Yields ``(pass_i, build_result, plan, ms, legs)``, the cold
    pass first as ``pass_i`` -1 (its ``ms`` covers all three calls).
    ``ms`` is the host wall time of the build and solve; ``legs`` the
    link legs of a delta pass (None for the cold pass and full builds)."""
    import time
    from .solver.incremental import IncrementalProblemBuilder
    from .state.cluster import DirtySet
    builder = IncrementalProblemBuilder()
    t = time.perf_counter()
    res = builder.build(churn.pods, pools, lattice,
                        existing=list(churn.existing),
                        dirty=DirtySet(since=-1, rev=0, full=True))
    solver.solve(res.problem)
    plan = solver.solve_delta(res.problem)
    yield -1, res, plan, (time.perf_counter() - t) * 1e3, None
    for pass_i in range(passes):
        touched, nochurn = churn.churn(pass_i)
        dirty = DirtySet(since=builder.rev, rev=builder.rev + 1,
                         pods=set(touched), bins=not nochurn)
        t = time.perf_counter()
        res = builder.build(churn.pods, pools, lattice,
                            existing=lambda: list(churn.existing),
                            dirty=dirty, touched=touched)
        if res.incremental:
            plan = solver.solve_delta(res.problem,
                                      dirty_groups=res.dirty_groups)
        else:
            plan = solver.solve(res.problem)
        ms = (time.perf_counter() - t) * 1e3
        legs = (solver.pipeline_stats["micro_last_legs"]
                if res.incremental else None)
        yield pass_i, res, plan, ms, legs
