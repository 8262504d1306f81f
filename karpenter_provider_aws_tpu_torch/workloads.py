"""The benchmark workloads, for this package.

Copies of the repository's ``bench.py`` generators ``config1``–``config7``,
``config9``–``config11`` and ``build_bench_problem`` with the same seeds,
written against this package's own API objects, so ``chip_smoke.py``, the
port's bench (``bench.py`` in this package) and the tests can build them
without the JAX package. ``config1``–``config7`` return ``(pods,
node_pools, existing_bins)``; the same seed gives the same pods, pools and
bins as ``bench.py``.

``config5_full_scale`` is the north-star wave: 50k pending pods over the
real 759-type catalog (``real_lattice``) and three NodePools.

``config10_steady_state`` with ``SteadyStateChurn`` is the steady-state
reconcile cluster of ``bench.py``'s microloop harness
(``run_microloop_config``): 20k pods, 120 partly used existing nodes, and
12 passes of about 1.5 % of the pods leaving and 1.5 % arriving.

``config7_highG_wave_split`` is the adversarial-diversity wave: 4,608
distinct signatures, past the largest group bucket, so the solve takes
the wave split. ``weather_operator`` puts cfg4's fleet in an Operator
under a ``WeatherSimulator``.

The mesh workloads (``bench.py``'s sharded rows): ``config9_sharded_16k``
(16,500 mixed-shape pods), ``config11_200k_sharded`` (200k pods in 32
shapes, the mesh-production scale), ``mesh_parity_problem`` (the capped
full-dissolve problem, whose mesh plan equals the single-device plan
byte for byte) and ``delta_on_mesh_passes`` (cfg10's steady passes on a
mesh-native Solver).
"""

import numpy as np
from typing import Tuple


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


def config6_ffd_beat():
    """The beat wave (``bench.config6_ffd_beat``): 20,000 tiny pods (50m,
    96Mi: bound by the pods axis), 2,000 mid-size pods and 400 one-GPU
    pods, one default NodePool. Its bench row referees the uncapped
    problem (``narrow=False``), the one the reference's scheduler packs."""
    from .apis import Pod
    pods = [Pod(name=f"w{i}", requests={"cpu": "50m", "memory": "96Mi"})
            for i in range(20000)]
    pods += [Pod(name=f"m{i}", requests={"cpu": "1", "memory": "2Gi"})
             for i in range(2000)]
    pods += [Pod(name=f"g{i}", requests={"cpu": "2", "memory": "8Gi",
                                         "nvidia.com/gpu": 1})
             for i in range(400)]
    return pods, _pools_default(), []


def build_bench_problem():
    """``bench.build_bench_problem``: the cfg5 problem over the synthetic
    catalog. Returns ``(lattice, problem, pod_count)``."""
    from .lattice import build_lattice
    from .solver.problem import build_problem
    pods, pools, existing = config5_full_scale()
    lattice = build_lattice()
    return lattice, build_problem(pods, pools, lattice, existing=existing), len(pods)


def config7_highG_wave_split():
    """The adversarial-diversity wave (``bench.config7_highG_wave_split``):
    4,608 pods with DISTINCT scheduling signatures (unique cpu requests
    defeat signature grouping), so the group axis overflows the largest
    group bucket and the solve takes the wave-split planner."""
    from .apis import Pod
    pods = [Pod(name=f"hg{i}",
                requests={"cpu": f"{100 + i}m",
                          "memory": f"{256 + (i % 8) * 64}Mi"})
            for i in range(4608)]
    return pods, _pools_default(), []


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


def config9_sharded_16k():
    """The mesh scale row (``bench.config9_sharded_16k``): 16,500 pods in
    three waves, small, mid and category-selector, one default NodePool,
    refereed against the single-device solve of the same problem."""
    from .apis import Pod
    from .apis import wellknown as wk
    n_each = 6600
    pods = [Pod(name=f"ss{i}", requests={"cpu": "500m", "memory": "1Gi"})
            for i in range(n_each)]
    pods += [Pod(name=f"sm{i}", requests={"cpu": "2", "memory": "4Gi"})
             for i in range(n_each)]
    pods += [Pod(name=f"sl{i}", requests={"cpu": "4", "memory": "8Gi"},
                 node_selector={wk.LABEL_INSTANCE_CATEGORY: "c"})
             for i in range(n_each // 2)]
    return pods, _pools_default(), []


def config11_200k_sharded():
    """The 200k-pod mesh-production row (``bench.config11_200k_sharded``,
    seed 12): four times the north-star pod count in 32 mixed shapes,
    a fifth with an instance-category selector and a tenth on-demand
    only, one default NodePool, no accelerator pods."""
    from .apis import Pod
    from .apis import wellknown as wk
    rng = np.random.default_rng(12)
    shapes = []
    for _s in range(32):
        cpu = int(rng.choice([100, 250, 500, 1000, 2000, 4000]))
        mem = int(rng.choice([256, 512, 1024, 2048, 4096, 8192]))
        sel = {}
        r = rng.random()
        if r < 0.2:
            sel[wk.LABEL_INSTANCE_CATEGORY] = str(rng.choice(["m", "c", "r"]))
        elif r < 0.3:
            sel[wk.LABEL_CAPACITY_TYPE] = "on-demand"
        shapes.append(({"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, sel))
    counts = rng.multinomial(200_000, np.ones(len(shapes)) / len(shapes))
    pods = []
    for s, ((req, sel), n) in enumerate(zip(shapes, counts)):
        pods += [Pod(name=f"xx{s}-{i}", requests=req, node_selector=sel)
                 for i in range(n)]
    return pods, _pools_default(), []


def mesh_parity_problem():
    """``bench.run_mesh_parity``'s capped full-dissolve problem: 16
    one-vCPU pods over a lattice of m5.4xlarge alone, so every shard's
    slice under-fills its bin, the merge dissolves all of them and the
    mesh plan must equal the single-device plan byte for byte. Returns
    ``(lattice, problem)``."""
    from .apis import NodePool, Pod
    from .lattice import build_catalog, build_lattice
    from .solver.problem import build_problem
    big = build_lattice([s for s in build_catalog()
                         if s.name == "m5.4xlarge"])
    pods = [Pod(name=f"t{i}", requests={"cpu": "1", "memory": "2Gi"})
            for i in range(16)]
    return big, build_problem(pods, [NodePool(name="default")], big)


# the microloop harness's pass schedule (bench.py DELTA_PASSES,
# DELTA_CHURN_FRACTION, MICRO_NOCHURN_EVERY)
STEADY_PASSES = 12
STEADY_CHURN_FRACTION = 0.015   # ~1.5% leave + ~1.5% arrive per pass
STEADY_NOCHURN_EVERY = 4        # every 4th pass churns nothing


class SteadyStateChurn:
    """cfg10's existing nodes and churn, as ``bench.run_microloop_config``
    makes them from one generator (seed 14): first 120 existing nodes at
    20 % usage over the 4 cheapest non-accelerator types with at least 8
    vCPUs, then, per pass, ``churn``. ``bench.run_steady_state_config``
    draws the same from seed 11 with every pass churned
    (``nochurn_every=0``).

    ``pods`` and ``existing`` are the current cluster; ``churn`` changes
    them in place and returns what a cluster journal would report."""

    def __init__(self, lattice, pods, shapes, seed: int = 14,
                 nochurn_every: int = STEADY_NOCHURN_EVERY):
        from .apis.resources import RESOURCE_AXES
        from .solver.problem import ExistingBin
        self._rng = rng = np.random.default_rng(seed)
        self.nochurn_every = nochurn_every
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
        """Pass ``pass_i``: unless it is a no-churn pass (every
        ``nochurn_every``-th; none when it is 0), about 1.5 % of the pods
        leave, as many arrive (drawn from ``shapes``) and two existing
        nodes gain 0.25 of their first resource. Returns ``(touched,
        nochurn)``: ``touched`` maps each churned pod name to ``("gone",
        None)`` or ``("pending", pod)``."""
        from .apis import Pod
        every = self.nochurn_every
        nochurn = bool(every) and pass_i % every == every - 1
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


def delta_on_mesh_passes(lattice, mesh, passes: int = STEADY_PASSES,
                         device=None):
    """``bench.run_sharded_artifact``'s delta-on-mesh row: cfg10's pods,
    existing nodes and churn through ``steady_state_passes`` on a
    mesh-native Solver (``Solver(lattice, mesh=mesh)``: every pass runs
    on its mesh). Returns ``(solver, churn, pools, passes)``: the Solver,
    the churn (its ``pods`` and ``existing`` are the current cluster), the
    NodePools and the generator of ``steady_state_passes``'s tuples."""
    from .solver import Solver
    pods, pools, shapes = config10_steady_state()
    churn = SteadyStateChurn(lattice, pods, shapes)
    solver = Solver(lattice, device=device, mesh=mesh)
    return solver, churn, pools, steady_state_passes(
        solver, lattice, pools, churn, passes=passes)


# ---- the provisioning controller over a simulated cluster -------------------

# seconds from launch to node registration, as the JAX package's
# provisioner tests set it (tests/test_controlplane.py)
REGISTRATION_DELAY = 2.0


class ProvisionerStack:
    """A direct provisioning stack (the simulation stratum, without the
    Operator's other controllers):
    one ``ClusterState``, ``FakeCloud``, ``UnavailableOfferings``,
    ``CloudProvider``, ``Recorder`` and metrics ``Registry`` on one
    ``FakeClock``, the ``Provisioner`` over ``solver`` (the delta path on
    when the solver supports it) and the ``LifecycleController`` that
    registers launched claims and binds their nominated pods.

    ``timing`` holds the host milliseconds of the last pass's parts,
    measured by wrapping the stack's own objects: ``build`` (the
    incremental or full problem build, ledgers included), ``launch_loop``
    (from the first claim write to the explain record at the loop's end:
    claim writes, ``CloudProvider.create`` through the Batcher, status
    writes, nominations, events) and ``create`` (the ``CloudProvider.create``
    calls alone)."""

    def __init__(self, lattice, pools, solver, clock=None,
                 registration_delay: float = REGISTRATION_DELAY):
        from .cache.unavailable import UnavailableOfferings
        from .cloud import FakeCloud
        from .cloudprovider.cloudprovider import CloudProvider
        from .controllers.lifecycle import LifecycleController
        from .controllers.provisioning import Provisioner
        from .events import Recorder
        from .kube.writer import DirectWriter
        from .metrics import Registry
        from .state.cluster import ClusterState
        from .utils.clock import FakeClock
        self.lattice = lattice
        self.solver = solver
        self.clock = clock = clock if clock is not None else FakeClock()
        self.registration_delay = registration_delay
        self.cluster = ClusterState(clock)
        # one writer for every controller, as the Operator wires them
        self.writer = DirectWriter(self.cluster, clock)
        self.cloud = FakeCloud(clock)
        self.unavailable = UnavailableOfferings(clock)
        self.recorder = Recorder(clock)
        self.metrics = Registry()
        self.cloud_provider = CloudProvider(lattice, self.cloud,
                                            self.unavailable, self.recorder,
                                            clock)
        self.node_pools = {p.name: p for p in pools}
        self.provisioner = Provisioner(
            self.cluster, solver, self.node_pools, self.cloud_provider,
            self.unavailable, recorder=self.recorder, clock=clock,
            metrics=self.metrics, writer=self.writer)
        self.lifecycle = LifecycleController(
            self.cluster, self.cloud_provider, recorder=self.recorder,
            clock=clock, registration_delay=registration_delay,
            metrics=self.metrics, writer=self.writer)
        self.timing = {}
        self._instrument()

    def _instrument(self) -> None:
        import time
        prov, timing = self.provisioner, self.timing

        def wrap(obj, name, before=None, after=None):
            fn = getattr(obj, name)

            def wrapper(*a, **kw):
                t = time.perf_counter()
                if before is not None:
                    before(t)
                try:
                    return fn(*a, **kw)
                finally:
                    if after is not None:
                        after(t, time.perf_counter())
            setattr(obj, name, wrapper)

        def add(key):
            def after(t0, t1):
                timing[key] = timing.get(key, 0.0) + (t1 - t0) * 1e3
            return after

        def loop_start(t):
            timing.setdefault("_loop_t0", t)

        def loop_end(t):
            timing["launch_loop"] = (t - timing.pop("_loop_t0", t)) * 1e3

        wrap(prov.inc_builder, "build", after=add("build"))
        wrap(prov.writer, "create_claim", before=loop_start)
        wrap(self.cloud_provider, "create", after=add("create"))
        wrap(prov.explain, "record", before=loop_end)

    def provision(self):
        """One ``provision_once``; returns ``(result, wall ms)`` and leaves
        the pass's parts in ``timing``."""
        import time
        self.timing.clear()
        t = time.perf_counter()
        result = self.provisioner.provision_once()
        wall = (time.perf_counter() - t) * 1e3
        self.timing.setdefault("launch_loop", 0.0)
        return result, wall

    def register(self) -> float:
        """Step the clock past the registration delay and reconcile the
        lifecycle (registration binds the nominated pods); returns its
        host ms."""
        import time
        self.clock.step(self.registration_delay + 0.1)
        t = time.perf_counter()
        self.lifecycle.reconcile()
        return (time.perf_counter() - t) * 1e3


class ProvisionerChurn:
    """cfg10's churn through a cluster mirror, with ``SteadyStateChurn``'s
    seed and rates: on each pass but every 4th, about 1.5 % of the BOUND
    pods are deleted and as many new pods arrive, drawn from ``shapes``.
    Deletions pick from the bound pods in name order, so the same cluster
    takes the same churn."""

    SEED = 14   # bench.py's microloop churn seed

    def __init__(self, shapes):
        self._rng = np.random.default_rng(self.SEED)
        self.shapes = shapes
        self._serial = 0

    def churn(self, cluster, pass_i: int):
        """Mutate ``cluster`` for pass ``pass_i``; returns ``(deleted
        names, added pods, nochurn)``."""
        from .apis import Pod
        if (pass_i % STEADY_NOCHURN_EVERY) == STEADY_NOCHURN_EVERY - 1:
            return [], [], True
        rng = self._rng
        bound = sorted(p.name for p in cluster.snapshot_pods()
                       if p.node_name is not None and not p.is_daemonset)
        k = max(1, int(len(bound) * STEADY_CHURN_FRACTION))
        gone = [bound[int(i)] for i in sorted(rng.choice(len(bound), size=k,
                                                         replace=False))]
        for name in gone:
            cluster.delete_pod(name)
        added = []
        for _ in range(k):
            self._serial += 1
            req, sel = self.shapes[int(rng.integers(len(self.shapes)))]
            added.append(Pod(name=f"churn-{self._serial}", requests=req,
                             node_selector=sel))
        for p in added:
            cluster.add_pod(p)
        return gone, added, False


def referee_problem(stack: ProvisionerStack):
    """A scratch ``build_problem`` of what the stack's next pass will see:
    the pending pods, the pools, the existing bins, the daemonset and bound
    pods (the referee of the delta path, as the JAX package's delta smoke
    builds it)."""
    from .solver.problem import build_problem
    c = stack.cluster
    return build_problem(c.pending_pods(), list(stack.node_pools.values()),
                         stack.lattice, existing=c.existing_bins(stack.lattice),
                         daemonset_pods=c.daemonset_pods(),
                         bound_pods=c.bound_pods())


def plan_digest(plan, pods, exact: bool):
    """What the delta path must not change: the new nodes (pool, type, zone,
    capacity type and the multiset of their pods' shapes), the cost, and
    the binds onto existing nodes, each node's as the multiset of its pods'
    shapes (``pods`` maps names to Pod objects). A delta build appends
    arriving pods to their group where a scratch build lists them in
    mirror order, so two pods of one shape may trade places; nothing else
    may move. With ``exact`` (a full rebuild, which sees what a scratch
    build sees) the nodes are compared in plan order and every pod by
    name."""
    def shape(name):
        p = pods[name]
        return (sorted(p.requests.items()), sorted(p.node_selector.items()))
    key = str if exact else shape
    nodes = [(n.node_pool, n.instance_type, n.zone, n.capacity_type,
              sorted(key(p) for p in n.pods)) for n in plan.new_nodes]
    return (nodes if exact else sorted(nodes),
            round(float(plan.new_node_cost), 6),
            {k: sorted(key(n) for n in v)
             for k, v in plan.existing_assignments.items() if v})


class SmallChurn:
    """The small-churn schedule of the JAX package's delta smoke
    (``tools/smoke_delta.py``, ``random.Random(7)``): per pass 2-4 pods
    arrive, round-robin over three shapes, and 1-2 bound pods leave.
    This is the churn the incremental builder's envelope admits (at most
    64 journal-touched pods, no signature the previous build lacks); the
    shapes here are the first three of cfg10's."""

    SEED = 7    # tools/smoke_delta.py's random.Random(7)

    def __init__(self, shapes):
        import random
        self._rng = random.Random(self.SEED)
        self.shapes = list(shapes[:3])
        self._serial = 0

    def churn(self, cluster, pass_i: int):
        """Mutate ``cluster``; returns ``(deleted names, added pods,
        nochurn)`` like ``ProvisionerChurn.churn``."""
        from .apis import Pod
        rng = self._rng
        added = []
        for _ in range(rng.randint(2, 4)):
            self._serial += 1
            req, sel = self.shapes[self._serial % len(self.shapes)]
            added.append(Pod(name=f"small-{self._serial}", requests=req,
                             node_selector=sel))
        for p in added:
            cluster.add_pod(p)
        bound = sorted(p.name for p in cluster.snapshot_pods()
                       if p.node_name is not None and not p.is_daemonset)
        gone = rng.sample(bound, min(len(bound), rng.randint(1, 2)))
        for name in gone:
            cluster.delete_pod(name)
        return gone, added, False


# ---- consolidation: the disruption controller over a simulated cluster ------

class ConsolidationStack(ProvisionerStack):
    """The direct consolidation stack (the simulation stratum, without the
    Operator's other controllers): a ``ProvisionerStack`` plus the
    ``TerminationController`` and the ``DisruptionController``
    (expiration, drift, emptiness and consolidation, with its
    ``ConsolidationEngine`` as ``disruption.engine``), all on the stack's
    clock and writer.

    ``run_once`` runs the controllers in the JAX package's Operator order
    (``operator/operator.py`` ``run_once``): provision when the batch is
    ready (or ``force_provision``), lifecycle, disruption, termination. The
    Operator's nodeclass, pricing, tagging, interruption and garbage
    collection controllers are not run here (``operator.Operator`` runs
    them all). ``settle`` is the Operator's: passes until no pod is
    pending and every live claim has its node."""

    def __init__(self, lattice, pools, solver, clock=None,
                 registration_delay: float = REGISTRATION_DELAY,
                 drift_enabled: bool = True,
                 spot_to_spot_consolidation: bool = False,
                 termination_grace_period=None):
        super().__init__(lattice, pools, solver, clock=clock,
                         registration_delay=registration_delay)
        from .controllers.disruption import DisruptionController
        from .controllers.termination import TerminationController
        self.node_classes = self.cloud_provider.node_classes
        self.termination = TerminationController(
            self.cluster, self.cloud_provider, self.recorder, self.clock,
            metrics=self.metrics,
            termination_grace_period=termination_grace_period,
            writer=self.writer)
        self.disruption = DisruptionController(
            self.cluster, solver, self.node_pools, self.cloud_provider,
            self.provisioner, self.termination, self.unavailable,
            self.recorder, self.clock, drift_enabled=drift_enabled,
            spot_to_spot_consolidation=spot_to_spot_consolidation,
            metrics=self.metrics, writer=self.writer)

    def run_once(self, force_provision: bool = False) -> None:
        if force_provision or self.provisioner.batch_ready():
            self.provisioner.provision_once()
        self.lifecycle.reconcile()
        self.disruption.reconcile()
        self.termination.reconcile()

    def settle(self, max_rounds: int = 50, step: float = 1.0) -> int:
        """Run until no pending pods and every live claim has its node (or
        the round budget runs out); returns the rounds used."""
        for i in range(max_rounds):
            self.run_once(force_provision=bool(self.cluster.pending_pods()))
            if not self.cluster.pending_pods() and all(
                    self.cluster.node_for_claim(c.name) is not None
                    for c in self.cluster.snapshot_claims()
                    if not c.deletion_timestamp):
                return i + 1
            self.clock.step(step)
        return max_rounds


def seed_fleet(target, existing, pods) -> None:
    """Stand up ``existing`` (``ExistingBin``s, each with an empty ``used``
    row) as registered nodes holding ``pods``, dealt to them in order, as
    many per node as there are pods per bin, in ``target``: a
    ``ConsolidationStack`` or an ``operator.Operator`` (anything with their
    cluster, lattice, provisioner, writer, cloud, cloud provider, lifecycle
    controller and clock). Each bin's instance is started in ``FakeCloud``
    at the bin's own type, zone and capacity type, at the catalog's price
    there (+inf where the catalog no longer offers it: a standing node the
    market withdrew), and its NodeClaim (the provisioner's, pinned to that
    offering) takes the instance's status; its pods are nominated to it,
    and one lifecycle pass after the registration delay registers every
    node and binds its pods."""
    from .cloud.fake import LaunchOverride
    from .solver.solve import PlannedNode
    per = len(pods) // max(len(existing), 1)
    if per * len(existing) != len(pods):
        raise ValueError(f"{len(pods)} pods do not deal evenly onto "
                         f"{len(existing)} nodes")
    for p in pods:
        target.cluster.add_pod(p)
    lat = target.lattice
    prov = target.provisioner
    for i, b in enumerate(existing):
        names = [p.name for p in pods[i * per: (i + 1) * per]]
        claim = prov._make_claim(PlannedNode(
            node_pool=b.node_pool, instance_type=b.instance_type,
            zone=b.zone, capacity_type=b.capacity_type,
            price_per_hour=0.0, pods=names,
            feasible_types=(b.instance_type,), feasible_zones=(b.zone,),
            feasible_capacity_types=(b.capacity_type,)))
        target.writer.create_claim(claim)
        price = float(lat.price[lat.name_to_idx[b.instance_type],
                                lat.zones.index(b.zone),
                                lat.capacity_types.index(b.capacity_type)])
        fleet = target.cloud.create_fleet([LaunchOverride(
            instance_type=b.instance_type, zone=b.zone,
            capacity_type=b.capacity_type, price=price)])
        target.cloud_provider._instance_to_claim(fleet.instance, claim)
        target.writer.update_claim_status(claim)
        for n in names:
            target.cluster.nominate(n, claim.name)
    target.clock.step(target.lifecycle.registration_delay + 0.1)
    target.lifecycle.reconcile()


def fleet_cost(target) -> Tuple[float, int]:
    """($/hr of ``target``'s running instances the catalog prices, count of
    running instances it does not price)."""
    run = [i.price for i in target.cloud.list_instances()
           if i.state == "running"]
    priced = [p for p in run if np.isfinite(p)]
    return float(sum(priced)), len(run) - len(priced)


# the cfg4 fleet's NodePool: consolidation on, a short consolidate_after,
# the default 10 % disruption budget
CFG4_CONSOLIDATE_AFTER = 30.0


def _cfg4_pool():
    from .apis.objects import NodePool, NodePoolDisruption
    return NodePool(name="default", disruption=NodePoolDisruption(
        consolidation_policy="WhenUnderutilized",
        consolidate_after=CFG4_CONSOLIDATE_AFTER))


def config4_fleet_stack(lattice, solver):
    """cfg4 (``config4_consolidation_repack`` over ``lattice``: 500 nodes of
    the three cheapest general-purpose multi-vCPU types, half spot and half
    on-demand, in random zones, 1,500 pods of 500m/1Gi bound 3 per node)
    seeded into a ``ConsolidationStack``: one NodePool ``default`` with
    ``WhenUnderutilized``, ``consolidate_after`` of
    ``CFG4_CONSOLIDATE_AFTER`` seconds and the default budget, and
    spot-to-spot consolidation on, so the spot half meets the 15-type
    flexibility guard rather than being skipped outright."""
    pods, _pools, existing = config4_consolidation_repack(lattice)
    stack = ConsolidationStack(lattice, [_cfg4_pool()], solver,
                               spot_to_spot_consolidation=True)
    seed_fleet(stack, existing, pods)
    return stack


def config4_fleet_operator(lattice, device=None, interruption_queue=None):
    """cfg4's fleet, as ``config4_fleet_stack`` seeds it, in an
    ``operator.Operator`` (direct mode) on ``device`` (None = ``cuda``):
    the same NodePool, registration delay and spot-to-spot consolidation,
    on its own ``FakeClock`` and ``FakeCloud``, reading
    ``interruption_queue`` when one is given."""
    from .cloud import FakeCloud
    from .operator import Operator, Options
    from .utils.clock import FakeClock
    clock = FakeClock()
    op = Operator(options=Options(registration_delay=REGISTRATION_DELAY,
                                  spot_to_spot_consolidation=True),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  node_pools=[_cfg4_pool()], device=device,
                  interruption_queue=interruption_queue)
    pods, _pools, existing = config4_consolidation_repack(lattice)
    seed_fleet(op, existing, pods)
    return op


def weather_operator(lattice, scenario, device=None):
    """cfg4's fleet (``config4_fleet_operator``) in an Operator on
    ``device`` (None = ``cuda``) that reads a ``FakeQueue``, with a
    ``WeatherSimulator`` of ``scenario`` attached and started on the
    Operator's clock: it reprices through the pricing provider, holds
    pools through ``FakeCloud`` capacity and ``UnavailableOfferings``,
    sends storms to the queue, injects device errors into the Solver's
    ``FaultInjector`` and advises the consolidation engine (its
    ``weather_advisory``). Returns ``(op, sim)``; the queue is
    ``op.interruption_queue``."""
    from .interruption.queue import FakeQueue
    from .weather import WeatherSimulator
    op = config4_fleet_operator(lattice, device=device,
                                interruption_queue=FakeQueue("weather"))
    sim = WeatherSimulator(scenario, lattice, clock=op.clock,
                           pricing=op.pricing_provider, cloud=op.cloud,
                           unavailable=op.unavailable,
                           queue=op.interruption_queue, solver=op.solver,
                           metrics=op.metrics).start()
    op.disruption.engine.weather_advisory = sim.consolidation_advisory
    return op, sim


# usable addresses of a /20 subnet (4,096 less the 5 AWS reserves): a
# cluster that launches the cfg5 wave's 1,840 nodes at once has subnets of
# this size; the fake network's default /24 subnets (250 addresses, each
# launch booking one until the subnet cache refreshes) stop a wave at about
# 250 launches a zone, as the reference's subnet provider does
WAVE_SUBNET_IPS = 4091


def wave_cloud(clock):
    """A ``FakeCloud`` on ``clock`` whose subnets are /20s
    (``WAVE_SUBNET_IPS`` addresses each), for a wave of thousands of nodes
    through the Operator's subnet-aware ``CloudProvider``."""
    from .cloud import FakeCloud
    cloud = FakeCloud(clock)
    for i, sub in enumerate(sorted(cloud.network.subnets.values(),
                                   key=lambda s: s.id)):
        sub.cidr = f"10.{i}.0.0/20"
        sub.available_ips = WAVE_SUBNET_IPS
    return cloud


# the Operator's controllers in its run_once order, by the name a pass's
# wall time is split under: (attribute path, method)
OPERATOR_CONTROLLERS = (
    ("provisioning", "provisioner", "provision_once"),
    ("nodeclass", "nodeclass_controller", "reconcile"),
    ("pricing", "pricing_controller", "reconcile"),
    ("lifecycle", "lifecycle", "reconcile"),
    ("tagging", "tagging", "reconcile"),
    ("interruption", "interruption", "reconcile"),
    ("disruption", "disruption", "reconcile"),
    ("termination", "termination", "reconcile"),
    ("gc", "gc", "reconcile"),
    ("emit_gauges", None, "emit_gauges"),
)


def time_controllers(op):
    """Wrap ``op``'s controllers (``OPERATOR_CONTROLLERS``) so that each
    call adds its host milliseconds to the returned dict, by controller;
    the caller clears it between passes."""
    import time
    ms = {}
    for name, attr, method in OPERATOR_CONTROLLERS:
        obj = op if attr is None else getattr(op, attr)
        if obj is None:
            continue
        fn = getattr(obj, method)

        def timed(*a, _fn=fn, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                ms[_name] = ms.get(_name, 0.0) + (time.perf_counter() - t) * 1e3
        setattr(obj, method, timed)
    return ms
