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


# ---- the provisioning controller over a simulated cluster -------------------

# seconds from launch to node registration, as the JAX package's
# provisioner tests set it (tests/test_controlplane.py)
REGISTRATION_DELAY = 2.0


class ProvisionerStack:
    """A direct provisioning stack (the simulation stratum, no Operator):
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
    """The direct consolidation stack (the simulation stratum, no
    Operator): a ``ProvisionerStack`` plus the ``TerminationController``
    and the ``DisruptionController`` (expiration, drift, emptiness and
    consolidation, with its ``ConsolidationEngine`` as ``disruption.engine``),
    all on the stack's clock and writer.

    ``run_once`` runs the controllers in the JAX package's Operator order
    (``operator/operator.py`` ``run_once``): provision when the batch is
    ready (or ``force_provision``), lifecycle, disruption, termination. The
    Operator's nodeclass, pricing, tagging, interruption and garbage
    collection controllers are not ported and not run. ``settle`` is the
    Operator's: passes until no pod is pending and every live claim has
    its node."""

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

    def seed_fleet(self, existing, pods) -> None:
        """Stand up ``existing`` (``ExistingBin``s, each with an empty
        ``used`` row) as registered nodes holding ``pods``, dealt to them
        in order, as many per node as there are pods per bin. Each bin's
        instance is started in ``FakeCloud`` at the bin's own type, zone
        and capacity type, at the catalog's price there (+inf where the
        catalog no longer offers it: a standing node the market withdrew),
        and its NodeClaim (the provisioner's, pinned to that offering)
        takes the instance's status; its pods are nominated to it, and one
        lifecycle pass after the registration delay registers every node
        and binds its pods."""
        from .cloud.fake import LaunchOverride
        from .solver.solve import PlannedNode
        per = len(pods) // max(len(existing), 1)
        if per * len(existing) != len(pods):
            raise ValueError(f"{len(pods)} pods do not deal evenly onto "
                             f"{len(existing)} nodes")
        for p in pods:
            self.cluster.add_pod(p)
        lat = self.lattice
        prov = self.provisioner
        for i, b in enumerate(existing):
            names = [p.name for p in pods[i * per: (i + 1) * per]]
            claim = prov._make_claim(PlannedNode(
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
        self.register()

    def fleet_cost(self) -> Tuple[float, int]:
        """($/hr of the running instances the catalog prices, count of
        running instances it does not price)."""
        run = [i.price for i in self.cloud.list_instances()
               if i.state == "running"]
        priced = [p for p in run if np.isfinite(p)]
        return float(sum(priced)), len(run) - len(priced)


# the cfg4 fleet's NodePool: consolidation on, a short consolidate_after,
# the default 10 % disruption budget
CFG4_CONSOLIDATE_AFTER = 30.0


def config4_fleet_stack(lattice, solver):
    """cfg4 (``config4_consolidation_repack`` over ``lattice``: 500 nodes of
    the three cheapest general-purpose multi-vCPU types, half spot and half
    on-demand, in random zones, 1,500 pods of 500m/1Gi bound 3 per node)
    seeded into a ``ConsolidationStack``: one NodePool ``default`` with
    ``WhenUnderutilized``, ``consolidate_after`` of
    ``CFG4_CONSOLIDATE_AFTER`` seconds and the default budget, and
    spot-to-spot consolidation on, so the spot half meets the 15-type
    flexibility guard rather than being skipped outright."""
    from .apis.objects import NodePool, NodePoolDisruption
    pods, _pools, existing = config4_consolidation_repack(lattice)
    pool = NodePool(name="default", disruption=NodePoolDisruption(
        consolidation_policy="WhenUnderutilized",
        consolidate_after=CFG4_CONSOLIDATE_AFTER))
    stack = ConsolidationStack(lattice, [pool], solver,
                               spot_to_spot_consolidation=True)
    stack.seed_fleet(existing, pods)
    return stack
