"""Operator: dependency wiring + the controller run loop.

Mirror of the reference operator (reference pkg/operator/operator.go:92-186
builds the session and all providers; cmd/controller/main.go:32-72 wires
cloudprovider → core+provider controllers → manager). Here the "session"
is the pluggable cloud backend, the providers are the lattice/ICE-cache/
cloudprovider stack, and the manager is a deterministic `run_once()` /
`run(duration)` loop over the controllers — clock-driven so the whole
control plane is simulable in tests (the reference's envtest stratum).

The port of the JAX package's Operator, in both of its modes: direct
mode, where controllers write straight into the ClusterState mirror
(kube/writer.py DirectWriter), and API mode (``api_server``), where they
write through the apiserver client and informers feed the mirror.
Beyond the JAX Operator's arguments it takes ``device``, where the
Solver's tensors live: None means ``cuda`` and raises without CUDA, and
tests pass ``"cpu"``. A solver mesh (``Options.mesh``) runs its shards
on min(shards, cards) ranks, rank 0 that device (parallel/ranks.py), or
batched on that device where it is the only card. ``Options.solver_address`` delegates the
provisioning solves to a pool of solver sidecars (parallel/pool.py)
whose local rung runs on that device. ``Options.compile_cache_dir``
(``COMPILE_CACHE_DIR``) is where the kernel libraries and the native
referee are built and loaded (solver/solve.py
``enable_persistent_compile_cache``), set before the Solver is built.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..apis.objects import NodeClaimPhase, NodeClass, NodePool
from ..cache.unavailable import UnavailableOfferings
from ..cloud.fake import FakeCloud
from ..cloudprovider.cloudprovider import CloudProvider
from ..controllers.disruption import DisruptionController
from ..controllers.garbagecollection import GarbageCollectionController
from ..controllers.lifecycle import LifecycleController
from ..controllers.provisioning import Provisioner
from ..controllers.tagging import TaggingController
from ..controllers.termination import TerminationController
from ..events import Recorder
from ..interruption.controller import InterruptionController
from ..interruption.queue import FakeQueue
from ..lattice.tensors import Lattice, build_lattice
from ..controllers.nodeclass import NodeClassController
from ..device import DeviceLike, resolve_device
from ..metrics import (Registry, emit_lattice_gauges, wire_core_metrics,
                       wire_lattice_metrics)
from ..providers import (
    AMIProvider, InstanceProfileProvider, LaunchTemplateProvider,
    PricingProvider, SecurityGroupProvider, SubnetProvider, VersionProvider,
)
from ..providers.amifamily import storage_config
from ..providers.pricing import PricingController
from ..solver.solve import Solver
from ..state.cluster import ClusterState
from ..utils.clock import Clock, FakeClock
from .options import Options

# ICE cleanup cadence: expired offerings re-enter the market at this
# tick (the reference sweeps its unavailable-offerings cache on the
# same interval, cache.go:39-42). docs/concepts/performance.md cites
# this as the staleness bound of the versioned masked-view memo.
ICE_CLEANUP_INTERVAL = 10.0


class Operator:
    def __init__(self, options: Optional[Options] = None,
                 lattice: Optional[Lattice] = None,
                 cloud: Optional[FakeCloud] = None,
                 clock: Optional[Clock] = None,
                 node_pools: Optional[Sequence[NodePool]] = None,
                 node_classes: Optional[Dict[str, NodeClass]] = None,
                 interruption_queue: Optional[FakeQueue] = None,
                 api_server=None, device: DeviceLike = None):
        """``api_server`` (kube.FakeAPIServer) switches the operator into
        API mode: controllers write through the apiserver client and the
        ClusterState mirror is fed ONLY by informers (operator/sync.py) —
        the reference's wiring (cmd/controller/main.go:47-53). Without
        it, writes go straight to the mirror (deterministic simulation
        stratum). NodePools/NodeClasses passed here are seeded INTO the
        apiserver in API mode; later API writes supersede them
        (watch-driven config). ``device`` is the Solver's (None =
        ``cuda``, raising when CUDA is absent)."""
        self.options = options or Options()
        self.options.validate()
        if self.options.compile_cache_dir:
            # before the Solver's first build: a restarted operator loads
            # the kernel libraries its cache volume holds instead of
            # running nvcc and g++ again
            from ..solver.solve import enable_persistent_compile_cache
            enable_persistent_compile_cache(self.options.compile_cache_dir)
        self.device = resolve_device(device)
        self.clock = clock or Clock()
        self.node_classes: Dict[str, NodeClass] = node_classes or {
            "default": NodeClass(name="default",
                                 role=f"KarpenterNodeRole-{self.options.cluster_name}")}
        pool_list = list(node_pools) if node_pools else [NodePool(name="default")]
        self._lattice_storage = None   # unknown when a lattice is passed in
        if lattice is not None:
            self.lattice = lattice
        else:
            # the reference computes instance types per NodeClass
            # (types.go:210-240 ephemeralStorage reads instanceStorePolicy +
            # blockDeviceMappings); the lattice carries ONE storage config —
            # the default NodeClass's. Reject wiring where a NodeClass a
            # pool actually REFERENCES would resolve different
            # ephemeral-storage capacities (the solver would silently
            # mis-state storage for that pool's nodes); merely-present
            # unreferenced classes are harmless.
            default_nc = (self.node_classes.get("default")
                          or next(iter(self.node_classes.values())))
            default_storage = storage_config(default_nc)
            self.lattice = build_lattice(
                vm_memory_overhead_percent=self.options.vm_memory_overhead_percent,
                reserved_enis=self.options.reserved_enis,
                storage=default_storage)
            self._lattice_storage = default_storage
        self.cloud = cloud or FakeCloud(self.clock, cluster_name=self.options.cluster_name)
        # connectivity probe before anything else (operator.go:115-117)
        self.cloud.list_instances()
        from ..utils.logging import get_logger
        self.log = get_logger("operator")
        # startup discovery, logged once (the reference logs kube-dns and
        # endpoint discovery at operator build, operator.go:125-132); a
        # configured CLUSTER_ENDPOINT wins over discovery
        # (operator.go:224-236), and an assume-role ARN layers the cloud
        # session (operator.go:93-107)
        endpoint = (self.options.cluster_endpoint
                    or self.cloud.network.cluster_endpoint)
        self.log.info("discovered cluster network",
                      endpoint=endpoint,
                      endpoint_source=("configured"
                                       if self.options.cluster_endpoint
                                       else "discovered"),
                      kube_dns=self.cloud.network.kube_dns_ip,
                      zones=self.lattice.Z, instance_types=self.lattice.T)
        if self.options.assume_role_arn:
            self.cloud.assume_role(self.options.assume_role_arn)
            self.log.info("assuming role for cloud session",
                          role_arn=self.options.assume_role_arn)
        self.recorder = Recorder(self.clock)
        self.metrics = Registry()
        wire_core_metrics(self.metrics)
        self._lattice_gauges = wire_lattice_metrics(self.metrics)
        self._lattice_gauge_state = None
        self._pool_gauge_rev = -1
        self._pool_status_cache: Dict[str, Dict[str, str]] = {}
        self.unavailable = UnavailableOfferings(self.clock)
        self.cluster = ClusterState(self.clock)
        # SLO burn tracking against the paper's bars (introspect/slo.py):
        # the provisioner records pass latencies + sampled FFD-referee
        # cost ratios; emit_gauges drives the rolling-window decision
        from ..introspect import SloTracker
        self.slo = SloTracker(self.clock, recorder=self.recorder,
                              metrics=self.metrics)
        self.node_pools: Dict[str, NodePool] = {p.name: p for p in pool_list}
        # cross-object config validation (single-valued os, os-vs-ami-
        # family, storage-config-vs-lattice): programmatically-passed
        # config fails LOUD here; watch-delivered config runs the same
        # guard in StateSync (a violating pool is skipped + event)
        for p in self.node_pools.values():
            err = self._validate_pool_config(p, self.node_classes)
            if err:
                raise ValueError(f"NodePool/{p.name}: {err}")
        # ---- the kube seam: apiserver client + writer + state sync ------
        # (reference operator.go:92-186 manager/client/indexers; the
        # DirectWriter keeps the deterministic stratum byte-identical)
        self.api_server = api_server
        self.kube = None
        self.sync = None
        if api_server is not None:
            from ..kube import (KubeClient, install_admission,
                                install_default_indexes)
            from ..kube.apiserver import AlreadyExistsError
            from ..kube.writer import ApiWriter
            from .sync import StateSync
            install_default_indexes(api_server)
            install_admission(api_server)
            if api_server._clock is None:
                api_server._clock = self.clock
            # watch hub tuning from options (bounded subscriber queues +
            # bookmark cadence; docs/reference/watch.md). Constructor
            # wins: a caller that built FakeAPIServer(watch_queue_bound=
            # ...) already tuned it (cli.py does — its surface serves
            # before this build), so options only fill defaults.
            from ..kube.apiserver import BOOKMARK_EVERY, WATCH_QUEUE_BOUND
            if api_server.watch_queue_bound == WATCH_QUEUE_BOUND:
                api_server.watch_queue_bound = \
                    self.options.api_watch_queue_bound
            if api_server.bookmark_every == BOOKMARK_EVERY:
                api_server.bookmark_every = self.options.api_bookmark_every
            self.kube = KubeClient(api_server)
            # seed programmatically-passed config into the server (tests
            # may also have pre-created objects there — first write wins)
            for pool in self.node_pools.values():
                try:
                    self.kube.create_nodepool(pool)
                except AlreadyExistsError:
                    pass
            for nc in self.node_classes.values():
                try:
                    self.kube.create_nodeclass(nc)
                except AlreadyExistsError:
                    pass
            self.writer = ApiWriter(self.kube, self.cluster, self.clock)
            # events mirror into the apiserver so `kpctl get events` /
            # GET /apis/events see what a kubectl user would
            from ..kube.eventsink import ApiEventSink
            self.recorder.sink = ApiEventSink(api_server)
            self.sync = StateSync(
                api_server, self.cluster, self.node_pools, self.node_classes,
                synced_gauge=self.metrics.gauge(
                    "karpenter_cluster_state_synced"),
                config_guard=self._validate_pool_config,
                recorder=self.recorder,
                pods_state_gauge=self.metrics.get("karpenter_pods_state"),
                clock=self.clock)
            self.sync.sync_once()   # initial list: config + state hydrated
        else:
            from ..kube.writer import DirectWriter
            self.writer = DirectWriter(self.cluster, self.clock)
        # domain providers (reference operator.go:135-178 builds all 11)
        self.subnet_provider = SubnetProvider(self.cloud, self.clock,
            cluster_name=self.options.cluster_name)
        self.security_group_provider = SecurityGroupProvider(self.cloud, self.clock,
            cluster_name=self.options.cluster_name)
        self.instance_profile_provider = InstanceProfileProvider(self.cloud, self.clock)
        self.ami_provider = AMIProvider(
            self.cloud, self.clock,
            cluster_name=self.options.cluster_name,
            cluster_endpoint=self.options.cluster_endpoint or None)
        self.launch_template_provider = LaunchTemplateProvider(
            self.cloud, self.security_group_provider, self.instance_profile_provider,
            self.ami_provider, self.clock, cluster_name=self.options.cluster_name)
        self.version_provider = VersionProvider(self.cloud, self.clock)
        self.pricing_provider = PricingProvider(
            self.lattice, self.clock,
            isolated_vpc=self.options.isolated_vpc)
        from ..cloudprovider.decorator import decorate
        self.cloud_provider = decorate(CloudProvider(
            self.lattice, self.cloud, self.unavailable, self.recorder, self.clock,
            node_classes=self.node_classes,
            subnets=self.subnet_provider,
            launch_templates=self.launch_template_provider,
            version=self.version_provider), self.metrics)
        # the mesh decision, once, at boot (parallel/mesh.py plan_mesh):
        # auto is the single-device passthrough, --mesh/SOLVER_MESH forces
        # a shape. The Solver then
        # runs every solve (full, wave-split and the steady-state delta)
        # over this mesh, its shards on min(shards, cards) ranks, one card
        # each (batched on the Solver's device where that is one)
        from ..parallel.mesh import plan_mesh
        self.mesh_plan = plan_mesh(self.options.mesh or "auto",
                                   device=self.device)
        if self.mesh_plan.devices > 1:
            self.log.info("solver mesh planned",
                          devices=self.mesh_plan.devices,
                          ranks=self.mesh_plan.ranks,
                          axis=self.mesh_plan.axis,
                          source=self.mesh_plan.source)
        if self.options.solver_address:
            # delegate provisioning solves to the failover POOL of
            # accelerator-resident sidecar processes (parallel/pool.py;
            # docs/reference/solver-pool.md): per-endpoint circuit
            # breakers on THIS operator's injected clock, solve/health
            # deadlines split by purpose, least-outstanding failover
            # routing. probe_batch and the degradation ladder's local
            # fallback stay on this (fully functional) local Solver, on
            # this Operator's device — the fallback rides the same
            # planned mesh, and it solves only when the whole pool is
            # dark (pool-exhausted).
            from ..parallel.pool import SolverPool
            self.solver = SolverPool(
                self.lattice, self.options.solver_address,
                clock=self.clock, mesh=self.mesh_plan.mesh,
                device=self.device,
                solve_deadline=self.options.solver_solve_deadline or None,
                health_deadline=self.options.solver_health_deadline,
                latency_budget_seconds=self.slo.latency_budget_seconds)
            self.log.info("solver pool configured",
                          endpoints=len(self.solver.endpoints),
                          solve_deadline_s=self.solver.solve_deadline,
                          health_deadline_s=self.solver.health_deadline)
        else:
            self.solver = Solver(self.lattice, device=self.device,
                                 clock=self.clock, mesh=self.mesh_plan.mesh)
        self.provisioner = Provisioner(
            self.cluster, self.solver, self.node_pools, self.cloud_provider,
            self.unavailable, self.recorder, self.clock,
            batch_idle_seconds=self.options.batch_idle_duration,
            batch_max_seconds=self.options.batch_max_duration,
            metrics=self.metrics, writer=self.writer, slo=self.slo)
        self.lifecycle = LifecycleController(
            self.cluster, self.cloud_provider, self.recorder, self.clock,
            registration_delay=self.options.registration_delay,
            metrics=self.metrics, writer=self.writer)
        self.termination = TerminationController(
            self.cluster, self.cloud_provider, self.recorder, self.clock,
            metrics=self.metrics,
            termination_grace_period=self.options.termination_grace_period,
            writer=self.writer)
        # NodePool-deletion cascade source of truth: in API mode the
        # nodepools INFORMER store (an invalid-config pool is absent from
        # the guarded active dict but still exists — its nodes must
        # survive a config hiccup; the store has always completed its
        # initial list by now: sync_once() ran above), in direct mode
        # the operator's pool dict itself
        if self.sync is not None:
            pools_inf = self.sync.informers.informers["nodepools"]

            def pool_exists(name: str) -> bool:
                return name in pools_inf.store
        else:
            def pool_exists(name: str) -> bool:
                return name in self.node_pools
        self.gc = GarbageCollectionController(
            self.cluster, self.cloud_provider, self.recorder, self.clock,
            writer=self.writer, pool_exists=pool_exists)
        self.tagging = TaggingController(
            self.cluster, self.cloud, self.recorder, self.clock)
        self.disruption = DisruptionController(
            self.cluster, self.solver, self.node_pools, self.cloud_provider,
            self.provisioner, self.termination, self.unavailable, self.recorder,
            self.clock, drift_enabled=self.options.drift_enabled,
            spot_to_spot_consolidation=self.options.spot_to_spot_consolidation,
            metrics=self.metrics, writer=self.writer)
        self.nodeclass_controller = NodeClassController(
            self.node_classes, self.cluster, self.subnet_provider,
            self.security_group_provider, self.ami_provider,
            self.instance_profile_provider, self.launch_template_provider,
            self.version_provider, self.recorder, self.clock)
        self.pricing_controller = PricingController(self.pricing_provider, self.clock)
        # interruption controller runs iff a queue is configured
        # (reference controllers.go:60-62)
        self.interruption_queue = interruption_queue
        if interruption_queue is None and self.options.interruption_queue:
            self.interruption_queue = FakeQueue(self.options.interruption_queue)
        self.interruption = None
        if self.interruption_queue is not None:
            self.interruption = InterruptionController(
                self.interruption_queue, self.cluster, self.termination,
                self.unavailable, self.recorder, self.clock, self.metrics)
        self._last_cache_cleanup = 0.0
        # handoff wiring (wire_handoff): unarmed by default — a single
        # operator pays one None check per write verb and no gauges
        self.elector = None
        self.handoff_replica = None
        self.handoff_source = None
        self._fence_guard = None
        self._wire_introspection()

    def wire_handoff(self, elector, replica=None, source=None) -> None:
        """Arm the operator-handoff surfaces (docs/reference/handoff.md):
        thread the elector's fence guard through the write seam, register
        the ``handoff`` introspection provider, and hook promotion side
        effects — the orphaned-lease sweep (holders that died in the
        blackout window) and the introspection re-wire (two in-process
        operators share the replace-by-name registry; the one now in
        charge re-asserts its providers). ``replica`` is this operator's
        StandbyReplica when it runs warm behind a leader; ``source`` its
        ReplicationSource when it serves one."""
        self.elector = elector
        self.handoff_replica = replica
        self.handoff_source = source
        self._fence_guard = elector.fence_guard()
        self.writer.set_fence(self._fence_guard)
        prev_promote = elector.on_promote

        def _promoted():
            self.cluster.sweep_orphaned_leases(self.writer.delete_lease)
            self._wire_introspection()
            self._register_handoff_provider()
            if prev_promote is not None:
                prev_promote()

        elector.on_promote = _promoted
        self._register_handoff_provider()
        if source is not None:
            # the replication journal window joins the observatory: a
            # standby falling behind the journal is a forecastable break
            self.headroom.register_probe("replication_window",
                                         source.headroom_probe)

    def _register_handoff_provider(self) -> None:
        from .. import introspect
        introspect.registry().register("handoff", self.handoff_stats)

    def handoff_stats(self) -> Dict[str, object]:
        """The ``handoff`` introspection provider: leadership, fencing,
        and replication counters — the LEADER row in kpctl top and the
        karpenter_operator_handoff_* gauges read this."""
        el = self.elector
        if el is None:
            return {"wired": False}
        out: Dict[str, object] = {
            "wired": True,
            "leader": bool(el.is_leader),
            "identity": el.identity,
            "fence": el.fence,
            "transitions": el.transitions,
            "promotions_blocked": el.promotions_blocked,
            "leases_swept": self.cluster.leases_swept,
        }
        if self._fence_guard is not None:
            out["fence_checks"] = self._fence_guard.checks
            out["fenced_rejections"] = self._fence_guard.rejections
        if hasattr(el.store, "corrupt_reads"):
            out["lease_corrupt_reads"] = el.store.corrupt_reads
        if self.handoff_replica is not None:
            out.update({f"replica_{k}": v
                        for k, v in self.handoff_replica.stats().items()})
        if self.handoff_source is not None:
            out.update({f"source_{k}": v
                        for k, v in self.handoff_source.stats().items()})
        return out

    def _wire_introspection(self) -> None:
        """Register every stateful subsystem's stats() with the
        process-wide introspection registry (docs/reference/
        introspection.md) and publish this operator's sampler for the
        /debug/statusz + /debug/vars surfaces. Registration is
        replace-by-name, so rebuilding an Operator in the same process
        (every test does) swaps the providers instead of leaking them."""
        from .. import introspect, trace
        reg = introspect.registry()
        reg.register("cluster", self.cluster.stats)
        reg.register("solver", self.solver.stats)
        if hasattr(self.solver, "pool_stats"):
            # the solver-pool surface (docs/reference/solver-pool.md):
            # per-endpoint breaker states, failovers, deadlines — the
            # POOL row in kpctl top and the karpenter_solver_pool_*
            # gauges read this provider
            reg.register("solver_pool", self.solver.pool_stats)
        reg.register("provisioner", self.provisioner.stats)
        # the decision-audit ring (solver/explain.py; docs/reference/
        # explain.md): per-pass reason-code histogram + elimination
        # counters ride the sampler into soak artifacts, and the ring
        # itself serves /debug/explain on both HTTP servers
        reg.register("explain", self.provisioner.explain.stats)
        introspect.set_explain_ring(self.provisioner.explain)
        # the vmapped consolidation engine (solver/consolidate.py;
        # docs/reference/consolidation.md): batched what-if dispatches,
        # zero-leg cache hits, host fallbacks, referee verdicts, skip
        # codes, and the savings-per-hour tally — the CONSOLIDATION row
        # in kpctl top and the soak savings trajectory read this
        reg.register("consolidation", self.disruption.engine.stats)
        reg.register("ice_cache", self.unavailable.stats)
        reg.register("writer", self.writer.stats)
        reg.register("events", self.recorder.stats)
        cp = self.cloud_provider
        reg.register("cloud_batcher", lambda: {
            **{"launch_" + k: v
               for k, v in cp._launch_batcher.stats().items()},
            **{"terminate_" + k: v
               for k, v in cp._terminate_batcher.stats().items()}})
        # the domain providers' TTL caches, one combined residency view
        caches = {
            "subnet": self.subnet_provider._cache,
            "security_group": self.security_group_provider._cache,
            "instance_profile": self.instance_profile_provider._cache,
            "ami": self.ami_provider._cache,
            "launch_template": self.launch_template_provider._cache,
            "version": self.version_provider._cache,
        }
        reg.register("provider_caches", lambda: {
            f"{name}_{k}": v
            for name, c in caches.items()
            for k, v in c.stats().items() if k != "ttl_seconds"})
        if self.api_server is not None:
            reg.register("watch_hub", self.api_server.stats)
        if self.interruption is not None:
            reg.register("interruption", self.interruption.stats)
        reg.register("flight_recorder", lambda: (
            trace.recorder().introspect_stats()
            if trace.recorder() is not None else {"enabled": False}))
        reg.register("slo", self.slo.stats)
        # the attribution layer (docs/reference/profiling.md): lock/queue
        # contention accounting, the whole-process sampling profiler
        # (a disabled marker until --profile publishes one), the device
        # cost model, and burn-triggered capture retention
        from ..introspect import contention
        from ..solver import costmodel
        contention.attach_metrics(
            self.metrics.get("karpenter_lock_wait_seconds"))
        reg.register("contention", contention.stats)
        # the lock-order witness (docs/reference/linting.md): the
        # acquisition-order graph's edge/cycle counts — cycles must stay
        # 0 (a standing invariant soak + the weather smoke assert)
        reg.register("lockorder", contention.lockorder_stats)
        reg.register("profiler", introspect.profiler_stats)
        reg.register("device", costmodel.model().stats)
        # burn-triggered capture: the SLO tracker's exactly-once-per-
        # episode sustained edge (and its per-pass slow-pass trigger)
        # snapshot profile+contention+device evidence into a bounded ring
        self.burn_capture = introspect.BurnCapture(
            self.clock,
            latency_budget_seconds=self.slo.latency_budget_seconds)
        self.slo.attach_capture(self.burn_capture)
        introspect.set_burn_capture(self.burn_capture)
        reg.register("burn_captures", self.burn_capture.stats)
        # build info: the constant-1 info gauge dashboards join on. The
        # label set is the JAX package's; this package runs no jax, so
        # jax_version is empty and backend is the Solver's device type
        from .. import __version__
        self.metrics.get("karpenter_build_info").set(
            1.0, version=__version__, jax_version="",
            backend=self.solver.device.type)
        # wall-clock sampler (not the sim clock): the rings feed soak
        # artifacts and kpctl top, both wall-time consumers. Started by
        # the CLI / soak harness; sample_once() serves the deterministic
        # stratum.
        self.sampler = introspect.Sampler(reg)
        introspect.set_sampler(self.sampler)
        self._wire_headroom(reg)

    def _wire_headroom(self, reg) -> None:
        """Register every bounded structure's cheap probe with the
        saturation observatory (introspect/headroom.py; docs/reference/
        headroom.md) and publish it for /debug/headroom + kpctl. The
        registry itself is per-operator (its monotonic high-water marks
        live exactly as long as the structures they watch) and survives
        a promotion re-wire; probes are replace-by-name like the
        introspection providers."""
        from .. import introspect
        from ..introspect import profiler as _prof
        hr = getattr(self, "headroom", None)
        if hr is None:
            hr = self.headroom = introspect.HeadroomRegistry(
                self.clock,
                high_water_fraction=(
                    self.options.headroom_high_water_fraction))
        # a queue-kind resource crossing the high-water fraction fires
        # the same capture machinery the SLO burn episodes feed
        hr.attach_capture(self.burn_capture)
        hr.register_probe("journal_ring", self.cluster.headroom_probe)
        hr.register_probe("journal_coalescer",
                          self.provisioner.journal_coalescer.headroom_probe)
        hr.register_probe("decision_audit_ring",
                          self.provisioner.explain.headroom_probe)
        hr.register_probe("consolidation_probe_cache",
                          self.disruption.engine.headroom_probe)
        hr.register_probe("events_ring", self.recorder.headroom_probe)
        hr.register_probe("slo_rings", self.slo.headroom_probe)
        hr.register_probe("burn_captures", self.burn_capture.headroom_probe)
        hr.register_probe("sampler_rings", self.sampler.headroom_probe)
        cp = self.cloud_provider
        hr.register_probe("cloud_launch_batcher",
                          cp._launch_batcher.headroom_probe)
        hr.register_probe("cloud_terminate_batcher",
                          cp._terminate_batcher.headroom_probe)
        resident = getattr(self.solver, "_resident", None)
        if resident is not None:
            hr.register_probe("solver_resident_cache",
                              resident.headroom_probe)
        if hasattr(self.solver, "pool_stats"):
            hr.register_probe("pool_outstanding",
                              self.solver.headroom_probe)
        if self.api_server is not None:
            hr.register_probe("api_watch_queues",
                              self.api_server.headroom_probe)
            hr.register_probe("api_publish_queues",
                              self.api_server.headroom_probe_publish)
        if self.interruption is not None:
            hr.register_probe("interruption_queue",
                              self.interruption.headroom_probe)

        def _profiler_probe():
            # the profiler is published lazily (--profile); until then
            # the bound exists with nothing in it
            p = introspect.profiler_instance()
            if p is None:
                return {"depth": 0.0,
                        "capacity": float(_prof.MAX_UNIQUE_STACKS)}
            return p.headroom_probe()

        hr.register_probe("profiler_stacks", _profiler_probe)
        reg.register("headroom", hr.stats)
        introspect.set_headroom(hr)

    def _validate_pool_config(self, pool: NodePool,
                              node_classes: Dict[str, NodeClass]):
        """Cross-object config checks a single-object admission webhook
        cannot perform. Returns an error string, or None when valid.

        - os requirement must resolve to exactly ONE os (pool_os would
          silently pin sorted()[0] for multi-valued or contradictory
          input and mis-type the pool for the solver/label path)
        - the pool's os must match its NodeClass amiFamily's (the solver
          would otherwise schedule pods the booted AMI can never run)
        - the NodeClass's storage config must match the lattice's (one
          lattice carries ONE ephemeral-storage resolution; a differing
          class would silently mis-state storage for the pool's nodes)
        """
        from ..apis.objects import pool_os
        from ..apis import wellknown as _wk
        os_c = pool.scheduling_requirements().get(_wk.LABEL_OS)
        if os_c.include is not None and len(os_c.include) != 1:
            return (f"os requirement must resolve to exactly one OS (a "
                    f"pool's nodes boot one OS), got {sorted(os_c.include)}")
        nc = node_classes.get(pool.node_class_ref)
        if nc is None:
            return None
        family_os = "windows" if nc.ami_family == "Windows" else "linux"
        if pool_os(pool) != family_os:
            return (f"os requirement {pool_os(pool)!r} contradicts "
                    f"NodeClass/{nc.name} amiFamily {nc.ami_family!r} "
                    f"({family_os})")
        if (self._lattice_storage is not None
                and storage_config(nc) != self._lattice_storage):
            return (f"NodeClass/{nc.name} storage config (instanceStore"
                    f"Policy/blockDeviceMappings/amiFamily root device) "
                    f"differs from the lattice's; the lattice carries one "
                    f"storage config — pass a per-config lattice explicitly")
        return None

    # ---- run loop --------------------------------------------------------

    def sync_once(self) -> int:
        """Pump the informers into the mirror (API mode; no-op direct)."""
        return self.sync.sync_once() if self.sync is not None else 0

    def run_once(self, force_provision: bool = False) -> None:
        """One deterministic reconcile pass over every controller. In API
        mode the informer pump runs between controllers so each observes
        its predecessors' writes within the pass — the deterministic
        analog of the threaded runtime's continuous watch delivery."""
        self.sync_once()
        if force_provision or self.provisioner.batch_ready():
            self.provisioner.provision_once()
        self.sync_once()
        self.nodeclass_controller.reconcile()
        self.pricing_controller.reconcile()
        self.lifecycle.reconcile()
        self.sync_once()
        self.tagging.reconcile()
        if self.interruption is not None:
            self.interruption.reconcile()
            # disruption must observe interruption's claim deletions (a
            # doomed claim must neither be a candidate nor landing space)
            self.sync_once()
        self.disruption.reconcile()
        self.sync_once()
        self.termination.reconcile()
        self.sync_once()
        self.gc.reconcile()
        self.sync_once()
        self.emit_gauges()
        now = self.clock.now()
        if now - self._last_cache_cleanup >= ICE_CLEANUP_INTERVAL:
            self.unavailable.cleanup()
            self._last_cache_cleanup = now

    def emit_gauges(self) -> None:
        """Refresh the state + offering gauge surfaces (run_once calls this
        every pass; the async runtime registers it as its own controller)."""
        # synced = the mirror is internally consistent: every registered
        # claim has its node and every node's owning claim exists (the
        # core's karpenter_cluster_state_synced reports state-hydration
        # readiness; it is NOT a cloud poll — the GC controller owns
        # cloud reconciliation). Locked snapshots: the async runtime runs
        # this in its own thread against live mutation.
        claims = {c.name: c for c in self.cluster.snapshot_claims()}
        nodes = self.cluster.snapshot_nodes()
        synced = all(n.node_claim is None or n.node_claim in claims
                     for n in nodes)
        if synced:
            with_node = {n.node_claim for n in nodes if n.node_claim}
            synced = all(c.name in with_node for c in claims.values()
                         if c.phase in (NodeClaimPhase.REGISTERED,
                                        NodeClaimPhase.INITIALIZED)
                         and not c.deletion_timestamp)
        self.metrics.gauge("karpenter_cluster_state_synced").set(1.0 if synced else 0.0)
        self.metrics.gauge("karpenter_cluster_state_node_count").set(len(self.cluster.nodes))
        self.metrics.gauge("karpenter_cluster_state_pod_count").set(len(self.cluster.pods))
        self.metrics.gauge("karpenter_ice_cache_size").set(
            sum(1 for _ in self.unavailable.entries()))
        # the mesh surface (docs/reference/sharding.md): device count of
        # the production mesh + the last sharded solve's load balance,
        # straight from the solver's lock-free stats snapshot
        sst = self.solver.stats()
        self.metrics.gauge("karpenter_solver_mesh_devices").set(
            float(sst.get("mesh_devices", 1)))
        self.metrics.gauge("karpenter_solver_shard_imbalance_ratio").set(
            float(sst.get("mesh_shard_imbalance", 0.0)))
        # the solver-pool surface (parallel/pool.py; docs/reference/
        # solver-pool.md): endpoint/health/failover gauges plus one
        # breaker-state gauge per endpoint address — replace() so a
        # re-configured pool never leaves stale endpoint labels
        if hasattr(self.solver, "pool_stats"):
            pst = self.solver.pool_stats()
            self.metrics.gauge("karpenter_solver_pool_endpoints").set(
                float(pst.get("endpoints", 0)))
            self.metrics.gauge(
                "karpenter_solver_pool_healthy_endpoints").set(
                float(pst.get("healthy", 0)))
            self.metrics.gauge("karpenter_solver_pool_failovers").set(
                float(pst.get("failovers", 0)))
            self.metrics.gauge("karpenter_solver_pool_local_solves").set(
                float(pst.get("local_solves", 0)))
            self.metrics.get(
                "karpenter_solver_pool_breaker_state").replace(
                {(addr,): float({"closed": 0, "half-open": 1,
                                 "open": 2}[state])
                 for addr, state in self.solver.breaker_states().items()})
        # the handoff surface (state/replication.py + operator/
        # leaderelection.py; docs/reference/handoff.md): role, fencing
        # token, fenced-write rejections, and replication-stream progress
        # — exported only once wire_handoff() attached an elector
        if self.elector is not None:
            ho = self.handoff_stats()
            self.metrics.gauge("karpenter_operator_leader_state").set(
                1.0 if ho.get("leader") else 0.0)
            self.metrics.gauge("karpenter_operator_handoff_fence_token").set(
                float(ho.get("fence", 0)))
            self.metrics.gauge(
                "karpenter_operator_handoff_fenced_writes").set(
                float(ho.get("fenced_rejections", 0)))
            self.metrics.gauge(
                "karpenter_operator_handoff_lease_transitions").set(
                float(ho.get("transitions", 0)))
            # a replica reports what it applied; a serving leader reports
            # what it streamed out — whichever side this process is on
            self.metrics.gauge("karpenter_operator_handoff_snapshots").set(
                float(ho.get("replica_snapshots",
                             ho.get("source_snapshots", 0))))
            self.metrics.gauge("karpenter_operator_handoff_deltas").set(
                float(ho.get("replica_deltas", ho.get("source_deltas", 0))))
            self.metrics.get("karpenter_operator_handoff_rebuilds").replace(
                {("stale-anchor",): float(
                    ho.get("replica_stale_anchor_rebuilds", 0)),
                 ("snapshot-version-mismatch",): float(
                    ho.get("replica_version_mismatch_rebuilds", 0))})
        # pods by phase (the state pump and the provisioner also refresh
        # this between metrics passes) + the rolling SLO burn decision
        self.metrics.get("karpenter_pods_state").replace(
            {(k,): float(v)
             for k, v in self.cluster.pod_phase_counts().items()})
        self.slo.update()
        # the saturation observatory (introspect/headroom.py): one
        # probe sweep per gauge pass feeds the EWMA fill/drain rates,
        # the first-to-break forecast, and the high-water capture edge;
        # the karpenter_headroom_* families re-render via replace() so
        # an unregistered resource disappears instead of flatlining
        self.headroom.observe()
        hr_rows = self.headroom.table()
        for key, gname in (
                ("depth", "karpenter_headroom_depth"),
                ("capacity", "karpenter_headroom_capacity"),
                ("highwater", "karpenter_headroom_highwater"),
                ("drops", "karpenter_headroom_drops"),
                ("fill_rate", "karpenter_headroom_fill_rate")):
            self.metrics.get(gname).replace(
                {(row["resource"],): float(row[key]) for row in hr_rows})
        self.metrics.get("karpenter_headroom_seconds_to_exhaustion").replace(
            {(row["resource"],): (float(row["seconds_to_exhaustion"])
                                  if row["seconds_to_exhaustion"] is not None
                                  else -1.0)
             for row in hr_rows})
        # depth/drop readouts that predate the observatory now FOLD from
        # the same registry read — one source of truth per number
        if self.interruption is not None:
            self.metrics.get("karpenter_interruption_queue_depth").set(
                self.headroom.read("interruption_queue").get("depth", 0.0))
        # pod startup latency samples observed since the last pass
        startup = self.metrics.get("karpenter_pods_startup_time_seconds")
        for s in self.cluster.drain_startup_samples():
            startup.observe(s)
        # per-pool committed usage + limits (reference metrics.md:16-22).
        # pool_usage() depends only on the node/claim capacity set —
        # re-render on its revision, not on every per-second pass. The
        # envelope status survives user applies (spec/status split), but
        # a watch-delivered pool re-install can still lose the typed
        # pool's hydrated status, so a cheap dict-compare against the
        # last computed status also re-arms the pass — otherwise the
        # wire object could show stale usage until the next node/claim
        # change.
        # snapshot: the async runtime's statesync thread mutates
        # node_pools concurrently with this (metrics-thread) scan
        pools_now = list(self.node_pools.items())
        # deleted pools leave the cache promptly (unbounded growth under
        # pool churn; a stale entry would also fire one spurious
        # re-render if the name is ever reused)
        live = {n for n, _ in pools_now}
        for gone in [n for n in self._pool_status_cache if n not in live]:
            del self._pool_status_cache[gone]
        status_dirty = self.api_server is not None and any(
            p.status_resources != self._pool_status_cache.get(n)
            for n, p in pools_now)
        if self.cluster.capacity_rev != self._pool_gauge_rev or status_dirty:
            self._pool_gauge_rev = self.cluster.capacity_rev
            from ..apis.resources import RESOURCE_AXES, vec_to_quantities
            usage_g = self.metrics.get("karpenter_nodepool_usage")
            limit_g = self.metrics.get("karpenter_nodepool_limit")
            usage = self.cluster.pool_usage()
            for name, pool in pools_now:
                vec = usage.get(name)
                limit = pool.limits_vec()
                # usage covers the primary axes plus every LIMITED axis —
                # a usage/limit dashboard never sees an unpaired limit
                axes = {"cpu", "memory", "pods"} | (
                    {k for k in pool.limits if k in RESOURCE_AXES}
                    if limit is not None else set())
                for ax in sorted(axes):
                    ai = RESOURCE_AXES.index(ax)
                    usage_g.set(float(vec[ai]) if vec is not None else 0.0,
                                nodepool=name, resource_type=ax)
                    if limit is not None and ax in pool.limits:
                        limit_g.set(float(limit[ai]), nodepool=name,
                                    resource_type=ax)
                # status.resources (the reference NodePool status): keep
                # the typed pool current, and in API mode patch the wire
                # object's STATUS sub-map — controller-owned, outside the
                # user spec, so a user apply can neither wipe it for long
                # nor accidentally re-submit it (spec/status split)
                sr = vec_to_quantities(vec) if vec is not None else {}
                self._pool_status_cache[name] = sr
                if sr != pool.status_resources:
                    # merge-patch deletes need explicit None markers for
                    # axes that dropped to zero (RFC 7386)
                    delta = {**{k: None for k in pool.status_resources
                                if k not in sr}, **sr}
                    pool.status_resources = sr
                    if self.api_server is not None:
                        from ..kube.apiserver import NotFoundError
                        try:
                            self.api_server.patch(
                                "nodepools", name,
                                status_patch={"resources": delta})
                        except NotFoundError:
                            pass   # pool deleted mid-pass; watch will prune
        # the API stratum's write/fan-out series (karpenter_api_*):
        # straight from the watch hub's stats snapshot, so /metrics and
        # /debug/statusz tell one story about watcher load
        if self.api_server is not None:
            api = self.api_server.stats()
            for key, gname in (
                    ("watchers", "karpenter_api_watchers"),
                    ("watch_queue_depth", "karpenter_api_watch_queue_depth"),
                    ("events_emitted", "karpenter_api_watch_events_delivered"),
                    ("bookmarks", "karpenter_api_watch_bookmarks"),
                    ("bulk_ops", "karpenter_api_bulk_ops"),
                    ("fanout_envelope_copies",
                     "karpenter_api_fanout_envelope_copies")):
                self.metrics.gauge(gname).set(float(api.get(key, 0)))
            # deepest-queue + drop gauges fold from the headroom
            # registry's reading of the SAME probe — never a second
            # hand-walked number
            watch_row = self.headroom.read("api_watch_queues")
            self.metrics.gauge("karpenter_api_watch_max_queue_depth").set(
                float(watch_row.get("depth", 0.0)))
            self.metrics.gauge("karpenter_api_watch_drops").set(
                float(watch_row.get("drops", 0.0)))
        # offering gauge surface: re-emit only when pricing or the ICE set
        # actually changed (both are versioned)
        gstate = (self.lattice.price_version, self.unavailable.seq_num)
        if gstate != self._lattice_gauge_state:
            emit_lattice_gauges(self._lattice_gauges, self.lattice,
                                self.unavailable.mask(self.lattice))
            self._lattice_gauge_state = gstate

    def run(self, duration: float, step: float = 1.0) -> None:
        """Drive the control plane for `duration` simulated (FakeClock) or
        real seconds."""
        end = self.clock.now() + duration
        while self.clock.now() < end:
            self.run_once()
            if isinstance(self.clock, FakeClock):
                self.clock.step(step)
            else:
                self.clock.sleep(step)

    def settle(self, max_rounds: int = 50, step: float = 1.0) -> int:
        """Run until no pending pods and no in-flight claims (or the round
        budget runs out). Returns rounds used. FakeClock only."""
        assert isinstance(self.clock, FakeClock)
        for i in range(max_rounds):
            self.run_once(force_provision=bool(self.cluster.pending_pods()))
            if not self.cluster.pending_pods() and all(
                    self.cluster.node_for_claim(c.name) is not None
                    for c in self.cluster.snapshot_claims() if not c.deletion_timestamp):
                return i + 1
            self.clock.step(step)
        return max_rounds
