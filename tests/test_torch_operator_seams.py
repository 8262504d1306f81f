"""The PyTorch port's Operator: its seams, the admission webhooks, a price
update through its PricingProvider, and cfg4's fleet cut down, on the CPU.

The seams are where the port's Operator differs from the JAX package's
by design: it takes the Solver's ``device`` (None = ``cuda``, raising
without CUDA), and it raises instead of running another way for a solver
pool (ROADMAP.md A11), a mesh of more than one device (A10) and the
persistent XLA compile cache; ``karpenter_build_info`` keeps the JAX
package's labels with an empty ``jax_version``. API mode builds and
hydrates its mirror from the apiserver as the JAX Operator's does. The
webhooks' verdicts (the wire entry ``validate_wire`` included) and a
repriced plan are compared with the JAX package's exactly; cfg4's fleet, cut to 30 nodes, must decide through
the Operator exactly as through ``workloads.ConsolidationStack``
(``chip_smoke.py``'s operator phase at full size on the card).
"""

import pytest

import test_torch_cases as cases


# ---- cfg4's fleet through the Operator, cut down: chip_smoke.py's phase ----

CFG4_NODES = 30


def test_config4_fleet_cut_down_operator_equal_to_stack(monkeypatch):
    """``workloads.config4_fleet_operator`` and ``config4_fleet_stack`` over
    the first 30 nodes of cfg4 (90 pods) on the m5/c5/r5/t3 catalog, both
    on the CPU, through 6 passes as ``chip_smoke.py`` runs them: the
    Operator's nodeclass, pricing, tagging and garbage-collection
    controllers and its gauges do not change a decision, so every pass
    removes the same claims and leaves the fleet at the same $/hr; the
    fleet's $/hr falls; nothing is left pending."""
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.solver import Solver

    full = workloads.config4_consolidation_repack

    def cut(lattice):
        pods, pools, existing = full(lattice)
        return pods[: 3 * CFG4_NODES], pools, existing[:CFG4_NODES]

    monkeypatch.setattr(workloads, "config4_consolidation_repack", cut)
    lat = cases.family_lattice(cases.TORCH_PKG, ("m5", "c5", "r5", "t3"))
    stack = workloads.config4_fleet_stack(lat, Solver(lat, device="cpu"))
    op = workloads.config4_fleet_operator(lat, device="cpu")
    timing = workloads.time_controllers(op)
    logs = []
    for target in (stack, op):
        assert len(target.cluster.nodes) == CFG4_NODES
        assert target.cluster.pod_phase_counts()["bound"] == 3 * CFG4_NODES
        delay = target.lifecycle.registration_delay
        log = [workloads.fleet_cost(target)]
        target.clock.step(workloads.CFG4_CONSOLIDATE_AFTER + 1.0)
        for _ in range(6):
            for _ in range(2):
                target.provisioner.batch_ready()
                target.clock.step(0.6)
            before = set(target.cluster.claims)
            timing.clear()
            target.run_once()
            target.clock.step(delay + 0.1)
            log.append((sorted(before - set(target.cluster.claims)),
                        workloads.fleet_cost(target)))
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[0][-1][1][0] < logs[0][0][0]
    assert set(timing) == {name for name, attr, _ in workloads.OPERATOR_CONTROLLERS
                           if attr != "interruption"}
    for target in (stack, op):
        if target.cluster.pending_pods():
            target.provisioner.provision_once()
        assert not target.cluster.pending_pods()


# ---- the port's seams ----

SEAM_FAMILIES = ("m5", "c5")


def _operator(pkg, lattice=None, **kw):
    """``pkg``'s Operator over the small catalog on a FakeClock and a
    FakeCloud (unless given; the port's on the CPU unless ``device`` is)."""
    m = lambda name: cases.mod(pkg, name)  # noqa: E731
    clock = kw.pop("clock", None) or m("utils.clock").FakeClock()
    cloud = kw.pop("cloud", None) or m("cloud").FakeCloud(clock)
    if pkg == cases.TORCH_PKG:
        kw.setdefault("device", "cpu")
    kw.setdefault("options", m("operator").Options(registration_delay=1.0))
    lat = lattice or cases.family_lattice(pkg, SEAM_FAMILIES)
    return m("operator").Operator(lattice=lat, cloud=cloud, clock=clock, **kw)


def test_operator_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _operator(cases.TORCH_PKG, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _operator(cases.TORCH_PKG, device="cuda")
    op = _operator(cases.TORCH_PKG)
    assert op.device.type == "cpu" and op.solver.device.type == "cpu"
    assert op.mesh_plan.devices == 1 and op.mesh_plan.mesh is None
    assert op.solver.mesh is None and op.solver._clock is op.clock


def test_api_mode_and_solver_pool_raise():
    """A ``solver_address`` builds the solver pool on both packages (the
    name is from when the port raised there): two endpoints, the derived
    solve deadline, the local rung on the Operator's device and clock,
    and equal ``pool_stats`` before any solve. API mode builds on both
    packages and its first ``sync_once`` hydrates the mirror with what
    the apiserver held, equally."""
    pools = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        op = _operator(pkg, options=cases.mod(pkg, "operator").Options(
            registration_delay=1.0, solver_address="unix:/a.sock, unix:/b.sock"))
        assert type(op.solver).__name__ == "SolverPool"
        assert op.solver._pool_clock is op.clock
        pools[pkg] = op.solver.pool_stats()
    assert op.solver.device.type == "cpu"
    assert pools[cases.TORCH_PKG] == pools[cases.JAX_PKG]
    assert pools[cases.JAX_PKG]["endpoints"] == 2
    assert pools[cases.JAX_PKG]["solve_deadline_s"] == 10.0
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        m = lambda name: cases.mod(pkg, name)  # noqa: E731
        clock = m("utils.clock").FakeClock()
        server = m("kube").FakeAPIServer(clock=clock)
        client = m("kube").KubeClient(server)
        A = m("apis")
        client.create_nodepool(A.NodePool(name="api-pool", weight=5))
        for i in range(4):
            client.create_pod(A.Pod(name=f"p{i}",
                                    requests={"cpu": "1", "memory": "1Gi"}))
        op = _operator(pkg, clock=clock, api_server=server)
        assert op.sync is not None and op.sync.has_synced
        assert op.writer.__class__.__name__ == "ApiWriter"
        assert op.sync_once() == 0   # the first list already hydrated
        out[pkg] = (sorted(op.cluster.pods), sorted(op.node_pools),
                    op.node_pools["api-pool"].weight,
                    sorted(o["metadata"]["name"]
                           for o in server.list("nodepools")[0]),
                    server.last_rv)
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG]
    assert out[cases.JAX_PKG][0] == ["p0", "p1", "p2", "p3"]


def test_mesh_plans(monkeypatch):
    """Mesh planning: auto is single-device on the CPU and on CUDA with
    one card or several (the shards would share one card); a forced N
    plans N shards on the Solver's device; the Operator plans at boot and
    its Solver runs the mesh; a mesh planned for another device type is
    refused."""
    import torch
    from karpenter_provider_aws_tpu_torch.operator import Options
    from karpenter_provider_aws_tpu_torch.parallel import plan_mesh
    from karpenter_provider_aws_tpu_torch.solver import Solver
    for spec in (None, "", "auto", "AUTO"):
        plan = plan_mesh(spec, device="cpu")
        assert (plan.devices, plan.source, plan.mesh) == (1, "single", None)
    for spec in ("off", "none", "single", "1"):
        plan = plan_mesh(spec, device="cpu")
        assert (plan.devices, plan.source, plan.mesh) == (1, "off", None)
    for spec in ("2", "8"):
        plan = plan_mesh(spec, device="cpu")
        assert (plan.devices, plan.source) == (int(spec), "forced")
        assert plan.mesh.devices.size == int(spec)
        assert plan.mesh.axis_names == ("pods",)
        assert plan.mesh.device == torch.device("cpu")
    for spec in ("bogus", "0", "-2"):
        with pytest.raises(ValueError):
            plan_mesh(spec, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert plan_mesh("auto", device="cuda").devices == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    plan = plan_mesh("auto")
    # four cards still plan the single-device path: the shards would
    # share one card (no shard per card yet), slower than one device
    assert (plan.devices, plan.source, plan.mesh) == (1, "single", None)
    assert plan_mesh("8").mesh.shards == 8
    assert plan_mesh("auto", device="cpu").devices == 1
    op = _operator(cases.TORCH_PKG, options=Options(mesh="2"))
    assert op.mesh_plan.devices == 2 and op.solver.mesh_devices == 2
    assert op.solver.mesh.device == op.solver.device
    with pytest.raises(ValueError):
        Options(mesh="bogus").validate()
    lat = cases.family_lattice(cases.TORCH_PKG, SEAM_FAMILIES)
    with pytest.raises(ValueError, match="Solver's device"):
        Solver(lat, device="cpu", mesh=plan_mesh("8", device="cuda").mesh)


def test_compile_cache_dir_parsed_and_rejected(monkeypatch, tmp_path):
    """``COMPILE_CACHE_DIR`` parses as the JAX package's does; the Operator
    points both kernel builds at it before its Solver is built, and one it
    cannot write leaves the builds where they were (no error: the process
    stays usable, as the JAX package's does)."""
    from karpenter_provider_aws_tpu_torch.native import build
    from karpenter_provider_aws_tpu_torch.operator import Options
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setenv("COMPILE_CACHE_DIR", str(tmp_path))
    assert Options.from_env().compile_cache_dir == str(tmp_path)
    monkeypatch.delenv("COMPILE_CACHE_DIR")
    assert Options.from_env().compile_cache_dir == ""
    before = (cuda_build.BUILD_DIR, build.BUILD_DIR)
    (tmp_path / "file").write_text("x")
    op = _operator(cases.TORCH_PKG, options=Options(
        compile_cache_dir=str(tmp_path / "file" / "cache")))
    assert (cuda_build.BUILD_DIR, build.BUILD_DIR) == before
    assert op.solver.device.type == "cpu"
    _operator(cases.TORCH_PKG, options=Options(
        compile_cache_dir=str(tmp_path / "cache")))
    assert cuda_build.BUILD_DIR == build.BUILD_DIR == tmp_path / "cache"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cache", "file"]


def test_build_info_labels():
    from karpenter_provider_aws_tpu_torch import __version__
    op = _operator(cases.TORCH_PKG)
    want = (f'karpenter_build_info{{version="{__version__}",jax_version="",'
            f'backend="cpu"}} 1.0')
    text = op.metrics.render()
    assert want in text.splitlines()
    assert op.metrics.get("karpenter_build_info").labelnames == (
        "version", "jax_version", "backend")
    lint = cases.mod(cases.TORCH_PKG, "metrics").lint_exposition
    assert lint(text) == []


def _reprice_run(pkg, capacity_type, reprice):
    """On a NodePool of one capacity type, provision 6 pods, reprice
    through the Operator's own PricingProvider (``reprice(op)``), then
    provision 6 more: the second wave's claims, every instance's price and
    the lattice's price version."""
    m = lambda name: cases.mod(pkg, name)  # noqa: E731
    L, A, wk = m("lattice"), m("apis"), m("apis.wellknown")
    lat = L.build_lattice([s for s in L.build_catalog()
                           if s.family in SEAM_FAMILIES])
    pool = A.NodePool(name="default", requirements=[A.Requirement(
        wk.LABEL_CAPACITY_TYPE, A.Operator.IN, (capacity_type,))])
    op = _operator(pkg, lattice=lat, node_pools=[pool])
    Pod = m("apis").Pod
    for i in range(6):
        op.cluster.add_pod(Pod(name=f"a{i}", requests={"cpu": "1", "memory": "2Gi"}))
    op.settle(max_rounds=20)
    first = {c.name for c in op.cluster.snapshot_claims()}
    version = lat.price_version
    reprice(op)
    assert lat.price_version > version
    for i in range(6):
        op.cluster.add_pod(Pod(name=f"b{i}", requests={"cpu": "1", "memory": "2Gi"}))
    op.settle(max_rounds=20)
    second = sorted((c.instance_type, c.zone, c.capacity_type)
                    for c in op.cluster.snapshot_claims() if c.name not in first)
    prices = sorted(i.price for i in op.cloud.instances.values())
    return second, prices, lat.price_version


def _cheapest_used(op):
    (claim,) = op.cluster.snapshot_claims()
    return claim


@pytest.mark.parametrize("kind", ["on-demand", "spot"])
def test_price_update_changes_next_plan_as_in_jax(kind):
    """A price update through the port's PricingProvider bumps the
    lattice's price version; the port's Solver re-reads the price (kept on
    its device by version) and the next plan changes exactly as the JAX
    Operator's does."""
    def reprice(op):
        claim = _cheapest_used(op)
        if kind == "on-demand":
            op.pricing_provider.update_on_demand_pricing(
                {claim.instance_type: 1000.0})
        else:
            op.pricing_provider.update_spot_pricing(
                {(claim.instance_type, z): 1000.0
                 for z in op.lattice.zones})

    def unchanged(op):
        op.lattice.price_version += 1

    runs = {pkg: _reprice_run(pkg, kind, reprice)
            for pkg in (cases.JAX_PKG, cases.TORCH_PKG)}
    assert runs[cases.TORCH_PKG] == runs[cases.JAX_PKG]
    baseline = _reprice_run(cases.TORCH_PKG, kind, unchanged)[0]
    assert runs[cases.TORCH_PKG][0] != baseline, "the reprice moved nothing"


# ---- the admission webhooks ----

def _admission_objects(pkg):
    """NodePools, NodeClasses and PDBs, valid and invalid, built from
    ``pkg``'s classes (the cases of the JAX package's webhook tests and
    their neighbours)."""
    A, O = cases.mod(pkg, "apis"), cases.mod(pkg, "apis.objects")
    wk = cases.mod(pkg, "apis.wellknown")
    req = lambda k, *v, op=A.Operator.IN: A.Requirement(k, op, tuple(v))  # noqa: E731
    pools = [
        A.NodePool(name="ok"),
        A.NodePool(name=""),
        A.NodePool(name="host", requirements=[req(wk.LABEL_HOSTNAME, "a")]),
        A.NodePool(name="os2", requirements=[req(wk.LABEL_OS, "linux", "windows")]),
        A.NodePool(name="osnot", requirements=[req(wk.LABEL_OS, "linux",
                                                   op=A.Operator.NOT_IN)]),
        A.NodePool(name="lim", limits={"cpu": "10", "gpus": "1"}),
        A.NodePool(name="badq", limits={"cpu": "ten"}),
        A.NodePool(name="w", weight=101),
        A.NodePool(name="empty", disruption=O.NodePoolDisruption(
            consolidation_policy="WhenEmpty", consolidate_after=None)),
        A.NodePool(name="policy", disruption=O.NodePoolDisruption(
            consolidation_policy="Sometimes")),
    ]
    for nodes, schedule, duration in (("1", "0 0 * * *", None),
                                      ("1", "bad cron here", 60.0),
                                      ("0", "0 0 * * *", 0.0),
                                      ("-1", None, None), ("x%", None, None),
                                      ("10%", "@daily", 3600.0)):
        pools.append(A.NodePool(name=f"b{nodes}", disruption=O.NodePoolDisruption(
            budgets=[O.DisruptionBudget(nodes=nodes, schedule=schedule,
                                        duration=duration)])))
    classes = [
        O.NodeClass(name="ok", role="r"),
        O.NodeClass(name="", role="r", instance_profile="p"),
        O.NodeClass(name="none"),
        O.NodeClass(name="fam", role="r", ami_family="Plan9"),
        O.NodeClass(name="custom", role="r", ami_family="Custom"),
        O.NodeClass(name="term", role="r",
                    subnet_selector_terms=[O.NodeClassSelectorTerm()]),
        O.NodeClass(name="meta", role="r", metadata_options=O.MetadataOptions(
            http_tokens="maybe", http_endpoint="on")),
        O.NodeClass(name="store", role="r", instance_store_policy="RAID5",
                    block_device_mappings=[
                        {"device_name": "/dev/a", "root_volume": True,
                         "volume_size_mib": -1},
                        {"device_name": "/dev/b", "root_volume": True,
                         "volume_size_mib": True},
                        {"root_volume": False}]),
    ]
    pdbs = [O.PodDisruptionBudget(name="ok", max_unavailable=1),
            O.PodDisruptionBudget(name="both", max_unavailable=1, min_available=1),
            O.PodDisruptionBudget(name="", min_available=-1),
            O.PodDisruptionBudget(name="neither")]
    return pools, classes, pdbs


def _verdicts(pkg):
    W = cases.mod(pkg, "webhooks")
    pools, classes, pdbs = _admission_objects(pkg)

    def admit(fn, obj):
        try:
            fn(obj)
            return "admitted"
        except W.AdmissionError as e:
            return str(e)

    out = []
    for p in pools:
        out.append(("pool", p.name, W.validate_node_pool(p)))
        d = W.default_node_pool(p)
        out.append(("default", p.name, sorted((r.key, r.operator.value, r.values)
                                              for r in d.requirements)))
    for nc in classes:
        out.append(("class", nc.name, W.validate_node_class(nc),
                    admit(W.admit_node_class, nc)))
    for pdb in pdbs:
        out.append(("pdb", pdb.name, W.validate_pdb(pdb), admit(W.admit_pdb, pdb)))
    pools, _, _ = _admission_objects(pkg)
    out += [("admit", p.name, admit(W.admit_node_pool, p)) for p in pools]
    return out


def test_webhook_verdicts_equal_to_jax():
    """Every validation, defaulting and admission verdict of the port's
    webhooks equals the JAX package's, error strings included."""
    j, t = _verdicts(cases.JAX_PKG), _verdicts(cases.TORCH_PKG)
    assert t == j
    assert sum(1 for v in j if v[0] in ("pool", "class", "pdb") and v[2]) >= 15


def test_validate_wire_raises_instead_of_answering():
    """``validate_wire`` (schema, then the semantic webhook, over wire
    dicts) answers as the JAX package's does on every admission object's
    wire dict, on unknown kinds and on malformed specs, error strings
    included. (The name is the one it had while the port raised here.)"""
    verdicts = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        W, serde = cases.mod(pkg, "webhooks"), cases.mod(pkg, "apis.serde")
        pools, classes, pdbs = _admission_objects(pkg)
        specs = ([("nodepools", serde.nodepool_to_dict(p)) for p in pools]
                 + [("nodeclasses", serde.nodeclass_to_dict(c))
                    for c in classes]
                 + [("ec2nodeclasses", serde.nodeclass_to_dict(c))
                    for c in classes]
                 + [("pdbs", serde.pdb_to_dict(b)) for b in pdbs]
                 + [("nodepools", {"name": "x", "weight": "heavy"}),
                    ("nodepools", {"name": "x", "requirements": [
                        {"key": "k", "operator": "In", "values": []}]}),
                    ("nodeclaims", {"name": "c"}),
                    ("nodeclaims", {"name": "c", "nodePool": "p",
                                    "phase": "Lost"}),
                    ("pods", {}), ("nodeclasses", {"name": "x"})])
        verdicts[pkg] = [(kind, W.validate_wire(kind, spec))
                         for kind, spec in specs]
    j = verdicts[cases.JAX_PKG]
    assert verdicts[cases.TORCH_PKG] == j
    assert sum(1 for _, v in j if v) >= 20 and any(not v for _, v in j)


def _subnet_wave(pkg, ips):
    """40 pods, one per node (hostname anti-affinity), through ``pkg``'s
    Operator on a FakeCloud whose
    subnets hold ``ips`` addresses (None: ``workloads.wave_cloud``'s /20s,
    port only): the wave's claims, launches, launch failures and the
    subnets its instances took."""
    m = lambda name: cases.mod(pkg, name)  # noqa: E731
    clock = m("utils.clock").FakeClock()
    if ips is None:
        from karpenter_provider_aws_tpu_torch import workloads
        cloud = workloads.wave_cloud(clock)
    else:
        cloud = m("cloud").FakeCloud(clock)
        for sub in cloud.network.subnets.values():
            sub.available_ips = ips
    op = _operator(pkg, clock=clock, cloud=cloud)
    results = []
    orig = op.provisioner.provision_once

    def provision_once(*a, **kw):
        results.append(orig(*a, **kw))
        return results[-1]
    op.provisioner.provision_once = provision_once
    Pod, O, wk = m("apis").Pod, m("apis.objects"), m("apis.wellknown")
    spread = [O.PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME,
                                label_selector=(("app", "w"),), anti=True)]
    for i in range(40):
        op.cluster.add_pod(Pod(name=f"w{i}", labels={"app": "w"},
                               requests={"cpu": "1", "memory": "1Gi"},
                               pod_affinity=spread))
    op.run_once(force_provision=True)
    (r,) = results
    return (len(r.created_claims), r.launched, r.launch_failures,
            sorted((i.subnet_id, i.zone) for i in op.cloud.instances.values()))


def test_small_subnets_fail_a_wave_as_in_jax():
    """Each launch books one address of its zone's subnet until the subnet
    cache refreshes, so a wave larger than the subnets fails launches, in
    the port as in the JAX package; /20 subnets (``workloads.wave_cloud``,
    what ``chip_smoke.py`` gives the cfg5 wave) launch it whole."""
    j, t = _subnet_wave(cases.JAX_PKG, 3), _subnet_wave(cases.TORCH_PKG, 3)
    assert t == j
    assert j[2] > 0
    claims, launched, failures, _ = _subnet_wave(cases.TORCH_PKG, None)
    assert failures == 0 and launched == claims > j[1]
