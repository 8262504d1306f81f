"""The PyTorch port's remote solver against the JAX package's, on the CPU:
the solver sidecar, the solve window in front of it and the failover pool
of sidecars, over the port's own gRPC wire (``parallel/rpc.py``).

- The JAX package's ``tests/test_sidecar.py`` and ``tests/test_pool.py``
  (breakers on the injected clock, split deadlines, failover routing, the
  local rung only when the pool is dark, the hung and the junk sidecar,
  one connected trace across a failover, the Operator's pool gauges and
  the sidecar-outage weather), the ``TestSolveWindow`` cases of
  ``tests/test_pipeline.py``, the sidecar case of
  ``tests/test_custom_labels.py`` and the remote-span cases of
  ``tests/test_trace.py`` are replayed on both packages by
  ``test_torch_replay``: each test's own checks run on each, and what both
  made (Operators, metric registries, solver pools, chaos sidecars) is
  compared. Their ``import grpc`` names the port's ``parallel.rpc`` on the
  port side. The test whose 0.5 s solve deadline races each package's
  first solve (a JAX compile, a cold torch solve) compares kinds and
  counts only (``THREADED``); the ``kpctl`` and ``soak`` cases load the
  port's copies of those tools on the port side.
- ``tests/test_crossprocess_e2e.py`` (``slow``, as there) runs with the
  port's control plane and the port's sidecar as subprocesses on the CPU.
- Across packages: a JAX Operator whose ``solver_address`` names a port
  sidecar, and a port Operator naming a JAX sidecar, plan the cfg2 wave
  (5,000 pods, 2 MB on the wire) as each package's in-process solve does;
  the cfg3 wave (10,000 pods, 5.1 MB) is over grpcio's 4 MiB limit, fails
  on every endpoint with ``RESOURCE_EXHAUSTED`` and lands on the local
  rung (``pool-exhausted``) with the same counters and plans on both; so
  does a pass over a registered cfg2 wave, whose bound pods ship with
  their nodes' labels.
- ``chip_smoke.py``'s failover steps (kill, hang, junk, both dark, cfg3)
  decide on both packages as its ``REMOTE_FAILOVER_EXPECTED`` says.

The waves run on the m5/c5/m6g/t3 slice of the synthetic catalog (the
wire carries pods, not the lattice). Tolerance: none.
"""

import json

import pytest

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

_GRPC = [("import grpc",
          "from karpenter_provider_aws_tpu_torch.parallel import rpc as grpc")]
_TOOLS = [('kpctl = importlib.import_module("kpctl")',
           'kpctl = importlib.import_module('
           '"karpenter_provider_aws_tpu_torch.tools.kpctl")'),
          ('soak = importlib.import_module("soak")',
           'soak = importlib.import_module('
           '"karpenter_provider_aws_tpu_torch.tools.soak")')]

FILES = {
    "test_sidecar.py": ({}, [], 7),
    "test_pool.py": ({}, _GRPC + _TOOLS, 37),
}
THREADED = {
    "test_pool.py::TestHang::test_hung_sidecar_bounded_by_deadline_plus_one_failover",
}
NAMED = {
    "test_pipeline.py": [
        "test_pipeline.py::TestSolveWindow::test_concurrent_callers_coalesce_and_fan_out",
        "test_pipeline.py::TestSolveWindow::test_exception_isolated_to_its_caller",
        "test_pipeline.py::TestSolveWindow::test_sidecar_serves_through_window"],
    "test_custom_labels.py": [
        "test_custom_labels.py::TestReviewRegressions::test_sidecar_preserves_custom_label_state"],
    "test_trace.py": [
        "test_trace.py::TestSpans::test_remote_parent_from_header",
        "test_trace.py::TestChromeExport::test_export_shape_and_process_rows",
        "test_trace.py::TestIngest::test_ingest_joins_open_trace",
        "test_trace.py::TestIngest::test_ingest_dedupes_by_span_id",
        "test_trace.py::TestIngest::test_remote_degraded_span_pins_trace",
        "test_trace.py::TestIngest::test_ingest_standalone_trace_finalizes",
        "test_trace.py::TestIngest::test_imported_span_round_trips"],
}

CASES = [(f, t) for f, (nr, _, _) in FILES.items()
         for t in replay.replayed(f, nr)] + \
    [(f, t) for f, tests in NAMED.items() for t in tests]


@pytest.mark.parametrize("filename,test_id", CASES, ids=[t for _, t in CASES])
def test_remote_equal_to_jax(filename, test_id, tmp_path):
    shims = FILES[filename][1] if filename in FILES else []
    replay.replay(filename, test_id, tmp_path, shims=shims,
                  threaded=test_id in THREADED)


def test_remote_replays_cover_the_jax_tests():
    """Every test of test_sidecar.py and test_pool.py is replayed or named
    in NOT_REPLAYED; the named cases of the other files exist."""
    for filename, (not_replayed, _, count) in FILES.items():
        names = replay.jax_tests(filename)
        assert len(names) == count, filename
        assert set(replay.replayed(filename, not_replayed)) \
            | set(not_replayed) == set(names)
    assert THREADED <= {t for _, t in CASES}
    for filename, tests in NAMED.items():
        assert set(tests) <= set(replay.jax_tests(filename))


# ---- test_crossprocess_e2e.py: the port's processes on the CPU ----

XPROC = "test_crossprocess_e2e.py"
XPROC_TESTS = ["test_crossprocess_e2e.py::test_provision_interrupt_converge_over_the_wire",
               "test_crossprocess_e2e.py::test_one_connected_trace_across_both_process_boundaries",
               "test_crossprocess_e2e.py::test_kpctl_watch_and_delete_over_the_wire"]
# the port's CLI and sidecar default to the card
XPROC_SHIMS = [('"--api-port", str(port),',
                '"--device", "cpu", "--api-port", str(port),'),
               ('"--address", sock, "--synthetic-catalog", "--trace"]',
                '"--address", sock, "--synthetic-catalog", "--trace", '
                '"--device", "cpu"]')]


@pytest.mark.slow
@pytest.mark.parametrize("test_id", XPROC_TESTS)
def test_crossprocess_equal_to_jax(test_id, tmp_path):
    replay.replay(XPROC, test_id, tmp_path, shims=XPROC_SHIMS)


def test_crossprocess_replays_cover_the_jax_tests():
    import ast
    src = (replay.TESTS / XPROC).read_text()
    names = [f"{XPROC}::{n.name}" for n in ast.parse(src).body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert names == XPROC_TESTS


# ---- across packages: each package's Operator on the other's sidecar ----

def _wave(pkg, name):
    """cfg2 or cfg3's pods and pools as ``pkg``'s objects (the port's
    workloads; the JAX package's come from bench.py, which builds the
    same waves from the same seeds)."""
    if pkg == cases.TORCH_PKG:
        src = getattr(cases.mod(pkg, "workloads"), name)()
    else:
        import bench
        src = getattr(bench, name)()
    return src[0], src[1]


def _semantic(pkg, plan):
    return json.dumps(cases.mod(pkg, "apis.serde").plan_semantic_dict(plan),
                      sort_keys=True)


def _sidecar(pkg, lat, address):
    kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
    S = cases.mod(pkg, "solver")
    return cases.mod(pkg, "parallel.sidecar").ChaosSidecar(
        S.Solver(lat, **kw), address).start()


def _delegating_operator(pkg, lat, addresses):
    clock = cases.mod(pkg, "utils.clock").FakeClock()
    kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
    O = cases.mod(pkg, "operator")
    return O.Operator(options=O.Options(registration_delay=1.0,
                                        solver_address=",".join(addresses),
                                        solver_solve_deadline=120.0),
                      lattice=lat, cloud=cases.mod(pkg, "cloud").FakeCloud(clock),
                      clock=clock, **kw)


def _forced_pass(op, pods, pools):
    op.node_pools.clear()
    op.node_pools.update({p.name: p for p in pools})
    for p in pods:
        op.cluster.add_pod(p)
    return op.provisioner.provision_once()


@pytest.mark.parametrize("operator_pkg", [cases.JAX_PKG, cases.TORCH_PKG],
                         ids=["jax-operator-port-sidecar",
                              "port-operator-jax-sidecar"])
def test_operator_delegates_to_the_other_packages_sidecar(operator_pkg,
                                                          tmp_path):
    """cfg2 (5,000 pods, 3 NodePools, 2 MB on the wire) through one
    provisioning pass of ``operator_pkg``'s Operator, delegated to the
    other package's sidecar: one delegated solve, no failover, and the
    plan equal to an in-process solve of either package."""
    sidecar_pkg = cases.JAX_PKG if operator_pkg == cases.TORCH_PKG \
        else cases.TORCH_PKG
    sidecar = _sidecar(sidecar_pkg, cases.small_lattice(sidecar_pkg),
                       f"unix:{tmp_path}/side.sock")
    plans = {}
    try:
        op = _delegating_operator(operator_pkg,
                                  cases.small_lattice(operator_pkg),
                                  [sidecar.address])
        pods, pools = _wave(operator_pkg, "config2_selectors_taints")
        seen = []
        solve = op.solver.endpoints[0].client().solve

        def spy(*a, **k):
            plan = solve(*a, **k)
            seen.append(plan)
            return plan

        op.solver.endpoints[0].client().solve = spy
        result = _forced_pass(op, pods, pools)
        st = op.solver.pool_stats()
        assert (st["delegated_solves"], st["local_solves"], st["failovers"]) \
            == (1, 0, 0)
        assert not result.plan.degraded and len(seen) == 1
        plans["wire"] = _semantic(operator_pkg, seen[0])
        op.solver.close()
    finally:
        sidecar.kill()
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        pods, pools = _wave(pkg, "config2_selectors_taints")
        plans[pkg] = _semantic(pkg, cases.mod(pkg, "solver").Solver(
            cases.small_lattice(pkg), **kw).solve_relaxed(pods, pools))
    assert plans["wire"] == plans[cases.JAX_PKG] == plans[cases.TORCH_PKG]


def test_cfg3_over_the_limit_lands_on_the_local_rung_on_both(tmp_path):
    """cfg3's Solve request (10,000 pods, 5.1 MB) is over the 4 MiB
    message limit: each package's pool, over one sidecar of its own and
    one of the other package, gets RESOURCE_EXHAUSTED from both (a
    non-fatal ``sidecar-unreachable`` failure), solves locally as
    ``pool-exhausted`` and plans as the other package does."""
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        other = cases.JAX_PKG if pkg == cases.TORCH_PKG else cases.TORCH_PKG
        lat = cases.small_lattice(pkg)
        short = "j" if pkg == cases.JAX_PKG else "p"
        sidecars = [_sidecar(pkg, lat, f"unix:{tmp_path}/{short}-own.sock"),
                    _sidecar(other, cases.small_lattice(other),
                             f"unix:{tmp_path}/{short}-other.sock")]
        try:
            kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
            pool = cases.mod(pkg, "parallel.pool").SolverPool(
                lat, ",".join(s.address for s in sidecars),
                clock=cases.mod(pkg, "utils.clock").FakeClock(),
                solve_deadline=120.0, **kw)
            errors = []
            for ep in pool.endpoints:
                solve = ep.client().solve

                def spy(*a, _solve=solve, **k):
                    try:
                        return _solve(*a, **k)
                    except Exception as e:
                        errors.append(e.code().name)
                        raise

                ep.client().solve = spy
            pods, pools = _wave(pkg, "config3_affinity_spread")
            plan = pool.solve_relaxed(pods, pools)
            failover = "solver pool failover: "
            reasons = [w.rsplit(": ", 1)[1] for w in plan.warnings
                       if w.startswith(failover)]
            plan.warnings = [w for w in plan.warnings
                             if not w.startswith(failover)]
            out[pkg] = (errors, reasons, dict(pool.degraded_counts),
                        {k: v for k, v in pool.pool_stats().items()
                         if not k.endswith("_address")},
                        _semantic(pkg, plan))
            assert plan.degraded and plan.degraded_reason == "pool-exhausted"
            pool.close()
        finally:
            for s in sidecars:
                s.kill()
    errors, reasons, degraded, stats, _ = out[cases.JAX_PKG]
    assert errors == ["RESOURCE_EXHAUSTED"] * 2
    assert reasons == ["sidecar-unreachable"] * 2
    assert degraded == {"pool-exhausted": 1}
    assert (stats["local_solves"], stats["failovers"]) == (1, 2)
    assert stats["ep0_state"] == stats["ep1_state"] == 0   # not fatal
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG]


def test_failover_steps_decide_as_chip_smoke_expects(tmp_path):
    """``chip_smoke.py``'s failover steps (kill, hang, junk, both dark,
    and cfg3 over the 4 MiB limit; each a fresh pool over two sidecars
    after a warm solve) decide on each package, on the CPU, as its
    ``REMOTE_FAILOVER_EXPECTED`` says: the endpoint that solved, the
    breaker states, failovers, local solves and failover reasons. The
    plans of the two packages are equal, step by step (cfg1's wave in
    place of cfg2 here; cfg3 whole)."""
    import chip_smoke
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat = cases.small_lattice(pkg)
        short = "j" if pkg == cases.JAX_PKG else "p"
        sidecars = [_sidecar(pkg, lat, f"unix:{tmp_path}/{short}{i}.sock")
                    for i in range(2)]
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        pools = []

        def make_pool(deadline):
            pool = cases.mod(pkg, "parallel.pool").SolverPool(
                lat, ",".join(s.address for s in sidecars),
                clock=cases.mod(pkg, "utils.clock").FakeClock(),
                solve_deadline=deadline, **kw)
            pools.append(pool)
            return pool

        problems = {"cfg2": _wave(pkg, "config1_parity"),
                    "cfg3": _wave(pkg, "config3_affinity_spread")}
        rows = []
        try:
            for step, row, plan, _ in chip_smoke._failover_steps(
                    make_pool, sidecars, problems, {"hang": 2.0}, 60.0):
                assert row == chip_smoke.REMOTE_FAILOVER_EXPECTED[step], \
                    (pkg, step)
                plan.warnings = [w for w in plan.warnings
                                 if not w.startswith("solver pool failover")]
                plan.degraded, plan.degraded_reason = False, ""
                rows.append((step, row, _semantic(pkg, plan)))
        finally:
            for pool in pools:
                pool.close()
            for s in sidecars:
                s.kill()
        out[pkg] = rows
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG]


def test_pass_over_a_registered_cfg2_wave_is_over_the_limit(tmp_path):
    """A delegated pass ships every bound pod with its node's labels: once
    cfg2's wave (5,000 pods) is registered, 250 new pods make a Solve
    request over the 4 MiB limit, and the port's Operator solves that
    pass locally (``pool-exhausted``), as the limit has it for the
    reference (the pool-exhausted rung itself is held to the JAX package
    above)."""
    from karpenter_provider_aws_tpu_torch.apis import serde
    from karpenter_provider_aws_tpu_torch.parallel import rpc
    sidecar = _sidecar(cases.TORCH_PKG, cases.small_lattice(cases.TORCH_PKG),
                       f"unix:{tmp_path}/reg.sock")
    try:
        op = _delegating_operator(cases.TORCH_PKG,
                                  cases.small_lattice(cases.TORCH_PKG),
                                  [sidecar.address])
        pods, pools = _wave(cases.TORCH_PKG, "config2_selectors_taints")
        _forced_pass(op, pods, pools)
        for _ in range(5):
            op.clock.step(op.options.registration_delay + 0.1)
            op.lifecycle.reconcile()
        bound = op.cluster.bound_pods()
        assert len(bound) > 4000
        shipped = len(json.dumps([
            {"pod": serde.pod_to_dict(b.pod), "nodeName": b.node_name,
             "zone": b.zone, "capacityType": b.capacity_type,
             "nodeLabels": dict(b.node_labels)} for b in bound]).encode())
        assert shipped > rpc.MAX_MESSAGE_BYTES
        for p in pods[:250]:
            op.cluster.add_pod(serde.pod_from_dict(
                {**serde.pod_to_dict(p), "name": p.name + "-b"}))
        result = op.provisioner.provision_once()
        st = op.solver.pool_stats()
        assert (st["delegated_solves"], st["local_solves"]) == (1, 1)
        assert result.plan.degraded_reason == "pool-exhausted"
        op.solver.close()
    finally:
        sidecar.kill()
