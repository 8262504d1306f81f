"""The PyTorch port's introspection layer against the JAX package's, on
the CPU.

The tests of the JAX package's ``tests/test_introspect.py`` (the
provider registry, the sampler, SLO burn and the cost referee, the
Operator's wiring, the debug routes on the metrics server and the REST
apiserver), ``tests/test_headroom.py`` (the saturation observatory's
forecaster, ranking, high water and capture, the Operator's probes and
the apiserver's watch high water) and ``tests/test_profiler.py`` (the
sampling profiler, lock contention, the device cost model, burn
captures, trace-correlated logs, the Operator's wiring, the pprof routes
and gzip on both HTTP surfaces, ``debug.Monitor``'s summary) are
replayed on both packages by ``test_torch_replay``: the test's own
checks run on each, and the two must make the same Operator state,
metric series and apiserver objects (tolerances in
``test_torch_replay``; everything else exact). The tests of
``tools/kpctl.py`` run the port's kpctl on the port side. The device cost
model's capture tests replay too: the port's ``record_compiled`` takes
the same duck-typed analyses, and its ``capture_cost_model`` fills the
model from the pack's meta-device analysis (``binpack.pack_analysis``).
"""

import pytest

import test_torch_replay as replay

FILES = {
    "test_introspect.py": {},
    "test_headroom.py": {},
    "test_profiler.py": {},
}
SHIMS = {"test_introspect.py": (replay.KPCTL_SHIM,), "test_headroom.py": (),
         "test_profiler.py": (replay.KPCTL_SHIM,)}
CASES = [(f, t) for f, nr in FILES.items() for t in replay.replayed(f, nr)]


@pytest.mark.parametrize("filename,test_id", CASES, ids=[t for _, t in CASES])
def test_introspection_equal_to_jax(filename, test_id, tmp_path):
    replay.replay(filename, test_id, tmp_path, shims=SHIMS[filename])


@pytest.mark.parametrize("filename,count", [
    ("test_introspect.py", 24), ("test_headroom.py", 25),
    ("test_profiler.py", 44)])
def test_introspection_replays_cover_the_jax_tests(filename, count):
    """Every test of the file is replayed or named in NOT_REPLAYED with
    the roadmap item that brings it."""
    names = replay.jax_tests(filename)
    assert len(names) == count
    nr = FILES[filename]
    assert set(replay.replayed(filename, nr)) | set(nr) == set(names)


def test_cost_referee_repacks_the_inputs_the_solve_saw():
    """The port's SLO cost referee re-packs the pass's own snapshots of the
    cluster (its existing bins, daemonset and bound pods), not a re-read
    after the solve. Here every bound pod is deleted just after the solve,
    as the runtime's other controllers may do while a pass runs: a re-read
    would fit the pending pods on the freed node and price the plan's new
    node as a cost burn (or drop the sample), where the solve's own inputs
    give a ratio of 1.0. The JAX package re-reads (ROADMAP C10)."""
    import test_torch_cases as cases
    from karpenter_provider_aws_tpu_torch.apis import Pod
    from karpenter_provider_aws_tpu_torch.cloud import FakeCloud
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    op = Operator(options=Options(registration_delay=1.0),
                  lattice=cases.family_lattice(cases.TORCH_PKG, ("m5", "c5")),
                  cloud=FakeCloud(clock), clock=clock, device="cpu")
    for i in range(6):
        op.cluster.add_pod(Pod(name=f"a{i}",
                               requests={"cpu": "1", "memory": "2Gi"}))
    op.settle()
    assert all(p.node_name for p in op.cluster.pods.values())
    runs = op.slo.referee_runs
    clock.step(op.slo.referee_interval + 1.0)
    for i in range(2):
        op.cluster.add_pod(Pod(name=f"b{i}",
                               requests={"cpu": "3", "memory": "4Gi"}))
    solver = op.provisioner.solver
    solves = {}
    for name in ("solve_relaxed", "solve_delta"):
        def solve(*args, _solve=getattr(solver, name), _name=name, **kw):
            plan = _solve(*args, **kw)
            solves[_name] = solves.get(_name, 0) + 1
            for pod in list(op.cluster.pods.values()):
                if pod.node_name:
                    op.cluster.delete_pod(pod.name)
            return plan
        setattr(solver, name, solve)
    op.run_once(force_provision=True)
    assert solves
    assert op.slo.referee_runs == runs + 1
    assert op.slo.cost_ratio_p50() == 1.0
