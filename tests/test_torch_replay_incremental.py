"""The JAX package's ``tests/test_incremental.py`` and
``tests/test_scale.py`` replayed on both packages, on the CPU.

The incremental problem builder (dirty journals, delta re-tensorization,
its parity with scratch builds over churn), the SLO warmup window with
``Solver.warmup``'s ``on_done``, the boot satellites, and the scale
scenarios (node- and pod-dense scale-ups, the deprovisioning matrix, ICE
chaos, the kitchen sink, each in direct and API mode, and API-mode scale
and consolidation) run through ``test_torch_replay`` with ``plans=True``:
the test's own checks run on each package, and the two must make the same
Operators, clouds, apiservers, metric series and plans (tolerances in
``test_torch_replay``; everything else exact). Tests over a parametrized
fixture (``stratum``) replay once per value. The persistent compile
cache's test asserts, on the port side, that both kernel builds point at
the directory (``CACHE_SHIM``) where the JAX test reads ``jax.config``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILES = {
    "test_incremental.py": {},
    "test_scale.py": {},
}
CASES = [(f, t, p) for f, nr in FILES.items()
         for t, p in replay.parametrized(f, replay.replayed(f, nr))]
# the compile cache's directory, read on the port from its two builds
CACHE_SHIM = (
    "        import jax\n"
    "        assert jax.config.jax_compilation_cache_dir == str(tmp_path)\n",
    "        from karpenter_provider_aws_tpu_torch.native import build\n"
    "        from karpenter_provider_aws_tpu_torch.ops import cuda_build\n"
    "        assert str(cuda_build.BUILD_DIR) == str(build.BUILD_DIR) \\\n"
    "            == str(tmp_path)\n")
_JAX_CACHE_KNOBS = ("jax_compilation_cache_dir",
                    "jax_persistent_cache_min_compile_time_secs",
                    "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(autouse=True)
def compile_cache_settings(monkeypatch):
    """The replayed compile-cache test points each package's cache at a
    test directory: both are restored after every test."""
    import jax

    from karpenter_provider_aws_tpu_torch.native import build
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_build_failed", build._build_failed)
    knobs = {k: getattr(jax.config, k) for k in _JAX_CACHE_KNOBS}
    yield
    for k, v in knobs.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("filename,test_id,params", CASES,
                         ids=[replay.case_id(t, p) for _, t, p in CASES])
def test_incremental_and_scale_equal_to_jax(filename, test_id, params,
                                            tmp_path):
    replay.replay(filename, test_id, tmp_path, plans=True, params=params,
                  shims=(CACHE_SHIM,) if filename == "test_incremental.py"
                  else ())


@pytest.mark.parametrize("filename,count", [("test_incremental.py", 24),
                                            ("test_scale.py", 7)])
def test_incremental_and_scale_replays_cover_the_jax_tests(filename, count):
    """Every test of the file is replayed or named in NOT_REPLAYED with
    its reason; the warm-start test replays."""
    names = replay.jax_tests(filename)
    assert len(names) == count
    nr = FILES[filename]
    assert set(replay.replayed(filename, nr)) | set(nr) == set(names)
    assert "test_incremental.py::TestSloWarmupWindow::" \
        "test_solver_warmup_on_done_fires" in \
        replay.replayed("test_incremental.py", FILES["test_incremental.py"])


def test_gc_fanout_calls_compare_as_a_set_within_their_run():
    """The garbage collector checks every claim's instance on a thread pool
    (``describe_instances`` from 100 workers, in both packages), so the
    order of those calls within one reconcile follows the threads: the
    node-dense scale-up replay once differed at index 2805 only in which
    of two instances the pool described first. ``cloud_calls`` sorts each
    run of consecutive fan-out calls and keeps every other call, and the
    runs' boundaries, in order."""
    gc = [("describe_instances", (f"i-{n:08x}",)) for n in (0x131, 0x130)]
    before = [("create_fleet", ("a",)), ("create_tags", ("i-1", ()))]
    after = [("list_instances", ()), ("terminate_instances", (("i-2",),))]
    a = replay.cloud_calls(before + gc + after)
    b = replay.cloud_calls(before + gc[::-1] + after)
    assert a == b
    assert [v for v, _ in a] == ["create_fleet", "create_tags",
                                 "describe_instances", "describe_instances",
                                 "list_instances", "terminate_instances"]
    # any other call still compares in order, and a fan-out call that
    # moves across another call moves the run's boundary
    assert replay.cloud_calls(before[::-1] + gc + after) != a
    assert replay.cloud_calls(before + gc[:1] + after[:1] + gc[1:]
                              + after[1:]) != a


def test_gc_reconcile_describes_every_claim_once_on_both_packages():
    """One garbage-collection reconcile over 64 launched claims on either
    package: the fan-out describes each claim's instance exactly once, so
    the sorted run is the same on both packages whatever the threads did."""
    import test_torch_cases as cases
    runs = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        clock = cases.mod(pkg, "utils.clock").FakeClock()
        fake = cases.mod(pkg, "cloud.fake")
        cloud = fake.FakeCloud(clock)
        cluster = cases.mod(pkg, "state.cluster").ClusterState(clock)
        objects = cases.mod(pkg, "apis.objects")
        lat = cases.family_lattice(pkg, ("m5",))
        cp = cases.mod(pkg, "cloudprovider").CloudProvider(
            lat, cloud, cases.mod(pkg, "cache").UnavailableOfferings(clock),
            clock=clock)
        for i in range(64):
            inst = cloud.create_fleet([fake.LaunchOverride(
                "m5.large", "us-west-2a", "on-demand", 0.096)]).instance
            cluster.add_claim(objects.NodeClaim(
                name=f"c-{i}", node_pool="default",
                provider_id=inst.provider_id))
        gc_mod = cases.mod(pkg, "controllers.garbagecollection")
        n0 = len(cloud.calls)
        gc_mod.GarbageCollectionController(cluster, cp, clock=clock) \
            .reconcile()
        runs[pkg] = replay.cloud_calls(list(cloud.calls)[n0:])
    jax_run, port_run = runs[cases.JAX_PKG], runs[cases.TORCH_PKG]
    described = [a for v, a in port_run if v == "describe_instances"]
    assert len(described) == len(set(described)) == 64
    assert port_run == jax_run
