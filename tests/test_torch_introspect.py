"""The PyTorch port's introspection layer against the JAX package's, on
the CPU.

The direct-mode tests of the JAX package's ``tests/test_introspect.py``
(the provider registry, the sampler, SLO burn and the cost referee, the
Operator's wiring), ``tests/test_headroom.py`` (the saturation
observatory's forecaster, ranking, high water and capture, and the
Operator's probes) and ``tests/test_profiler.py`` (the sampling profiler,
lock contention, the device cost model, burn captures, trace-correlated
logs, the Operator's wiring) are replayed on both packages by
``test_torch_replay``: the test's own checks run on each, and the two
must make the same Operator state and metric series (tolerances in
``test_torch_replay``; everything else exact). The tests that need the
API stratum, the CLI's HTTP server, ``tools/kpctl.py`` or an XLA
executable are named in ``NOT_REPLAYED`` with the roadmap item that
brings them.
"""

import pytest

import test_torch_replay as replay

_HTTP = "A6c (the CLI's metrics server, cli.start_server)"
_API = "A6c (the API stratum: kube.FakeAPIServer, kube.httpserver)"
_KPCTL = "A12 (tools/kpctl.py, which renders the JAX package's surfaces)"
_XLA = ("B7 (record_compiled and capture_cost_model read an XLA "
        "executable's analysis, which a torch pack does not have)")
FILES = {
    "test_introspect.py": {
        "test_introspect.py::TestHttpSurfaces::test_metrics_server_serves_statusz_and_vars": _HTTP,
        "test_introspect.py::TestHttpSurfaces::test_rest_apiserver_serves_debug_routes": _API,
        "test_introspect.py::TestHttpSurfaces::test_kpctl_top_tolerates_errored_provider": _KPCTL,
        "test_introspect.py::TestHttpSurfaces::test_debug_routes_carry_server_time": _API,
        "test_introspect.py::TestHttpSurfaces::test_kpctl_top_once_renders": _HTTP,
    },
    "test_headroom.py": {
        "test_headroom.py::TestMonotonicHighWater::test_apiserver_watch_high_water_survives_dropped_watcher": _API,
    },
    "test_profiler.py": {
        "test_profiler.py::TestDeviceCostModel::test_record_compiled_handles_both_jax_shapes": _XLA,
        "test_profiler.py::TestDeviceCostModel::test_analysis_failure_is_contained": _XLA,
        "test_profiler.py::TestDeviceCostModel::test_solver_lowering_capture_fills_model": _XLA,
        "test_profiler.py::TestOperatorWiringAndHttp::test_pprof_routes_on_metrics_server": _HTTP,
        "test_profiler.py::TestOperatorWiringAndHttp::test_pprof_routes_on_rest_apiserver": _API,
        "test_profiler.py::TestOperatorWiringAndHttp::test_gzip_negotiation_on_vars_and_metrics": _HTTP,
        "test_profiler.py::TestOperatorWiringAndHttp::test_gzip_on_rest_apiserver_vars": _API,
        "test_profiler.py::TestOperatorWiringAndHttp::test_tiny_bodies_skip_gzip": _API,
        "test_profiler.py::TestKpctlSurfaces::test_top_renders_contention_device_profiler_rows": _KPCTL,
        "test_profiler.py::TestKpctlSurfaces::test_profile_top_and_capture_live": _KPCTL,
        "test_profiler.py::TestKpctlSurfaces::test_profile_capture_reports_disabled": _KPCTL,
        "test_profiler.py::TestKpctlSurfaces::test_profile_diff": _KPCTL,
        "test_profiler.py::TestKpctlSurfaces::test_soak_summary_prints_peak_lock_wait": _KPCTL,
        "test_profiler.py::TestKpctlSurfaces::test_monitor_summary_computes_lock_peak":
            "A6c (debug.Monitor)",
    },
}
# module-level imports of unported modules: (source line, name, item)
STUBS = {
    "test_headroom.py": [
        ("from karpenter_provider_aws_tpu.kube.apiserver import FakeAPIServer",
         "FakeAPIServer", "A6c")],
}
CASES = [(f, t) for f, nr in FILES.items() for t in replay.replayed(f, nr)]


@pytest.mark.parametrize("filename,test_id", CASES, ids=[t for _, t in CASES])
def test_introspection_equal_to_jax(filename, test_id, tmp_path):
    replay.replay(filename, test_id, tmp_path, stubs=STUBS.get(filename, ()))


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
