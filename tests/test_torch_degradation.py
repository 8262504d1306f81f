"""The PyTorch port's degradation ladder against the JAX package's, on
the CPU.

Every test of the JAX package's ``tests/test_degradation.py`` that needs
no unported module (the error taxonomy; the wave split, with its ≤2 %
FFD cost envelope up to the 5,120-signature batch in 20 waves; the
host-FFD rung after bin-table exhaustion, a persistent device error or a
host-side bug; the one retry of a transient device error; the worst rung
reported by ``solve_relaxed``; the ladder through the Operator's
provisioner, its metric series and events; the degradation metric
families) is replayed on both packages by ``test_torch_replay``: the
test's own checks run on each, and the two must make the same Operators
(their Solvers' ``degraded_counts`` included), fault injectors, cloud
calls and metric series (tolerances in ``test_torch_replay``; everything
else exact), and so does the event sink's retention of external events
in the apiserver. The tests of ``tools/kpctl.py`` and ``tools/soak.py``
run the port's copies on the port side.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_degradation.py"
NOT_REPLAYED = {}
SHIMS = (replay.KPCTL_SHIM, replay.SOAK_SHIM)


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_degradation_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS)


def test_degradation_replays_cover_the_jax_tests():
    """Every test of test_degradation.py is replayed or named in
    NOT_REPLAYED with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 22
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)


def test_bin_ceiling_below_existing_bins_lands_on_host_ffd():
    """More existing bins than the bin-table ceiling (an injected
    ``b_limit`` of 32 under 40 nodes; without an injector, a cluster of
    more than 8,191 nodes): the existing-bin buffer cannot be built, and
    both packages carry the solve on the host FFD with equal plans. The
    reason differs by design (ROADMAP Queue C): the JAX package wraps any
    error of its dispatch block as a retryable device error, while the
    port checks the bins against the ceiling before it builds anything
    and reports the structural ceiling, ``b-exhausted``, without a
    retry (a rung the card keeps: a device error would raise there)."""
    import numpy as np
    import test_torch_cases as cases
    from karpenter_provider_aws_tpu.apis import serde
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat, pods, pools, _ = cases.build(pkg, "anti_wide")
        P = cases.mod(pkg, "solver.problem")
        R = cases.mod(pkg, "apis.resources").R
        existing = [P.ExistingBin(
            name=f"x{i}", node_pool="default", instance_type="m5.xlarge",
            zone=lat.zones[i % lat.Z], capacity_type="on-demand",
            used=np.zeros((R,), np.float32)) for i in range(40)]
        problem = P.build_problem(pods[:10], pools, lat, existing=existing)
        S = cases.mod(pkg, "solver")
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        s = S.Solver(lat, **kw)
        s.inject_faults(S.FaultInjector(b_limit=32))
        out[pkg] = (s.solve(problem), dict(s.degraded_counts))
    (jplan, jcounts), (tplan, tcounts) = out[cases.JAX_PKG], out[cases.TORCH_PKG]
    assert jplan.solver_path == tplan.solver_path == "host-ffd"
    assert (jplan.degraded_reason, jplan.device_retries, jcounts) == \
        ("device-error", 1, {"device_retry": 1, "host_ffd": 1})
    assert (tplan.degraded_reason, tplan.device_retries, tcounts) == \
        ("b-exhausted", 0, {"host_ffd": 1})
    jd, td = serde.plan_semantic_dict(jplan), serde.plan_semantic_dict(tplan)
    for d in (jd, td):
        del d["warnings"], d["degradedReason"]
    assert td == jd and not tplan.unschedulable
