"""The PyTorch port's weather simulator against the JAX package's, on the
CPU.

Every test of the JAX package's ``tests/test_weather.py`` (the scenario
library and its JSON round trip, same-seed determinism and live-vs-replay
timelines, the spot-market and ICE fields through the pricing provider,
``FakeCloud`` capacity and ``UnavailableOfferings``, device weather
through the Solver's ``FaultInjector`` and the degradation ladder, storm
bursts through the interruption controller, the introspection surface
and the message parser) is replayed on both packages by
``test_torch_replay``: the test's own checks run on each, and the two
must make the same Operators, cloud calls, prices, queue contents, metric
series and fault injectors (tolerances in ``test_torch_replay``;
everything else exact). The tests of ``tools/kpctl.py`` and
``tools/soak.py`` run the port's copies on the port side. One more test holds the
timelines of every named scenario byte for byte.
"""

import json

import pytest

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_weather.py"
NOT_REPLAYED = {}
SHIMS = (replay.KPCTL_SHIM,
         ("        from soak import apply_fault, parse_fault_schedule\n",
          "        from karpenter_provider_aws_tpu_torch.tools.soak import "
          "apply_fault, parse_fault_schedule\n"))


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_weather_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS)


def test_weather_replays_cover_the_jax_tests():
    """Every test of test_weather.py is replayed or named in NOT_REPLAYED
    with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 29
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)


@pytest.mark.parametrize("seed", [None, 123])
def test_named_timelines_byte_identical(seed):
    """Every named scenario's timeline over 90 ticks is the same JSON, byte
    for byte, in both packages (stdlib ``random`` on both sides)."""
    docs = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        weather = cases.mod(pkg, "weather")
        lat = cases.family_lattice(pkg, ("m5", "c5", "t3"))
        docs[pkg] = {name: json.dumps(weather.WeatherSimulator.replay(
            weather.named(name), lat, 90, seed=seed), sort_keys=True)
            for name in weather.NAMED_SCENARIOS}
    assert docs[cases.TORCH_PKG] == docs[cases.JAX_PKG]
    assert all(len(d) > 2 for d in docs[cases.JAX_PKG].values())


def test_weather_operator_squall_recovers(monkeypatch):
    """``workloads.weather_operator`` on the CPU, cfg4's fleet cut to 12
    nodes on the m5/c5/r5/t3 catalog, through the squall as ``chip_smoke.py``
    drives it (60 ticks, 2 pods a tick, then 40 recovery passes with the
    injector cleared), under the ladder the Solver keeps on the card: the
    lattice repriced, the ladder engaged, its rungs and the faults the
    microloop consumed adding up to the faults fired, nothing more in
    recovery, storm messages and junk counted, the queue drained,
    consolidation held by the weather gate, nothing pending or leaked, and
    the timeline replays."""
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.apis import Pod
    from karpenter_provider_aws_tpu_torch.weather import (WeatherSimulator,
                                                          named)
    full = workloads.config4_consolidation_repack

    def cut(lattice):
        pods, pools, existing = full(lattice)
        return pods[:36], pools, existing[:12]

    monkeypatch.setattr(workloads, "config4_consolidation_repack", cut)
    L = cases.mod(cases.TORCH_PKG, "lattice")
    # a lattice of its own: the weather reprices it in place
    lat = L.build_lattice([s for s in L.build_catalog()
                           if s.family in ("m5", "c5", "r5", "t3")])
    sc = named("squall")
    op, sim = workloads.weather_operator(lat, sc, device="cpu")
    assert op.solver.device.type == "cpu" and len(op.cluster.nodes) == 12
    # the card's ladder: only injected faults and ceilings reach the host FFD
    op.solver._host_ffd_carries_all = False
    from karpenter_provider_aws_tpu_torch.errors import SolverDeviceError
    micro_faults = []
    solve_micro = op.solver._solve_micro

    def counted_micro(*a, **kw):
        try:
            return solve_micro(*a, **kw)
        except SolverDeviceError as e:
            micro_faults.append(e.injected)
            raise
    monkeypatch.setattr(op.solver, "_solve_micro", counted_micro)
    assert op.disruption.engine.weather_advisory == sim.consolidation_advisory
    v0 = lat.price_version
    serial = 0
    for _ in range(int(sc.duration_seconds / sc.tick_seconds)):
        for _ in range(2):
            serial += 1
            op.cluster.add_pod(Pod(name=f"w{serial}", requests={
                "cpu": "500m", "memory": "1Gi"}))
        op.run_once(force_provision=True)
        op.clock.step(sc.tick_seconds)
        sim.advance()
    counts = dict(op.solver.degraded_counts)
    fired = dict(op.solver.faults.fired)
    storm_micro = list(micro_faults)
    sent = sim.stats()
    sim.stop()
    op.solver.inject_faults(None)
    for r in range(40):
        if r % 4 == 0:
            serial += 1
            op.cluster.add_pod(Pod(name=f"w{serial}", requests={
                "cpu": "250m", "memory": "512Mi"}))
        op.run_once(force_provision=True)
        op.clock.step(10.0)
    assert lat.price_version > v0
    assert all(storm_micro) and micro_faults == storm_micro
    rungs = counts.get("device_retry", 0) + counts.get("host_ffd", 0)
    assert rungs > 0 and rungs + len(storm_micro) == fired["device_error"]
    assert dict(op.solver.degraded_counts) == counts
    assert sent["messages_sent"] > 0 and sent["junk_sent"] > 0
    intr = op.interruption.stats()
    assert intr["received_malformed"] > 0 and intr["handler_errors"] == 0
    assert len(op.interruption_queue) == 0
    assert op.disruption.engine.counters["weather_holds"] > 0
    assert not op.cluster.pending_pods()
    claimed = {c.provider_id for c in op.cluster.claims.values()
               if c.provider_id}
    assert all(x.provider_id in claimed for x in op.cloud.list_instances())
    assert op.slo.update()["cost_burn"] <= 1.0
    assert WeatherSimulator.replay(sc, lat, sim.ticks, seed=sim.seed) \
        == sim.timeline
