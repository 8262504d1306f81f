"""CI smoke for the adversarial weather suite (ci.sh weather gate), for this
package (the counterpart of the repository's ``tools/smoke_weather.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_weather [--device cuda]

Runs the ``squall`` scenario (weather/scenario.py) for its scripted 60
seconds on FakeClock against a real Operator (its Solver on ``--device``)
— the deterministic twin of ``tools.soak --weather squall`` — and asserts
the four things the chaos suite exists to prove
(docs/reference/weather.md):

1. the degradation ladder ENGAGED under device weather
   (``sum(Solver.degraded_counts) > 0`` — a storm that never forced a
   rung off the primary path would be a vacuous pass),
2. the control plane RECOVERED: after the front passes, the rolling SLO
   window drains the storm-era samples and the latency burn reads
   < 1.0 again, the queue is empty, every pod is scheduled, and no
   instance leaked,
3. interruption robustness held: every storm message (all four
   EventBridge schemas plus junk) was counted and dropped —
   ``handler_errors == 0`` and queue depth 0,
4. the weather was REPLAYABLE: a second no-op derivation from the same
   (scenario, seed, ticks) produces the byte-identical event timeline.

Fast by design: small-family lattice, ~2 pods/tick churn.
"""

from __future__ import annotations

from . import gate


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..cloud import FakeCloud
    from ..interruption.queue import FakeQueue
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock
    from ..weather import WeatherSimulator, named

    failures = []
    # arm-check the lock-order witness before the run (the soak does the
    # same): the production locks are deliberately flat, so "0 cycles"
    # from an empty graph would be ambiguous between "no deadlock" and
    # "witness never armed"
    from ..introspect import contention
    with contention.lock("smoke_witness_outer"):
        with contention.lock("smoke_witness_inner"):
            pass
    clock = FakeClock()
    lattice = gate.small_lattice()
    queue = FakeQueue("weather-smoke")
    op = Operator(options=Options(registration_delay=0.5),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  interruption_queue=queue, device=device)
    scenario = named("squall")
    sim = WeatherSimulator(scenario, lattice, clock=clock,
                           pricing=op.pricing_provider, cloud=op.cloud,
                           unavailable=op.unavailable, queue=queue,
                           solver=op.solver, metrics=op.metrics).start()
    price_v0 = lattice.price_version

    # the scripted 60 s: sustained pod churn while the squall passes over
    serial = 0
    for _ in range(int(scenario.duration_seconds / scenario.tick_seconds)):
        for _ in range(2):
            serial += 1
            op.cluster.add_pod(Pod(name=f"w{serial}",
                                   requests={"cpu": "500m",
                                             "memory": "1Gi"}))
        op.run_once(force_provision=True)
        clock.step(scenario.tick_seconds)
        sim.advance()
    storm_ticks = sim.ticks

    if lattice.price_version == price_v0:
        failures.append("weather never repriced the lattice "
                        "(price_version unchanged)")
    degraded_total = sum(op.solver.degraded_counts.values())
    if degraded_total == 0:
        failures.append("degradation ladder never engaged "
                        f"(degraded_counts={op.solver.degraded_counts})")
    wstats = sim.stats()
    if wstats["messages_sent"] == 0 or wstats["junk_sent"] == 0:
        failures.append(f"storm sent no messages ({wstats})")

    # the front passes: fair weather + convergence. Step the clock well
    # past the SLO window so storm-era latency samples age out and the
    # burn reading is about the recovered steady state.
    sim.stop()
    op.solver.inject_faults(None)
    for r in range(40):
        if r % 4 == 0:
            # keep real (fast, un-faulted) passes landing in the SLO
            # window so "recovered" is a measured p50, not an empty ring
            serial += 1
            op.cluster.add_pod(Pod(name=f"w{serial}",
                                   requests={"cpu": "250m",
                                             "memory": "512Mi"}))
        op.run_once(force_provision=True)
        clock.step(10.0)
    slo = op.slo.update()
    if slo["latency_p50_ms"] <= 0.0:
        failures.append("recovery window recorded no latency samples "
                        "(vacuous recovery check)")
    if slo["latency_burn"] >= 1.0:
        failures.append(f"latency burn did not recover after the storm "
                        f"(burn={slo['latency_burn']})")
    if slo["cost_burn"] > 1.0:
        failures.append(f"cost burn {slo['cost_burn']} > 1.0 "
                        "(>2% vs FFD referee)")
    if op.cluster.pending_pods():
        failures.append(f"{len(op.cluster.pending_pods())} pods still "
                        "pending after recovery")
    if len(queue) != 0:
        failures.append(f"{len(queue)} interruption messages stranded")
    intr = op.interruption.stats()
    if intr.get("handler_errors", 0) != 0:
        failures.append(f"interruption handler errors: {intr}")
    if intr.get("received_malformed", 0) == 0:
        failures.append("junk bodies were sent but none counted malformed")
    claimed = {c.provider_id for c in op.cluster.claims.values()
               if c.provider_id}
    leaked = [x for x in op.cloud.list_instances()
              if x.provider_id not in claimed]
    if leaked:
        failures.append(f"{len(leaked)} instances leaked")

    # replay determinism: the recorded timeline must re-derive
    # byte-identically from (scenario, seed, ticks) alone
    replay = WeatherSimulator.replay(scenario, lattice, storm_ticks,
                                     seed=sim.seed)
    if replay != sim.timeline:
        failures.append("same-seed replay diverged from the recorded "
                        "timeline")

    # the lock-order witness must be armed (>= the arm-check edge) and
    # cycle-free at exit (introspect/contention.py; docs/reference/
    # linting.md) — a cycle found even on this single-threaded
    # deterministic run is a deadlock two threads can complete in
    # production
    lo_cycles = contention.lockorder_cycles()
    lo_edges = contention.lockorder_stats()["edges"]
    if lo_edges < 1:
        failures.append("lock-order witness lost even its arm-check edge "
                        "(witness disarmed mid-run?)")
    if lo_cycles:
        failures.append(f"lock-order witness found cycles: {lo_cycles} "
                        "(see /debug/pprof/lockorder)")

    gate.report("weather", device, op.solver.stats()["device"], failures)
    if failures:
        print("weather smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"weather smoke: OK (ticks={storm_ticks}, "
          f"timeline={len(sim.timeline)} events, "
          f"degraded_total={degraded_total}, "
          f"messages={wstats['messages_sent']} "
          f"(junk {wstats['junk_sent']}), "
          f"recovered latency_burn={slo['latency_burn']}, "
          f"lockorder {lo_edges:g} edges / 0 cycles, "
          f"replay identical)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
