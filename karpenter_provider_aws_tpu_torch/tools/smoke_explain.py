"""CI smoke for the decision-explainability surface (ci.sh explain gate),
for this package (the counterpart of the repository's
``tools/smoke_explain.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_explain [--device cuda]

Boots a real Operator (its Solver on ``--device``) under a short
``squall`` weather scenario, ICEs a whole instance family out of the
market, and drives passes with one pod that can ONLY land on that family —
then asserts the explain stack tells the truth about it
(docs/reference/explain.md):

1. ``/debug/explain?pod=...`` over LIVE HTTP attributes the pending pod
   to the **ice** elimination stage (code ``ice-hold``), with the
   eliminated offerings named,
2. ``kpctl explain pod`` (this package's ``tools/kpctl.py``) renders the
   elimination waterfall against the same live server (exit 0, the ice
   row present),
3. the FailedScheduling dedup holds: many passes over the same stuck
   pod publish ONE event for the (pod, reason-code) pair,
4. the ``explain`` introspection provider reports through /debug/vars —
   the same per-pass reason-code histogram soak artifacts embed — with
   ``reason_ice_hold`` > 0 and the elimination counters moving.

Fast by design: small-family lattice, ~10 weather ticks, a handful of
passes on FakeClock.
"""

from __future__ import annotations

import contextlib
import io
import json
import urllib.request

from . import gate


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from ..apis import Pod
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..interruption.queue import FakeQueue
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock
    from ..weather import WeatherSimulator, named
    from . import kpctl

    failures = []
    clock = FakeClock()
    lattice = gate.small_lattice()
    queue = FakeQueue("explain-smoke")
    op = Operator(options=Options(registration_delay=0.5),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  interruption_queue=queue, device=device)
    scenario = named("squall")
    sim = WeatherSimulator(scenario, lattice, clock=clock,
                           pricing=op.pricing_provider, cloud=op.cloud,
                           unavailable=op.unavailable, queue=queue,
                           solver=op.solver, metrics=op.metrics).start()

    # the deliberately ICE'd-out pod: its node selector admits ONLY the
    # c5 family, and every c5 offering is held out of the market
    for z in lattice.zones:
        for ct in lattice.capacity_types:
            for t in [n for n in lattice.names if n.startswith("c5.")]:
                op.unavailable.mark_unavailable("smoke-ice", ct, t, z)
    op.cluster.add_pod(Pod(
        name="iced-pod", requests={"cpu": "500m"},
        node_selector={"karpenter.k8s.aws/instance-family": "c5"}))

    serial = 0
    for _ in range(10):
        serial += 1
        op.cluster.add_pod(Pod(name=f"bg-{serial}",
                               requests={"cpu": "500m", "memory": "1Gi"}))
        # re-assert the smoke's ICE hold each tick (the 10 s cleanup may
        # thaw TTL'd entries; the weather scenario churns its own)
        for z in lattice.zones:
            for ct in lattice.capacity_types:
                for t in [n for n in lattice.names if n.startswith("c5.")]:
                    op.unavailable.mark_unavailable("smoke-ice", ct, t, z)
        op.run_once(force_provision=True)
        clock.step(scenario.tick_seconds)
        sim.advance()
    sim.stop()
    op.sampler.sample_once()

    if not any(p.name == "iced-pod" for p in op.cluster.pending_pods()):
        failures.append("the ICE'd-out pod is not pending — the smoke's "
                        "premise broke")
    # FailedScheduling dedup: many passes, ONE event for (pod, code)
    evs = [e for e in op.recorder.events(reason="FailedScheduling")
           if e.object_name == "iced-pod"]
    if len(evs) != 1:
        failures.append(f"FailedScheduling dedup broke: {len(evs)} events "
                        "for one stuck (pod, reason-code)")

    server = start_server(op, 0)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        # 1. /debug/explain over live HTTP attributes the pod to ICE
        doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/explain?pod=iced-pod", timeout=10).read())
        if doc.get("code") != "ice-hold":
            failures.append(f"expected code ice-hold, got {doc.get('code')} "
                            f"({doc.get('reason')})")
        group = doc.get("group") or {}
        if group.get("blame") != "ice":
            failures.append(f"expected ledger blame 'ice', got "
                            f"{group.get('blame')!r}")
        ice_row = next((s for s in group.get("stages", [])
                        if s.get("stage") == "ice"), None)
        if ice_row is None or not ice_row.get("eliminated"):
            failures.append(f"ice stage did not eliminate offerings: "
                            f"{ice_row}")
        elif not ice_row.get("examples"):
            failures.append("ice stage carries no example offerings")
        # the ring's pass list serves too (kpctl explain pass)
        ring_doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/explain", timeout=10).read())
        if not ring_doc.get("passes"):
            failures.append("/debug/explain lists no passes")
        if ring_doc.get("reasons", {}).get("ice-hold", 0) <= 0:
            failures.append(f"ring reasons missing ice-hold: "
                            f"{ring_doc.get('reasons')}")

        # 2. kpctl explain pod renders the waterfall against live HTTP
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = kpctl.main(["--server", base, "explain", "pod",
                             "iced-pod"])
        rendered = out.getvalue()
        if rc != 0:
            failures.append(f"kpctl explain pod exited {rc}")
        if "eliminated by ice" not in rendered:
            failures.append("kpctl explain pod did not render the ice "
                            f"elimination row:\n{rendered}")

        # 3. the explain provider (what soak artifacts embed) reports
        vars_doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/vars", timeout=10).read())
        ex = vars_doc.get("providers", {}).get("explain", {})
        if ex.get("reason_ice_hold", 0) <= 0:
            failures.append(f"explain provider histogram missing "
                            f"reason_ice_hold: {ex}")
        if not any(k.startswith("elim_") and v > 0
                   for k, v in ex.items() if isinstance(v, (int, float))):
            failures.append(f"explain provider elimination counters "
                            f"never moved: {ex}")
    finally:
        server.shutdown()

    gate.report("explain", device, op.solver.stats()["device"], failures)
    if failures:
        print("explain smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"explain smoke: OK (iced-pod attributed to the ice stage "
          f"[{ice_row['eliminated']} offerings, e.g. "
          f"{ice_row['examples'][0]}], 1 deduped FailedScheduling event, "
          f"kpctl explain renders, reason histogram "
          f"ice-hold={ex['reason_ice_hold']:g})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
