"""CI smoke for the saturation observatory (ci.sh headroom gate), for this
package (the counterpart of the repository's ``tools/smoke_headroom.py``).

    python -m karpenter_provider_aws_tpu_torch.tools.smoke_headroom [--device cuda]

Boots an API-mode Operator (its Solver on ``--device``) with a
deliberately TINY watch queue bound, parks an idle watcher on the pods
feed, and churns writes so the idle queue fills — then asserts the
observatory tells the future, not just the past
(docs/reference/headroom.md):

1. BEFORE the first overflow, ``/debug/headroom`` over LIVE HTTP ranks
   ``api_watch_queues`` first-to-break with a finite time-to-exhaustion
   and zero drops — the forecaster names the tightened resource while
   the run is still green,
2. crossing the high-water fraction fires the burn-capture machinery
   EXACTLY ONCE for the episode (reason ``headroom-api_watch_queues``
   at ``/debug/pprof/captures``), no capture storm while the queue sits
   pinned at its bound,
3. after the overflow, the same probe reports the drops (reusing the
   apiserver's own ``watch_drops`` counter) and the monotonic high
   water holds at the bound,
4. ``kpctl headroom`` (this package's ``tools/kpctl.py``) renders the
   ranked table against the live server (exit 0), and degrades to
   ``headroom: unavailable`` (exit 1, no traceback) when no registry is
   published — the error-shape contract every kpctl surface follows.

Fast by design: small-family lattice, FakeClock, a few hundred writes.
The gate writes pods and reads gauges; it runs no provisioning pass, so
it reports ``solved: false`` and launches no kernel.
"""

from __future__ import annotations

import contextlib
import io
import json
import urllib.request

from . import gate

BOUND = 64


def main(argv=None) -> int:
    device = gate.device_arg(argv, __doc__)
    from .. import introspect
    from ..cli import start_server
    from ..cloud import FakeCloud
    from ..kube import FakeAPIServer
    from ..operator import Operator, Options
    from ..utils.clock import FakeClock
    from . import kpctl

    failures = []
    clock = FakeClock()
    lattice = gate.small_lattice()
    api = FakeAPIServer()
    op = Operator(options=Options(registration_delay=0.5,
                                  api_watch_queue_bound=BOUND),
                  lattice=lattice, cloud=FakeCloud(clock), clock=clock,
                  api_server=api, device=device)

    # the deliberately idle watcher: subscribed, never drained — the
    # tightened bound is ITS queue
    idle = api.watch("pods")

    server = start_server(op, 0)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"

    def fetch(path):
        return json.loads(urllib.request.urlopen(base + path,
                                                 timeout=10).read())

    def churn_round(serial):
        for i in range(4):
            api.create("pods", {"name": f"churn-{serial}-{i}"})
        op.emit_gauges()        # observe() rides every gauge pass
        clock.step(1.0)

    try:
        serial = 0
        # ---- phase 1: fill to ~half the bound, NO overflow yet --------
        while len(idle._events) < BOUND // 2:
            churn_round(serial)
            serial += 1
        if api.watch_drops != 0:
            failures.append("premise broke: overflow before the forecast "
                            "assertion")
        doc = fetch("/debug/headroom")
        rows = doc.get("resources") or []
        first = rows[0] if rows else {}
        if first.get("resource") != "api_watch_queues":
            failures.append(
                "forecaster did not rank the tightened watch queue "
                f"first-to-break BEFORE its overflow: "
                f"{[r['resource'] for r in rows[:3]]}")
        if first.get("seconds_to_exhaustion") is None:
            failures.append("first-to-break row carries no finite "
                            "time-to-exhaustion while filling")
        if first.get("drops", 0) != 0:
            failures.append("the prediction-before-overflow gate saw "
                            f"drops={first.get('drops')} — too late")
        # ---- phase 2: drive through high water into overflow ----------
        while api.watch_drops == 0:
            churn_round(serial)
            serial += 1
            if serial > 200:
                failures.append("watch queue never overflowed — churn "
                                "premise broke")
                break
        op.emit_gauges()
        caps = fetch("/debug/pprof/captures").get("captures", [])
        hw_caps = [c for c in caps
                   if c.get("reason") == "headroom-api_watch_queues"]
        if len(hw_caps) != 1:
            failures.append(f"expected EXACTLY one high-water capture for "
                            f"the episode, got {len(hw_caps)} "
                            f"(reasons: {[c.get('reason') for c in caps]})")
        elif hw_caps[0].get("occupancy", 0.0) < 0.9:
            failures.append(f"capture fired below the high-water fraction: "
                            f"{hw_caps[0].get('occupancy')}")
        row = next((r for r in fetch("/debug/headroom")["resources"]
                    if r["resource"] == "api_watch_queues"), {})
        if row.get("drops", 0) <= 0:
            failures.append("after overflow the probe does not report the "
                            "apiserver's watch_drops counter")
        if row.get("highwater", 0) < BOUND:
            failures.append(f"monotonic high water below the bound after "
                            f"overflow: {row.get('highwater')}")
        st = fetch("/debug/vars").get("providers", {}).get("headroom", {})
        if st.get("episodes", 0) != 1:
            failures.append(f"headroom provider episodes != 1: "
                            f"{st.get('episodes')}")

        # ---- kpctl headroom against the live server --------------------
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = kpctl.main(["--server", base, "headroom"])
        rendered = out.getvalue()
        if rc != 0:
            failures.append(f"kpctl headroom exited {rc}")
        if "api_watch_queues" not in rendered:
            failures.append("kpctl headroom did not render the watch "
                            f"queue row:\n{rendered}")
        # error-shape safety: no registry published -> graceful message
        saved = introspect.headroom_registry()
        try:
            introspect.set_headroom(None)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = kpctl.main(["--server", base, "headroom"])
            if rc == 0 or "headroom: unavailable" not in out.getvalue():
                failures.append("kpctl headroom did not degrade to the "
                                "unavailable message without a registry: "
                                f"rc={rc} out={out.getvalue()!r}")
        finally:
            introspect.set_headroom(saved)
    finally:
        server.shutdown()
        api.stop_watch(idle)

    gate.report("headroom", device, op.solver.stats()["device"], failures,
                solved=False)
    if failures:
        print("headroom smoke: FAIL")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"headroom smoke: OK (api_watch_queues ranked first-to-break "
          f"{first['seconds_to_exhaustion']:.0f}s out with 0 drops, then "
          f"overflowed to drops={row['drops']:g} hw={row['highwater']:g}; "
          f"1 capture for the episode; kpctl headroom renders + degrades)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
