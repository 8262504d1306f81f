"""The PyTorch port's chaos gates on the CPU: ``smoke_weather`` against the
JAX package's, and ``smoke_explain``, ``smoke_pool`` and ``smoke_handoff``
(two processes of the port on a shared lease) on their own.

The weather gate (the ``squall`` for its scripted 60 s on a FakeClock,
then 40 recovery passes) runs in a subprocess beside the repository's own
``tools/smoke_weather.py`` (``JAX_PLATFORMS=cpu``); both must exit 0 and
their summary lines must be equal but for one field: the recovered
``latency_burn`` is the SLO tracker's reading of each pass's wall time, so
it is compared by presence only (a number). The ticks, the timeline's
events, the rungs taken, the messages and junk sent, the lock-order edges
and the replay compare exactly.

The explain, pool and handoff gates must exit 0 with their device line and
summary; the handoff's promotion latency is wall-clock derived (presence
only), and so is everything the pool's breakers time. The handoff gate's
duplicate-launch check differs from the reference's where the reference
races with its leader's churn (pods replicated pending at promotion may
get capacity); its cases are pinned here.

Tolerance: none, but for the wall-clock fields named above.
"""

import re

import pytest

from test_torch_smokes import check_port, run_both, run_port, summary

WALL_CLOCK = re.compile(r"latency_burn=[0-9.e+-]+")


def test_weather_summary_equals_the_jax_gates_but_its_latency_burn():
    port, jax = run_both("weather")
    got, want = check_port("weather", port), summary(jax)
    assert WALL_CLOCK.search(got) and WALL_CLOCK.search(want)
    assert WALL_CLOCK.sub("latency_burn=<wall>", got) \
        == WALL_CLOCK.sub("latency_burn=<wall>", want)


@pytest.mark.parametrize("name", ["explain", "pool", "handoff"])
def test_gate_passes_on_the_cpu(name):
    line = check_port(name, run_port(name))
    if name == "handoff":
        assert re.search(r"promoted in [\d.]+s, fence \d+->\d+", line), line


@pytest.mark.parametrize("pending, claims, held, fault", [
    # the reference's case: nothing pending, nothing launched
    ([], 0, {}, None),
    # nothing pending, yet a claim: the reference's check fails it too
    ([], 1, {"c-1": ["lp3"]}, "duplicate capacity for already-bound"),
    # two pods replicated pending, one claim that holds both
    (["lp7", "lp8"], 1, {"c-1": ["lp7", "lp8"]}, None),
    # a pod pending, but its claim also took a pod bound before promotion
    (["lp8"], 1, {"c-1": ["lp3", "lp8"]}, "already-bound pods ['lp3']"),
    # pods pending, and a claim that holds only pods bound earlier
    (["lp7", "lp8"], 2, {"c-1": ["lp7", "lp8"], "c-2": ["lp3"]},
     "already-bound pods ['lp3']"),
    # a claim that holds no pod at all
    (["lp7"], 1, {"c-1": []}, "holds no pod"),
    # a launch the mirror does not hold
    (["lp7"], 2, {"c-1": ["lp7"]}, "2 claims launched"),
], ids=["none", "claim-with-nothing-pending", "pending-pods",
        "mixed-claim", "claim-of-bound-pods", "empty-claim",
        "claim-not-in-the-mirror"])
def test_handoff_convergence_claims_only_for_pods_pending_at_promotion(
        pending, claims, held, fault):
    """The handoff gate's duplicate-launch check, made on each claim of
    the convergence passes: it holds pods, and only pods pending at
    promotion (with none pending, the reference's check of no claim)."""
    from karpenter_provider_aws_tpu_torch.tools.smoke_handoff import (
        convergence_fault)
    got = convergence_fault({"pending_at_promotion": pending,
                             "convergence_claims": claims,
                             "convergence_pods": held})
    if fault is None:
        assert got is None
    else:
        assert got is not None and fault in got, got
