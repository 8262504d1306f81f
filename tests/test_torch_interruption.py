"""The PyTorch port's interruption controller and metrics surface against
the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_interruption.py`` (the four
message schemas and the parser, spot interruption, rebalance, scheduled
change, the message and core metric series, the cloud-provider
decoration, the Prometheus rendering, the throughput harness) is replayed
on both packages by ``test_torch_replay``: the test's own checks run on
each, and the two must make the same claims, events, cloud calls, queue
contents and metric series (tolerances in ``test_torch_replay``;
everything else exact). The throughput harness imports the repository's
``tools/bench_interruption.py``; on the port side ``SHIMS`` point it at the
port's copy (``karpenter_provider_aws_tpu_torch/tools``) with its
Operator on the CPU. No test is left out (``NOT_REPLAYED`` is empty).
"""

import pytest

import test_torch_replay as replay

FILE = "test_interruption.py"
NOT_REPLAYED = {}
SHIMS = (
    ("from tools.bench_interruption import build_env, drain, seed_messages",
     "from karpenter_provider_aws_tpu_torch.tools.bench_interruption "
     "import build_env, drain, seed_messages"),
    ("env = build_env(lattice)", "env = build_env(lattice, device='cpu')"),
)


# The throughput harness's drain: the interruption controller handles a
# reconcile's messages on its pool of MESSAGE_WORKERS threads in both
# packages, so within one reconcile the order of the handlers' events, and
# whether a lock wait is observed at all (only when threads contend),
# follow the threads. For this test alone each run of consecutive
# POOLED_EVENTS at one time compares as a sorted list, and the lock-wait
# series' presence is not compared (their family is; their values, wall
# time, never are). Every other test compares as the harness does.
DRAIN = "test_interruption.py::TestThroughputHarness::test_drain_2000_messages"
POOLED_EVENTS = ("SpotInterruptionKind", "RebalanceRecommendationKind",
                 "ScheduledChangeKind", "StateChangeKind")
LOCK_WAIT = "karpenter_lock_wait_seconds"


def pooled_events(events):
    """Each maximal run of consecutive ``POOLED_EVENTS`` at one time
    sorted, every other event in order."""
    out, run = [], []
    for ev in events:
        if run and (ev[2] not in POOLED_EVENTS or ev[0] != run[0][0]):
            out.extend(sorted(run))
            run = []
        if ev[2] in POOLED_EVENTS:
            run.append(ev)
        else:
            out.append(ev)
    return out + sorted(run)


def drained(kind, obs):
    """The drain's observation of ``kind`` as compared."""
    if kind[1] == "Operator":
        return {**obs, "events": pooled_events(obs["events"])}
    if kind[1] == "Registry":
        return {**obs, "present": {p for p in obs["present"]
                                   if p[0] != LOCK_WAIT}}
    return obs


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_interruption_equal_to_jax(test_id, tmp_path):
    if test_id != DRAIN:
        replay.replay(FILE, test_id, tmp_path, shims=SHIMS)
        return
    j, t = replay.replay(FILE, test_id, tmp_path, shims=SHIMS,
                         threaded=True)
    for kind in j:
        for i, (a, b) in enumerate(zip(j[kind], t[kind])):
            replay._same(drained(kind, a), drained(kind, b),
                         f"{kind[1]}[{i}]")


def test_interruption_replays_cover_the_jax_tests():
    """Every test of test_interruption.py is replayed or named in
    NOT_REPLAYED with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 19
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)


def test_drain_compares_pooled_events_as_a_set_within_their_run():
    """The drain's handler events of one reconcile compare in any order;
    their contents, their count, a run at another time and every other
    event's order still count."""
    ev = [(1.0, "Warning", "SpotInterruptionKind", "NodeClaim", f"claim-{i}",
           f"interruption event for instance i-{i}") for i in range(3)]
    other = (1.0, "Normal", "Launched", "NodeClaim", "claim-9", "launched")
    later = (2.0,) + ev[0][1:]
    assert pooled_events([other, ev[1], ev[0], ev[2], later]) \
        == pooled_events([other, ev[0], ev[2], ev[1], later])
    assert pooled_events([other] + ev) != pooled_events(ev + [other])
    assert pooled_events(ev) != pooled_events(ev[:2])
    assert pooled_events(ev[:2] + [later]) != pooled_events([later] + ev[:2])


def test_drain_compares_the_lock_wait_family_not_its_presence():
    """A lock wait observed in one package's drain only leaves the two
    registries' observations equal; its family, and every other series'
    presence, still count."""
    from karpenter_provider_aws_tpu_torch import metrics
    kind = ("metrics", "Registry")
    a, b = metrics.Registry(), metrics.Registry()
    ma, _ = metrics.wire_core_metrics(a), metrics.wire_core_metrics(b)
    ma["lock_wait"].observe(0.001, lock="cluster_state")
    assert replay.observe_registry(a) != replay.observe_registry(b)
    assert drained(kind, replay.observe_registry(a)) \
        == drained(kind, replay.observe_registry(b))
    assert LOCK_WAIT in {f[0] for f in drained(
        kind, replay.observe_registry(a))["families"]}
    ma["pods_startup_time"].observe(1.0)
    assert drained(kind, replay.observe_registry(a)) \
        != drained(kind, replay.observe_registry(b))

