"""The PyTorch port's ``ClusterState`` (the mirror, its dirty journal and
``DirtyJournalCoalescer``) against the JAX package's, on the CPU.

Both mirrors start from the same seeded contents
(``test_torch_cases.cluster_contents``) and take the same seeded mutation
script: pods added, deleted, bound and nominated; claims added, deleted
and marked for deletion; nodes registered and removed; the clock stepped
past nominations; coalescer ticks between checkpoints. At every
checkpoint the two must give equal ``DirtySet``s (a direct journal read,
the coalescer's ``take``, and a read from before the ring's horizon that
must overflow to ``full``), equal ``touched_pods``, ``pending_pods``,
``existing_bins`` (``used`` and ``alloc_override`` byte-equal),
``bound_pods``, ``pool_usage``, nominations and phase counts.
Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest

import test_torch_cases as cases

SEEDS = (3, 11, 29)
CHECKPOINTS = 10
JOURNAL_MAX = 48   # small ring, so the script runs past its horizon


def _dirty_row(d):
    row = dataclasses.asdict(d)
    for k in ("pods", "bin_names"):
        row[k] = sorted(row[k])
    return row


def _bin_row(b):
    return (b.name, b.node_pool, b.instance_type, b.zone, b.capacity_type,
            b.used.dtype.str, b.used.tobytes(),
            None if b.alloc_override is None else b.alloc_override.tobytes(),
            sorted(b.labels.items()))


def _snapshot(pkg, cluster, coalescer, lat, anchor):
    """Everything a provisioning pass reads from the mirror, as plain
    data. ``anchor`` is the revision the incremental builder last built
    at; the coalescer's ``take`` consumes what it ticked since then."""
    direct = cluster.dirty_since(anchor)
    taken = coalescer.take(anchor)
    stale = cluster.dirty_since(max(cluster.state_rev - JOURNAL_MAX - 5, 0))
    touched = cluster.touched_pods(sorted(direct.pods))
    usage = cluster.pool_usage()
    return {
        "rev": cluster.state_rev,
        "direct": _dirty_row(direct),
        "taken": _dirty_row(taken),
        "stale": _dirty_row(stale),
        "coalescer": (coalescer.ticks, coalescer.takes, coalescer.fallbacks),
        "touched": {n: (s, p.name if p is not None else None)
                    for n, (s, p) in touched.items()},
        "pending": [p.name for p in cluster.pending_pods()],
        "existing": [_bin_row(b) for b in cluster.existing_bins(lat)],
        "bound": [(b.pod.name, b.node_name, b.zone, b.capacity_type,
                   sorted(b.node_labels.items())) for b in cluster.bound_pods()],
        "usage": {k: v.tobytes() for k, v in sorted(usage.items())},
        "nominated": {c: [p.name for p in cluster.nominated_pods(c)]
                      for c in sorted(cluster.claims)},
        "phases": cluster.pod_phase_counts(),
        "daemonsets": [p.name for p in cluster.daemonset_pods()],
        "capacity_rev": cluster.capacity_rev,
    }


def _run(pkg, seed, monkeypatch):
    """The mutation script over ``pkg``'s mirror: a snapshot per
    checkpoint. Random choices read only names, so both packages take
    the same script as long as their mirrors agree."""
    C = cases.mod(pkg, "state.cluster")
    monkeypatch.setattr(C, "_JOURNAL_MAX", JOURNAL_MAX)
    A = cases.mod(pkg, "apis")
    O = cases.mod(pkg, "apis.objects")
    lat = cases.small_lattice(pkg)
    contents = cases.cluster_contents(pkg, lat, seed)
    clock = cases.mod(pkg, "utils.clock").FakeClock()
    cluster = cases.populate(pkg, contents, clock)
    coalescer = C.DirtyJournalCoalescer(cluster)
    rng = np.random.default_rng(seed + 100)
    anchor = 0
    serial = 0
    snaps = []
    for step in range(CHECKPOINTS):
        for _ in range(int(rng.integers(3, 9))):
            op = int(rng.integers(10))
            pending = sorted(p.name for p in cluster.pending_pods())
            nodes = sorted(cluster.nodes)
            claims = sorted(cluster.claims)
            if op <= 1:
                serial += 1
                cpu, mem = cases.CHURN_SHAPES[int(rng.integers(4))]
                cluster.add_pod(A.Pod(name=f"x{serial}",
                                      requests={"cpu": cpu, "memory": mem}))
            elif op == 2 and pending:
                cluster.delete_pod(pending[int(rng.integers(len(pending)))])
            elif op == 3 and pending and nodes:
                cluster.bind_pod(pending[int(rng.integers(len(pending)))],
                                 nodes[int(rng.integers(len(nodes)))])
            elif op == 4 and pending and claims:
                cluster.nominate(pending[int(rng.integers(len(pending)))],
                                 claims[int(rng.integers(len(claims)))])
            elif op == 5:
                bound = sorted(p.name for p in cluster.pods.values()
                               if p.node_name and not p.is_daemonset)
                if bound:
                    cluster.delete_pod(bound[int(rng.integers(len(bound)))])
            elif op == 6 and claims:
                name = claims[int(rng.integers(len(claims)))]
                if rng.random() < 0.5:
                    cluster.delete_claim(name)
                else:
                    c = cluster.claims[name]
                    c.deletion_timestamp = clock.now()
                    c.phase = O.NodeClaimPhase.TERMINATING
                    cluster.touch_capacity(name)
            elif op == 7 and nodes:
                cluster.delete_node(nodes[int(rng.integers(len(nodes)))])
            elif op == 8:
                clock.step(float(rng.choice([1.0, 25.0])))
            else:
                coalescer.tick(anchor)
        snaps.append(_snapshot(pkg, cluster, coalescer, lat, anchor))
        if rng.random() < 0.7:
            anchor = cluster.state_rev   # the builder rebuilt here
    return snaps


_RUNS = {}


def _runs(seed, monkeypatch):
    if seed not in _RUNS:
        _RUNS[seed] = (_run(cases.JAX_PKG, seed, monkeypatch),
                       _run(cases.TORCH_PKG, seed, monkeypatch))
    return _RUNS[seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("checkpoint", range(CHECKPOINTS))
def test_checkpoint_equal(seed, checkpoint, monkeypatch):
    j, t = _runs(seed, monkeypatch)
    assert t[checkpoint] == j[checkpoint]


@pytest.mark.parametrize("seed", SEEDS)
def test_script_is_not_vacuous(seed, monkeypatch):
    """The script moves every answer a pass reads: pods pend and leave,
    bins change, the coalescer merges ticks and falls back, and an old
    anchor overflows to ``full``."""
    _, t = _runs(seed, monkeypatch)
    assert any(s["stale"]["full"] for s in t)
    assert any(s["taken"]["ticks"] > 1 for s in t)
    assert any(s["direct"]["bins"] for s in t)
    assert len({len(s["pending"]) for s in t}) > 1
    assert len({tuple(r[0] for r in s["existing"]) for s in t}) > 1
    assert any(s["touched"] for s in t)
    assert t[-1]["coalescer"][1] == CHECKPOINTS


class TestJournal:
    def _pair(self):
        out = []
        for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
            lat = cases.small_lattice(pkg)
            out.append(cases.populate(pkg, cases.cluster_contents(pkg, lat)))
        return out

    def test_contents_load_equal(self):
        j, t = self._pair()
        assert t.state_rev == j.state_rev > 0
        assert t.stats() == j.stats()
        assert _dirty_row(t.dirty_since(0)) == _dirty_row(j.dirty_since(0))

    def test_future_anchor_is_full(self):
        j, t = self._pair()
        assert t.dirty_since(t.state_rev + 1).full
        assert _dirty_row(t.dirty_since(t.state_rev + 1)) == \
            _dirty_row(j.dirty_since(j.state_rev + 1))

    def test_coalescer_falls_back_on_another_anchor(self):
        outs = []
        for c in self._pair():
            pkg = type(c).__module__.split(".")[0]
            co = cases.mod(pkg, "state.cluster").DirtyJournalCoalescer(c)
            co.tick(0)
            A = cases.mod(pkg, "apis")
            c.add_pod(A.Pod(name="late", requests={"cpu": "1"}))
            d = co.take(c.state_rev - 1)
            outs.append((_dirty_row(d), co.ticks, co.takes, co.fallbacks))
        assert outs[0] == outs[1]
        # live nominations ride every read; the new pod is the only other
        assert outs[1][3] == 1 and "late" in outs[1][0]["pods"]

    def test_merge_rejects_a_gap(self):
        DirtySet = cases.mod(cases.TORCH_PKG, "state.cluster").DirtySet
        with pytest.raises(ValueError):
            DirtySet(since=0, rev=3).merge(DirtySet(since=4, rev=5))
