"""The PyTorch port's incremental problem builder and ``DirtySet`` against
the JAX package's, on the CPU.

Both builders go through one seeded churn sequence
(``test_torch_cases.churn_sequence``: pending pods added and removed,
existing-bin usage moved, a pass with no churn, and the gates — a
revision skew, bulk churn, a new signature, a pod with an unknown
resource, a pool change, a count mismatch). Tolerance: none. Every step
must give equal problems (``assert_problems_equal``), the same
``incremental`` flag, ``reason`` and ``dirty_groups``.
"""

import pytest

from karpenter_provider_aws_tpu.solver.incremental import (
    IncrementalProblemBuilder as JaxBuilder)
from karpenter_provider_aws_tpu.state.cluster import DirtySet as JaxDirtySet
from karpenter_provider_aws_tpu_torch.solver.incremental import (
    IncrementalProblemBuilder as TorchBuilder)
from karpenter_provider_aws_tpu_torch.state.cluster import DirtySet as TorchDirtySet

import test_torch_cases as cases
from test_torch_solver import assert_problems_equal

STEPS = list(range(15))
_RUNS = {}


def _run_sequence():
    """(jax results, torch results, builders) over the whole sequence,
    computed once for every parametrized step."""
    if "seq" not in _RUNS:
        jl = cases.small_lattice(cases.JAX_PKG)
        tl = cases.small_lattice(cases.TORCH_PKG)
        jb, tb = JaxBuilder(explain=False), TorchBuilder(explain=False)
        jres, tres = [], []
        for (jpods, jpools, jex, jd, jt), (tpods, tpools, tex, td, tt) in zip(
                cases.churn_sequence(cases.JAX_PKG, jl),
                cases.churn_sequence(cases.TORCH_PKG, tl)):
            jres.append(jb.build(jpods, jpools, jl, existing=lambda: jex,
                                 dirty=jd, touched=jt))
            tres.append(tb.build(tpods, tpools, tl, existing=lambda: tex,
                                 dirty=td, touched=tt))
        _RUNS["seq"] = (jres, tres, jb, tb)
    return _RUNS["seq"]


class TestChurnSequence:
    @pytest.mark.parametrize("step", STEPS)
    def test_step_equal(self, step):
        jres, tres, _, _ = _run_sequence()
        j, t = jres[step], tres[step]
        assert (t.incremental, t.reason, t.dirty_groups, t.rev) == \
            (j.incremental, j.reason, j.dirty_groups, j.rev)
        assert_problems_equal(j.problem, t.problem)

    def test_sequence_hits_every_gate(self):
        """Non-vacuous: the sequence takes the delta path and each gate."""
        _, tres, jb, tb = _run_sequence()
        reasons = [r.reason for r in tres]
        assert sum(r.incremental for r in tres) >= 8
        for gate in ("cold", "revision-skew", "bulk-churn", "new-signature",
                     "pools-changed", "count-mismatch"):
            assert gate in reasons
        assert tb.stats() == jb.stats()
        assert (tb.incremental_builds, tb.full_builds) == \
            (jb.incremental_builds, jb.full_builds)

    def test_unknown_resource_pod_is_unschedulable_on_the_delta_path(self):
        jres, tres, _, _ = _run_sequence()
        step = next(i for i, r in enumerate(tres) if "weird-1" in r.problem.unschedulable)
        assert tres[step].incremental and jres[step].incremental
        assert tres[step].problem.unschedulable == jres[step].problem.unschedulable


class TestBuilderSurface:
    def test_explain_is_not_ported(self):
        """(Named when explain builds raised here.) The builder now
        defaults to ``explain=True``, as the JAX package's does: a full
        build carries a ledger on every group, and ``explain=False``
        carries none."""
        lat, pods, pools, _ = cases.build(cases.TORCH_PKG, "generic")
        DirtySet = cases.mod(cases.TORCH_PKG, "state.cluster").DirtySet
        full = lambda: DirtySet(since=-1, rev=0, full=True)
        on = TorchBuilder().build(pods, pools, lat, dirty=full()).problem
        off = TorchBuilder(explain=False).build(pods, pools, lat, dirty=full()).problem
        assert on.groups and all(g.ledger is not None for g in on.groups)
        assert all(g.ledger is None for g in off.groups)

    def test_no_dirty_set_and_gates_without_a_previous_build(self):
        lat = cases.small_lattice(cases.TORCH_PKG)
        _, pods, pools, _ = cases.build(cases.TORCH_PKG, "generic")
        b = TorchBuilder()
        assert b.rev == -1
        r = b.build(pods, pools, lat)
        assert not r.incremental and r.reason == "no-dirty-set"
        r = b.build(pods, pools, lat, dirty=TorchDirtySet(since=-1, rev=0, other=True))
        assert not r.incremental and r.reason == "untracked-mutation"
        assert b.rev == 0

    @pytest.mark.parametrize("flag, reason", [("volumes", "volume-churn"),
                                              ("daemonsets", "daemonset-churn")])
    def test_volume_and_daemonset_gates(self, flag, reason):
        outs = []
        for pkg, Builder in ((cases.JAX_PKG, lambda: JaxBuilder(explain=False)),
                             (cases.TORCH_PKG, lambda: TorchBuilder(explain=False))):
            DirtySet = cases.mod(pkg, "state.cluster").DirtySet
            lat, pods, pools, _ = cases.build(pkg, "generic")
            b = Builder()
            b.build(pods, pools, lat, dirty=DirtySet(since=-1, rev=0, full=True))
            r = b.build(pods, pools, lat,
                        dirty=DirtySet(since=0, rev=1, **{flag: True}))
            outs.append((r.incremental, r.reason))
        assert outs[0] == outs[1] == (False, reason)

    @pytest.mark.parametrize("case", ["affinity", "existing", "selectors_taints"])
    def test_eligibility_equal(self, case):
        """Which full builds may seed deltas, and why not."""
        outs = []
        for pkg, Builder in ((cases.JAX_PKG, lambda: JaxBuilder(explain=False)),
                             (cases.TORCH_PKG, lambda: TorchBuilder(explain=False))):
            DirtySet = cases.mod(pkg, "state.cluster").DirtySet
            lat, pods, pools, kw = cases.build(pkg, case)
            b = Builder()
            b.build(pods, pools, lat, dirty=DirtySet(since=-1, rev=0, full=True), **kw)
            outs.append((b.stats(), b.last_reason))
        assert outs[0] == outs[1]


class TestDirtySet:
    def test_merge_equal(self):
        def sets(DirtySet):
            a = DirtySet(since=3, rev=5, pods={"a"}, bin_names={"n1"})
            a.merge(DirtySet(since=5, rev=9, pods={"b"}, bins=True,
                             bins_unnamed=True, volumes=True, ticks=2))
            return a
        j, t = sets(JaxDirtySet), sets(TorchDirtySet)
        assert vars(j) == vars(t)
        assert (t.since, t.rev, t.ticks, t.pods) == (3, 9, 3, {"a", "b"})

    def test_non_contiguous_merge_raises(self):
        with pytest.raises(ValueError):
            TorchDirtySet(since=0, rev=2).merge(TorchDirtySet(since=3, rev=4))
