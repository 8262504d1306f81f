"""The PyTorch port's explain builds against the JAX package's, on the CPU.

``build_problem(explain=True)`` runs in both packages over every
``test_torch_cases`` case, three seeded random mixes, and an ICE-masked
lattice (``UnavailableOfferings`` through ``masked_view_versioned``) in
which some groups lose every offering to the ICE stage and others to
their requirements. Each group's constraint-elimination ledger must be
equal (stage rows with their counts and examples, ``blame_code()``,
notes, pool counts), and so must the dropped groups' ledgers and the
reason codes of their pods. The incremental builder's ledgers, patched
copy-on-write by ``with_count`` on delta passes, must match over
``churn_sequence``, and a pass explanation folded from a CPU plan must
equal the JAX package's. Tolerance: none.
"""

import pytest

import test_torch_cases as cases

RANDOM = ["random-0", "random-1", "random-2"]


def _ledger_rows(problem):
    out = []
    for kind, groups in (("kept", problem.groups), ("dropped", problem.dropped_groups)):
        for g in groups:
            led = g.ledger
            out.append((kind, g.signature, led.to_doc(), led.blame_code(),
                        [(r.stage, r.remaining, r.eliminated, r.examples)
                         for r in led.stages], led.notes))
    return out


def _build(pkg, case, lattice=None):
    lat, pods, pools, kw = cases.build(pkg, case)
    P = cases.mod(pkg, "solver.problem")
    return P.build_problem(pods, pools, lattice or lat, explain=True, **kw)


@pytest.mark.parametrize("case", list(cases.CASES) + RANDOM)
def test_ledgers_equal(case):
    jp, tp = _build(cases.JAX_PKG, case), _build(cases.TORCH_PKG, case)
    assert all(g.ledger is not None for g in tp.groups + tp.dropped_groups)
    assert _ledger_rows(tp) == _ledger_rows(jp)
    assert tp.unschedulable == jp.unschedulable


def _ice_inputs(pkg):
    """The selectors/taints case over a lattice whose c5 offerings are all
    marked unavailable: the c-category groups are ICE-held, and a pod that
    asks for a family the slice lacks is dropped for want of an offering."""
    lat, pods, pools, kw = cases.build(pkg, "selectors_taints")
    clock = cases.mod(pkg, "utils.clock").FakeClock()
    unav = cases.mod(pkg, "cache.unavailable").UnavailableOfferings(clock)
    for t in lat.names:
        if t.startswith("c5."):
            for z in lat.zones:
                for c in lat.capacity_types:
                    unav.mark_unavailable("test", c, t, z)
    T = cases.mod(pkg, "lattice.tensors")
    masked = T.masked_view_versioned(lat, unav)
    A = cases.mod(pkg, "apis")
    wk = cases.mod(pkg, "apis.wellknown")
    pods = pods + [A.Pod(name="nofam", requests={"cpu": "1"},
                         node_selector={wk.LABEL_INSTANCE_FAMILY: "p4d"})]
    P = cases.mod(pkg, "solver.problem")
    return P.build_problem(pods, pools, masked, explain=True, **kw)


def test_ice_hold_and_no_offering_codes_equal():
    jp, tp = _ice_inputs(cases.JAX_PKG), _ice_inputs(cases.TORCH_PKG)
    assert _ledger_rows(tp) == _ledger_rows(jp)
    assert tp.unschedulable == jp.unschedulable
    T = cases.mod(cases.TORCH_PKG, "solver.taxonomy")
    codes = {T.code_of(r) for r in tp.unschedulable.values()}
    # non-vacuous: both refinements of a dropped group occur
    assert {T.ICE_HOLD, T.NO_OFFERING} <= codes
    assert any(r[3] == T.ICE_HOLD and r[4][4][3] for r in _ledger_rows(tp))


def test_explain_off_builds_no_ledgers():
    """Without ``explain`` neither package builds a ledger, and both give
    the same reason codes."""
    outs = []
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat, pods, pools, kw = cases.build(pkg, "generic")
        P = cases.mod(pkg, "solver.problem")
        p = P.build_problem(pods, pools, lat, **kw)
        outs.append(([g.ledger for g in p.groups], p.unschedulable))
    assert outs[0] == outs[1]
    assert all(led is None for led in outs[1][0])


_RUNS = {}


def _churn():
    if "seq" not in _RUNS:
        out = []
        for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
            lat = cases.small_lattice(pkg)
            b = cases.mod(pkg, "solver.incremental").IncrementalProblemBuilder()
            out.append([b.build(pods, pools, lat, existing=lambda: ex,
                                dirty=dirty, touched=touched)
                        for pods, pools, ex, dirty, touched
                        in cases.churn_sequence(pkg, lat)])
        _RUNS["seq"] = out
    return _RUNS["seq"]


@pytest.mark.parametrize("step", range(15))
def test_incremental_ledgers_equal(step):
    jres, tres = _churn()
    j, t = jres[step], tres[step]
    assert (t.incremental, t.reason) == (j.incremental, j.reason)
    assert _ledger_rows(t.problem) == _ledger_rows(j.problem)
    assert [g.ledger.pods for g in t.problem.groups] == \
        [len(g.pod_names) for g in t.problem.groups]


def test_incremental_ledgers_are_patched_copy_on_write():
    """A delta pass keeps an untouched group's ledger object and replaces
    a touched one's (``with_count``), never mutating the previous pass's."""
    _, tres = _churn()
    seen = False
    for prev, cur in zip(tres, tres[1:]):
        if not cur.incremental:
            continue
        for gi, (pg, cg) in enumerate(zip(prev.problem.groups, cur.problem.groups)):
            if gi in cur.dirty_groups and len(pg.pod_names) != len(cg.pod_names):
                assert cg.ledger is not pg.ledger
                assert pg.ledger.pods == len(pg.pod_names)
                seen = True
            elif gi not in cur.dirty_groups:
                assert cg.ledger is pg.ledger
    assert seen


@pytest.mark.parametrize("case", ["relax", "existing", "affinity"])
def test_pass_explanation_equal(case):
    """``explain_pass`` over each package's own CPU plan of the same
    problem: the same audit record (trace id and time given)."""
    docs = []
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        p = _build(pkg, case)
        S = cases.mod(pkg, "solver.solve")
        solver = (S.Solver(p.lattice) if pkg == cases.JAX_PKG
                  else S.Solver(p.lattice, device="cpu"))
        plan = solver.solve(p)
        E = cases.mod(pkg, "solver.explain")
        expl = E.explain_pass(p, plan, 1, "t", 5.0)
        ring = E.DecisionAuditRing(size=4)
        ring.record(expl)
        docs.append((expl.to_doc(full=True), ring.stats()))
    assert docs[0] == docs[1]
