"""The PyTorch port's batched what-if probes against the JAX package's, on
the CPU.

``ops/binpack.pack_probe_fused`` runs K consolidation what-if packs in one
batched pass and returns one [K,6] f32 buffer (leftover, n_new, new_cost,
cap_c, flex, overflow). The JAX package builds the fused per-probe buffers
with its own Solver helpers; the port gets the same bytes, each row padded
to a multiple of 16 bytes as the port's ``probe_batch`` pads them.
``Solver.probe_batch`` is compared with the JAX package's on the scenarios
of ``tests/test_solver.py::TestProbeBatch`` and on a K-padding case.

Tolerance: the counts (leftover, n_new, cap_c, flex, overflow) are exact;
``new_cost`` is a float32 sum over bins whose order differs between XLA and
PyTorch, so it is held within 1e-5 relative.

The skip test holds the scan that issues steps for the real groups only
(``n_groups``; the padding rows past them are zero-count no-ops) to the
full-bucket scan and to the JAX package's, byte for byte, in the single
packs' decode buffers and the probe's summary, at one real group in a
bucket of 16, 31 in 32, none, and a probe batch of several counts; and
counts the ``pack.step`` spans the scan issued.

The op-count test guards the batching itself: if ``torch.func.vmap`` met an
op without a batching rule it would loop over the probes and multiply the
launches by K without any error. So a K=8 pack must run the same aten ops
as a K=1 pack over the same (G, B), counted both as the profiler's
top-level ops and as the ops that reach dispatch below the batching layer
(where a fallback loop shows), and the vmap fallback is disabled while the
probe runs in these tests.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from karpenter_provider_aws_tpu.lattice import build_catalog, build_lattice
from karpenter_provider_aws_tpu.ops import binpack as jb
from karpenter_provider_aws_tpu.solver import Solver as JaxSolver
from karpenter_provider_aws_tpu.solver.problem import build_problem as j_build
from karpenter_provider_aws_tpu.solver.solve import _G_BUCKETS, _bucket
from karpenter_provider_aws_tpu_torch import convert, trace
from karpenter_provider_aws_tpu_torch.errors import SolverDeviceError
from karpenter_provider_aws_tpu_torch.ops import binpack as tb
from karpenter_provider_aws_tpu_torch.solver import Solver as TorchSolver
from karpenter_provider_aws_tpu_torch.trace.recorder import FlightRecorder

import test_torch_cases as cases

CPU = "cpu"
REL = 1e-5
COUNT_COLS = ("leftover", "n_new", "cap_c", "flex", "overflow")


@contextlib.contextmanager
def no_vmap_fallback():
    """Any op without a batching rule raises instead of looping over K."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)


def pad_rows(a: np.ndarray, align: int = 16) -> np.ndarray:
    w = -(-a.shape[1] // align) * align
    out = np.zeros((a.shape[0], w), np.uint8)
    out[:, : a.shape[1]] = a
    return out


_SOLVERS = {}


def jax_solver():
    s = _SOLVERS.get("small")
    if s is None:
        s = _SOLVERS["small"] = JaxSolver(cases.small_lattice(cases.JAX_PKG),
                                          pipeline=False)
    return s


def existing_variant(keep):
    """The ``existing`` case with only its first ``keep`` existing bins (so
    the probes of one batch carry different counts of existing bins)."""
    lat, pods, pools, kw = cases.build(cases.JAX_PKG, "existing")
    kw = dict(kw, existing=list(kw["existing"])[:keep])
    kept = {b.name for b in kw["existing"]}
    kw["bound_pods"] = [bp for bp in kw.get("bound_pods", ())
                        if bp.node_name in kept]
    return j_build(pods, pools, lat, **kw)


def fused_batch(problems, B):
    """The JAX package's fused per-probe buffers (unpadded) and the
    batch's buckets."""
    s = jax_solver()
    G = _bucket(max(p.G for p in problems), _G_BUCKETS)
    A = max(max(p.A for p in problems), 1)
    NP = max(max(p.NP for p in problems), 1)
    g = np.stack([s._fused_inputs_np(p, G, A, NP) for p in problems])
    i = (np.stack([s._fused_init_np(p, B, A) for p in problems])
         if any(p.E for p in problems) else None)
    ne = np.array([p.E for p in problems], np.int32)
    return g, i, ne, G, A, NP


def run_jax(problems, B):
    s = jax_solver()
    lat = s.lattice
    g, i, ne, G, A, NP = fused_batch(problems, B)
    out = jb.pack_probe_fused(s._alloc, s._avail, s._price, jnp.asarray(g),
                              None if i is None else jnp.asarray(i),
                              jnp.asarray(ne), B, G, lat.T, lat.Z, lat.C, NP, A)
    return np.asarray(out)


def run_torch(problems, B, n_groups=None):
    lat = jax_solver().lattice
    g, i, ne, G, A, NP = fused_batch(problems, B)
    with no_vmap_fallback():
        out = tb.pack_probe_fused(
            *convert.lattice_tensors(lat, CPU), torch.from_numpy(pad_rows(g)),
            None if i is None else torch.from_numpy(pad_rows(i)),
            torch.from_numpy(ne), B, G, lat.T, lat.Z, lat.C, NP, A,
            n_groups=n_groups)
    return out.numpy()


def assert_summaries_equal(t, j):
    assert t.shape == j.shape and t.dtype == np.float32
    cols = tb.ProbeSummary._fields
    assert cols == jb.ProbeSummary._fields
    for c in COUNT_COLS:
        k = cols.index(c)
        np.testing.assert_array_equal(t[:, k], j[:, k], err_msg=c)
    k = cols.index("new_cost")
    np.testing.assert_allclose(t[:, k], j[:, k], rtol=REL, atol=0.0)


BATCHES = {
    # no existing bins anywhere: the init stack is None
    "no_existing": lambda: [cases.problem(cases.JAX_PKG, c) for c in
                            ("generic", "selectors_taints", "affinity", "relax")],
    # every probe with existing bins, each a different count of them
    "existing_mixed": lambda: [existing_variant(k) for k in (8, 5, 2, 1)],
    # some probes with existing bins and some without
    "existing_and_none": lambda: [
        existing_variant(8), cases.problem(cases.JAX_PKG, "generic"),
        existing_variant(3), cases.problem(cases.JAX_PKG, "anti_wide")],
}


class TestPackProbeFused:
    @pytest.mark.parametrize("batch", sorted(BATCHES))
    def test_summary_equal_to_jax(self, batch):
        problems = BATCHES[batch]()
        ne = [p.E for p in problems]
        if batch == "existing_mixed":
            assert len(set(ne)) == len(ne) and min(ne) > 0
        assert_summaries_equal(run_torch(problems, 512), run_jax(problems, 512))

    def test_overflow_column(self):
        """A bin table too small for the probe: overflow and leftover set
        the same way on both sides."""
        problems = [cases.problem(cases.JAX_PKG, "anti_wide"), existing_variant(8)]
        t, j = run_torch(problems, 32), run_jax(problems, 32)
        assert j[:, tb.ProbeSummary._fields.index("overflow")].any()
        assert_summaries_equal(t, j)

    def test_each_probe_equals_its_single_pack(self):
        """Probe k of the batch equals the summary of a batch of one."""
        problems = BATCHES["existing_and_none"]()
        batch = run_torch(problems, 512)
        g, i, ne, G, A, NP = fused_batch(problems, 512)
        lat = jax_solver().lattice
        for k in range(len(problems)):
            with no_vmap_fallback():
                one = tb.pack_probe_fused(
                    *convert.lattice_tensors(lat, CPU),
                    torch.from_numpy(pad_rows(g[k: k + 1])),
                    torch.from_numpy(pad_rows(i[k: k + 1])),
                    torch.from_numpy(ne[k: k + 1]), 512, G, lat.T, lat.Z,
                    lat.C, NP, A).numpy()
            np.testing.assert_array_equal(one[0], batch[k])


def _one_shape():
    """The ``existing`` case's nodes under its 40 pods of one shape, as a
    consolidation what-if holds them: one real group."""
    lat, pods, pools, kw = cases.build(cases.JAX_PKG, "existing")
    return j_build([p for p in pods if p.name.startswith("p")], pools, lat,
                   **kw)


def _shapes(n):
    """``n`` request shapes, two pods each, one pool: ``n`` real groups."""
    lat = cases.small_lattice(cases.JAX_PKG)
    A = cases.mod(cases.JAX_PKG, "apis")
    pods = [A.Pod(name=f"s{k}-{r}", requests={"cpu": f"{100 * (k + 1)}m",
                                               "memory": "512Mi"})
            for k in range(n) for r in range(2)]
    return j_build(pods, [A.NodePool(name="default")], lat)


def _no_pods():
    """The ``existing`` case's nodes and no pending pod: no real group."""
    lat, _pods, pools, kw = cases.build(cases.JAX_PKG, "existing")
    return j_build([], pools, lat, **kw)


SKIP_CASES = {
    # (problems, their real groups, the bucket G)
    "g1_in_16": lambda: ([_one_shape()], (1,), 16),
    "g31_in_32": lambda: ([_shapes(31)], (31,), 32),
    "g0": lambda: ([_no_pods()], (0,), 16),
    "probe_mixed_g": lambda: ([_one_shape(), cases.problem(cases.JAX_PKG,
                                                           "generic"),
                               _shapes(31), _no_pods()], (1, 4, 31, 0), 32),
}


def _pack_steps(fn):
    """(``fn()``, the ``pack.step`` spans it recorded)."""
    tr = trace.get_tracer()
    saved = (tr.enabled, tr.recorder, tr.clock)
    tr.enable(recorder=FlightRecorder())
    try:
        before = trace.totals()["spans"].get("pack.step", {"count": 0})
        out = fn()
        after = trace.totals()["spans"].get("pack.step", {"count": 0})
    finally:
        tr.enabled, tr.recorder, tr.clock = saved
    return out, after["count"] - before["count"]


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_scan_skips_padding_steps_exactly(case):
    """A scan that issues steps for the real groups alone gives the bytes
    of the full-bucket scan and of the JAX package's pack: each problem's
    lean and full decode buffers (efused, and combined with its bin
    table) and the batch's [K,6] probe summary; and it records one
    ``pack.step`` per real group (per real group of the batch's largest
    problem for the vmapped probe)."""
    problems, real, G_case = SKIP_CASES[case]()
    assert tuple(p.G for p in problems) == real
    s = jax_solver()
    lat = s.lattice
    lt = convert.lattice_tensors(lat, CPU)
    for prob in problems:
        G = _bucket(prob.G, _G_BUCKETS)
        B = s._b_budget_single(prob, G)[1]
        NP, A = max(prob.NP, 1), max(prob.A, 1)
        gbuf = s._fused_inputs_np(prob, G)
        ibuf = s._fused_init_np(prob, B)
        combined = np.concatenate([gbuf, ibuf])
        for lean in (True, False):
            jout = np.asarray(jb.pack_packed_efused(
                s._alloc, s._avail, s._price, jnp.asarray(gbuf),
                jnp.asarray(ibuf), prob.E, B, G, lat.T, lat.Z, lat.C, NP, A,
                lean=lean))
            jcomb = np.asarray(jb.pack_packed_combined(
                s._alloc, s._avail, s._price, jnp.asarray(combined),
                len(gbuf), prob.E, B, G, lat.T, lat.Z, lat.C, NP, A,
                lean=lean))
            for n in (None, prob.G):
                eff, steps = _pack_steps(lambda n=n: tb.pack_packed_efused(
                    *lt, convert.fused_buffer(gbuf, CPU),
                    convert.fused_buffer(ibuf, CPU), prob.E, B, G, lat.T,
                    lat.Z, lat.C, NP, A, lean=lean, n_groups=n))
                assert steps == (G if n is None else prob.G)
                np.testing.assert_array_equal(eff.numpy(), jout)
                comb, steps = _pack_steps(lambda n=n: tb.pack_packed_combined(
                    *lt, convert.fused_buffer(combined, CPU), len(gbuf),
                    prob.E, B, G, lat.T, lat.Z, lat.C, NP, A, lean=lean,
                    n_groups=n))
                assert steps == (G if n is None else prob.G)
                np.testing.assert_array_equal(comb.numpy(), jcomb)
    assert fused_batch(problems, 512)[3] == G_case
    full, steps = _pack_steps(lambda: run_torch(problems, 512))
    assert steps == G_case
    skip, steps = _pack_steps(lambda: run_torch(problems, 512, max(real)))
    assert steps == max(real)
    np.testing.assert_array_equal(skip, full)
    np.testing.assert_array_equal(skip, run_jax(problems, 512))


class _PhysicalOps(TorchDispatchMode):
    """Counts the ops that reach the kernels' dispatch: below vmap's
    batching layer, so an op the batching rules handle counts once and a
    fallback loop counts once per probe."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _issued(event) -> bool:
    """An aten event the code issued itself: no aten event above it, only
    the program's trace ranges (``pack.step``) or nothing."""
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("aten::"):
        parent = parent.cpu_parent
    return parent is None


def _op_counts(fn):
    """(aten ops the code issued, as the profiler's top-level events under
    the program's trace ranges; ops that reached dispatch below the
    batching layer) of one call. The profiler's nested events are left
    out: they are the CPU reductions' own decompositions, which change
    with the output's size and launch nothing by themselves."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _PhysicalOps() as phys:
            fn()
    top = collections.Counter(e.name for e in prof.events()
                              if e.name.startswith("aten::") and _issued(e))
    return top, phys.counts


def _probe_call(K):
    problems = [existing_variant(8)] * K
    lat = jax_solver().lattice
    g, i, ne, G, A, NP = fused_batch(problems, 512)
    args = (*convert.lattice_tensors(lat, CPU), torch.from_numpy(pad_rows(g)),
            torch.from_numpy(pad_rows(i)), torch.from_numpy(ne), 512, G,
            lat.T, lat.Z, lat.C, NP, A)
    return lambda: tb.pack_probe_fused(*args)


def _diff(a, b):
    return {k: (a[k], b[k]) for k in set(a) | set(b) if a[k] != b[k]}


def test_op_count_does_not_grow_with_k():
    with no_vmap_fallback():
        (top1, phys1), (top8, phys8) = (_op_counts(_probe_call(1)),
                                        _op_counts(_probe_call(8)))
    assert sum(top1.values()) > 1000
    assert top1 == top8, _diff(top1, top8)
    assert phys1 == phys8, _diff(phys1, phys8)


def test_op_counter_sees_a_vmap_fallback():
    """The physical-op count is the one that catches a fallback: histc has
    no batching rule, so vmap loops over the batch."""
    fn = lambda x: torch.histc(x, bins=4)  # noqa: E731
    with pytest.warns(UserWarning, match="batching rule"):
        (top1, phys1), (top8, phys8) = (
            _op_counts(lambda: torch.func.vmap(fn)(torch.rand(1, 6))),
            _op_counts(lambda: torch.func.vmap(fn)(torch.rand(8, 6))))
    assert top1 == top8
    assert sum(phys8.values()) > sum(phys1.values())


# ---- Solver.probe_batch against the JAX package's ----

_PB_FAMILIES = ("m5", "c5", "r5", "m6g", "c6g", "g5", "t3")
_PB = {}


def pb_solvers():
    """(jax Solver, port Solver on the CPU) over the lattice of
    ``tests/test_solver.py``."""
    if not _PB:
        jl = build_lattice([s for s in build_catalog() if s.family in _PB_FAMILIES])
        L = cases.mod(cases.TORCH_PKG, "lattice")
        tl = L.build_lattice([s for s in L.build_catalog()
                              if s.family in _PB_FAMILIES])
        _PB["j"] = JaxSolver(jl)
        _PB["t"] = TorchSolver(tl, device=CPU)
    return _PB["j"], _PB["t"]


def _scenarios(pkg, lat):
    """``TestProbeBatch``'s three scenarios, built from ``pkg``'s classes:
    probes that agree with their exact solve (one infeasible), a probe
    that fits on an existing bin, and a spot probe (capacity type and
    flexibility)."""
    A = cases.mod(pkg, "apis")
    wk = cases.mod(pkg, "apis.wellknown")
    P = cases.mod(pkg, "solver.problem")
    R = cases.mod(pkg, "apis.resources").R

    def pods(n, cpu="500m", mem="1Gi", prefix="pod"):
        return [A.Pod(name=f"{prefix}-{i}", requests={"cpu": cpu, "memory": mem})
                for i in range(n)]

    pool = A.NodePool(name="default")
    exact = [P.build_problem(pods(4), [pool], lat),
             P.build_problem(pods(12, cpu="2", mem="4Gi", prefix="big"),
                             [pool], lat),
             P.build_problem([A.Pod(name="huge", requests={"cpu": "10000"})],
                             [pool], lat)]
    existing = [P.ExistingBin(name="n0", node_pool="default",
                              instance_type="m5.4xlarge", zone="us-west-2a",
                              capacity_type="on-demand",
                              used=np.zeros(R, np.float32))]
    on_existing = [P.build_problem(pods(4), [A.NodePool(name="default")], lat,
                                   existing=existing)]
    spot_pool = A.NodePool(name="default", requirements=[
        A.Requirement(wk.LABEL_CAPACITY_TYPE, A.Operator.IN, ("spot",))])
    spot = [P.build_problem(pods(2), [spot_pool], lat)]
    return {"exact": exact, "existing": on_existing, "spot": spot,
            # K=5 pads to the K=8 bucket with repeats of problem 0
            "k_padding": exact + on_existing + [
                P.build_problem(pods(7, cpu="1", mem="3Gi", prefix="mid"),
                                [pool], lat)]}


def _rows(results):
    return [(r.feasible, r.n_new, r.new_cap_type, r.flex) for r in results]


@pytest.mark.parametrize("scenario", ["exact", "existing", "spot", "k_padding"])
def test_probe_batch_equal_to_jax(scenario):
    js, ts = pb_solvers()
    jprobs = _scenarios(cases.JAX_PKG, js.lattice)[scenario]
    tprobs = _scenarios(cases.TORCH_PKG, ts.lattice)[scenario]
    with no_vmap_fallback():
        tres = ts.probe_batch(tprobs)
    jres = js.probe_batch(jprobs)
    assert _rows(tres) == _rows(jres)
    for t, j in zip(tres, jres):
        assert t.new_cost == pytest.approx(j.new_cost, rel=REL, abs=0.0)
    lp = ts.last_probe
    assert lp["K"] == len(tprobs) and lp["summary"].shape == (len(tprobs), 6)
    if scenario == "k_padding":
        assert len(tprobs) == 5 and lp["padded"] == 8
    if scenario == "existing":
        (r,) = tres
        assert r.feasible and r.n_new == 0 and r.new_cost == 0.0
    if scenario == "spot":
        (r,) = tres
        assert r.feasible and r.n_new == 1 and r.new_cap_type == "spot" and r.flex > 0


def test_probe_agrees_with_exact_solve():
    """The port's own contract, as the JAX package's test states it: a
    probe's feasibility, new-node count and cost equal its exact solve's."""
    _, ts = pb_solvers()
    problems = _scenarios(cases.TORCH_PKG, ts.lattice)["k_padding"]
    for pr, problem in zip(ts.probe_batch(problems), problems):
        plan = ts.solve(problem)
        assert pr.feasible == (not plan.unschedulable)
        if pr.feasible:
            assert pr.n_new == len(plan.new_nodes)
            assert pr.new_cost == pytest.approx(plan.new_node_cost, rel=REL)


def test_probe_batch_raises_on_device_error(monkeypatch):
    """No fallback: a failing batched pass surfaces as SolverDeviceError."""
    _, ts = pb_solvers()
    problems = _scenarios(cases.TORCH_PKG, ts.lattice)["spot"]

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tb, "pack_probe_fused", boom)
    with pytest.raises(SolverDeviceError):
        ts.probe_batch(problems)


def test_probe_batch_rejects_bad_batches():
    _, ts = pb_solvers()
    with pytest.raises(ValueError):
        ts.probe_batch([])
    probs = _scenarios(cases.TORCH_PKG, ts.lattice)["spot"]
    with pytest.raises(ValueError):
        ts.probe_batch(probs * (ts._K_BUCKETS[-1] + 1))
