"""The port's steady-state reconcile passes against the benchmark's plain
reference, on the CPU: the cell ``steady20k.churn`` at a tiny size.

``benchmark/drivers/steady.py`` drives the port as the cell does (a cold
full build, ``solve`` and a priming ``solve_delta``, then passes of the
seeded churn through ``IncrementalProblemBuilder.build`` and
``Solver.solve_delta``), here 600 pods in 6 shapes over 12 standing nodes,
12 passes, every 4th a no-churn pass, each with the program's tracing on.
For every pass:

- ``benchmark/reference/check.check_plan`` holds the plan to the pass's
  plain problem, replayed from the seed by the plain generator: 0 in every
  number;
- the plan equals a sequential ``Solver.solve`` of the same problem
  (``serde.plan_semantic_dict``);
- what the pass added to the solver's stats reads as the pass implies: the
  microloop served it, a skipped fetch and nothing uploaded on a no-churn
  pass, a fetch and the changed blocks uploaded on a churned one; the
  program's trace holds one ``incremental.build`` span;
- the pod names the step keeps of its plan are the pass's own pods, each
  once.

Then ``steady.check`` over all the passes, and a standing node's
integer ``used`` through ``ExistingBin.used`` and back with no loss.
Tolerance: none.
"""

import json
import pathlib
import sys

import numpy as np
import pytest

from karpenter_provider_aws_tpu_torch import trace
from karpenter_provider_aws_tpu_torch.apis import serde
from karpenter_provider_aws_tpu_torch.apis.resources import RESOURCE_AXES
from karpenter_provider_aws_tpu_torch.solver import Solver

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.drivers import port, steady  # noqa: E402
from benchmark.reference import catalog as rc, check as rcheck  # noqa: E402

BENCH = ROOT / "benchmark"
PASSES = 12
TINY = {"pods": 600, "shapes": 6, "nodes": 12}
SEED = 2**33 + 2026
_RUN = {}


def _env():
    cfg = json.loads((BENCH / "configs" / "steady20k.json").read_text())
    cfg.update(TINY)
    traffic = json.loads((BENCH / "traffic" / "churn.json").read_text())
    traffic.update(warmup_passes=1)
    return {"cfg": cfg, "traffic": traffic, "seed": SEED, "device": "cpu",
            "gen": harness.load_module(BENCH / "configs" / "steady20k.py"),
            "spans": harness.Spans(), "root": ROOT, "base": BENCH, "log": sys.stderr}


def _span_counts(before, after):
    """How many times each of the program's spans ran between two totals."""
    return {name: row["count"] - before["spans"].get(name, {"count": 0})["count"]
            for name, row in after["spans"].items()}


def _run():
    """The passes: (record, problem, sequential plan, the program's spans that
    ran), and ``steady.check``'s verdict."""
    if "passes" not in _RUN:
        tracer = trace.get_tracer()
        saved = (tracer.enabled, tracer.recorder, tracer.clock)
        env = _env()
        try:
            state = steady.setup(env)
            sequential = Solver(state["lattice"], device="cpu", pipeline=False)
            passes = []
            trace.enable()
            for i in range(PASSES):
                before = trace.totals()
                rec = steady.step(state, i)
                ran = _span_counts(before, trace.totals())
                passes.append((rec, state["problem"], sequential.solve(state["problem"]), ran))
            trace.disable()
            steady.release(state)
            _RUN["check"] = steady.check(state, [p[0] for p in passes])
        finally:
            tracer.enabled, tracer.recorder, tracer.clock = saved
        _RUN["passes"], _RUN["env"] = passes, env
    return _RUN


@pytest.mark.parametrize("i", range(PASSES))
def test_pass_matches_the_reference_and_the_sequential_solve(i):
    run = _run()
    rec, _, seq, ran = run["passes"][i]
    env = run["env"]
    assert not rec["failed"] and rec["incremental"] and rec["aborted"] == 0
    cat = rc.load(env["cfg"]["zones"], env["cfg"]["local_zones"])
    replay = steady._backlog(env, cat)
    while replay.passes <= rec["p"]:
        ch = replay.churn()
    plain = replay.problem()
    names = [n for by_shape in plain["pods_by_shape"] for n in by_shape]
    assert len(names) == TINY["pods"]
    assert sorted(n for kept in rec["names"] for n in kept) == sorted(names)
    got = port.plain_plan(rec["plan"], cat, plain)
    assert rcheck.check_plan(cat, plain, got) == dict.fromkeys(rcheck.NUMBERS, 0)
    assert serde.plan_semantic_dict(rec["plan"]) == serde.plan_semantic_dict(seq)
    assert rec["micro"] == 1
    assert ran["incremental.build"] == 1
    if ch["idle"]:
        assert (rec["skipped"], rec["fetched"], rec["upload_bytes"]) == (1, 0, 0)
    else:
        assert (rec["skipped"], rec["fetched"]) == (0, 1)
        assert rec["upload_bytes"] >= 4096       # the changed blocks, one scatter
        assert len(ch["gone"]) == len(ch["added"]) == int(TINY["pods"] * 0.015)


def test_steady_check_holds_every_pass():
    run = _run()
    assert run["check"]["numbers"] == dict.fromkeys(
        ("answers_missing",) + rcheck.NUMBERS, 0)
    assert run["check"]["plans_checked"] == PASSES
    assert run["check"]["cost_vs_ffd"] > 0
    idle = [rec["p"] % 4 == 3 for rec, *_ in run["passes"]]
    assert sum(idle) == PASSES // 4


def test_the_backlog_is_cfg10s():
    """The plain generator, which imports nothing of the port, draws cfg10's
    shapes and counts (``workloads.config10_steady_state``) and its
    standing nodes' types (``SteadyStateChurn``)."""
    from karpenter_provider_aws_tpu_torch.apis.resources import resources_to_vec
    from karpenter_provider_aws_tpu_torch.workloads import (SteadyStateChurn,
                                                            config10_steady_state)
    cfg = json.loads((BENCH / "configs" / "steady20k.json").read_text())
    gen = harness.load_module(BENCH / "configs" / "steady20k.py")
    shapes, counts = gen.draw_shapes(cfg)
    pods, _, want = config10_steady_state()
    assert len(shapes) == len(want) and int(counts.sum()) == len(pods) == cfg["pods"]
    for s, (req, sel) in zip(shapes, want):
        vec = resources_to_vec(req)
        assert s["req"][:2] == [int(vec[0]), int(vec[1])]
        assert {k: v[0] for k, _, v in s["requirements"]} == sel
    cat = rc.load(cfg["zones"], cfg["local_zones"])
    from karpenter_provider_aws_tpu_torch.lattice import build_lattice
    from karpenter_provider_aws_tpu_torch.lattice.realdata import load_catalog
    lat = build_lattice(load_catalog(BENCH / "reference" / "catalog.json",
                                     require_price=True), zones=tuple(cfg["zones"]))
    churn = SteadyStateChurn(lat, pods, want)
    assert ({cat.names[t] for t in gen.node_types(cfg, cat)}
            == {b.instance_type for b in churn.existing})


def test_fixed_passes_are_the_same_on_every_seed():
    """The passes that ``cost_vs_ffd`` prices churn alike on every seed;
    the later ones, and the pods' names, by the seed."""
    runs = []
    for seed in (SEED, SEED + 1):
        env = _env()
        env["seed"] = seed
        backlog = steady._backlog(env, rc.load(env["cfg"]["zones"], env["cfg"]["local_zones"]))
        fixed = backlog.fixed_passes
        assert fixed == 1 + steady.COST_PASSES
        runs.append((backlog, [backlog.churn() for _ in range(fixed + 8)]))
    (a, ca), (b, cb) = runs
    assert a.tag != b.tag and a.nodes == b.nodes
    assert ca[:fixed] == cb[:fixed]
    assert ca[fixed:] != cb[fixed:]
    assert [c["idle"] for c in ca] == [c["idle"] for c in cb]


@pytest.mark.parametrize("t", range(4))
def test_standing_node_used_round_trips(t):
    """A standing node's integer ``used`` (the generator's, 20 % of the
    allocatable rounded down, and after bumps up to the allocatable) lands
    on the lattice's axes exactly, and reads back the same integers."""
    env = _env()
    cat = rc.load(env["cfg"]["zones"], env["cfg"]["local_zones"])
    kind = env["gen"].node_types(env["cfg"], cat)[t]
    used = cat.alloc[kind] * env["cfg"]["node_used_pct"] // 100
    for bumped in (used, used + np.array([250 * 25, 0, 0, 0, 0])):
        vec = steady.bin_used(bumped)
        assert vec.dtype == np.float32 and vec.shape == (len(RESOURCE_AXES),)
        back = np.array([vec[RESOURCE_AXES.index(a)] for a in port.AXES])
        assert (back.astype(np.int64) == bumped).all() and (back == bumped).all()
        others = [j for j, a in enumerate(RESOURCE_AXES) if a not in port.AXES]
        assert not vec[others].any()
