"""The harness end to end on the CPU, each cell at a tiny size: the result
line, and ``correct`` coming out false when the timed path is broken
underneath (the faults each cell can have, and a finalization that picks a
dearer offering than the cheapest)."""

import io
import json
import time

import pytest

CELLS = ("wave50k.burst", "fleet500.consolidate")


def run(root, cell, trace=False, seconds=0.3, seed=2**31 + 12345):
    from benchmark import harness
    log = io.StringIO()
    out = harness.run(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                      root=root, log=log)
    return out, log.getvalue()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(checkout, cell, trace):
    from benchmark import harness
    out, log = run(checkout, cell, trace)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "compared"
    json.dumps(out)
    bench = harness.load_benchmark(checkout)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    # the readers of device numbers find nothing on the CPU, nor a
    # percentile reader in a window of fewer steps than it wants
    traffic = json.loads((checkout / "benchmark" / "traffic"
                          / f"{cell.split('.')[1]}.json").read_text())
    steps = out["attempted"] - (traffic["trace_steps"] if trace else 0)
    absent = {m["name"] for m in bench[kind] if m["source"] == "device_trace"
              or (m["name"][-4:-2] == "_p" and steps < harness.MIN_TAIL)}
    assert set(out["metrics"]) == want - absent
    assert all(v["value"] > 0 for v in out["metrics"].values()
               if not v["unit"] == "ratio")
    lines = log.strip().splitlines()
    assert lines[-len(out["compared"]):] == [
        f"compared {k}: {c['value']} (limit {c['limit']})" for k, c in out["compared"].items()]


def _wave_fault(monkeypatch, fault):
    from karpenter_provider_aws_tpu_torch.solver.solve import Solver
    solve, last = Solver.solve, {}

    def broken(self, problem, mesh=None):
        plan = solve(self, problem, mesh=mesh)
        if fault == "unchanged":          # the step hands back its last state
            plan, last["plan"] = last.get("plan", plan), plan
        elif fault == "half":             # half of the wave left out
            plan.new_nodes = plan.new_nodes[: len(plan.new_nodes) // 2]
            plan.new_node_cost = sum(n.price_per_hour for n in plan.new_nodes)
        elif fault == "altered":          # an answer altered where it is produced
            plan.new_nodes[0].instance_type = "t3.nano"
        return plan
    monkeypatch.setattr(Solver, "solve", broken)


def _fleet_fault(monkeypatch, fault):
    from karpenter_provider_aws_tpu_torch.solver.solve import Solver
    from karpenter_provider_aws_tpu_torch.state.cluster import ClusterState
    probe_batch, solve_relaxed = Solver.probe_batch, Solver.solve_relaxed
    bind = ClusterState.bind_pod
    if fault == "unchanged":              # a bound pod's move leaves the state as it was
        monkeypatch.setattr(ClusterState, "bind_pod", lambda self, pod, node: (
            None if self.pods[pod].node_name else bind(self, pod, node)))

    def broken_probe(self, problems):
        got = probe_batch(self, problems)
        if fault == "half":               # half of the batch left out
            half = len(got) // 2
            got = got[:half] + [type(g)(feasible=g.feasible, n_new=0, new_cost=0.0,
                                        new_cap_type=None, flex=0) for g in got[half:]]
        elif fault == "altered":
            got[0] = type(got[0])(feasible=not got[0].feasible, n_new=got[0].n_new,
                                  new_cost=got[0].new_cost,
                                  new_cap_type=got[0].new_cap_type, flex=got[0].flex)
        return got

    def broken_what_if(self, pods, *a, **kw):
        plan = solve_relaxed(self, pods, *a, **kw)
        if fault == "altered" and plan.existing_assignments:
            name = next(iter(plan.existing_assignments))
            plan.existing_assignments[name] = plan.existing_assignments[name] * 8
        return plan
    monkeypatch.setattr(Solver, "probe_batch", broken_probe)
    monkeypatch.setattr(Solver, "solve_relaxed", broken_what_if)


def _dearer_offering(monkeypatch):
    """The finalization picks each bin's second-cheapest allowed offering,
    where it has two."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import binpack

    def second(tmask, zcmask, price):
        B = tmask.shape[0]
        allowed = tmask.bool()[:, :, None] & zcmask.bool()[:, None, :]
        cost = torch.where(allowed, price[None], torch.full((), float("inf"))).reshape(B, -1)
        vals, idx = torch.topk(cost, 2, dim=1, largest=False)
        pick = torch.isfinite(vals[:, 1:]).long()
        return vals.gather(1, pick)[:, 0], idx.gather(1, pick)[:, 0].to(torch.int32)
    monkeypatch.setattr(binpack, "cheapest_offering", second)


def _root(request, cell, control=False, fault=None):
    """The fleet's faults show once its what-ifs fill standing nodes, a
    dearer offering once they launch a node, and the control once nodes
    fill to their allocatable."""
    if cell.startswith("wave"):
        return request.getfixturevalue("checkout_mid" if control else "checkout")
    return request.getfixturevalue("checkout_tight" if fault == "dearer_offering"
                                   else "checkout_mid")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "dearer_offering"])
def test_broken_path_is_not_correct(request, monkeypatch, cell, fault):
    root = _root(request, cell, fault=fault)
    if fault == "dearer_offering":
        _dearer_offering(monkeypatch)
    else:
        (_wave_fault if cell.startswith("wave") else _fleet_fault)(monkeypatch, fault)
    out, _ = run(root, cell, seconds=0.5)
    assert out["correct"] is False, out["compared"]


def test_tight_fleet_launches_a_node(checkout_tight):
    """The fleet that the dearer offering is planted in is correct when
    sound, and its exact what-ifs launch nodes."""
    from benchmark.drivers import port
    launched = []
    plain_plan = port.plain_plan

    def spy(plan, *a):
        launched.append(len(plan.new_nodes))
        return plain_plan(plan, *a)
    port.plain_plan = spy
    try:
        out, _ = run(checkout_tight, "fleet500.consolidate", seconds=0.5)
    finally:
        port.plain_plan = plain_plan
    assert out["correct"] is True, out["compared"]
    assert launched and min(launched) >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(request, cell):
    root = _root(request, cell, control=True)
    from benchmark import controls, harness
    with controls.raw_capacity():
        out = harness.run(cell, 7, 0.3, False, time.perf_counter(), device="cpu",
                          root=root, log=io.StringIO())
    assert out["correct"] is False, out["compared"]
    assert out["compared"]["nodes_over_allocatable"]["value"] > 0


def test_unmatched_kernels():
    from benchmark import harness
    summary = {"kernel_s": {"argmin": 0.002, "other": 0.0, "idle": 0.0},
               "kernel_bytes": {"argmin": 4096, "other": 512, "idle": 0}}
    assert harness.unmatched_kernels(summary) == ["other"]
    summary["kernel_bytes"]["argmin"] = 0
    assert harness.unmatched_kernels(summary) == ["argmin", "other"]


def test_quantile_of_a_short_window():
    from benchmark import harness
    log = io.StringIO()
    assert harness.quantile(list(range(9)), 90, log) is None
    assert harness.quantile(list(range(1, 101)), 90, log) == pytest.approx(90.1)
    assert log.getvalue() == ""
    assert harness.quantile(list(range(1, 51)), 90, log) == pytest.approx(45.1)
    assert "under 10" in log.getvalue()
