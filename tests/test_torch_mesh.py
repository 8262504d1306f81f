"""The PyTorch port's mesh-native Solver against the JAX package's, on the
CPU: the port's 8 (or 4) shards batched on one device against the JAX
package's virtual CPU mesh of as many devices.

- The JAX package's ``tests/test_mesh.py`` (mesh planning, the
  mesh-native Solver: passthrough, engagement, the capped full-dissolve
  problem's byte-identical plan, delta on the mesh, mesh-shape
  invalidation, the retry's and a reprice's memo handling, the per-call
  override; the plan wire, provenance annotation, cost-model key and the
  Operator's gauges) and the three mesh cases of ``tests/test_microloop.py``
  (merge reuse on an unchanged pass, mesh-shape reset, pinned groups
  leaving the microloop) are replayed on both packages by
  ``test_torch_replay``, with every solve's plan and every sharded and
  seeded pack compared (buffers byte for byte), the sidecar's health
  document and a remote solver reporting the sidecar's mesh included. The
  ``kpctl`` case runs the port's kpctl on the port side.
- Every rung of the degradation ladder over an 8-shard mesh (the wave
  split under a group ceiling, a retried device error, the host FFD after
  two, and after bin-table exhaustion) gives the JAX package's plans,
  counts, fired faults and pack buffers.
- Consolidation over a mesh-native Solver: the overprovisioned fleet's
  probes, exact what-ifs and removals, and a co-located fleet's probe
  flagged for the host path, decide as the JAX package's do.
- Existing bins past the bin ceiling on a mesh land on the host FFD with
  the JAX package's nodes; only the reason differs, by design.

Tolerance: none, but the consolidation engine's savings (1e-5 relative,
as ``test_torch_consolidation``).
"""

import dataclasses

import pytest

import test_torch_cases as cases
import test_torch_consolidation as consolidation
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_mesh.py"
NOT_REPLAYED = {}
SHIMS = {FILE: (replay.KPCTL_SHIM,)}
MICRO_FILE = "test_microloop.py"
MICRO_MESH = ["test_microloop.py::TestMicroloopOnMesh::test_mesh_micro_parity_and_merge_reuse",
              "test_microloop.py::TestMicroloopOnMesh::test_mesh_shape_change_resets_micro_state",
              "test_microloop.py::TestMicroloopOnMesh::test_pinned_groups_abort_to_standard_planner"]


def _params(filename, tests):
    return [pytest.param(filename, test_id, params, id=test_id + (
        f"[{','.join(map(str, params.values()))}]" if params else ""))
        for test_id, params in replay.parametrized(filename, tests)]


@pytest.mark.parametrize(
    "filename,test_id,params",
    _params(FILE, replay.replayed(FILE, NOT_REPLAYED))
    + _params(MICRO_FILE, MICRO_MESH))
def test_mesh_equal_to_jax(filename, test_id, params, tmp_path):
    replay.replay(filename, test_id, tmp_path, plans=True, buffers=True,
                  params=params, shims=SHIMS.get(filename, ()))


def test_mesh_replays_cover_the_jax_tests():
    """Every test of test_mesh.py is replayed or named in NOT_REPLAYED, and
    the replayed microloop cases are test_microloop.py's mesh class."""
    names = replay.jax_tests(FILE)
    assert len(names) == 22
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
    micro = [n for n in replay.jax_tests(MICRO_FILE)
             if "::TestMicroloopOnMesh::" in n]
    assert micro == MICRO_MESH


# ---- the degradation ladder over a mesh ----

RUNGS = {
    "wave-split": {"g_limit": None},     # a third of the problem's groups
    "retry": {"device_errors": 1},
    "host-ffd": {"device_errors": 2},
    "b-exhausted": {"b_limit": 32},
}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_ladder_on_mesh_equal_to_jax(rung):
    """Each rung forced by a FaultInjector on an 8-shard mesh-native
    Solver, on the seeded ``random-0`` problem (the wave split at a group
    ceiling of a third of its groups; for the bin table, ``anti_wide``'s
    one-pod nodes doubled to 300, more than 8 shards of 32 bins hold):
    the plans, the Solver's
    ``degraded_counts`` and retries, the faults that fired and every
    sharded and seeded pack equal the JAX package's, sequential and
    pipelined."""
    case = "anti_wide" if rung == "b-exhausted" else "random-0"
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        S = cases.mod(pkg, "solver")
        plan_mesh = cases.mod(pkg, "parallel").plan_mesh
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        lat = cases.small_lattice(pkg)
        problem = cases.problem(pkg, case)
        if rung == "b-exhausted":
            _, pods, pools, extra = cases.build(pkg, case)
            pods = pods + [dataclasses.replace(p, name=p.name + "-2")
                           for p in pods]
            problem = cases.mod(pkg, "solver.problem").build_problem(
                pods, pools, lat, **extra)
        rows = []
        with replay.recording(pkg, plans=True, buffers=True) as made:
            for pipeline in (False, True):
                s = S.Solver(lat, pipeline=pipeline,
                             mesh=plan_mesh("8", **kw).mesh, **kw)
                faults = dict(RUNGS[rung])
                if "g_limit" in faults:
                    faults["g_limit"] = max(1, problem.G // 3)
                s.inject_faults(S.FaultInjector(**faults))
                plan = s.solve(problem)
                rows.append((plan.solver_path, plan.degraded_reason,
                             plan.waves, plan.device_retries,
                             plan.mesh_devices, dict(s.degraded_counts),
                             dict(s.faults.fired),
                             s.stats()["mesh_solves"]))
        out[pkg] = (rows, [(k, o) for k, o in made
                           if k in (replay.PLANS, replay.BUFFERS)])
    (jrows, jmade), (trows, tmade) = out[cases.JAX_PKG], out[cases.TORCH_PKG]
    assert trows == jrows
    assert tmade == jmade
    path = {"wave-split": "wave-split", "retry": "device"}.get(rung, "host-ffd")
    assert trows[0][0] == path


# ---- consolidation over a mesh ----

def _on_mesh(env):
    kw = {"device": "cpu"} if env.pkg == cases.TORCH_PKG else {}
    env.solver.set_mesh(cases.mod(env.pkg, "parallel").plan_mesh(
        "8", **kw).mesh)


def sc_overprovisioned_consolidates_on_mesh(env):
    """The overprovisioned fleet on a mesh-native Solver: the batched
    probes, then passes whose exact what-ifs solve on the mesh."""
    _on_mesh(env)
    consolidation.overprovisioned(env)
    rows = consolidation.probe_rows(env.disruption.engine.probe(
        consolidation.singles(env)))
    for i in range(6):
        env.run_once()
        env.clock.step(2.0)
        env.snap(f"pass {i}")
    assert env.solver.stats()["mesh_solves"] > 0
    return rows


def sc_colocated_probe_flagged_on_mesh(env):
    """A node holding a co-located (hostname self-affinity) group: on a
    mesh its what-if leaves the batched probe for the host path, counted
    in ``host_fallbacks``."""
    _on_mesh(env)
    for i in range(3):
        env.cluster.add_pod(env.A.Pod(
            name=f"aff-{i}", labels={"app": "aff"},
            requests={"cpu": "500m", "memory": "512Mi"},
            pod_affinity=[env.O.PodAffinityTerm(
                topology_key=env.wk.LABEL_HOSTNAME, anti=False,
                label_selector=(("app", "aff"),))]))
    env.settle()
    eng = env.disruption.engine
    v = eng.probe(consolidation.singles(env))
    assert v and all(x.host for x in v)
    assert eng.counters["host_fallbacks"] == len(v)
    return consolidation.probe_rows(v)


@pytest.mark.parametrize("scenario", [sc_overprovisioned_consolidates_on_mesh,
                                      sc_colocated_probe_flagged_on_mesh],
                         ids=["overprovisioned", "colocated"])
def test_consolidation_on_mesh_equal_to_jax(scenario):
    consolidation.replay(scenario, **consolidation.OVERPROVISIONED)


def test_bin_ceiling_below_existing_bins_on_mesh_lands_on_host_ffd():
    """40 existing nodes under an injected ``b_limit`` of 32 on an 8-shard
    mesh: shard 0 cannot hold the existing bins, and both packages plan
    on the host FFD with equal nodes and assignments. The reason differs
    by design (ROADMAP Queue C), as on one device: the port checks the
    bins against the ceiling before it builds anything (``b-exhausted``,
    a rung the card keeps), while the JAX package fails building the
    existing-bin buffer (``internal-error``)."""
    import numpy as np
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat, pods, pools, _ = cases.build(pkg, "anti_wide")
        P = cases.mod(pkg, "solver.problem")
        R = cases.mod(pkg, "apis.resources").R
        existing = [P.ExistingBin(
            name=f"x{i}", node_pool="default", instance_type="m5.xlarge",
            zone=lat.zones[i % lat.Z], capacity_type="on-demand",
            used=np.zeros((R,), np.float32)) for i in range(40)]
        problem = P.build_problem(pods[:10], pools, lat, existing=existing)
        S = cases.mod(pkg, "solver")
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        s = S.Solver(lat, mesh=cases.mod(pkg, "parallel").plan_mesh(
            "8", **kw).mesh, **kw)
        s.inject_faults(S.FaultInjector(b_limit=32))
        plan = s.solve(problem)
        d = cases.mod(pkg, "apis.serde").plan_semantic_dict(plan)
        out[pkg] = ({k: v for k, v in d.items()
                     if k not in ("warnings", "degradedReason")},
                    plan.solver_path, plan.degraded_reason,
                    dict(s.degraded_counts))
    (jd, jpath, jreason, jcounts), (td, tpath, treason, tcounts) = (
        out[cases.JAX_PKG], out[cases.TORCH_PKG])
    assert td == jd
    assert tpath == jpath == "host-ffd"
    assert tcounts == jcounts == {"host_ffd": 1}
    assert (jreason, treason) == ("internal-error", "b-exhausted")
