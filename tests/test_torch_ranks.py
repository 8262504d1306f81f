"""The port's mesh on ranks (parallel/ranks.py, one shard per card), on the
CPU: the ranks are worker processes of one ``gloo`` group, and each packs
its own block of shards.

- Mesh planning: blocks, the device of each shard, ``plan_mesh`` and
  ``solver_mesh`` with ranks, and what a Solver refuses.
- The sharded pack on ranks against the JAX package's mesh of as many
  shards, with D not a multiple of W (3 over 2, 5 and 6 over 4): equal
  decode buffers, totals and float32 cost, bit for bit; and the whole
  solve with existing bins, bound pods and the seeded merge: equal plans
  and pack bytes. A group of one rank gives the batched pack's bytes.
- ``test_torch_cases.churn_sequence`` through ``solve_delta`` on ranks
  (8 over 4, 3 over 2): every pass's plan, ``pipeline_stats`` and
  ``link_stats`` equal to the batched mesh's; the resident combined
  buffer reaches the ranks as its delta.
- A killed rank: the solve ends within the group timeout on the
  reference's rungs (a device error, its retry, then the host FFD on the
  CPU; on the card a lost device), its set's other workers go, and the
  next Solver gets fresh ranks. A stalled rank: the same at the group
  timeout. Workers exit when their parent is killed.

Every file that starts ranks ends with none of its workers alive
(``ranks_of_this_file``). Torch runs one thread in every rank. Tolerance:
none.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

from karpenter_provider_aws_tpu_torch.apis import serde
from karpenter_provider_aws_tpu_torch.errors import DeviceLostError
from karpenter_provider_aws_tpu_torch.parallel import mesh as tmesh
from karpenter_provider_aws_tpu_torch.parallel import ranks
from karpenter_provider_aws_tpu_torch.parallel import (plan_mesh,
                                                       solver_mesh)
from karpenter_provider_aws_tpu_torch.solver import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# the ranks a replayed mesh is planned over on the CPU (8 shards: 2 a
# rank; 4 shards: 1 a rank)
RANKS = 4
# the group timeout of the tests' ranks (s)
GROUP_TIMEOUT_S = 30.0


def _gone(pid: int) -> bool:
    """Whether ``pid`` has exited (a zombie waiting for its reaper too)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.fixture(scope="module", autouse=True)
def ranks_of_this_file():
    """The file's rank sets start once (on first use, shared by its
    Solvers), with the tests' group timeout; at the end of the file they
    are closed and none of their workers is alive."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ranks, "GROUP_TIMEOUT_S", GROUP_TIMEOUT_S)
    started = len(ranks._ALL)
    yield
    pids = [pid for rs in ranks._ALL[started:] for pid in rs.pids()]
    ranks.shutdown_all()
    mp.undo()
    assert ranks.live_workers() == []
    assert all(_gone(pid) for pid in pids), pids


def on_ranks(monkeypatch, modules=()):
    """Plan the port's meshes over ``RANKS`` cards on the CPU (the shim of
    the replays: ``plan_mesh("8")`` runs 8 shards on 4 gloo ranks), and
    give each replayed port module ``modules`` a fixture cache of its own
    for this file, so that no mesh cached by another file's replay of the
    same module leaks in or out."""
    monkeypatch.setattr(tmesh, "_visible", lambda device: RANKS)
    for module in modules:
        monkeypatch.setattr(module, "_module_fixtures",
                            _CACHES.setdefault(module.__name__, {}))


_CACHES = {}


def packs_on_ranks() -> int:
    return sum(rs.packs for rs in ranks._ALL)


def sharded_records(obs) -> int:
    return sum(1 for o in obs.get(replay.BUFFERS, ()) if o[0] == "sharded")


# ---- planning ----

def test_blocks_are_contiguous_with_shard0_on_rank0():
    assert tmesh.rank_blocks(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert tmesh.rank_blocks(3, 2) == [(0, 2), (2, 3)]
    assert tmesh.rank_blocks(6, 4) == [(0, 2), (2, 4), (4, 5), (5, 6)]
    assert tmesh.rank_blocks(5, 1) == [(0, 5)]


def test_solver_mesh_places_shards_on_ranks():
    m = solver_mesh(8, device=CPU, ranks=4)
    assert (m.shards, m.ranks, m.group) == (8, 4, True)
    assert list(m.devices) == ["cpu"] * 8 and m.devices.size == 8
    one = solver_mesh(8, device=CPU)
    assert (one.ranks, one.group) == (1, False)
    assert solver_mesh(8, device=CPU, ranks=1, group=True).group
    cuda = tmesh.SolverMesh(shards=6, device=torch.device("cuda", 1),
                            ranks=3)
    assert [str(d) for d in cuda.rank_devices(torch.device("cuda", 1))] \
        == ["cuda:1", "cuda:0", "cuda:2"]
    assert list(cuda.devices) == ["cuda:1", "cuda:1", "cuda:0", "cuda:0",
                                  "cuda:2", "cuda:2"]
    with pytest.raises(ValueError):
        solver_mesh(2, device=CPU, ranks=3)
    with pytest.raises(ValueError):
        tmesh.SolverMesh(shards=4, ranks=0)


def test_plan_mesh_takes_min_of_shards_and_cards(monkeypatch):
    """One card (or the CPU): a forced N keeps W = 1, the batched pack.
    Four cards: 8 shards on 4 ranks, 2 shards on 2; auto stays single."""
    assert plan_mesh("8", device=CPU).mesh.ranks == 1
    assert plan_mesh("8", device=CPU).ranks == 1
    assert plan_mesh("8", device=CPU, ranks=4).ranks == 4
    monkeypatch.setattr(tmesh, "_visible", lambda device: 4)
    assert plan_mesh("8").mesh.ranks == 4 and plan_mesh("8").devices == 8
    assert plan_mesh("2").mesh.ranks == 2
    assert plan_mesh("auto").mesh is None and plan_mesh("auto").ranks == 1
    with pytest.raises(ValueError):
        solver_mesh(8, ranks=5)        # more ranks than cards


def test_solver_refuses_a_mesh_on_more_cards_than_visible(monkeypatch):
    lat = cases.small_lattice(cases.TORCH_PKG)
    s = Solver(lat, device=CPU)
    monkeypatch.setattr(s, "device", torch.device("cuda", 0))
    with pytest.raises(ValueError):
        s._check_mesh(tmesh.SolverMesh(shards=8, ranks=2))


# ---- the pack on ranks against the JAX package's mesh ----

def _jax_and_port_packs(D, W, B=128, G=64):
    """Both packages' sharded pack of one-pod-a-node pods (every bin live
    at its own price) on a mesh of D shards: the port's on W ranks."""
    out = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        A = cases.mod(pkg, "apis")
        O = cases.mod(pkg, "apis.objects")
        wk = cases.mod(pkg, "apis.wellknown")
        P = cases.mod(pkg, "parallel")
        S = cases.mod(pkg, "solver")
        kw = {"device": CPU} if pkg == cases.TORCH_PKG else {}
        lat = cases.family_lattice(pkg, ("m5", "c5", "r5", "m6g", "c6g"))
        rng = np.random.default_rng(2)
        pods = []
        for g in range(40):
            req = {"cpu": f"{int(rng.integers(100, 3000))}m",
                   "memory": f"{int(rng.integers(128, 6000))}Mi"}
            pods += [A.Pod(name=f"g{g}-{i}", labels={"app": "x"},
                           requests=req,
                           pod_affinity=[O.PodAffinityTerm(
                               topology_key=wk.LABEL_HOSTNAME, anti=True,
                               label_selector=(("app", "x"),))])
                     for i in range(30)]
        problem = S.build_problem(pods, [A.NodePool(name="default")], lat)
        solver = S.Solver(lat, **kw)
        count = np.zeros((G,), np.int32)
        count[: problem.G] = problem.count
        mesh = (solver_mesh(D, device=CPU, ranks=W, group=True)
                if pkg == cases.TORCH_PKG else P.plan_mesh(str(D)).mesh)
        sp = P.sharded_pack(mesh, solver._alloc, solver._avail,
                            solver._price, solver._fused_inputs(problem, G),
                            None, 0, P.split_counts(count, D), B, G, lat.T,
                            lat.Z, lat.C, 1, max(problem.A, 1))
        out[pkg] = (replay._host(sp.packed).tobytes(),
                    np.float32(replay._host(sp.total_cost)).tobytes(),
                    int(sp.total_nodes), int(sp.total_leftover))
    return out


@pytest.mark.parametrize("D,W", [(3, 2), (5, 4), (6, 4), (8, 4), (4, 4)])
def test_pack_on_ranks_equal_to_jax(D, W):
    """Decode buffers byte for byte, node and leftover counts and the
    float32 cost bit for bit, D a multiple of W or not; the pack ran on
    the ranks, each rank its own block."""
    packs = packs_on_ranks()
    out = _jax_and_port_packs(D, W)
    assert out[cases.TORCH_PKG] == out[cases.JAX_PKG]
    assert packs_on_ranks() == packs + 1
    rs = ranks.acquire(solver_mesh(D, device=CPU, ranks=W), CPU)
    assert rs.last["shards"] == [hi - lo for lo, hi in tmesh.rank_blocks(D, W)]


def test_group_of_one_rank_gives_the_batched_bytes():
    """``group=True`` at W = 1: a gloo group of one rank runs the whole
    protocol, with the batched pack's bytes."""
    lat = cases.small_lattice(cases.TORCH_PKG)
    prob = cases.problem(cases.TORCH_PKG, "existing")
    plans, bufs = [], []
    for mesh in (plan_mesh("8", device=CPU).mesh,
                 solver_mesh(8, device=CPU, ranks=1, group=True)):
        with replay.recording(cases.TORCH_PKG, plans=True,
                              buffers=True) as made:
            Solver(lat, device=CPU, mesh=mesh).solve(prob)
        plans.append([o for k, o in made if k == replay.PLANS])
        bufs.append([o for k, o in made if k == replay.BUFFERS])
    assert plans[0] == plans[1] and bufs[0] == bufs[1]
    assert any(o[0] == "sharded" for o in bufs[1])
    rs = ranks.acquire(solver_mesh(8, device=CPU, ranks=1, group=True), CPU)
    assert rs.size == 1 and rs.packs >= 1 and rs.pids() == []


@pytest.mark.parametrize("D,W", [(3, 2), (8, 4)])
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sequential", "pipelined"])
def test_seeded_solve_on_ranks_equal_to_jax(D, W, pipeline):
    """About 100 signatures beside six partly used existing nodes, two with
    bound pods that seed affinity classes (existing bins on shard 0, so on
    rank 0): the plan, every sharded pack and every seeded merge equal the
    JAX package's mesh of D shards."""
    import test_torch_waves as waves
    obs = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        lat = cases.small_lattice(pkg)
        problem = waves.wave_inputs(pkg, lat)
        S = cases.mod(pkg, "solver")
        if pkg == cases.TORCH_PKG:
            s = S.Solver(lat, pipeline=pipeline, device=CPU,
                         mesh=solver_mesh(D, device=CPU, ranks=W))
        else:
            s = S.Solver(lat, pipeline=pipeline,
                         mesh=cases.mod(pkg, "parallel").plan_mesh(
                             str(D)).mesh)
        with replay.recording(pkg, plans=True, buffers=True) as made:
            s.solve(problem)
        obs[pkg] = [(k, o) for k, o in made
                    if k in (replay.PLANS, replay.BUFFERS)]
    assert obs[cases.TORCH_PKG] == obs[cases.JAX_PKG]
    assert any(k == replay.BUFFERS and o[0] == "seeded"
               for k, o in obs[cases.TORCH_PKG])


# ---- steady state: churn passes through solve_delta ----

_CHURN = {}


def _drive(solver):
    from karpenter_provider_aws_tpu_torch.solver.incremental import (
        IncrementalProblemBuilder)
    b = IncrementalProblemBuilder(explain=False)
    lat = solver.lattice
    out = []
    for pods, pools, ex, dirty, touched in cases.churn_sequence(
            cases.TORCH_PKG, lat):
        res = b.build(pods, pools, lat, existing=lambda: ex, dirty=dirty,
                      touched=touched)
        if res.incremental:
            plan = solver.solve_delta(res.problem,
                                      dirty_groups=res.dirty_groups)
        else:
            plan = solver.solve(res.problem)
            solver.solve_delta(res.problem)
        out.append((serde.plan_semantic_dict(plan), plan.solver_path,
                    plan.mesh_devices, dict(solver.pipeline_stats),
                    dict(solver.link_stats)))
    return out


def _churn(D, W):
    if (D, W) not in _CHURN:
        lat = cases.small_lattice(cases.TORCH_PKG)
        batched = _drive(Solver(lat, device=CPU,
                                mesh=plan_mesh(str(D), device=CPU).mesh))
        packs = packs_on_ranks()
        s = Solver(lat, device=CPU, mesh=solver_mesh(D, device=CPU,
                                                     ranks=W))
        on_ranks = _drive(s)
        _CHURN[(D, W)] = (batched, on_ranks, packs_on_ranks() - packs,
                          dict(s._ranks.last))
    return _CHURN[(D, W)]


@pytest.mark.parametrize("step", range(15))
@pytest.mark.parametrize("D,W", [(8, 4), (3, 2)])
def test_churn_pass_on_ranks_equal_to_batched(D, W, step):
    """Each pass of the churn sequence: plan, path, shards, the Solver's
    pipeline and link stats (legs and bytes) equal to the batched mesh's
    after the same pass; the packs ran on the ranks."""
    batched, on_ranks, packs, last = _churn(D, W)
    assert len(on_ranks) == len(batched) == 15
    assert on_ranks[step] == batched[step]
    assert on_ranks[step][2] == D
    assert packs == batched[-1][3]["mesh_solves"] > 0
    # the microloop's resident buffer reaches the ranks as its delta
    assert last["resident"] in ("delta", "none")


# ---- a lost rank ----

def _ranked_solver(mesh, **kw):
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock
    return Solver(cases.small_lattice(cases.TORCH_PKG), device=CPU,
                  clock=FakeClock(), mesh=mesh, **kw)


def test_killed_rank_lands_on_the_ladder_within_the_timeout(monkeypatch):
    """A worker killed while a solve waits on it: the solve ends well
    within the group timeout on the reference's rungs (a device error,
    its retry, then the host FFD on the CPU), the set's other workers
    go, the Solver's later solves fail as a lost device on the card, and
    the next Solver gets fresh ranks with the healthy plan."""
    mesh = solver_mesh(8, device=CPU, ranks=4)
    s = _ranked_solver(mesh)
    problem = cases.problem(cases.TORCH_PKG, "random-0")
    healthy = s.solve(problem)
    rs = s._ranks
    assert rs.broken is None and len(rs.live_pids()) == 3
    victim = rs._procs[1]
    wait = ranks.Ranks._wait

    def killing_wait(self, works):
        if self is rs and victim.is_alive():
            os.kill(victim.pid, signal.SIGKILL)
            victim.join(10)
        return wait(self, works)

    monkeypatch.setattr(ranks.Ranks, "_wait", killing_wait)
    t0 = time.monotonic()
    plan = s.solve(problem)
    wall = time.monotonic() - t0
    assert wall < GROUP_TIMEOUT_S / 2, wall
    assert (plan.solver_path, plan.degraded_reason, plan.device_retries) \
        == ("host-ffd", "device-error", 1)
    assert s.degraded_counts == {"device_retry": 1, "host_ffd": 1}
    assert "rank 2" in rs.broken
    assert rs.live_pids() == [] and all(_gone(p) for p in rs.pids())
    host = serde.plan_semantic_dict(s.solve_host_ffd(problem))
    got = serde.plan_semantic_dict(plan)
    provenance = ("degraded", "degradedReason", "warnings")
    assert {k: v for k, v in got.items() if k not in provenance} \
        == {k: v for k, v in host.items() if k not in provenance}
    # on the card the host FFD carries no real device error: the lost
    # rank is a lost device, and the Solver says so
    s._host_ffd_carries_all = False
    with pytest.raises(DeviceLostError):
        s.solve(problem)
    fresh = _ranked_solver(mesh)
    again = fresh.solve(problem)
    assert fresh._ranks is not rs and fresh._ranks.broken is None
    assert serde.plan_semantic_dict(again) == serde.plan_semantic_dict(
        healthy)


def test_stalled_rank_raises_at_the_group_timeout(monkeypatch):
    """A worker stopped (alive, silent) during a solve: the solve gives up
    at the group timeout and lands on the host FFD."""
    monkeypatch.setattr(ranks, "GROUP_TIMEOUT_S", 5.0)
    s = _ranked_solver(solver_mesh(3, device=CPU, ranks=3))
    problem = cases.problem(cases.TORCH_PKG, "generic")
    s.solve(problem)
    rs = s._ranks
    assert rs.timeout == 5.0
    os.kill(rs._procs[0].pid, signal.SIGSTOP)
    t0 = time.monotonic()
    plan = s.solve(problem)
    wall = time.monotonic() - t0
    assert 5.0 <= wall < 5.0 + 10.0, wall
    assert plan.solver_path == "host-ffd"
    # rank 0's deadline or gloo's own, whichever fires first: both are
    # the group's timeout
    assert "timeout" in rs.broken
    assert rs.live_pids() == []


def test_workers_exit_when_their_parent_is_killed(tmp_path):
    """A process that started ranks is killed: its workers, polling their
    parent, exit within a few seconds."""
    code = "\n".join([
        "import sys, time",
        f"sys.path.insert(0, {REPO!r})",
        "import torch",
        "torch.set_num_threads(1)",
        "from karpenter_provider_aws_tpu_torch.parallel import ranks, "
        "solver_mesh",
        "rs = ranks.acquire(solver_mesh(3, device='cpu', ranks=3), "
        "torch.device('cpu'))",
        "print(' '.join(map(str, rs.pids())), flush=True)",
        "time.sleep(300)",
    ])
    child = subprocess.Popen([sys.executable, "-c", code],
                             stdout=subprocess.PIPE, text=True, cwd=tmp_path)
    try:
        pids = [int(p) for p in child.stdout.readline().split()]
        assert len(pids) == 2 and not any(_gone(p) for p in pids)
    finally:
        child.kill()
        child.wait(30)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not all(_gone(p) for p in pids):
        time.sleep(0.1)
    assert all(_gone(p) for p in pids)


def test_workers_import_no_jax():
    """What each worker had imported when it joined the group: the port,
    and nothing of jax or the JAX package."""
    rs = ranks.acquire(solver_mesh(3, device=CPU, ranks=3), CPU)
    assert len(rs.worker_modules) == 2
    for mods in rs.worker_modules:
        assert "karpenter_provider_aws_tpu_torch.parallel.sharded" in mods
        assert "karpenter_provider_aws_tpu_torch.ops.offering_argmin" in mods
        bad = [m for m in mods if m == "jax" or m.startswith("jax.")
               or m == cases.JAX_PKG or m.startswith(cases.JAX_PKG + ".")]
        assert not bad, bad
