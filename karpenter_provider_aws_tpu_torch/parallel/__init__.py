"""Device-mesh planning and the pod-axis sharded solve: the boot-time mesh
decision (``mesh.plan_mesh``) and D pod shards packed as one batched pass
on the Solver's device (``sharded.sharded_pack``). The solver sidecar
and the solver pool are not ported: their names raise, naming ROADMAP.md
A11."""

from .mesh import MeshPlan, SolverMesh, plan_mesh, solver_mesh
from .sharded import (ShardedPack, shard_groups, sharded_pack,
                      split_counts)

__all__ = ["MeshPlan", "ShardedPack", "SolverMesh", "plan_mesh",
           "shard_groups", "solver_mesh", "sharded_pack", "split_counts"]

_NOT_PORTED = ("ChaosSidecar", "RemoteSolver", "SidecarProtocolError",
               "SolverClient", "SolverPool", "SolverService",
               "serve_sidecar")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"parallel.{name} is not ported to this package (ROADMAP.md "
            "A11: the solver sidecar and pool)")
    raise AttributeError(name)
