"""Device-mesh planning and the pod-axis sharded solve (``mesh.plan_mesh``,
``sharded.sharded_pack``: D pod shards packed as one batched pass on the
Solver's device, or on ranks, one card each: ``ranks``), and the remote
solver: the sidecar that serves a
resident Solver (``sidecar``), the failover pool of sidecars (``pool``),
over this package's own unary gRPC wire (``rpc``)."""

from .mesh import MeshPlan, SolverMesh, plan_mesh, solver_mesh
from .sharded import (ShardedPack, shard_groups, sharded_pack,
                      split_counts)

__all__ = ["ChaosSidecar", "MeshPlan", "RemoteSolver", "ShardedPack",
           "SidecarProtocolError", "SolverClient", "SolverMesh", "SolverPool",
           "SolverService", "plan_mesh", "serve_sidecar", "shard_groups",
           "solver_mesh", "sharded_pack", "split_counts"]

_SIDECAR = {"ChaosSidecar": "ChaosSidecar", "RemoteSolver": "RemoteSolver",
            "SidecarProtocolError": "SidecarProtocolError",
            "SolverClient": "SolverClient", "SolverService": "SolverService",
            "serve_sidecar": "serve"}


def __getattr__(name):
    # lazy: the sidecar and the pool import solver/solve.py, which imports
    # this package for the mesh
    if name in _SIDECAR:
        from . import sidecar
        return getattr(sidecar, _SIDECAR[name])
    if name == "SolverPool":
        from .pool import SolverPool
        return SolverPool
    raise AttributeError(name)
