"""Device-mesh planning. Only the boot-time mesh decision is ported
(``mesh.plan_mesh``): the port solves on one device, so every plan it
accepts is the single-device passthrough. The sharded solve, the
sidecar and the solver pool are not ported."""

from .mesh import MeshPlan, plan_mesh

__all__ = ["MeshPlan", "plan_mesh"]
