from .problem import Problem, ExistingBin, build_problem
from .oracle import ffd_oracle, OraclePlan
from .faults import FaultInjector
from .solve import Solver, NodePlan, PlannedNode

__all__ = [
    "Problem", "ExistingBin", "build_problem",
    "ffd_oracle", "OraclePlan",
    "FaultInjector",
    "Solver", "NodePlan", "PlannedNode",
]
