from .problem import Problem, ExistingBin, build_problem
from .oracle import ffd_oracle, OraclePlan
from .solve import Solver, NodePlan, PlannedNode
