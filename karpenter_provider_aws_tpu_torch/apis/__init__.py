from .resources import RESOURCE_AXES, R, resources_to_vec, resources_to_vec_checked, vec_to_resources
from .requirements import Operator, Requirement, Requirements
from .objects import (
    Taint,
    TaintEffect,
    Toleration,
    tolerates_all,
    TopologySpreadConstraint,
    PodAffinityTerm,
    PreferredRequirement,
    relax_pod,
    relaxation_depth,
    Pod,
    NodePoolDisruption,
    DisruptionBudget,
    NodePool,
    NodeClassSelectorTerm,
    PersistentVolumeClaim,
    StorageClass,
    PodDisruptionBudget,
    NodeClass,
    NodeClaim,
    Node,
)

__all__ = [
    "RESOURCE_AXES", "R", "resources_to_vec", "resources_to_vec_checked", "vec_to_resources",
    "Operator", "Requirement", "Requirements",
    "Taint", "TaintEffect", "Toleration", "tolerates_all",
    "TopologySpreadConstraint", "PodAffinityTerm", "PreferredRequirement",
    "relax_pod", "relaxation_depth", "Pod",
    "NodePoolDisruption", "DisruptionBudget", "NodePool",
    "NodeClassSelectorTerm", "NodeClass", "NodeClaim", "Node",
    "PersistentVolumeClaim", "StorageClass", "PodDisruptionBudget",
]
