"""The one bridge between the benchmark's plain data and the system under test.

Turns a plain problem (``reference/check.py``) into the port's API objects
(``Pod``, ``NodePool``, ``ExistingBin``), and a port ``NodePlan`` or probe
verdict back into plain data, which is what the check judges. The
reference never imports this module.
"""

from __future__ import annotations

from typing import Dict, List

AXES = ("cpu", "memory", "pods", "nvidia.com/gpu", "aws.amazon.com/neuron")

_OPS = {"In": "IN", "Gt": "GT"}


def requests(req) -> Dict[str, object]:
    out = {"cpu": f"{int(req[0])}m", "memory": f"{int(req[1])}Mi"}
    for a, v in zip(AXES[3:], req[3:]):
        if v:
            out[a] = int(v)
    return out


def pods(problem: Dict) -> List:
    from karpenter_provider_aws_tpu_torch.apis import Pod
    out = []
    for shape, names in zip(problem["shapes"], problem["pods_by_shape"]):
        req = requests(shape["req"])
        sel = {k: v[0] for k, _, v in shape["requirements"]}
        out += [Pod(name=n, requests=req, node_selector=sel) for n in names]
    return out


def pools(problem: Dict, **kw) -> List:
    from karpenter_provider_aws_tpu_torch.apis import NodePool, Operator, Requirement
    return [NodePool(name=p["name"], weight=p["weight"], requirements=[
        Requirement(k, getattr(Operator, _OPS[op]), tuple(v))
        for k, op, v in p["requirements"]], **kw) for p in problem["pools"]]


def plain_plan(plan, cat=None, problem=None) -> Dict:
    """The port's plan as a plain plan. ``cat`` and ``problem``, the plain
    catalog and problem that the plan answers, are for a stand-in that
    answers in the port's place (``controls.py``); the port's plan needs
    neither."""
    return {"new_nodes": [{"pool": n.node_pool, "type": n.instance_type, "zone": n.zone,
                           "capacity_type": n.capacity_type, "price": n.price_per_hour,
                           "pods": list(n.pods), "feasible_types": list(n.feasible_types),
                           "feasible_zones": list(n.feasible_zones),
                           "feasible_capacity_types": list(n.feasible_capacity_types)}
                          for n in plan.new_nodes],
            "existing_assignments": {k: list(v) for k, v in plan.existing_assignments.items()},
            "unschedulable": dict(plan.unschedulable),
            "new_node_cost": plan.new_node_cost}


def plain_verdict(probe, removed_price: float, cat=None, problem=None) -> Dict:
    """A batched what-if's ``ProbeResult`` and the removed set's $/hr as a
    plain verdict (``reference/check.py check_verdict``); ``cat`` and
    ``problem`` as for ``plain_plan``."""
    return {"feasible": probe.feasible, "n_new": probe.n_new, "new_cost": probe.new_cost,
            "new_cap_type": probe.new_cap_type, "flex": probe.flex,
            "removed_price": removed_price}
