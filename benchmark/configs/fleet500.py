"""fleet500: cfg4's under-utilized fleet after a scale-down, drawn from a seed.

``draw(cfg, rng)`` returns the fleet as plain data: ``nodes`` (name, type,
zone, capacity type, pool), each drawn as cfg4 draws it (a type of
``node_types``, spot with ``spot_share``, a zone of ``zones``), the
``pods`` on each node (``pods_per_node`` pods of the one shape
``cfg["pod"]``) and the NodePool.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def draw(cfg: Dict, rng: np.random.Generator) -> Dict:
    nodes, pods = [], []
    for i in range(cfg["nodes"]):
        nodes.append({"name": f"node-{i}", "pool": cfg["pool"]["name"],
                      "type": str(rng.choice(cfg["node_types"])),
                      "capacity_type": "spot" if rng.random() < cfg["spot_share"] else "on-demand",
                      "zone": cfg["zones"][int(rng.integers(len(cfg["zones"])))]})
        pods.append([f"p{i}-{j}" for j in range(cfg["pods_per_node"])])
    pod = cfg["pod"]
    shape = {"req": [pod["cpu_m"], pod["memory_mi"], 1, 0, 0], "requirements": []}
    pool = {"name": cfg["pool"]["name"], "weight": cfg["pool"]["weight"],
            "requirements": [(k, op, tuple(v)) for k, op, v in cfg["pool"]["requirements"]]}
    return {"nodes": nodes, "pods": pods, "shape": shape, "pools": [pool]}
