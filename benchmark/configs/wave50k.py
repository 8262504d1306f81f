"""wave50k: cfg5's north-star wave, drawn from a seed.

``draw(cfg, rng, tag)`` returns one wave as plain data (see
``reference/check.py``): the shapes of ``cfg["shapes"]`` pods with cpu and
memory from the config's lists and, by the config's shares, one node
selector each; ``cfg["pods"]`` pods spread over them by a multinomial draw;
then the config's extra pods (one GPU, one Neuron device each); and the
config's NodePools. Pod names start with ``tag``, so two waves never share
a pod.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

AXES = ("cpu", "memory", "pods", "nvidia.com/gpu", "aws.amazon.com/neuron")


def _req(cpu_m: int, memory_mi: int, extra: Dict) -> list:
    return [int(cpu_m), int(memory_mi), 1] + [int(extra.get(a, 0)) for a in AXES[3:]]


def draw(cfg: Dict, rng: np.random.Generator, tag: str) -> Dict:
    shapes = []
    for _ in range(cfg["shapes"]):
        cpu = int(rng.choice(cfg["cpu_m"]))
        mem = int(rng.choice(cfg["memory_mi"]))
        r, lo, reqs = rng.random(), 0.0, []
        for sel in cfg["selectors"]:
            if lo <= r < lo + sel["share"]:
                value = (str(rng.choice(sel["values"])) if len(sel["values"]) > 1
                         else sel["values"][0])
                reqs = [(sel["key"], "In", (value,))]
                break
            lo += sel["share"]
        shapes.append({"req": _req(cpu, mem, {}), "requirements": reqs})
    counts = rng.multinomial(cfg["pods"], np.ones(cfg["shapes"]) / cfg["shapes"])
    pods_by_shape = [[f"{tag}s{s}-{i}" for i in range(int(n))]
                     for s, n in enumerate(counts)]
    for extra in cfg["extra_pods"]:
        shapes.append({"req": _req(extra["cpu_m"], extra["memory_mi"], extra),
                       "requirements": []})
        pods_by_shape.append([f"{tag}{extra['name']}-{i}" for i in range(extra["count"])])
    pools = [{"name": p["name"], "weight": p["weight"],
              "requirements": [(k, op, tuple(v)) for k, op, v in p["requirements"]]}
             for p in cfg["pools"]]
    return {"shapes": shapes, "pools": pools, "pods_by_shape": pods_by_shape,
            "existing": []}
