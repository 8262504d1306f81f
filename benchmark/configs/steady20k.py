"""steady20k: cfg10's steady-state reconcile deployment, drawn from a seed.

``Backlog(cfg, traffic, cat, seed)`` holds the cluster as plain data (see
``reference/check.py``) and changes it pass by pass:

- the pending pods: ``cfg["shapes"]`` shapes, cpu and memory from the
  config's lists and, with the selector's share, one instance-category
  selector each, and ``cfg["pods"]`` pods spread over them by a
  multinomial draw, drawn as ``workloads.config10_steady_state`` draws
  them, from the fixed draw ``cfg["shape_draw"]``;
- the standing nodes: ``cfg["nodes"]`` on-demand nodes of the
  ``cfg["node_types"]`` cheapest types (by on-demand price in ``cat``)
  with no accelerator and at least ``cfg["node_min_cpu_m"]`` of cpu, each
  in a zone that offers its type on demand, with ``used`` the config's
  share of its allocatable, rounded down, as cfg10's ``SteadyStateChurn``
  draws them, from the fixed draw ``cfg["node_draw"]``;
- ``churn()``, one pass: unless it is a no-churn pass (every
  ``traffic["nochurn_every"]``-th), ``churn_share`` of the pending pods
  leave, as many arrive, each of a shape drawn from all of them, and
  ``bumped_nodes`` standing nodes that still have ``bump_cpu_m`` of cpu
  free gain it in ``used``.

The first ``fixed_passes`` passes churn by the traffic's fixed draw
``traffic["churn_draw"]``, so every seed plans the same problems there;
the later passes churn by the run's seed. The seed also draws the pods'
names, so two runs never share one. Two backlogs of one seed go through
the same passes, so the check replays a run's passes without the
program. Imports nothing but NumPy and the standard library.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

AXES = ("cpu", "memory", "pods", "nvidia.com/gpu", "aws.amazon.com/neuron")
LABEL_GPU_COUNT = "karpenter.k8s.aws/instance-gpu-count"
ON_DEMAND = 0           # the catalog's capacity-type index of on-demand


def draw_shapes(cfg: Dict):
    """The shapes and their pod counts, in cfg10's order of draws."""
    rng = np.random.default_rng(cfg["shape_draw"])
    sel = cfg["selector"]
    shapes = []
    for _ in range(cfg["shapes"]):
        cpu = int(rng.choice(cfg["cpu_m"]))
        mem = int(rng.choice(cfg["memory_mi"]))
        reqs = ([(sel["key"], "In", (str(rng.choice(sel["values"])),))]
                if rng.random() < sel["share"] else [])
        shapes.append({"req": [cpu, mem, 1, 0, 0], "requirements": reqs})
    counts = rng.multinomial(cfg["pods"], np.ones(cfg["shapes"]) / cfg["shapes"])
    return shapes, counts


def node_types(cfg: Dict, cat) -> List[int]:
    """The catalog indices of the standing nodes' types, cheapest first."""
    od = np.where(cat.available[:, :, ON_DEMAND], cat.price[:, :, ON_DEMAND], np.inf).min(axis=1)
    plain = np.array([lab.get(LABEL_GPU_COUNT, "0") == "0" for lab in cat.labels])
    ok = (plain & (cat.alloc[:, 3:] == 0).all(axis=1) & np.isfinite(od)
          & (cat.capacity[:, 0] >= cfg["node_min_cpu_m"]))
    idx = np.nonzero(ok)[0]
    return [int(i) for i in idx[np.argsort(od[idx], kind="stable")][:cfg["node_types"]]]


class Backlog:
    def __init__(self, cfg: Dict, traffic: Dict, cat, seed: int, fixed_passes: int = 0):
        self.traffic = traffic
        self.tag = f"{int(np.random.default_rng(seed).integers(1 << 32)):08x}-"
        self.shapes, counts = draw_shapes(cfg)
        self.pools = [{"name": cfg["pool"]["name"], "weight": cfg["pool"]["weight"],
                       "requirements": [(k, op, tuple(v))
                                        for k, op, v in cfg["pool"]["requirements"]]}]
        self.shape = np.repeat(np.arange(len(self.shapes)), counts)
        self.serial = np.arange(len(self.shape))
        self.next_serial = len(self.shape)
        types = node_types(cfg, cat)
        rng = np.random.default_rng(cfg["node_draw"])
        self.nodes, used = [], []
        for i in range(cfg["nodes"]):
            t = types[int(rng.integers(len(types)))]
            zones = np.nonzero(cat.available[t, :, ON_DEMAND])[0]
            z = int(zones[int(rng.integers(len(zones)))])
            self.nodes.append({"name": f"node-{i}", "pool": cfg["pool"]["name"],
                               "type": cat.names[t], "zone": cat.zones[z],
                               "capacity_type": "on-demand"})
            used.append(cat.alloc[t] * cfg["node_used_pct"] // 100)
        self.used = np.array(used, np.int64).reshape(-1, len(AXES))
        self.cpu_alloc = np.array([cat.alloc[cat.index[n["type"]], 0] for n in self.nodes])
        self.fixed_rng = np.random.default_rng(traffic["churn_draw"])
        self.fixed_passes = fixed_passes
        self.rng = np.random.default_rng([seed, 1])
        self.passes = 0

    def name(self, serial) -> str:
        return f"{self.tag}{int(serial)}"

    def churn(self) -> Dict:
        """One pass: ``idle`` (a no-churn pass), the serials that left
        (``gone``), the ``(serial, shape)`` of each arrival (``added``) and
        the nodes whose ``used`` grew (``bumped``)."""
        tr = self.traffic
        every = int(tr["nochurn_every"])
        p, self.passes = self.passes, self.passes + 1
        rng = self.fixed_rng if p < self.fixed_passes else self.rng
        if every and p % every == every - 1:
            return {"idle": True, "gone": [], "added": [], "bumped": []}
        n = len(self.serial)
        k = max(1, int(n * tr["churn_share"]))
        gone = rng.choice(n, size=k, replace=False)
        keep = np.ones(n, bool)
        keep[gone] = False
        gone_serials = self.serial[gone]
        new_serials = np.arange(self.next_serial, self.next_serial + k)
        new_shapes = rng.integers(len(self.shapes), size=k)
        self.next_serial += k
        self.serial = np.concatenate([self.serial[keep], new_serials])
        self.shape = np.concatenate([self.shape[keep], new_shapes])
        bump = int(tr["bump_cpu_m"])
        room = np.nonzero(self.used[:, 0] + bump <= self.cpu_alloc)[0]
        bumped = (rng.choice(room, size=min(int(tr["bumped_nodes"]), len(room)), replace=False)
                  if len(room) else np.zeros(0, np.int64))
        self.used[bumped, 0] += bump
        return {"idle": False, "gone": gone_serials.tolist(),
                "added": list(zip(new_serials.tolist(), new_shapes.tolist())),
                "bumped": bumped.tolist()}

    def problem(self) -> Dict:
        """The pass's plain problem: the pending pods, the pool and the
        standing nodes with their ``used``."""
        by_shape: List[List[str]] = [[] for _ in self.shapes]
        for serial, s in zip(self.serial.tolist(), self.shape.tolist()):
            by_shape[s].append(f"{self.tag}{serial}")
        return {"shapes": self.shapes, "pools": self.pools, "pods_by_shape": by_shape,
                "existing": [{**n, "used": self.used[i].copy()}
                             for i, n in enumerate(self.nodes)]}
