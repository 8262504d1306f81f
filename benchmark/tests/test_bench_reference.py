"""The plain reference on hand-worked cases: its catalog, its FFD and the
checks that hold a plan or a verdict to the guarantees."""

import copy
import json

import numpy as np
import pytest

from benchmark.reference import catalog as rc
from benchmark.reference import check, ffd

ZONES = ["us-west-2a", "us-west-2b", "us-west-2c", "us-west-2d", "us-west-2-lax-1a"]
LOCAL = ["us-west-2-lax-1a"]
POD = [1000, 1024, 1, 0, 0]          # 1 cpu, 1 GiB


@pytest.fixture(scope="module")
def full():
    return rc.load(ZONES, LOCAL)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The catalog cut to m5.large and m5.xlarge."""
    doc = json.loads(rc.CATALOG_PATH.read_text())
    doc["types"] = [t for t in doc["types"] if t["name"] in ("m5.large", "m5.xlarge")]
    p = tmp_path_factory.mktemp("cat") / "catalog.json"
    p.write_text(json.dumps(doc))
    return rc.load(ZONES, LOCAL, p)


def wave(n, requirements=()):
    return {"shapes": [{"req": POD, "requirements": list(requirements)}],
            "pools": [{"name": "default", "weight": 0, "requirements": []}],
            "pods_by_shape": [[f"p{i}" for i in range(n)]], "existing": []}


def test_catalog_allocatable_and_offerings(full):
    assert full.T == 759
    m5 = full.index["m5.large"]
    # 8,192 MiB less 7.5 % VM overhead, 11 x 29 + 255 MiB kube-reserved, 100 MiB eviction
    assert list(full.alloc[m5]) == [1930, 6903, 29, 0, 0]
    assert list(full.capacity[m5][:2]) == [2000, 8192]
    # the local zone sells m5 on demand only, at a 20 % premium
    lax = ZONES.index("us-west-2-lax-1a")
    assert full.available[m5, lax, 0] and not full.available[m5, lax, 1]
    assert full.price[m5, lax, 0] == np.float32(round(0.096 * 1.2, 4))
    # metal has no spot; generation 3 and older nothing in zone d
    metal = full.index["m5.metal"]
    assert not full.available[metal, :, 1].any()
    assert not full.available[full.index["m3.medium"], ZONES.index("us-west-2d")].any()
    gpu = full.index["g4dn.xlarge"]
    assert full.alloc[gpu, 3] == 1
    assert full.alloc[full.index["g4ad.xlarge"], 3] == 0     # an AMD GPU is no nvidia.com/gpu


def test_ffd_hand_worked_wave(small):
    """Four 1-cpu pods: m5.xlarge (3,920m) holds three, m5.large (1,930m) one.
    A fresh node opens with both types, takes three, and launches as the
    cheapest type still holding them; the fourth pod opens a node that
    launches as m5.large."""
    plan = ffd.pack(small, wave(4))
    got = [(n["type"], len(n["pods"])) for n in plan["new_nodes"]]
    assert got == [("m5.xlarge", 3), ("m5.large", 1)]
    xl, lg = small.index["m5.xlarge"], small.index["m5.large"]
    want = [small.price[xl][small.available[xl]].min(), small.price[lg][small.available[lg]].min()]
    assert [np.float32(n["price"]) for n in plan["new_nodes"]] == want
    assert plan["new_node_cost"] == float(want[0]) + float(want[1])
    assert check.check_plan(small, wave(4), plan) == dict.fromkeys(check.NUMBERS, 0)


def test_ffd_honours_selectors(full):
    prob = wave(50, [(rc.LABEL_ARCH, "In", ("arm64",)),
                     (rc.LABEL_CAPACITY_TYPE, "In", ("on-demand",))])
    plan = ffd.pack(full, prob)
    assert all(full.labels[full.index[n["type"]]][rc.LABEL_ARCH] == "arm64"
               and n["capacity_type"] == "on-demand" for n in plan["new_nodes"])
    assert check.check_plan(full, prob, plan) == dict.fromkeys(check.NUMBERS, 0)


@pytest.mark.parametrize("fault,number", [
    ("drop", "pods_misplaced"), ("twice", "pods_misplaced"), ("stranger", "pods_misplaced"),
    ("unschedulable", "pods_misplaced"), ("crowd", "nodes_over_allocatable"),
    ("selector", "selector_breaks"), ("pool", "selector_breaks"),
    ("price", "offering_breaks"), ("offering", "offering_breaks"), ("total", "cost_breaks"),
    ("dearer", "cheapest_breaks"), ("outside", "cheapest_breaks"),
    ("flex_type", "flexible_breaks"), ("flex_capacity", "flexible_breaks"),
])
def test_check_plan_counts_each_break(small, fault, number):
    prob = wave(4, [(rc.LABEL_CAPACITY_TYPE, "In", ("on-demand",))])
    plan = copy.deepcopy(ffd.pack(small, prob))
    a, b = plan["new_nodes"]
    if fault == "drop":
        a["pods"].pop()
    elif fault == "twice":
        b["pods"].append(a["pods"][0])
    elif fault == "stranger":
        b["pods"].append("nobody")
    elif fault == "unschedulable":
        plan["unschedulable"][b["pods"].pop()] = "said so"
    elif fault == "crowd":
        b["pods"].append(a["pods"].pop())
    elif fault == "selector":
        a["capacity_type"] = "spot"
        a["price"] = float(small.price[small.index[a["type"]], 0, 1])
        a["zone"] = ZONES[0]
    elif fault == "pool":
        a["pool"] = "elsewhere"
    elif fault == "price":
        a["price"] += 0.001
    elif fault == "offering":
        a["zone"] = "us-east-1a"
    elif fault == "total":
        plan["new_node_cost"] += 0.001
    elif fault == "dearer":               # an available offering, not the cheapest
        lax = ZONES.index("us-west-2-lax-1a")
        a["zone"], a["price"] = ZONES[lax], float(small.price[small.index[a["type"]], lax, 0])
    elif fault == "outside":              # the choice is not in its own flexible sets
        a["feasible_types"] = [t for t in a["feasible_types"] if t != a["type"]]
    elif fault == "flex_type":            # m5.large cannot hold three 1-cpu pods
        a["feasible_types"] = a["feasible_types"] + ["m5.large"]
    elif fault == "flex_capacity":        # the pods ask for on-demand
        a["feasible_capacity_types"] = ["on-demand", "spot"]
    assert check.check_plan(small, prob, plan)[number] >= 1


def test_what_if_and_verdicts(small):
    """Two standing m5.xlarge nodes with two pods each take one more pod
    each (1,920m free); three evictees leave one for a new node."""
    prob = wave(3)
    prob["existing"] = [{"name": f"n{i}", "pool": "default", "type": "m5.xlarge",
                         "zone": ZONES[0], "capacity_type": "on-demand",
                         "used": np.array(POD) * 2} for i in range(2)]
    plan = ffd.pack(small, prob)
    assert plan["existing_assignments"] == {"n0": ["p0"], "n1": ["p1"]}
    assert [len(n["pods"]) for n in plan["new_nodes"]] == [1]
    assert check.check_plan(small, prob, plan) == dict.fromkeys(check.NUMBERS, 0)
    over = copy.deepcopy(plan)
    over["existing_assignments"]["n0"].append(over["new_nodes"].pop()["pods"][0])
    over["new_node_cost"] = 0.0
    assert check.check_plan(small, prob, over)["nodes_over_allocatable"] == 1
    lone = plan["new_nodes"][0]
    assert lone["feasible_types"] == ["m5.large", "m5.xlarge"]
    good = {"feasible": True, "n_new": 1, "new_cost": plan["new_node_cost"],
            "new_cap_type": lone["capacity_type"], "flex": 2, "removed_price": 1.5}
    assert check.check_verdict(small, prob, good, 1.5) == 0
    lg = small.index["m5.large"]
    dearer = float(np.sort(small.price[lg][small.available[lg]])[1])
    other = "on-demand" if lone["capacity_type"] == "spot" else "spot"
    for bad in ({"n_new": 0}, {"feasible": False}, {"removed_price": 1.25},
                {"new_cost": 0.123457}, {"new_cost": dearer}, {"new_cap_type": other},
                {"new_cost": plan["new_node_cost"] / 2, "flex": 1}):
        assert check.check_verdict(small, prob, {**good, **bad}, 1.5) == 1, bad
    # a node that may launch as fewer types than hold its pods launches at
    # the cheapest offering of one of them, at its capacity type
    xl = small.index["m5.xlarge"]
    cell = np.unravel_index(np.argmin(np.where(small.available[xl], small.price[xl], np.inf)),
                            small.available[xl].shape)
    narrowed = {**good, "flex": 1, "new_cost": float(small.price[xl][cell]),
                "new_cap_type": rc.CAPACITY_TYPES[cell[1]]}
    assert check.check_verdict(small, prob, narrowed, 1.5) == 0
    assert check.check_verdict(small, prob, {**narrowed, "new_cost": dearer}, 1.5) == 1
    none = {**good, "n_new": 0, "new_cost": 0.0}
    assert check.check_verdict(small, wave(2) | {"existing": prob["existing"]}, none, 1.5) == 0
    assert check.check_verdict(small, wave(2) | {"existing": prob["existing"]},
                               {**none, "new_cost": 0.01}, 1.5) == 1


def test_control_breaks_allocatable(small):
    """The control, packing to raw capacity, puts two 2-cpu pods on an
    m5.xlarge (4,000m raw, 3,920m allocatable)."""
    prob = wave(4)
    prob["shapes"][0]["req"] = [2000, 1024, 1, 0, 0]
    raw = ffd.pack(small, prob, alloc=small.capacity)
    assert [len(n["pods"]) for n in raw["new_nodes"]] == [2, 2]
    assert check.check_plan(small, prob, raw)["nodes_over_allocatable"] == 2
    assert check.check_plan(small, prob, ffd.pack(small, prob)) == dict.fromkeys(check.NUMBERS, 0)
