"""Fixtures of the benchmark's own tests: a checkout of the benchmark in a
temporary directory, its cells cut to a size the CPU runs in seconds."""

import json
import os
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = "karpenter_provider_aws_tpu_torch"

# the cells at a tiny size: a few hundred pods, a dozen nodes
TINY = {
    "wave50k": {"shapes": 6, "pods": 480, "extra_pods": [
        {"name": "gpu", "count": 10, "cpu_m": 4000, "memory_mi": 16384, "nvidia.com/gpu": 1},
        {"name": "neuron", "count": 4, "cpu_m": 4000, "memory_mi": 8192, "aws.amazon.com/neuron": 1}]},
    "fleet500": {"nodes": 12},
}
TINY_TRAFFIC = {"burst": {"warmup_rounds": 1, "trace_steps": 2},
                "consolidate": {"prefix_probes": 4, "single_probes": 4, "warmup_steps": 1,
                                "trace_steps": 2}}
# a fleet too large for one new node to take all its pods, as the full
# fleet is: a what-if then fills standing nodes to their allocatable
MID = {"fleet500": {"nodes": 300}, "wave50k": {"shapes": 12, "pods": 4800}}
MID_TRAFFIC = {"consolidate": {"prefix_probes": 4, "single_probes": 2, "churn_share": 0.02,
                               "warmup_steps": 1}}
# a tiny fleet of m5.large nodes, two pods each: a what-if of a prefix
# past a third of the fleet launches a node for what the rest cannot hold
TIGHT = {"fleet500": {"nodes": 12, "node_types": ["m5.large"], "pods_per_node": 2}}


def _cut(dest: pathlib.Path, configs: dict, traffic: dict) -> None:
    for kind, table in (("configs", configs), ("traffic", traffic)):
        for name, cut in table.items():
            p = dest / BENCH.name / kind / f"{name}.json"
            doc = json.loads(p.read_text())
            doc.update(cut)
            p.write_text(json.dumps(doc, indent=1))


def make_checkout(dest: pathlib.Path, tiny: bool = True) -> pathlib.Path:
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH, dest / BENCH.name,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    os.symlink(ROOT / PORT, dest / PORT)
    if tiny:
        _cut(dest, TINY, TINY_TRAFFIC)
    return dest


def _importable(root: pathlib.Path, monkeypatch) -> pathlib.Path:
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m == BENCH.name or m.startswith(BENCH.name + ".")]:
        monkeypatch.delitem(sys.modules, name)
    return root


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A tiny checkout, importable as ``benchmark`` while the test runs."""
    return _importable(make_checkout(tmp_path / "checkout"), monkeypatch)


@pytest.fixture
def checkout_mid(tmp_path, monkeypatch):
    """The tiny checkout with a 300-node fleet and a 4,800-pod wave."""
    root = make_checkout(tmp_path / "checkout")
    _cut(root, MID, MID_TRAFFIC)
    return _importable(root, monkeypatch)


@pytest.fixture
def checkout_tight(tmp_path, monkeypatch):
    """The tiny checkout with a fleet whose what-ifs launch a node."""
    root = make_checkout(tmp_path / "checkout")
    _cut(root, TIGHT, {})
    return _importable(root, monkeypatch)


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
