"""Nothing a run loads is JAX or the JAX package, and the plain reference
imports nothing of the program: top-level module names, compared whole."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "karpenter_provider_aws_tpu"}
PORT = "karpenter_provider_aws_tpu_torch"

RUN = """
import json, sys, time, io
sys.path.insert(0, {root!r})
from benchmark import harness
out = harness.run({cell!r}, 5, 0.2, False, time.perf_counter(), device="cpu", log=io.StringIO())
print(json.dumps({{"correct": out["correct"],
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def imported_tops(path: pathlib.Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("cell", ["wave50k.burst", "fleet500.consolidate"])
def test_a_run_loads_nothing_of_jax(checkout, cell):
    proc = subprocess.run([sys.executable, "-c", RUN.format(root=str(checkout), cell=cell)],
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(checkout),
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert PORT in got["top"]
    assert not set(got["top"]) & JAX_SIDE


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert len(files) >= 3
    for f in files:
        assert not imported_tops(f) & (JAX_SIDE | {PORT}), f.name


def test_no_benchmark_file_imports_jax():
    for f in sorted(BENCH.rglob("*.py")):
        assert not imported_tops(f) & JAX_SIDE, f
