"""The benchmark's command on a card, and its refusal without one."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


# a window long enough for the percentile metrics' ten values (the fleet's
# evaluations take about half a second each)
SECONDS = {"wave50k.burst": 3, "fleet500.consolidate": 8}


def command(cell, trace=0):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", str(2**31 + 7), "--seconds", str(SECONDS[cell]),
                           "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_refuses_without_a_card(no_card):
    proc = command("wave50k.burst")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["wave50k.burst", "fleet500.consolidate"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    proc = command(cell, trace=trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
