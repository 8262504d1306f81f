"""The PyTorch port's CI gates (``karpenter_provider_aws_tpu_torch/tools/
smoke_*.py``) on the CPU: what every gate shares, and the gates whose
summary is wall-clock bound.

Each gate runs as ``python -m karpenter_provider_aws_tpu_torch.tools
.smoke_<name> --device cpu`` in a subprocess, in which jax, the JAX
package and the repository's ``tools/`` modules cannot load
(``run_port``), and must exit 0 with its device line (``tools/gate.py``:
the Solver on ``cpu``, 0 kernel launches, since the CPU takes the plain
version) and its summary line. Where a gate's summary follows from a
FakeClock and seeds alone, the JAX package's own gate
(``tools/smoke_<name>.py`` with ``JAX_PLATFORMS=cpu``) runs beside it and
the two summary lines must be equal (``test_torch_smokes_churn.py``,
``_mesh.py``, ``_chaos.py``).

This file: the introspect and profile gates, run alone (introspect: its
provider count; profile: its samples, folded stacks and overhead, which
are wall-clock derived and so checked by presence only), and the
headroom gate, whose summary follows from its FakeClock and equals the
JAX gate's. Every gate (``tools.gate.GATES``, the port's
``smoke_*.py``) defaults to ``cuda`` and raises without it; every gate's
module constants (sizes, seeds, passes, bounds) equal the reference
gate's.

Tolerance: none (exit codes, lines and constants compare exactly).
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from karpenter_provider_aws_tpu_torch.tools.gate import GATES

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = "karpenter_provider_aws_tpu_torch"
# gates that run no provisioning pass (so launch no kernel on the card)
UNSOLVED = ("headroom",)
GATE_SECONDS = 600
# modules the port's gate process must never load
BLOCKED = ("jax", "karpenter_provider_aws_tpu", "tools", "kpctl", "soak",
           "grpc")


def _run(cmd, env=None):
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=GATE_SECONDS,
                          env={**os.environ, **(env or {})})


def run_port(name):
    """The port's gate ``name`` on the CPU, in a process where jax, the
    JAX package and the repository's tool modules cannot load."""
    code = "\n".join(
        ["import runpy, sys"]
        + [f"sys.modules[{m!r}] = None" for m in BLOCKED]
        + [f"sys.argv = ['smoke_{name}', '--device', 'cpu']",
           f"runpy.run_module('{PORT}.tools.smoke_{name}', "
           "run_name='__main__', alter_sys=True)"])
    return _run([sys.executable, "-c", code])


def run_jax(name):
    """The repository's own gate ``name`` on the JAX package's CPU
    backend."""
    return _run([sys.executable, f"tools/smoke_{name}.py"],
                env={"JAX_PLATFORMS": "cpu"})


def run_both(name):
    """The port's and the JAX package's gate ``name`` at once."""
    with ThreadPoolExecutor(2) as ex:
        port, jax = ex.submit(run_port, name), ex.submit(run_jax, name)
        return port.result(), jax.result()


def summary(proc):
    """The gate's last line: its summary (``... smoke: OK (...)``)."""
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and lines, (
        f"exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
        f"{proc.stderr[-3000:]}")
    return lines[-1]


def check_port(name, proc):
    """The port's gate passed on the CPU: its device line (the Solver on
    ``cpu``, no kernel launch) just before its summary; returns the
    summary."""
    line = summary(proc)
    assert re.search(r"smoke(: |_\w+: )OK \(", line), line
    dev = json.loads(proc.stdout.strip().splitlines()[-2])
    assert dev == {"gate": name, "device": "cpu", "kernel_launches": 0,
                   "solved": name not in UNSOLVED}, dev
    return line


def _module_constants(path):
    """The module-level UPPER_CASE constants of a source file."""
    tree = ast.parse(pathlib.Path(path).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.isupper():
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


@pytest.mark.parametrize("name", ["introspect", "profile"])
def test_gate_passes_on_the_cpu(name):
    line = check_port(name, run_port(name))
    if name == "profile":
        # wall-clock derived: samples, folded stacks, overhead (presence)
        assert re.search(r"\d+ samples, \d+ folded stacks, 4 locks "
                         r"accounted, overhead [\d.]+%", line), line


def test_headroom_summary_equals_the_jax_gates():
    """The queue ranked first to break, its lead time, drops and high
    water, the captures and the kpctl rendering: the FakeClock's alone."""
    port, jax = run_both("headroom")
    assert check_port("headroom", port) == summary(jax)


def test_gates_are_the_references():
    """The port's gates (its ``tools/smoke_*.py``) are the repository's
    twelve, name for name."""
    assert len(GATES) == 12
    assert GATES == tuple(sorted(
        p.stem[len("smoke_"):] for p in (REPO / "tools").glob("smoke_*.py")))


@pytest.mark.parametrize("name", GATES)
def test_gate_defaults_to_cuda_and_raises_without_it(name, monkeypatch):
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"{PORT}.tools.smoke_{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


@pytest.mark.parametrize("name", GATES)
def test_gate_constants_equal_the_reference_gates(name):
    """Sizes, seeds, passes and bounds kept as module constants are the
    reference gate's, value for value; the pool's solve deadline, inline
    in the reference, is the port's ``SOLVE_DEADLINE``."""
    import importlib
    mod = importlib.import_module(f"{PORT}.tools.smoke_{name}")
    ref = _module_constants(REPO / "tools" / f"smoke_{name}.py")
    for key, value in ref.items():
        assert getattr(mod, key) == value, key
    if name == "pool":
        assert "solver_solve_deadline=10.0" in \
            (REPO / "tools" / "smoke_pool.py").read_text()
        assert mod.SOLVE_DEADLINE == 10.0
    if name == "handoff":
        assert (mod.LEASE_DURATION, mod.PROMOTE_SLACK) == (3.0, 20.0)


def test_gate_report_fails_a_card_gate_that_never_launched(capsys):
    """On the card a gate that solved and launched the kernel no time
    fails; one that did not solve, or ran on the CPU, does not."""
    from karpenter_provider_aws_tpu_torch.tools import gate
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cases = [(cuda, True, 0, 1), (cuda, True, 1, 0), (cuda, False, 0, 0),
             (cpu, True, 0, 0)]
    for device, solved, launches, n_failures in cases:
        failures = []
        gate.report("x", device, str(device), failures, solved=solved,
                    kernel_launches=launches)
        assert len(failures) == n_failures, (device, solved, launches)
        assert json.loads(capsys.readouterr().out) == {
            "gate": "x", "device": str(device),
            "kernel_launches": launches, "solved": solved}
