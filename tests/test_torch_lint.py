"""The JAX package's ``tests/test_lint.py`` replayed whole on both
packages, on the CPU.

On the port side the lint suite is this package's own copy
(``karpenter_provider_aws_tpu_torch/tools/lint/``): the same seven rules,
with ``PACKAGE`` naming the port, over the port's tree against its own
baseline; ``kpctl`` is the port's. So every fixture of the rules, the
baseline round-trip, the standing gate (the whole port package lints
clean against its baseline, of at most 10 reasoned entries), the
scratch-violation pins and the runtime lock-order witness run on each
package with the test's own checks, and the two must make the same
Operators, clouds and metric series (``test_torch_replay``).
``test_port_baseline_entries_each_have_a_reason_and_a_violation`` pins
the port's baseline entry by entry.
"""

import json
import pathlib

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
FILE = "test_lint.py"
NOT_REPLAYED = {}
_LINT = "karpenter_provider_aws_tpu_torch.tools.lint"
SHIMS = (
    ("from lint import baseline as baseline_mod",
     f"from {_LINT} import baseline as baseline_mod"),
    ("from lint.rules import (", f"from {_LINT}.rules import ("),
    ("from lint.run import run_checks", f"from {_LINT}.run import run_checks"),
    ("import lint.run as lint_run", f"import {_LINT}.run as lint_run"),
    ('REPO / "tools" / "lint" / "baseline.json"',
     'REPO / "karpenter_provider_aws_tpu_torch" / "tools" / "lint" / '
     '"baseline.json"'),
    ('baseline_mod.load(REPO / "tools" / "lint" /',
     'baseline_mod.load(REPO / "karpenter_provider_aws_tpu_torch" / '
     '"tools" / "lint" /'),
    ("        import kpctl\n",
     "        from karpenter_provider_aws_tpu_torch.tools import kpctl\n"),
)
CASES = replay.parametrized(FILE, replay.replayed(FILE, NOT_REPLAYED))

# the port's baseline: (file under the package, call) of each entry
PORT_BASELINE = {
    ("cli.py", "time.monotonic"), ("debug.py", "time.time"),
    ("introspect/__init__.py", "time.time"),
    ("cloud/fake.py", "deque(maxlen)"),
    ("tools/soak.py", "time.monotonic"), ("tools/soak.py", "time.sleep"),
    ("tools/profile_run.py", "time.monotonic"),
    ("tools/profile_run.py", "time.sleep"),
}


@pytest.mark.parametrize("test_id,params", CASES,
                         ids=[replay.case_id(t, p) for t, p in CASES])
def test_lint_equal_to_jax(test_id, params, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS, params=params)


def test_lint_replays_cover_the_jax_tests():
    """Every test of test_lint.py is replayed (none left out)."""
    names = replay.jax_tests(FILE)
    assert len(names) == 59
    assert set(replay.replayed(FILE, NOT_REPLAYED)) == set(names)


def test_port_baseline_entries_each_have_a_reason_and_a_violation():
    """The port's baseline holds exactly the four sites the JAX package
    baselines (under the port's paths) and the two wall-clock tools
    inside the package, soak and profile_run; each has a reason and
    still matches a live violation, and nothing else is baselined."""
    from karpenter_provider_aws_tpu_torch.tools.lint import baseline, run
    path = (REPO / "karpenter_provider_aws_tpu_torch" / "tools" / "lint"
            / "baseline.json")
    entries = baseline.load(path)
    pkg = "karpenter_provider_aws_tpu_torch/"
    assert {(e["file"][len(pkg):], e["call"]) for e in entries} \
        == PORT_BASELINE
    assert all(e["file"].startswith(pkg) for e in entries)
    assert all(str(e["reason"]).strip() for e in entries)
    violations, errors = run.run_checks(REPO)
    assert errors == []
    un, used, stale = baseline.apply(violations, entries)
    assert un == [] and stale == []
    jax_entries = json.loads((REPO / "tools" / "lint" / "baseline.json")
                             .read_text())["entries"]
    assert {(e["rule"], e["file"].split("/", 1)[1], e["call"])
            for e in jax_entries} <= {(e["rule"], e["file"][len(pkg):],
                                       e["call"]) for e in entries}


def test_port_runner_checks_the_whole_port_package(capsys):
    """``python -m karpenter_provider_aws_tpu_torch.tools.lint.run
    --check`` scans every module of the port package, its tools
    included, and exits 0."""
    from karpenter_provider_aws_tpu_torch.tools.lint import run
    port = REPO / "karpenter_provider_aws_tpu_torch"
    mods = [p for p in port.rglob("*.py") if "__pycache__" not in p.parts]
    assert run.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert f"graftlint: {len(mods)} modules" in out and "clean" in out
    rels = {rel for _, rel in run.iter_modules(REPO)}
    assert "karpenter_provider_aws_tpu_torch/tools/soak.py" in rels
    assert not any(r.startswith("karpenter_provider_aws_tpu/") for r in rels)
