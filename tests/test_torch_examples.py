"""The JAX package's ``tests/test_examples.py`` replayed whole on both
packages, on the CPU.

On the port side ``kpctl`` is this package's (``karpenter_provider_aws_
tpu_torch/tools/kpctl.py``), so its document loader (what ``kpctl apply
-f`` runs) reads every ``examples/*.yaml``; each document then passes the
port's admission chain (schema and webhooks) on the port's apiserver, and
the general-purpose and spot examples schedule through the port's
Operator (on the CPU). Each test's own checks run on both packages, and
the two must make the same Operators, clouds, apiservers and metric
series (``test_torch_replay``).
"""

import pathlib

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_examples.py"
NOT_REPLAYED = {}
SHIMS = (
    ("import kpctl  # noqa: E402",
     "from karpenter_provider_aws_tpu_torch.tools import kpctl  # noqa: E402"),
)
CASES = replay.parametrized(FILE, replay.replayed(FILE, NOT_REPLAYED))


def _case_id(test_id, params):
    return test_id + "".join(f"[{v.name}]" for v in params.values()
                             if isinstance(v, pathlib.Path))


@pytest.mark.parametrize("test_id,params", CASES,
                         ids=[_case_id(t, p) for t, p in CASES])
def test_examples_equal_to_jax(test_id, params, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS, params=params)


def test_examples_replays_cover_the_jax_tests():
    """Every test of test_examples.py is replayed, the admission test once
    per shipped example."""
    names = replay.jax_tests(FILE)
    assert len(names) == 4
    assert set(replay.replayed(FILE, NOT_REPLAYED)) == set(names)
    repo = pathlib.Path(__file__).resolve().parent.parent
    examples = sorted((repo / "examples").rglob("*.yaml"))
    admitted = [p["path"] for t, p in CASES
                if t.endswith("test_example_passes_admission")]
    assert admitted == examples and len(examples) > 0
