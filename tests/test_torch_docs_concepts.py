"""The JAX package's ``tests/test_docs_concepts.py`` replayed whole on
both packages, on the CPU.

The concept docs (``docs/concepts/``, ``docs/getting-started.md`` and the
task pages) cite constants, metric names, CLI flags, event reasons and
kpctl subcommands; on the port side each is checked against the port:
its modules and sources (the test reads ``karpenter_provider_aws_tpu/
<module>.py`` by path, which the replay points at the port's file), its
bench (``karpenter_provider_aws_tpu_torch/bench.py``) and its kpctl.
Each test's own checks run on both packages (``test_torch_replay``).
A fact the port states differently by design would be named in
``NOT_REPLAYED`` as a ``seam`` with its reason: none is.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_docs_concepts.py"
NOT_REPLAYED = {}
SHIMS = (
    ("        import bench\n",
     "        from karpenter_provider_aws_tpu_torch import bench\n"),
    ('tools = DOCS.parent.parent / "tools" / "kpctl.py"',
     'tools = DOCS.parent.parent / "karpenter_provider_aws_tpu_torch" / '
     '"tools" / "kpctl.py"'),
    ('src = (DOCS.parent.parent / "tools" / "kompat.py").read_text()',
     'src = (DOCS.parent.parent / "karpenter_provider_aws_tpu_torch" / '
     '"tools" / "kompat.py").read_text()'),
)
CASES = replay.parametrized(FILE, replay.replayed(FILE, NOT_REPLAYED))


@pytest.mark.parametrize("test_id,params", CASES,
                         ids=[replay.case_id(t, p) for t, p in CASES])
def test_docs_concepts_equal_to_jax(test_id, params, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS, params=params)


def test_docs_concepts_replays_cover_the_jax_tests():
    """Every test of test_docs_concepts.py is replayed (none left out)."""
    names = replay.jax_tests(FILE)
    assert len(names) == 67
    assert set(replay.replayed(FILE, NOT_REPLAYED)) == set(names)
