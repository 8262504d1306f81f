"""The JAX package's ``tests/test_sharded.py`` replayed with the port's mesh
on ranks: every mesh the port plans on the CPU runs on 4 ``gloo`` ranks
(8 shards, 2 a rank), each a worker process that packs its own block of
shards (parallel/ranks.py), against the JAX package's 8-way virtual CPU
mesh.

Each test replays as ``test_torch_sharded`` replays it
(``test_torch_replay.replay(..., plans=True, buffers=True)``): its own
checks run on both packages, and the plans of every solve, every sharded
pack's split, stacked decode buffers and totals (the float32 cost bit for
bit) and every seeded merge's bytes must be equal. Every replay that
makes a sharded pack makes it on the ranks. The ranks start once for the
file, and none is alive at its end. Tolerance: none.
"""

import pytest

import test_torch_cases as cases
import test_torch_replay as replay
import test_torch_ranks as on
import test_torch_sharded as batched
from test_torch_ranks import ranks_of_this_file  # noqa: F401 (autouse)
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = batched.FILE


@pytest.mark.parametrize("test_id,params", batched._cases())
def test_sharded_on_ranks_equal_to_jax(test_id, params, tmp_path,
                                       monkeypatch):
    on.on_ranks(monkeypatch, [replay.load(FILE, cases.TORCH_PKG)])
    packs = on.packs_on_ranks()
    _, t = replay.replay(FILE, test_id, tmp_path, plans=True, buffers=True,
                         params=params)
    assert on.packs_on_ranks() - packs >= on.sharded_records(t)
