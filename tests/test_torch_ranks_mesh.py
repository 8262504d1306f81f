"""The JAX package's ``tests/test_mesh.py`` and the three mesh cases of
``tests/test_microloop.py`` replayed with the port's mesh on ranks: every
mesh the port plans on the CPU runs on 4 ``gloo`` ranks (8 shards, 2 a
rank; 4 shards, 1 a rank), each a worker process that packs its own block
of shards (parallel/ranks.py), against the JAX package's virtual CPU mesh
of as many devices.

Each test replays as ``test_torch_mesh`` replays it (plans of every solve,
every sharded and seeded pack byte for byte, the float32 totals, the
Operator's and the sidecar's surfaces, kpctl on the port side). The
microloop cases run the resident combined buffer's delta out to the
ranks, and their link legs, fetches and merge reuse equal the JAX
package's. Every replay that makes a sharded pack makes it on the ranks.
The ranks start once for the file, and none is alive at its end.
Tolerance: none.
"""

import pytest

import test_torch_cases as cases
import test_torch_mesh as batched
import test_torch_ranks as on
import test_torch_replay as replay
from test_torch_ranks import ranks_of_this_file  # noqa: F401 (autouse)
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize(
    "filename,test_id,params",
    batched._params(batched.FILE, replay.replayed(batched.FILE,
                                                  batched.NOT_REPLAYED))
    + batched._params(batched.MICRO_FILE, batched.MICRO_MESH))
def test_mesh_on_ranks_equal_to_jax(filename, test_id, params, tmp_path,
                                    monkeypatch):
    shims = batched.SHIMS.get(filename, ())
    on.on_ranks(monkeypatch, [replay.load(filename, cases.TORCH_PKG, (),
                                          shims)])
    packs = on.packs_on_ranks()
    _, t = replay.replay(filename, test_id, tmp_path, plans=True,
                         buffers=True, params=params, shims=shims)
    assert on.packs_on_ranks() - packs >= on.sharded_records(t)
