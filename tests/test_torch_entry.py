"""The port's entry module (``karpenter_provider_aws_tpu_torch/entry.py``)
against the repository's ``__graft_entry__.py``, on the CPU.

``entry()``: the same tiny problem's tensors through the port's
``ops.binpack.pack`` (its ``_finalize`` calls the cheapest-offering
kernel's wrapper once, the plain version on the CPU) equal the JAX
entry's pack, field for field (no tolerance). ``dryrun_multichip(8)``:
every solve of the port's run (meshes of 2, 4 and 8 shards batched on
the CPU, the overflow retry on the 8-shard mesh) plans as the JAX
package's run on the 8-device virtual CPU mesh of ``tests/conftest.py``
(``serde.plan_semantic_dict``, exact), and its probe batch answers the
same.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

from karpenter_provider_aws_tpu_torch import entry
from karpenter_provider_aws_tpu_torch.ops import binpack

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import __graft_entry__ as jax_entry  # noqa: E402

PROBE_FIELDS = ("feasible", "n_new", "new_cost", "new_cap_type", "flex")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_entry_fn_equals_jax_entry(monkeypatch):
    jfn, jargs = jax_entry.entry()
    jout = jfn(*jargs)
    fn, args = entry.entry(device="cpu")
    tensors = [t for a in args
               for t in ((a,) if isinstance(a, torch.Tensor) else a)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    calls = []
    orig = binpack.cheapest_offering

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(binpack, "cheapest_offering", counted)
    out = fn(*args)
    assert len(calls) == 1, "one cheapest-offering call per pack"
    for name in ("assign", "leftover", "chosen_t", "chosen_z", "chosen_c",
                 "chosen_price"):
        np.testing.assert_array_equal(_np(getattr(out, name)),
                                      _np(getattr(jout, name)), err_msg=name)
    for name in jout.state._fields:
        np.testing.assert_array_equal(_np(getattr(out.state, name)),
                                      _np(getattr(jout.state, name)),
                                      err_msg=f"state.{name}")
    assert int(out.state.npods.sum()) == 36


def _dryrun(pkg, run):
    """(plans of every solve, probe answers) of one package's dryrun."""
    solver_cls = cases.mod(pkg, "solver.solve").Solver
    probes = []
    with pytest.MonkeyPatch.context() as mp:
        orig = solver_cls.probe_batch

        def probe_batch(self, *a, _orig=orig, **k):
            res = _orig(self, *a, **k)
            probes.extend(tuple(getattr(r, f) for f in PROBE_FIELDS)
                          for r in res)
            return res

        mp.setattr(solver_cls, "probe_batch", probe_batch)
        with replay.recording(pkg, plans=True) as made:
            out = run()
    plans = [obj for kind, obj in made if kind == replay.PLANS]
    return plans, probes, out


def test_dryrun_multichip_equals_jax_on_the_virtual_mesh(capsys):
    jplans, jprobes, _ = _dryrun(cases.JAX_PKG,
                                 lambda: jax_entry.dryrun_multichip(8))
    jtext = capsys.readouterr().out
    tplans, tprobes, out = _dryrun(
        cases.TORCH_PKG, lambda: entry.dryrun_multichip(8, device="cpu"))
    ttext = capsys.readouterr().out
    assert len(tplans) == len(jplans) == 4
    assert tplans == jplans
    assert tprobes == jprobes and len(tprobes) == 2
    # the same report, line for line
    assert ttext.splitlines() == jtext.splitlines()
    assert sorted(out["mesh_plans"]) == [2, 4, 8]
    assert out["overflow_plan"].existing_assignments
