"""The JAX package's ``tests/test_tools.py`` replayed whole on both
packages, on the CPU.

The docs generator and the allocatable diff run as this package's own
copies (``karpenter_provider_aws_tpu_torch/tools/{gen_docs,
allocatable_diff}.py``) on the port side; ``kompat.py`` and ``deflake.py``
import nothing of either package and replay as they are. Each test's own
checks run on both packages, and the two must make the same Operators,
clouds and metric series (``test_torch_replay``).

The rendered reference pages equal the checked-in ``docs/reference/``
byte for byte, but ``settings.md``, where the port's CLI differs by
design: ``SETTINGS_SEAMS`` pins each differing line (the ``--device``
row the port adds, and the five rows whose help names the device, the
profiler or the compile cache) with its reason. The replay compares the
port's page against the checked-in page with exactly those rows
swapped; ``test_settings_page_differs_only_by_its_seams`` pins that
nothing else differs.
"""

import difflib
import pathlib

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
FILE = "test_tools.py"
NOT_REPLAYED = {}
SHIMS = (
    ("        import gen_docs\n",
     "        from karpenter_provider_aws_tpu_torch.tools import gen_docs\n"),
    ("        import allocatable_diff\n",
     "        from karpenter_provider_aws_tpu_torch.tools import "
     "allocatable_diff\n"),
    ('checked_in = (repo / "docs" / "reference" / page).read_text()',
     'checked_in = __import__("test_torch_tools_replay").seamed('
     'page, (repo / "docs" / "reference" / page).read_text())'),
)

# flag -> (reason, the port's row of settings.md); "--device" is the one
# row the port adds (first of the flag table), the others replace the
# checked-in page's row of the same flag
SETTINGS_SEAMS = {
    '--device': (
        "the port's one extra flag: the device of the Solver's tensors (default cuda, raising without a card)",
        "| `--device` | - | cuda | Device of the solver's tensors: "
        "'cuda' (default; raises without CUDA) or 'cpu' (the plain "
        'PyTorch path). |'),
    '--warm-start': (
        'the boot ladder runs each shape on the device; nothing is compiled (no XLA, no AOT)',
        "| `--warm-start` | - |  | Run the Solver's boot (G, B) bucket "
        'ladder on the --device on a background thread at start (the '
        'SLO warmup window stays open until it ends), so the first real '
        'pass does not pay the cold cost. |'),
    '--compile-cache-dir': (
        'no compile cache to persist: the flag is refused at start',
        '| `--compile-cache-dir` | COMPILE_CACHE_DIR |  | Not carried '
        '(env COMPILE_CACHE_DIR): nothing is compiled at run time; '
        'fails at start when set. |'),
    '--profile-dir': (
        "the trace is torch.profiler's (CPU and CUDA activity), not xprof's",
        '| `--profile-dir` | - |  | Profile every solve with '
        'torch.profiler (CPU and CUDA activity, a named span per pack '
        'call) and write the Chrome trace under this directory on exit. '
        '|'),
    '--mesh': (
        "the mesh batches its shards on the one --device; 'auto' stays single-device until one shard per card lands",
        '| `--mesh` | SOLVER_MESH |  | Device mesh for the sharded '
        'solver (env SOLVER_MESH): an integer N splits every solve '
        '(full, wave-split and the steady-state delta) into N pod '
        'shards packed as one batched pass on the --device, then merges '
        "their tail bins; 'auto' (default) plans the single-device path "
        'however many cards are visible, since the shards would share '
        'the --device and a mesh batched on one card is slower than the '
        "single-device solve; 'off' or 1 pins the single-device path. |"),
    '--solver-address': (
        "the sidecar module is this package's, and the local rung runs on --device",
        '| `--solver-address` | SOLVER_ADDRESSES (or SOLVER_ADDRESS) |  '
        '| Delegate provisioning solves to a POOL of solver sidecar '
        'processes: a comma-separated list of gRPC addresses (python -m '
        'karpenter_provider_aws_tpu_torch.parallel.sidecar; env '
        'SOLVER_ADDRESSES, singular SOLVER_ADDRESS still works). Each '
        'endpoint gets a circuit breaker with health-checked half-open '
        'probation; solves fail over to the least-loaded healthy '
        'endpoint, and the local solver (on --device) is the final rung '
        'only when the whole pool is dark '
        '(docs/reference/solver-pool.md). |'),
}


def _row_flag(line):
    return line.split("`")[1] if line.startswith("| `--") else None


def seamed(page, text):
    """The checked-in ``page`` as the port renders it: ``settings.md``
    with ``SETTINGS_SEAMS`` applied, every other page as it is."""
    if page != "settings.md":
        return text
    out, added = [], False
    for line in text.split("\n"):
        flag = _row_flag(line)
        if flag in SETTINGS_SEAMS:
            line = SETTINGS_SEAMS[flag][1]
        out.append(line)
        if line == "|---|---|---|---|" and not added:
            # the flag table's head: the port's first row is --device
            out.append(SETTINGS_SEAMS["--device"][1])
            added = True
    return "\n".join(out)


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_tools_equal_to_jax(test_id, tmp_path):
    # the docs generator renders the CLI's defaults: keep the port's own
    # (--device cuda) rather than the replay's CPU default
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS, cpu_cli=False)


def test_tools_replays_cover_the_jax_tests():
    """Every test of test_tools.py is replayed (none left out)."""
    names = replay.jax_tests(FILE)
    assert len(names) == 11
    assert set(replay.replayed(FILE, NOT_REPLAYED)) == set(names)


def test_settings_page_differs_only_by_its_seams(tmp_path):
    """The port's ``settings.md`` against the checked-in page: one row
    added (``--device``), five rows changed, nothing else; each changed
    row's flag exists on both pages."""
    from karpenter_provider_aws_tpu_torch.tools import gen_docs
    gen_docs.gen_settings(tmp_path)
    port = (tmp_path / "settings.md").read_text().split("\n")
    ref = (REPO / "docs" / "reference" / "settings.md").read_text() \
        .split("\n")
    removed = [ln for ln in difflib.ndiff(ref, port) if ln.startswith("- ")]
    added = [ln for ln in difflib.ndiff(ref, port) if ln.startswith("+ ")]
    assert sorted(_row_flag(ln[2:]) for ln in added) == sorted(SETTINGS_SEAMS)
    assert sorted(_row_flag(ln[2:]) for ln in removed) \
        == sorted(set(SETTINGS_SEAMS) - {"--device"})
    assert {ln[2:] for ln in added} == {v[1] for v in SETTINGS_SEAMS.values()}
    assert all(reason for reason, _ in SETTINGS_SEAMS.values())


@pytest.mark.parametrize("page", ["instance-types.md", "metrics.md",
                                  "compatibility.md"])
def test_other_pages_equal_the_checked_in_docs(page, tmp_path):
    """The port renders the instance types (its own copy of the real
    catalog), its metrics registry and the compatibility matrix exactly
    as ``docs/reference/`` holds them."""
    from karpenter_provider_aws_tpu_torch.tools import gen_docs
    assert gen_docs.main(["--out-dir", str(tmp_path)]) == 0
    assert (tmp_path / page).read_text() \
        == (REPO / "docs" / "reference" / page).read_text()
