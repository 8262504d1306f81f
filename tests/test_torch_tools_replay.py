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
design: ``SETTINGS_SEAMS`` (in the port's ``tools/gen_docs.py``, whose
``--check`` is the drift step of the port's ``ci.sh``) pins each
differing line (the ``--device`` row the port adds, and the five rows
whose help names the device, the profiler or the compile cache) with its
reason. The replay compares the
port's page against the checked-in page with exactly those rows
swapped; ``test_settings_page_differs_only_by_its_seams`` pins that
nothing else differs.
"""

import difflib
import pathlib

import pytest

import test_torch_replay as replay
from karpenter_provider_aws_tpu_torch.tools.gen_docs import (  # noqa: F401
    SETTINGS_SEAMS, row_flag, seamed)
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
    assert sorted(row_flag(ln[2:]) for ln in added) == sorted(SETTINGS_SEAMS)
    assert sorted(row_flag(ln[2:]) for ln in removed) \
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


def test_drift_check_reports_a_stale_page(tmp_path, capsys, monkeypatch):
    """The drift step of the port's ``ci.sh`` (``gen_docs --check``, from
    the repository root): the checked-in pages are clean under
    ``SETTINGS_SEAMS``; a page that differs prints its diff and one
    ``STALE`` line, and is returned."""
    import shutil
    from karpenter_provider_aws_tpu_torch.tools import gen_docs
    ref = REPO / "docs" / "reference"
    monkeypatch.chdir(REPO)
    assert gen_docs.main(["--check"]) == 0
    assert "STALE" not in capsys.readouterr().out
    for page in gen_docs.PAGES:
        shutil.copy(ref / page, tmp_path / page)
    stale = tmp_path / "metrics.md"
    stale.write_text(stale.read_text().replace("karpenter_", "karpentr_", 1))
    assert gen_docs.check(tmp_path) == ["metrics.md"]
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("STALE")] == [
        f"STALE {stale} — run: python -m "
        "karpenter_provider_aws_tpu_torch.tools.gen_docs --out-dir <dir> "
        "and compare"]
    assert "+" in out and "-" in out
