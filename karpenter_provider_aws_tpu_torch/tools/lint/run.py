"""graftlint runner: the static-analysis gate, for this package.

    python -m karpenter_provider_aws_tpu_torch.tools.lint.run --check
                                                  # gate: exit 1 on any
                                                  # unbaselined violation,
                                                  # stale baseline entry,
                                                  # or reasonless entry
    python -m ...tools.lint.run --update-baseline # accept current
                                                  # violations (new
                                                  # entries get an EMPTY
                                                  # reason — --check
                                                  # stays red until a
                                                  # human writes one)
    python -m ...tools.lint.run --root DIR        # lint another tree
                                                  # (tests use tmp trees)

Scans ``karpenter_provider_aws_tpu_torch/**/*.py`` under ``--root``
(tests/ is out of scope). Unlike the repository's runner, the package's
own ``tools/`` (soak, bench drivers) lies inside the scanned tree: where
they drive wall time legitimately, the baseline says so. Rules:
docs/reference/linting.md.
"""

from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path
from typing import List, Tuple

from . import baseline as baseline_mod
from .rules import PACKAGE, Violation, default_rules

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def iter_modules(root: Path):
    pkg = root / PACKAGE
    for p in sorted(pkg.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        yield p, p.relative_to(root).as_posix()


def run_checks(root: Path, rules=None) -> Tuple[List[Violation], List[str]]:
    """(violations, parse errors) across the package tree."""
    rules = rules if rules is not None else default_rules(root)
    violations: List[Violation] = []
    errors: List[str] = []
    for path, rel in iter_modules(root):
        applicable = [r for r in rules if r.applies_to(rel)]
        if not applicable:
            continue
        src = path.read_text()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            errors.append(f"{rel}: {e}")
            continue
        for r in applicable:
            violations.extend(r.check_module(tree, rel, src))
    violations.sort(key=lambda v: (v.file, v.line, v.rule))
    return violations, errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="gate mode (the default behavior; spelled out "
                         "in ci.sh for clarity)")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="tree to lint (default: this repo)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline path (default: this package's "
                         "tools/lint/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every violation")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write unbaselined violations into the baseline "
                         "(new entries carry an empty reason — fill it "
                         "in or --check stays red)")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    violations, errors = run_checks(root)
    for e in errors:
        print(f"graftlint: parse error: {e}", file=sys.stderr)

    entries = [] if args.no_baseline else baseline_mod.load(args.baseline)
    unbaselined, used, stale = baseline_mod.apply(violations, entries)
    base_problems = baseline_mod.problems(entries, stale)

    if args.update_baseline:
        new = []
        seen = set()
        for v in unbaselined:
            key = (v.rule, v.file, v.call)
            if key in seen:
                continue
            seen.add(key)
            new.append({"rule": v.rule, "file": v.file, "call": v.call,
                        "reason": ""})
        baseline_mod.save(args.baseline, used + new)
        print(f"graftlint: baseline updated — {len(used)} kept, "
              f"{len(new)} added (empty reasons: fill them in), "
              f"{len(stale)} stale dropped")
        return 0

    for v in unbaselined:
        print(str(v))
    for p in base_problems:
        print(f"graftlint: {p}")
    n_checked = sum(1 for _ in iter_modules(root))
    status = "clean" if not (unbaselined or base_problems or errors) \
        else "FAIL"
    print(f"graftlint: {n_checked} modules, "
          f"{len(violations)} violations ({len(violations) - len(unbaselined)}"
          f" baselined), {len(base_problems)} baseline problems — {status}")
    return 0 if status == "clean" else 1


if __name__ == "__main__":
    raise SystemExit(main())
