"""kompat — Kubernetes compatibility-matrix tool.

Analog of the reference's ``tools/kompat`` CLI (reference
tools/kompat/README.md): reads a ``compatibility.yaml`` holding rows of
``{appVersion, minK8sVersion, maxK8sVersion}``, renders the matrix as
markdown (the docs generator embeds it), validates it, and answers "is
app version X compatible with control-plane version Y" — the same check
an operator runs before an upgrade.

The counterpart of the repository's ``tools/kompat.py``, which imports
nothing of either package; this package's ``gen_docs`` renders the matrix
with it.

Usage:
  python -m karpenter_provider_aws_tpu_torch.tools.kompat [matrix.yaml] [-n LAST_N]
  python -m karpenter_provider_aws_tpu_torch.tools.kompat [matrix.yaml] validate
  python -m karpenter_provider_aws_tpu_torch.tools.kompat [matrix.yaml] check APP_VER K8S_VER
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

DEFAULT_MATRIX = Path(__file__).resolve().parents[2] / "deploy" / "compatibility.yaml"


@dataclass
class Row:
    app_version: str
    min_k8s: Tuple[int, int]
    max_k8s: Tuple[int, int]


def _parse_minor(v: str) -> Tuple[int, int]:
    """'1.27' → (1, 27); tolerates a patch suffix ('1.27.3' → (1, 27))."""
    parts = str(v).split(".")
    if len(parts) < 2:
        raise ValueError(f"not a <major>.<minor> version: {v!r}")
    return int(parts[0]), int(parts[1])


def load_matrix(path: Path = DEFAULT_MATRIX) -> Tuple[str, List[Row]]:
    import yaml
    doc = yaml.safe_load(Path(path).read_text())
    rows = [Row(app_version=str(r["appVersion"]),
                min_k8s=_parse_minor(r["minK8sVersion"]),
                max_k8s=_parse_minor(r["maxK8sVersion"]))
            for r in doc.get("compatibility", ())]
    return str(doc.get("name", "unknown")), rows


def validate(rows: List[Row]) -> List[str]:
    """Lints mirroring kompat's: non-empty, min<=max per row, and ranges
    non-regressing as app versions advance (a newer app line must not
    support an OLDER minimum-max than its predecessor dropped)."""
    errs = []
    if not rows:
        errs.append("matrix has no compatibility rows")
    for r in rows:
        if r.min_k8s > r.max_k8s:
            errs.append(f"{r.app_version}: minK8sVersion {r.min_k8s} > "
                        f"maxK8sVersion {r.max_k8s}")
    for prev, cur in zip(rows, rows[1:]):
        if cur.max_k8s < prev.max_k8s:
            errs.append(f"{cur.app_version}: maxK8sVersion regressed vs "
                        f"{prev.app_version}")
    return errs


def _matches(pattern: str, version: str) -> bool:
    """appVersion patterns use a '.x' wildcard tail ('0.1.x')."""
    p = pattern.split(".")
    v = str(version).split(".")
    for i, part in enumerate(p):
        if part == "x":
            return True
        if i >= len(v) or part != v[i]:
            return False
    return len(v) == len(p)


def check(rows: List[Row], app_version: str, k8s_version: str) -> Optional[Row]:
    """The row proving compatibility, or None."""
    k = _parse_minor(k8s_version)
    for r in rows:
        if _matches(r.app_version, app_version) and r.min_k8s <= k <= r.max_k8s:
            return r
    return None


def render(name: str, rows: List[Row], last_n: Optional[int] = None) -> str:
    """The kompat markdown matrix: one column per app version, the
    supported k8s range beneath."""
    shown = rows[-last_n:] if last_n else rows
    head = [name.upper()] + [r.app_version for r in shown]
    vals = ["Kubernetes"] + [
        f"{r.min_k8s[0]}.{r.min_k8s[1]} - {r.max_k8s[0]}.{r.max_k8s[1]}"
        for r in shown]
    w = [max(len(a), len(b)) for a, b in zip(head, vals)]
    line = lambda cells: "| " + " | ".join(c.ljust(n) for c, n in zip(cells, w)) + " |"
    sep = "|-" + "-|-".join("-" * n for n in w) + "-|"
    return "\n".join([line(head), sep, line(vals)])


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    path = DEFAULT_MATRIX
    if args and args[0].endswith((".yaml", ".yml")):
        path = Path(args.pop(0))
    name, rows = load_matrix(path)

    if args and args[0] == "validate":
        errs = validate(rows)
        for e in errs:
            print(f"error: {e}", file=sys.stderr)
        print(f"{name}: {len(rows)} rows, "
              f"{'INVALID' if errs else 'valid'}")
        return 1 if errs else 0

    if args and args[0] == "check":
        if len(args) != 3:
            print("usage: kompat.py [matrix] check APP_VER K8S_VER",
                  file=sys.stderr)
            return 2
        row = check(rows, args[1], args[2])
        if row is None:
            print(f"{name} {args[1]} is NOT compatible with "
                  f"Kubernetes {args[2]}")
            return 1
        print(f"{name} {args[1]} is compatible with Kubernetes {args[2]} "
              f"(row {row.app_version}: {row.min_k8s[0]}.{row.min_k8s[1]} - "
              f"{row.max_k8s[0]}.{row.max_k8s[1]})")
        return 0

    last_n = None
    if len(args) >= 2 and args[0] == "-n":
        last_n = int(args[1])
    print(render(name, rows, last_n))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
