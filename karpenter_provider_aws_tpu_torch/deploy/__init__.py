"""The port controller's deployment manifest.

``deployment.yaml`` here is the counterpart of the repository's
``deploy/templates/deployment.yaml``; every other template there is used
as it is. ``render`` substitutes ``${VAR}`` from a values file the way
``deploy/render.sh`` does (an unset variable stays as written), and

    python -m karpenter_provider_aws_tpu_torch.deploy [--values deploy/values.env] \\
        [--out-dir deploy/rendered]

writes every template of ``deploy/templates/``, this package's deployment
in place of the reference's, plus the CRDs. It mints no serving
certificates: run ``deploy/gen_certs.sh`` first, as ``render.sh`` does.
"""

from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
TEMPLATE = HERE / "deployment.yaml"
TEMPLATES = REPO / "deploy" / "templates"
VALUES = REPO / "deploy" / "values.env"
CERTS_ENV = REPO / "deploy" / "certs" / "certs.env"


def load_values(path: Path = VALUES) -> Dict[str, str]:
    """``KEY=VALUE`` lines of a values file (comments and blanks skipped)."""
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "=" in line:
            key, value = line.split("=", 1)
            out[key.strip()] = value.strip()
    return out


def render(values: Dict[str, str], template: Path = TEMPLATE) -> str:
    """The template with ``${VAR}``/``$VAR`` substituted from ``values``;
    a variable ``values`` lacks stays as written (``os.path.expandvars``)."""
    saved = dict(os.environ)
    try:
        os.environ.update(values)
        return os.path.expandvars(Path(template).read_text())
    finally:
        os.environ.clear()
        os.environ.update(saved)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--values", default=str(VALUES))
    ap.add_argument("--out-dir", default=str(REPO / "deploy" / "rendered"))
    args = ap.parse_args(argv)
    values = load_values(Path(args.values))
    if CERTS_ENV.exists():
        values.update(load_values(CERTS_ENV))
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for tpl in sorted(TEMPLATES.glob("*.yaml")):
        src = TEMPLATE if tpl.name == TEMPLATE.name else tpl
        (out / tpl.name).write_text(render(values, src))
        n += 1
    for crd in sorted((REPO / "deploy" / "crds").glob("*.yaml")):
        shutil.copy(crd, out / crd.name)
        n += 1
    print(f"rendered {n} manifests to {out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
