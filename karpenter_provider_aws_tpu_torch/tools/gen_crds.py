"""Generate deploy/crds/*.yaml from this package's apis/schema.py — the
codegen step the reference runs to keep pkg/apis/crds/*.yaml in lockstep
with its Go types (make codegen).

The counterpart of the repository's ``tools/gen_crds.py``: the port's
schema renders the checked-in ``deploy/crds/`` byte for byte, header
included (``tests/test_torch_schema.py``).

Usage: python -m karpenter_provider_aws_tpu_torch.tools.gen_crds [--check]
  --check  exit 1 if any checked-in artifact differs from the generator
"""

from __future__ import annotations

import pathlib
import sys

import yaml

from ..apis import schema

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "deploy" / "crds"

FILES = {
    "nodepools": "karpenter.tpu_nodepools.yaml",
    "nodeclasses": "karpenter.tpu_nodeclasses.yaml",
    "nodeclaims": "karpenter.tpu_nodeclaims.yaml",
}


def render(kind: str) -> str:
    doc = schema.crd_document(kind)
    return ("# Code generated by tools/gen_crds.py from apis/schema.py. "
            "DO NOT EDIT.\n"
            + yaml.safe_dump(doc, sort_keys=True, width=100))


def main(argv=None) -> int:
    check = "--check" in (sys.argv[1:] if argv is None else argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stale = []
    for kind, fname in FILES.items():
        path = OUT_DIR / fname
        text = render(kind)
        if check:
            if not path.exists() or path.read_text() != text:
                stale.append(fname)
        else:
            path.write_text(text)
            print(f"wrote {path}")
    if check and stale:
        print(f"STALE: {', '.join(stale)} — run python -m "
              "karpenter_provider_aws_tpu_torch.tools.gen_crds")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
