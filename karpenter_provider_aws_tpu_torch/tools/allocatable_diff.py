"""allocatable-diff: predicted vs reported node allocatable, for this
package.

The counterpart of the repository's ``tools/allocatable_diff.py``, over
this package's lattice (the same overhead math and catalogs).

Analog of reference tools/allocatable-diff/main.go — walks every instance
type the lattice models, computes the framework's predicted capacity /
allocatable (lattice/overhead.py math: VM overhead, kube+system reserved,
eviction threshold, ENI-limited pods), and diffs against reported values
when given (a CSV of node-status allocatable, or live nodes in a cluster
state). The reference uses the diff to validate VM_MEMORY_OVERHEAD_PERCENT
against real EC2 nodes; this does the same for the lattice formulas.

Usage:
  python -m karpenter_provider_aws_tpu_torch.tools.allocatable_diff --out-file allocatable-diff.csv \
      [--overhead-percent 0.075] [--reported reported.csv]

reported.csv columns: instance_type,cpu_m,memory_mib
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-file", default="allocatable-diff.csv")
    p.add_argument("--overhead-percent", type=float, default=0.075,
                   help="VM memory overhead used for the prediction")
    p.add_argument("--reported", default=None,
                   help="CSV of reported allocatable "
                        "(instance_type,cpu_m,memory_mib)")
    p.add_argument("--catalog", default=None,
                   help="'real' (bundled reference catalog) or a "
                        "real-data JSON path (lattice/realdata.py schema); "
                        "default: the synthetic catalog")
    p.add_argument("--against-reference", action="store_true",
                   help="diff against the reference's own published "
                        "allocatable (the refAllocatable block the importer "
                        "preserves from instance-types.md) instead of a "
                        "reported CSV; implies --catalog real")
    args = p.parse_args(argv)
    if args.against_reference and not args.catalog:
        args.catalog = "real"

    from ..apis.resources import RESOURCE_AXES
    from ..lattice import build_catalog, build_lattice

    if args.catalog:
        from ..lattice.realdata import load_catalog
        specs = load_catalog(None if args.catalog == "real" else args.catalog)
    else:
        specs = build_catalog()
    lattice = build_lattice(
        specs, vm_memory_overhead_percent=args.overhead_percent)
    cpu_ax = RESOURCE_AXES.index("cpu")
    mem_ax = RESOURCE_AXES.index("memory")
    pods_ax = RESOURCE_AXES.index("pods")

    reported = {}
    if args.reported:
        with open(args.reported) as f:
            for row in csv.DictReader(f):
                reported[row["instance_type"]] = (
                    float(row["cpu_m"]), float(row["memory_mib"]))
    elif args.against_reference:
        import json
        from ..lattice.realdata import DEFAULT_PATH
        path = (DEFAULT_PATH if args.catalog == "real" else args.catalog)
        doc = json.loads(Path(path).read_text())
        for t in doc["types"]:
            ra = t.get("refAllocatable")
            if ra and ra.get("cpuMilli"):
                reported[t["name"]] = (float(ra["cpuMilli"]),
                                       float(ra["memoryMi"]))

    rows = []
    for i, name in enumerate(lattice.names):
        cap, alloc = lattice.capacity[i], lattice.alloc[i]
        row = {
            "instance_type": name,
            "capacity_cpu_m": f"{cap[cpu_ax]:.0f}",
            "capacity_memory_mib": f"{cap[mem_ax]:.0f}",
            "allocatable_cpu_m": f"{alloc[cpu_ax]:.0f}",
            "allocatable_memory_mib": f"{alloc[mem_ax]:.0f}",
            "max_pods": f"{alloc[pods_ax]:.0f}",
        }
        if name in reported:
            rcpu, rmem = reported[name]
            row["reported_cpu_m"] = f"{rcpu:.0f}"
            row["reported_memory_mib"] = f"{rmem:.0f}"
            row["cpu_diff_m"] = f"{alloc[cpu_ax] - rcpu:.0f}"
            row["memory_diff_mib"] = f"{alloc[mem_ax] - rmem:.0f}"
        rows.append(row)

    fields = list(rows[0]) if not reported else list(
        max(rows, key=len))
    with open(args.out_file, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} instance types to {args.out_file}")
    if reported:
        import numpy as np
        diffs = [float(r["memory_diff_mib"]) for r in rows
                 if "memory_diff_mib" in r]
        if diffs:
            print(f"memory diff MiB: mean {np.mean(diffs):.1f} "
                  f"max |{np.max(np.abs(diffs)):.1f}|")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
