"""Docs generators — the hack/docs analog, for this package.

The counterpart of the repository's ``tools/gen_docs.py``: the same pages
rendered from this package's lattice, metrics registry and CLI. The pages
differ from the checked-in ``docs/reference/`` only where the port's CLI
does (``settings.md``: the ``--device`` flag and the flags whose help
names the device or the compile cache), each line pinned by
``tests/test_torch_tools_replay.py``.

The reference generates its website reference pages from code
(hack/docs/instancetypes_gen_docs.go, metrics_gen_docs.go,
configuration_gen_docs.go); this does the same for docs/reference/:

  python -m karpenter_provider_aws_tpu_torch.tools.gen_docs [--out-dir docs/reference]

- instance-types.md — every lattice instance type with its labels,
  capacity, and allocatable (reference website
  reference/instance-types.md)
- metrics.md        — every metric the registry wires, grouped by
  subsystem (reference website reference/metrics.md)
- settings.md       — every CLI flag with its env var and default
  (reference website reference/settings.md)
"""

from __future__ import annotations

import argparse
from pathlib import Path


def gen_instance_types(out: Path) -> int:
    from ..apis.resources import RESOURCE_AXES
    from ..lattice import build_lattice
    from ..lattice.realdata import load_catalog

    # the REAL catalog (the reference's own data tables, imported by
    # tools/import_reference_data.py) — the same lattice the default
    # bench packs; the reference's page is likewise generated from its
    # real instance data
    lattice = build_lattice(load_catalog())
    cpu_ax = RESOURCE_AXES.index("cpu")
    mem_ax = RESOURCE_AXES.index("memory")
    pods_ax = RESOURCE_AXES.index("pods")
    lines = [
        "# Instance Types",
        "",
        "Generated by `tools/gen_docs.py` (the reference generates its",
        "page with hack/docs/instancetypes_gen_docs.go) from the real",
        "imported catalog (`lattice/data/reference_catalog.json`).",
        "Values reflect the default kubelet configuration and",
        "`VM_MEMORY_OVERHEAD_PERCENT=0.075`; prices are the imported",
        "on-demand rates (\"-\" = no price in the source tables, the",
        "type is excluded from priced solves).",
        "",
    ]
    by_family = {}
    for i, spec in enumerate(lattice.specs):
        by_family.setdefault(spec.family, []).append(i)
    for family in sorted(by_family):
        lines += [f"## {family} family", ""]
        lines += ["| Type | vCPU | Memory (MiB) | Arch | GPU | "
                  "Allocatable CPU (m) | Allocatable Mem (MiB) | Max pods "
                  "| OD $/hr |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for i in by_family[family]:
            s, alloc = lattice.specs[i], lattice.alloc[i]
            gpu = f"{s.gpu_count}x {s.gpu_name}" if s.gpu_count else "-"
            price = f"{s.od_price:.4f}" if s.od_price > 0 else "-"
            lines.append(
                f"| {s.name} | {s.vcpus} | {s.memory_mib} | {s.arch} | {gpu} "
                f"| {alloc[cpu_ax]:.0f} | {alloc[mem_ax]:.0f} "
                f"| {alloc[pods_ax]:.0f} | {price} |")
        lines.append("")
    (out / "instance-types.md").write_text("\n".join(lines))
    return len(lattice.specs)


def gen_metrics(out: Path) -> int:
    from ..metrics import (
        Registry, wire_core_metrics, wire_lattice_metrics,
    )

    reg = Registry()
    wire_core_metrics(reg)
    wire_lattice_metrics(reg)
    groups = {}
    for name, m in sorted(reg._metrics.items()):
        sub = name.split("_")[1] if name.startswith("karpenter_") else "misc"
        groups.setdefault(sub, []).append(m)
    lines = [
        "# Metrics",
        "",
        "Generated by `tools/gen_docs.py` (reference:",
        "hack/docs/metrics_gen_docs.go → website reference/metrics.md).",
        "All series render in the Prometheus text exposition format on",
        "`/metrics`.",
        "",
        "With tracing enabled (`--trace`, see",
        "[tracing](tracing.md)), histograms may carry an exemplar — the",
        "trace id of a concrete request behind the aggregate",
        "(`karpenter_solver_stage_duration_seconds` attaches the",
        "provisioning pass's trace, resolvable via `kpctl trace show`).",
        "It renders as a `# exemplar ...` COMMENT line after the `+Inf`",
        "bucket: this endpoint serves the classic text format, where an",
        "OpenMetrics exemplar suffix on the sample line itself would",
        "fail the scrape. Series without exemplars render",
        "byte-identically to a tracing-disabled run.",
        "",
    ]
    for sub in sorted(groups):
        lines += [f"## {sub}", ""]
        for m in groups[sub]:
            labels = (f" `{{{', '.join(m.labelnames)}}}`"
                      if m.labelnames else "")
            lines += [f"### `{m.name}`{labels}", "",
                      f"{m.kind}. {m.help}", ""]
    (out / "metrics.md").write_text("\n".join(lines))
    return sum(len(v) for v in groups.values())


def gen_settings(out: Path) -> int:
    import dataclasses

    from ..cli import build_parser
    from ..operator.options import Options

    parser = build_parser()
    # flag → (env var, Options field) — Options carries the authoritative
    # defaults; the parser's own defaults are mostly None (unset = fall
    # through to env/Options layering)
    env_map = {
        "--cluster-name": ("CLUSTER_NAME", "cluster_name"),
        "--cluster-endpoint": ("CLUSTER_ENDPOINT", "cluster_endpoint"),
        "--assume-role-arn": ("ASSUME_ROLE_ARN", "assume_role_arn"),
        "--vm-memory-overhead-percent": ("VM_MEMORY_OVERHEAD_PERCENT",
                                         "vm_memory_overhead_percent"),
        "--reserved-enis": ("RESERVED_ENIS", "reserved_enis"),
        "--batch-idle-duration": ("BATCH_IDLE_DURATION",
                                  "batch_idle_duration"),
        "--batch-max-duration": ("BATCH_MAX_DURATION", "batch_max_duration"),
        "--interruption-queue": ("INTERRUPTION_QUEUE", "interruption_queue"),
        "--termination-grace-period": ("TERMINATION_GRACE_PERIOD",
                                       "termination_grace_period"),
        "--feature-gates": ("FEATURE_GATE_DRIFT / FEATURE_GATE_SPOT_TO_SPOT",
                            None),
        "--isolated-vpc": ("ISOLATED_VPC", "isolated_vpc"),
        "--solver-address": ("SOLVER_ADDRESSES (or SOLVER_ADDRESS)",
                             "solver_address"),
        "--solver-solve-deadline": ("SOLVER_SOLVE_DEADLINE",
                                    "solver_solve_deadline"),
        "--solver-health-deadline": ("SOLVER_HEALTH_DEADLINE",
                                     "solver_health_deadline"),
        "--mesh": ("SOLVER_MESH", "mesh"),
        "--compile-cache-dir": ("COMPILE_CACHE_DIR", "compile_cache_dir"),
        "--api-watch-queue-bound": ("API_WATCH_QUEUE_BOUND",
                                    "api_watch_queue_bound"),
        "--api-bookmark-every": ("API_BOOKMARK_EVERY", "api_bookmark_every"),
        "--headroom-high-water-fraction": ("HEADROOM_HIGH_WATER_FRACTION",
                                           "headroom_high_water_fraction"),
    }
    opt_defaults = {f.name: f.default for f in dataclasses.fields(Options)}
    lines = [
        "# Settings",
        "",
        "Generated by `tools/gen_docs.py` (reference:",
        "hack/docs/configuration_gen_docs.go → website",
        "reference/settings.md).",
        "",
        "Resolution order, highest first (operator/options.py layering,",
        "like the reference's flag/env registry):",
        "",
        "1. explicit CLI flags / programmatic `Options(...)` kwargs,",
        "2. environment variables,",
        "3. the defaults below.",
        "",
        "The deployment template (`deploy/templates/deployment.yaml`)",
        "materializes the env-var side 1:1, the way the reference's Helm",
        "chart materializes its settings.",
        "",
        "| Flag | Env var | Default | Description |",
        "|---|---|---|---|",
    ]
    n = 0
    for a in parser._actions:
        if not a.option_strings or a.option_strings[0] == "-h":
            continue
        flag = a.option_strings[0]
        env, opt_field = env_map.get(flag, ("-", None))
        if opt_field is not None and opt_field in opt_defaults:
            d = opt_defaults[opt_field]
            default = "" if d in (None, "") else str(d)
        else:
            default = "" if a.default in (None, False) else str(a.default)
        helptext = (a.help or "").replace("\n", " ")
        lines.append(f"| `{flag}` | {env} | {default} | {helptext} |")
        n += 1
    lines += [
        "",
        "## Batching parameters",
        "",
        "Pending pods coalesce into one solver batch per the reference's",
        "windows (website reference/settings.md:17-18,51-65): a pass",
        "starts when no NEW pod has arrived for `--batch-idle-duration`",
        "seconds, or unconditionally once the oldest waiter has been",
        "pending `--batch-max-duration` seconds. Larger idle windows give",
        "the device solver bigger (cheaper-per-pod) batches; smaller ones",
        "cut p50 pod-to-capacity latency. Arrival detection compares the",
        "pending-pod NAME set, so a bind racing an arrival still resets",
        "the idle timer (controllers/provisioning.py batch_ready).",
        "",
        "## Feature gates",
        "",
        "Comma-separated via `--feature-gates`, or individually via env",
        "(settings.md:40-47 of the reference):",
        "",
        "| Gate | Env var | Default | Effect |",
        "|---|---|---|---|",
        "| Drift | FEATURE_GATE_DRIFT | true | Disruption controller"
        " considers drifted NodeClaims (stale nodepool-hash, AMI/subnet/"
        "SG changes) for replacement |",
        "| SpotToSpotConsolidation | FEATURE_GATE_SPOT_TO_SPOT | false |"
        " Allow spot→spot consolidation (requires ≥15-type launch"
        " flexibility, disruption.md:129) |",
        "",
        "## Options without flags",
        "",
        "| Options field | Default | Purpose |",
        "|---|---|---|",
        "| `registration_delay` | 5.0 | SIMULATION-ONLY: seconds between"
        " launch and the fake kubelet registering the Node (the envtest"
        "-stratum analog of instance boot time) |",
        "",
        "## Batch windows vs the solver's own batching",
        "",
        "The pod batch window above is the CONTROL-PLANE admission",
        "window. Independently, the solver buckets problem shapes",
        "(solver/solve.py `_G_BUCKETS`/`_B_BUCKETS`) so XLA compiles a",
        "bounded set of kernels, and the disruption controller batches",
        "its consolidation what-ifs into one vmapped probe call",
        "(`Solver.probe_batch`). Neither needs tuning; they exist so the",
        "accelerator path stays shape-stable.",
        "",
    ]
    (out / "settings.md").write_text("\n".join(lines))
    return n


def gen_compatibility(out: Path) -> int:
    from . import kompat

    name, rows = kompat.load_matrix()
    errs = kompat.validate(rows)
    if errs:
        raise SystemExit(f"compatibility matrix invalid: {errs}")
    lines = [
        "# Compatibility",
        "",
        "Generated by `tools/gen_docs.py` from `deploy/compatibility.yaml`",
        "(reference: hack/docs/compatibilitymetrix_gen_docs.go renders its",
        "matrix into the upgrade guide the same way; `tools/kompat.py`",
        "checks a live pair).",
        "",
        kompat.render(name, rows),
        "",
    ]
    (out / "compatibility.md").write_text("\n".join(lines))
    return len(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", default="docs/reference")
    args = p.parse_args(argv)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_types = gen_instance_types(out)
    n_metrics = gen_metrics(out)
    n_flags = gen_settings(out)
    n_compat = gen_compatibility(out)
    print(f"docs: {n_types} instance types, {n_metrics} metrics, "
          f"{n_flags} flags, {n_compat} compatibility rows -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
