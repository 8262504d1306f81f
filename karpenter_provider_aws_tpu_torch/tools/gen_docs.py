"""Docs generators — the hack/docs analog, for this package.

The counterpart of the repository's ``tools/gen_docs.py``: the same pages
rendered from this package's lattice, metrics registry and CLI. The pages
differ from the checked-in ``docs/reference/`` only where the port's CLI
does (``settings.md``: the ``--device`` flag and the flags whose help
names the device or the compile cache), each line pinned with its reason
by ``SETTINGS_SEAMS`` below. ``--check`` is the drift gate of the port's
``ci.sh``: it renders every page into a scratch directory and compares
each with the checked-in page as the port renders it (``seamed``),
printing a unified diff and a ``STALE`` line for each page that differs.

The reference generates its website reference pages from code
(hack/docs/instancetypes_gen_docs.go, metrics_gen_docs.go,
configuration_gen_docs.go); this does the same for docs/reference/:

  python -m karpenter_provider_aws_tpu_torch.tools.gen_docs [--out-dir docs/reference]
  python -m karpenter_provider_aws_tpu_torch.tools.gen_docs --check

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
        'the boot ladder runs each shape on the device; with a cache directory it builds the kernel sources first (no XLA executables)',
        "| `--warm-start` | - |  | Run the Solver's boot (G, B) bucket "
        'ladder on the --device on a background thread at start (the '
        'SLO warmup window stays open until it ends), so the first real '
        'pass does not pay the cold cost. With --compile-cache-dir set, '
        "every kernel source is built into it first and each shape's "
        'analysis fills the device cost model. |'),
    '--compile-cache-dir': (
        "the cache holds the kernel libraries nvcc and g++ build, not XLA executables",
        '| `--compile-cache-dir` | COMPILE_CACHE_DIR |  | Directory the '
        'CUDA kernel libraries (nvcc) and the native referee (g++) are '
        'built into and loaded from (env COMPILE_CACHE_DIR): each '
        "library's name carries its source, flags and compiler version, "
        'so a restarted process loads them without building and another '
        "toolkit's are never served. Empty builds in the package's own "
        '_build/. |'),
    '--profile-dir': (
        "the trace is torch.profiler's (CPU and CUDA activity), not xprof's",
        '| `--profile-dir` | - |  | Profile every solve with '
        'torch.profiler (CPU and CUDA activity, a named span per pack '
        'call) and write the Chrome trace under this directory on exit. '
        '|'),
    '--mesh': (
        "the mesh runs a process per card over NCCL, batched on the one --device where that is one; 'auto' stays single-device, slower with a card per shard too",
        '| `--mesh` | SOLVER_MESH |  | Device mesh for the sharded '
        'solver (env SOLVER_MESH): an integer N splits every solve '
        '(full, wave-split and the steady-state delta) into N pod '
        'shards on min(N, visible cards) ranks, a process per card in '
        'one NCCL group (on one card, or the CPU, one batched pass on '
        "the --device), then merges their tail bins; 'auto' (default) "
        'plans the single-device path however many cards are visible, '
        'since the mesh is slower than one device even with a card per '
        "shard; 'off' or 1 pins the single-device path. |"),
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


def row_flag(line):
    """The flag of a row of ``settings.md``'s flag table, else None."""
    return line.split("`")[1] if line.startswith("| `--") else None


def seamed(page, text):
    """The checked-in ``page`` as the port renders it: ``settings.md``
    with ``SETTINGS_SEAMS`` applied, every other page as it is."""
    if page != "settings.md":
        return text
    out, added = [], False
    for line in text.split("\n"):
        flag = row_flag(line)
        if flag in SETTINGS_SEAMS:
            line = SETTINGS_SEAMS[flag][1]
        out.append(line)
        if line == "|---|---|---|---|" and not added:
            # the flag table's head: the port's first row is --device
            out.append(SETTINGS_SEAMS["--device"][1])
            added = True
    return "\n".join(out)


PAGES = ("instance-types.md", "metrics.md", "settings.md",
         "compatibility.md")


def render_all(out: Path) -> str:
    """Write every page into ``out``; the summary line."""
    out.mkdir(parents=True, exist_ok=True)
    n_types = gen_instance_types(out)
    n_metrics = gen_metrics(out)
    n_flags = gen_settings(out)
    n_compat = gen_compatibility(out)
    return (f"docs: {n_types} instance types, {n_metrics} metrics, "
            f"{n_flags} flags, {n_compat} compatibility rows -> {out}")


def check(against: Path) -> list:
    """The pages of ``against`` that differ from what this package renders
    (``settings.md`` compared under ``SETTINGS_SEAMS``); each one's
    unified diff is printed, then a ``STALE`` line."""
    import difflib
    import tempfile
    stale = []
    with tempfile.TemporaryDirectory() as tmp:
        render_all(Path(tmp))
        for page in PAGES:
            path = against / page
            want = seamed(page, path.read_text()) if path.exists() else ""
            got = (Path(tmp) / page).read_text()
            if want != got:
                print("".join(difflib.unified_diff(
                    want.splitlines(True), got.splitlines(True),
                    str(path), f"(rendered) {page}")), end="")
                print(f"STALE {path} — run: python -m "
                      "karpenter_provider_aws_tpu_torch.tools.gen_docs "
                      "--out-dir <dir> and compare")
                stale.append(page)
    return stale


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", default="docs/reference")
    p.add_argument("--check", action="store_true",
                   help="render into a scratch directory and compare with "
                        "docs/reference instead of writing; exit 1 on drift")
    args = p.parse_args(argv)
    if args.check:
        return 1 if check(Path("docs/reference")) else 0
    print(render_all(Path(args.out_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
