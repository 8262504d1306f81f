"""Operator configuration.

Mirror of the reference's layered flag/env options (reference
pkg/operator/options/options.go:35-57 + website reference/settings.md:13-47):
cluster identity, memory-overhead model, batching windows, interruption
queue, and feature gates. Resolution order: explicit kwargs > environment
variables > defaults, like the reference's flag/env layering.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


def _env(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        raise ValueError(f"invalid value for {name}: {raw!r}")


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class Options:
    cluster_name: str = "sim"
    # apiserver endpoint handed to node bootstrap userdata. Empty =
    # discover from the cloud's network description, like the
    # reference's EKS describe-cluster fallback (operator.go:119-124,
    # 224-236: the CLUSTER_ENDPOINT option wins when set)
    cluster_endpoint: str = ""
    # role to assume for every cloud call (reference operator.go:93-107
    # STS assume-role session layering). The fake session records it;
    # a real backend would chain credentials through it.
    assume_role_arn: str = ""
    # VM memory the hypervisor eats before the OS sees it (options.go
    # VM_MEMORY_OVERHEAD_PERCENT, default 0.075)
    vm_memory_overhead_percent: float = 0.075
    reserved_enis: int = 0
    # assume AWS services without a VPC endpoint are unreachable: live
    # pricing lookups are skipped and the compiled-in static prices serve
    # (reference options.go:53 ISOLATED_VPC; pricing.go:150-163)
    isolated_vpc: bool = False
    # pending-pod batch window (settings.md:17-18)
    batch_idle_duration: float = 1.0
    batch_max_duration: float = 10.0
    # interruption queue name; empty disables the interruption controller
    # (reference controllers.go:60-62)
    interruption_queue: str = ""
    # feature gates (settings.md:40-47)
    drift_enabled: bool = True
    spot_to_spot_consolidation: bool = False
    # force-drain backstop: a terminating claim older than this many
    # seconds evicts even PDB-blocked pods so the instance is never
    # billed forever behind a zero-allowance budget. None = wait forever
    # (the pinned reference release's behavior; later releases added the
    # same escape as NodeClaim spec.terminationGracePeriod)
    termination_grace_period: Optional[float] = None
    # sim-only knob: seconds between launch and (fake) kubelet registration
    registration_delay: float = 5.0
    # gRPC address(es) of solver SIDECAR processes (parallel/sidecar.py
    # main), COMMA-SEPARATED (env SOLVER_ADDRESSES; the singular
    # SOLVER_ADDRESS still works). Set, the operator's provisioning
    # solves ship over the Solve RPC to a failover POOL of
    # accelerator-resident sidecars (parallel/pool.py SolverPool:
    # per-endpoint circuit breakers, split solve/health deadlines,
    # least-outstanding routing, local solve only when the whole pool is
    # dark — docs/reference/solver-pool.md); empty = resident in-process
    # solver
    solver_address: str = ""
    # solve RPC deadline in seconds; 0 = derive from the SLO latency
    # budget (budget x pool.SOLVE_DEADLINE_MULTIPLIER — 10 s at the
    # paper's 200 ms bar). The old behavior was a flat 60 s shared with
    # health probes.
    solver_solve_deadline: float = 0.0
    # health/liveness RPC deadline in seconds: a probe against a HUNG
    # sidecar must answer in about a second, not a solve timeout
    solver_health_deadline: float = 1.0
    # device mesh for the sharded solver (parallel/mesh.py plan_mesh).
    # "" or "auto" plans the single-device path, however many cards are
    # visible (the mesh is slower than one device even with a card per
    # shard), "off" pins it, an integer forces an N-way mesh, its shards
    # on min(N, cards) ranks (batched on the Solver's device on one card).
    mesh: str = ""
    # directory the kernel libraries (nvcc) and the native referee (g++)
    # are built into and loaded from (solver/solve.py
    # enable_persistent_compile_cache): a restarted operator whose cache
    # volume survives loads them instead of building again, and a
    # read-only image still builds. Empty = the package's own _build/
    compile_cache_dir: str = ""
    # API-mode watch hub tuning (kube/apiserver.py; docs/reference/
    # watch.md): a subscriber whose queue exceeds the bound is dropped
    # to 410/relist instead of growing without limit, and a BOOKMARK
    # event (current RV, no object) goes to each watcher after this many
    # deliveries so idle watchers' resume points stay fresh. 0 bookmarks
    # disables them.
    api_watch_queue_bound: int = 8192
    api_bookmark_every: int = 256
    # saturation observatory (introspect/headroom.py; docs/reference/
    # headroom.md): a queue-kind resource whose occupancy crosses this
    # fraction of its capacity triggers one burn-capture per episode
    # (profile + contention evidence at /debug/pprof/captures)
    headroom_high_water_fraction: float = 0.9

    def validate(self) -> None:
        if not self.cluster_name:
            raise ValueError("cluster_name is required")
        if self.cluster_endpoint and not self.cluster_endpoint.startswith(
                "https://"):
            # the reference validates the configured endpoint is a URL
            # (options_validation.go); a bootstrap pointed at plaintext
            # would fail far later and far less legibly
            raise ValueError("cluster_endpoint must be an https:// URL")
        if not (0.0 <= self.vm_memory_overhead_percent < 1.0):
            raise ValueError("vm_memory_overhead_percent must be in [0, 1)")
        if self.batch_idle_duration < 0 or self.batch_max_duration < self.batch_idle_duration:
            raise ValueError("batch windows: need 0 <= idle <= max")
        if self.api_watch_queue_bound < 1:
            raise ValueError("api_watch_queue_bound must be >= 1")
        if self.solver_address and not [
                a.strip() for a in self.solver_address.split(",")
                if a.strip()]:
            # same normalization parallel/pool.py parse_addresses applies
            # (kept inline: Options must stay importable without the
            # solver stack)
            raise ValueError(
                f"solver_address: no endpoint in {self.solver_address!r}")
        if self.solver_solve_deadline < 0:
            raise ValueError("solver_solve_deadline must be >= 0 "
                             "(0 = derive from the latency budget)")
        if self.solver_health_deadline <= 0:
            raise ValueError("solver_health_deadline must be > 0")
        if self.api_bookmark_every < 0:
            raise ValueError("api_bookmark_every must be >= 0 (0 disables)")
        if not (0.0 < self.headroom_high_water_fraction <= 1.0):
            raise ValueError(
                "headroom_high_water_fraction must be in (0, 1]")
        m = (self.mesh or "auto").strip().lower()
        if m not in ("auto", "off", "none", "single"):
            try:
                if int(m) < 1:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"mesh must be 'auto', 'off', or a positive device "
                    f"count, got {self.mesh!r}")

    @staticmethod
    def from_env(**overrides) -> "Options":
        opts = Options(
            cluster_name=_env("CLUSTER_NAME", "sim", str),
            cluster_endpoint=_env("CLUSTER_ENDPOINT", "", str),
            assume_role_arn=_env("ASSUME_ROLE_ARN", "", str),
            vm_memory_overhead_percent=_env("VM_MEMORY_OVERHEAD_PERCENT", 0.075, float),
            reserved_enis=_env("RESERVED_ENIS", 0, int),
            isolated_vpc=_env_bool("ISOLATED_VPC", False),
            batch_idle_duration=_env("BATCH_IDLE_DURATION", 1.0, float),
            batch_max_duration=_env("BATCH_MAX_DURATION", 10.0, float),
            interruption_queue=_env("INTERRUPTION_QUEUE", "", str),
            drift_enabled=_env_bool("FEATURE_GATE_DRIFT", True),
            spot_to_spot_consolidation=_env_bool("FEATURE_GATE_SPOT_TO_SPOT", False),
            termination_grace_period=_env("TERMINATION_GRACE_PERIOD", None, float),
            # empty counts as unset on BOTH vars: the deploy template
            # ships SOLVER_ADDRESSES="" as a placeholder, which must not
            # shadow an overlay's legacy SOLVER_ADDRESS
            solver_address=(_env("SOLVER_ADDRESSES", "", str)
                            or _env("SOLVER_ADDRESS", "", str)),
            solver_solve_deadline=_env("SOLVER_SOLVE_DEADLINE", 0.0, float),
            solver_health_deadline=_env("SOLVER_HEALTH_DEADLINE", 1.0,
                                        float),
            mesh=_env("SOLVER_MESH", "", str),
            compile_cache_dir=_env("COMPILE_CACHE_DIR", "", str),
            api_watch_queue_bound=_env("API_WATCH_QUEUE_BOUND", 8192, int),
            api_bookmark_every=_env("API_BOOKMARK_EVERY", 256, int),
            headroom_high_water_fraction=_env(
                "HEADROOM_HIGH_WATER_FRACTION", 0.9, float),
        )
        for k, v in overrides.items():
            setattr(opts, k, v)
        opts.validate()
        return opts
