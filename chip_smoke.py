#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (karpenter_provider_aws_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the package's CUDA source (csrc/offering_argmin.cu) with nvcc,
   printing ptxas's registers, shared memory and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   on every case of ``ops/offering_cases.py`` (the main path's shapes,
   ties, all-infeasible bins, unaligned rows, T of 1 to 6000, ZC of 1 to
   130, uint8 masks, sparse and dense bins); indices and finite values
   must be exactly equal;
4. main path: the north-star wave (50k pods x the real 759-type catalog,
   3 NodePools) through ``solve_relaxed`` on ``cuda``, twice: the
   sequential ``Solver(lattice, pipeline=False)`` and the default,
   pipelined ``Solver(lattice)``. For each, kernel launch counts are
   zeroed just before one solve and read just after; the plan must place
   every pod, cost within 1.02x of the FFD referee's (``_referee``: the
   native referee, held to the Python oracle in phase 17), and equal
   the port's CPU plan node by node. Then each path's e2e p50 over 12
   solves, the two paths in turns, and its median stage times;
5. steady state: cfg10 (20k pods in 24 shapes, 120 partly used existing
   nodes) through the microloop harness of ``bench.py``'s
   ``run_microloop_config`` with this package's objects: a cold full
   build, ``solve`` and a priming ``solve_delta``, then 12 passes of
   about 1.5 % pods leaving and 1.5 % arriving (every 4th pass churns
   nothing), each an incremental build plus ``solve_delta``. Every pass
   is refereed twice: equal to a sequential Solver's plan of the same
   problem, and the same node multiset at the same cost as a solve of a
   scratch ``build_problem``. The phase fails unless every pass rode the
   microloop with no abort, the 3 no-churn passes skipped their fetch, no
   pass paid more than 2 link legs, and every pass launched the kernel;
6. provisioner: the provisioning controller end to end on the card
   (``workloads.ProvisionerStack``: ``ClusterState``, ``FakeCloud``,
   ``CloudProvider``, ``Provisioner`` with the delta path on, and the
   ``LifecycleController``, all on one ``FakeClock``). (a) The cfg5 wave
   as pending pods through one ``provision_once``: not degraded, on the
   device path, 0 unschedulable pods and 0 launch failures, every pod
   nominated to a launched claim, the kernel launched, and the plan equal
   to the port's CPU plan node by node; then registration binds every
   pod. (b) cfg10's 20k pods provisioned from empty and registered, then
   12 passes of cfg10's churn rate (about 1.5 % of the bound pods leave
   and as many arrive, every 4th pass nothing) and 12 passes of the delta
   smoke's small churn, each with batch-window polls, ``provision_once``
   and registration, each churned pass refereed by a scratch
   ``build_problem`` of the same cluster solved on a sequential Solver
   (pod by pod where the pass rebuilt in full, by pod shape where it rode
   the delta path), and each churned pass's own kernel inputs, captured
   during the pass, held exactly against the plain version.
   The phase fails on a degraded pass, a launch failure, a referee
   mismatch, a churned pass that did not launch the kernel, a microloop
   abort, no delta solve or incremental build, or a pod left pending;
7. consolidation: cfg4's fleet (``workloads.config4_fleet_stack``: 500
   under-utilized nodes of the real catalog's three cheapest
   general-purpose types, half spot, 1,500 pods bound 3 per node) in a
   ``workloads.ConsolidationStack`` on the card, through 8 ``run_once``
   passes (provisioning, lifecycle, disruption with its batched probes,
   termination), each printing its probe dispatch's K, G and B, wall and
   device span (CUDA events), the host build of the what-if problems, the
   exact what-if solves, the referee, the nodes removed and the fleet's
   $/hr. The phase fails on a host fallback, a degraded plan, an accepted
   removal the host-FFD referee did not pass, a pass that raised the
   fleet's $/hr, a probe dispatch or an exact what-if that did not launch
   the kernel exactly once, or a pod pending at the end; every kernel
   call of every pass is held exactly against the plain version, every
   probe of the first dispatch is re-run alone (K=1) and must equal its
   batched row, and the largest prefix and one single must equal a CPU
   Solver's probe. One dispatch is re-run under the profiler for the
   device's idle share;
8. operator: the Operator in direct mode (``operator.Operator`` with no
   device, so on ``cuda``: every controller, the domain providers, the
   webhooks' config checks and the introspection layer). (a) cfg4's fleet
   seeded into it (``workloads.config4_fleet_operator``) through 8
   ``run_once`` passes on the consolidation phase's schedule, each
   printing the nodes removed, the fleet's $/hr, the kernel launches and
   the wall time split by controller; every pass must remove the same
   claims, leave the same $/hr and launch the kernel as often as the
   consolidation phase's stack did in the same pass. (b) The cfg5 wave as
   50,000 pending pods, in a cluster whose subnets are /20s
   (``workloads.wave_cloud``), through one ``run_once(force_provision=True)``:
   its plan must equal the CPU plan node by node, its SLO cost referee
   (the host FFD, timed on its own line) must return a ratio of at most
   1.02, and then the clock steps and the lifecycle controller runs until
   every claim registered.
   Both fail on a degraded plan, a host fallback, an SLO referee error, an
   introspection provider reporting an error, a ``/metrics`` rendering
   that ``metrics.lint_exposition`` does not pass clean, or no kernel
   launch through the Operator;
9. wave split: (a) cfg7 (``workloads.config7_highG_wave_split``: 4,608
   pods with distinct signatures over the real catalog, past the largest
   group bucket of 4,096) through ``Solver.solve`` on the card,
   ``WAVE_SOLVES`` solves per path, sequential and pipelined in turns. Every solve must be a ``wave-split`` plan for
   ``g-overflow`` in 5 waves with no retry, launch the kernel exactly once
   a wave (counted around the solve), place every pod within 1.02x of the
   FFD oracle's cost, and equal the first plan node by node; the pipelined
   path must prefetch 4 waves. Each path's first solve captures every
   wave's kernel inputs (their B is printed) and the last wave's are held exactly
   against the plain version. (b) cfg7's first 320 pods under
   ``FaultInjector(g_limit=64)`` (5 waves) on the card and on the CPU: the
   plans must be equal node by node;
10. ladder: each rung forced by a ``FaultInjector`` on cfg10's 20,000
   pending pods, each on a fresh Solver with a ``FakeClock``: one device
   error is retried (the plan equal to the unfaulted one, the clock 0.05 s
   on), two land on the host FFD (``device-error``, its plan equal to
   ``solve_host_ffd``, no launch), ``b_limit=32`` lands there too
   (``b-exhausted``); after ``inject_faults(None)`` each Solver solves on
   the device again with its counts unchanged. A launch that fails for
   real (the wrapper's launcher made to return error 700) must raise
   ``SolverDeviceError`` after one retry, and a kernel that does not build
   ``KernelBuildError`` with no retry: no host plan stands in for the
   card. Then a fault mid-microloop
   on one of cfg10's steady passes: the pass aborts the microloop once,
   and it and the next equal their sequential referees;
11. weather: the ``squall`` scenario (``weather/scenario.py``: a 15 s storm
   over two zones with device errors, junk messages and an ICE spell)
   against cfg4's fleet in an Operator on the card
   (``workloads.weather_operator``, a fresh real catalog): 60 ticks of 1 s
   with 2 pods a tick through ``run_once(force_provision=True)``, then
   ``WEATHER_RECOVERY`` passes with the injector cleared. It must reprice
   the lattice, engage the ladder, take one rung for each fault fired that
   the microloop did not consume and none at all in recovery, send storm messages and count the junk malformed,
   drain the queue with no handler error, hold consolidation, launch the
   kernel on every un-faulted provisioning pass that placed pods, leave
   nothing pending or leaked, keep the SLO cost burn at most 1.0, and
   replay its timeline byte for byte. It prints the pass wall p50 split
   by controller, the rung each provisioning pass took and the fleet's
   $/hr before and after;
12. api: the API stratum on the card. (a) The cfg5 wave in API mode, every
   ``API_POD_STRIDE``-th pod (12,500 of its 50,000; cut so that the
   whole script keeps to its time with the tools phase): a
   ``FakeAPIServer`` with its indexes and admission, served over HTTP
   with a bearer token (``kube.httpserver.serve``), and an
   ``Operator(api_server=...)`` with no device, so on ``cuda``, over a
   fresh real catalog and ``workloads.wave_cloud``. The three NodePools
   and the first ``API_REST_PODS`` pods are POSTed over REST, the other
   11,500 enter through ``KubeClient.create_pods`` (the bulk verb), and a
   watch on ``GET /apis/pods?watch=1`` runs over HTTP in a thread. The
   informers sync, one forced ``run_once`` plans, and registration
   passes (sync, lifecycle, sync) bind. The phase fails unless every pod
   is bound in the server's own truth, the watch stream saw every
   binding, the claims and nodes in the server are the plan's, the plan
   equals node by node the CPU plan of the same pods under the NodePools
   as admission stored them (defaulting adds the reference's default
   requirements, on-demand among them: by design, ROADMAP Queue C), the
   pass launched the kernel exactly once and did not degrade, the
   ``/metrics`` of the metrics server lints clean, and ``/debug/vars``
   answers over REST with the token. It prints the wall times of the
   bulk create, the REST creates, the informer sync, the pass (and in it
   the solve and the ``ApiWriter``'s writes) and registration. (b) The
   port's CLI in process (``cli.main`` with ``--api-port``,
   ``--metrics-port``, ``--async-runtime``, no ``--device``) in a thread,
   electing through the apiserver's lease: a NodePool and
   ``API_CLI_PODS`` of cfg10's pods POSTed over REST must all be bound
   (read over REST), the lease held by this process, the kernel launched,
   ``/metrics`` lint clean, no controller tick raised, and ``main`` must
   return 0 within ``API_CLI_STOP_SECONDS`` of its stop event;
13. mesh: the sharded solve, ``MESH_SHARDS`` (8) pod shards batched on
   the card (``plan_mesh("8", ranks=1)``, as ``--mesh 8`` plans it on one
   card). (a) cfg11
   (``workloads.config11_200k_sharded``: 200,000 pods in 32 shapes with
   selectors, the real catalog, seed 12; not cut) on a mesh-native
   ``Solver(lattice, mesh=...)``, sequential and pipelined, and on the
   single-device Solver: each cold solve places every pod within 1.02x of
   the FFD oracle's cost, does not degrade and launches the kernel (its
   count per solve printed: the shard pack's dispatches and the merge);
   each mesh plan equals one CPU solve of the same mesh problem
   (``serde.plan_semantic_dict``); then ``MESH_SOLVES`` solves per path
   (``build_problem`` included) in turns for each path's e2e and stage
   p50s, one mesh solve under the profiler for the device's idle share,
   the shard imbalance and B per shard. (b) cfg9 (16,500 pods) on the mesh
   within 1.02x of the single-device plan's cost, and the capped
   full-dissolve problem, whose mesh plan must equal the single-device
   plan byte for byte. (c) cfg10's 12 steady passes on a mesh-native
   Solver (``workloads.delta_on_mesh_passes``): every pass an incremental
   build through ``solve_delta``'s microloop on the mesh with a resident
   hit, at most ``MESH_LEGS`` link legs (``MESH_LEGS_MERGE`` on a pass
   that re-ran the tail-bin merge, 2 more a merge regrow, the reference's
   bound), the no-churn passes skipping their fetch, and each plan equal
   to a sequential mesh solve of the same problem and (node multiset,
   cost) to a scratch build's. (d) ``Operator(options=Options(mesh="8"))``
   on the card through one forced pass of the cfg9 wave: its plan on 8
   shards, equal to (b)'s mesh plan node by node, the kernel launched, and
   ``/metrics`` carrying ``karpenter_solver_mesh_devices 8.0`` and linting
   clean. (e) One shard per card: cfg11 through the rank program
   (parallel/ranks.py) over NCCL on every visible card, 8 shards on
   min(8, cards) ranks (on one card a group of one rank, forced with
   ``solver_mesh(8, ranks=1, group=True)``, since ``plan_mesh`` plans the
   batched pack there): its plan equal to the batched pack's, its
   stacked shard buffer and float32 total byte-identical to the batched
   pack's, at least one launch on every rank, their sum counted at rank
   0, the e2e p50 against the batched mesh and the single-device solve in
   turns (``MESH_RANK_SOLVES`` each), the workers' spawn time, cfg10's
   steady passes through the microloop on the ranks (the resident buffer
   sent as its delta; each plan equal to a sequential batched-mesh solve,
   legs within phase (c)'s bound), and no worker alive after the ranks
   close; the step must end within
   ``MESH_RANK_SECONDS``. (f) A lost rank, on ``LOST_RANK_CARDS`` cards
   or more (on fewer it prints that it needs them and checks nothing): a
   child process (``--lost-rank``, group timeout ``LOST_RANK_TIMEOUT_S``)
   runs cfg11 on the ranks of three Solvers in turn; a worker of the
   first is killed, one of the second stopped, in the middle of a pack:
   each solve must raise ``DeviceLostError`` from ``RanksLost`` (the kill
   within the group timeout, the stall at it), the Solver report its
   device lost and no worker be left; each next Solver must get a fresh
   set that spawns within the timeout and plans as the first. The shard pack's D·B kernel rows and the
   merge's rows of (a)'s pipelined cold solve, and rank 0's shard rows of
   (e), are held exactly against the plain version and timed in phase 22;
14. remote: the remote solver over the port's own gRPC wire
   (``parallel/rpc.py``). (a) ``python -m
   karpenter_provider_aws_tpu_torch.parallel.sidecar`` as its own process
   on the card on a ``unix:`` socket (it must print its serving line
   within ``SIDECAR_START_SECONDS``), and an
   ``Operator(options=Options(solver_address=...))`` on the card through
   one forced pass of cfg2 (5,000 pods with selectors and taints, 3
   NodePools, the real catalog, 2.0 MB on the wire): one delegated solve,
   no local one and no kernel launch in this process, the plan equal to
   an in-process card solve by ``serde.plan_semantic_dict``, the pool
   gauges on ``/metrics`` (lint clean). (e) That
   Operator serves a ``ReplicationSource``; a ``StandbyReplica`` syncs the
   snapshot over the wire, ``REMOTE_CHURN`` pods leave and arrive, a
   second pass runs, delegated too (its pods not yet registered: a pass
   over the registered wave ships every bound pod, over the 4 MiB
   limit), the standby syncs the delta, its mirror
   equals the leader's as serde documents and ``promotion_ready()`` holds.
   (f) cfg2's Solve RPC to the sidecar process against the in-process
   ``solve_relaxed``, ``REMOTE_TURNS`` each in turns, with the request and
   response bytes, the serialize / wire-and-sidecar / decode split, the
   sidecar's own spans of one traced call, and the Health RPC's p50.
   (b) Two in-process ``ChaosSidecar``s on the card, each with its own
   resident Solver: one cfg2 Solve RPC must launch the kernel exactly
   once; its inputs, captured, are held exactly against the plain version
   and timed in phase 22. (c) ``SolverPool``s over the two, one fresh pool
   a step after a warm solve: one endpoint killed, hung (against a
   ``REMOTE_HANG_DEADLINE`` solve deadline), answering junk, both killed,
   and cfg3 (10,000 pods, 5.1 MB, over the 4 MiB message limit): each
   step's endpoint that solved, breaker states, failovers, local solves
   and failover reasons must be ``REMOTE_FAILOVER_EXPECTED``, the
   reference's decisions (``pool-exhausted`` for the last two), and each
   plan the in-process plan; only those two pools may end with a
   ``pool-exhausted`` count. (d) ``REMOTE_WINDOW_THREADS`` threads send
   Solve RPCs of distinct cfg1-sized problems to one sidecar with the
   solve window at once: every plan equal to its serial solve, at least
   two coalesced;
15. warm start: cfg5's first ``solve_relaxed`` in three fresh processes
   (this script run with a mode, so each has its own CUDA context): cold;
   after the boot warmup ladder (``Solver.warmup`` over
   ``BOOT_G_BUCKETS`` x ``BOOT_B_BUCKETS`` with probes, on its
   background thread, waited for through ``on_done``); and cold under
   ``start_profiling``, whose trace gives the breakdown of the cold cost
   (device kernels, CUDA runtime and driver calls by name, the pack
   span). Each prints its context creation, its first solve, the
   allocator segments it added and the p50 of ``WARM_LATER_SOLVES``
   later solves; the warm one the ladder's wall and kernel launches. The
   phase fails if the ladder launched no kernel, a first solve launched
   none or left a pod unplaced, or the three plans differ. Then the
   compile cache: two processes started as the CLI starts
   (``--cache-first-solve``) on one fresh, empty ``COMPILE_CACHE_DIR``,
   each through the Operator and the CLI's ahead-of-time ``--warm-start``
   ladder (cut to cfg5's shape) and cfg5's first solve: the first must
   build both libraries (``nvcc``, ``g++``) into the directory, the second
   load them with no compile, neither write into ``_build/``, and both
   plan as the cold process with a launch;
16. profiling: ``capture_cost_model`` over the boot ladder (its shapes
   traced on the meta device: every shape captured, no launch), then
   ``PROFILED_SOLVES`` cfg5 solves between ``start_profiling``
   and ``stop_profiling`` on a warm Solver: the trace file must exist and
   name one ``solver.pack`` span and at least one
   ``cheapest_offering_kernel`` event a solve, and each solve launch the
   kernel once; cfg5's shape in the device cost model must then carry
   its FLOPs, bytes and peak beside its measured ``last_vs_model``;
17. native: the C++ FFD referee (``native/``) built from the checkout's
   ``ffd.cc`` into the port's ``_build/`` under its keyed name (never
   ``native/libffd.so``),
   run on cfg5: its node count and cost must equal the Python
   ``ffd_oracle``'s (cost within 1e-5 relative); both are timed;
18. bench: the port's bench (``karpenter_provider_aws_tpu_torch/bench.py``,
   the rows of the repository's ``bench.py``). (a) ``python -m
   karpenter_provider_aws_tpu_torch.bench --smoke`` as a child process
   must exit 0 with the cfg1 row as its last line, its ``detail.device``
   naming this card. (b) The north-star cfg5 row in this process through
   the bench's ``run_config`` at ``BENCH_ITERS`` iterations with
   ``kernel_parity_check``: 1,840 new nodes at $2938.00/hr as phase 4's
   plan, 0 unschedulable, ``cost_vs_ffd_oracle`` at most 1.02, both
   referees ``native`` (a ``python`` referee means the native build failed
   here), the kernel parity checked with prices and choices identical, and
   the kernel's launch count risen by exactly the row's solves (one
   launch each) plus the parity check's one;
19. device lost: a child process runs an Operator with cfg10's 20,000
   pending pods through the CLI's loop (``cli.run_passes``); the first
   pack first indexes a CUDA tensor out of range (a device-side assert,
   patched in the child). The child must exit with ``EXIT_DEVICE_LOST``
   right after that pass, with no pass after the error (or, were the
   context to recover, go on planning and exit 0); it prints whether a
   one-element op still runs;
20. tools: the operator's tools and entry points of the port. (a) The
   entry module (``entry.py``, the counterpart of ``__graft_entry__``):
   ``entry()``'s pack on the card must launch the kernel exactly once and
   equal the same call on the CPU field for field; ``dryrun_multichip(8)``
   on the card must plan every mesh size, the overflow retry and the
   probe batch as on the CPU. (b) The port's CLI as a child process on
   the card (``--api-port``, the async runtime; the child counts the
   kernel launches of every provisioning pass and prints them), driven
   by ``python -m karpenter_provider_aws_tpu_torch.tools.kpctl``:
   ``apply -f examples/general-purpose.yaml``, ``apply`` of
   ``TOOLS_CLI_PODS`` of cfg10's pods on that pool, every pod bound,
   ``get nodeclaims/nodes/pods -o json`` equal to the CPU plan of the
   same pods under the pools as admitted (node by node), ``top --once``
   with the card in its SOLVER row, and ``explain pod`` on one pod; every
   provisioning pass with pending pods must launch the kernel. (c) The
   soak (``python -m karpenter_provider_aws_tpu_torch.tools.soak
   --minutes 1.5 --weather squall --fault-schedule`` with one
   ``device-error`` and a ``clear``) on the card: its weather artifact
   must show no pending pod, no leaked instance, no orphaned lease, a
   cost burn of at most 1.0, the ladder engaged and a timeline
   byte-identical to its replay; the soak's exit code and each of its
   gates are printed, and a failed gate other than a latency gate
   (``SOAK_LATENCY_GATES``, which this host's speed alone can fail) fails
   the phase;
21. ci gates: the port's CI on the card. The drift checks (``python -m
   karpenter_provider_aws_tpu_torch.tools.gen_crds --check`` and
   ``gen_docs --check``) and the lint (``tools.lint.run --check``) once,
   then each of the twelve CI gates (``tools/smoke_*.py`` of the port,
   ``tools.gate.GATES``) as a child process with ``--device cuda``,
   ``CI_GATES_AT_ONCE`` at a time, each of these processes killed with
   its children at ``CI_SECONDS``: each gate must exit 0 with its
   summary line, its device line must name ``cuda:0``, and each gate that solved must have
   launched the kernel (its own count); the phase prints each gate's
   seconds and launches;
22. kernel timing: the kernel and its plain version at cfg5's and cfg10's
   own inputs (captured in a solve of each), at the first consolidation
   pass's probe dispatch (K x B rows in one call), at cfg7's last wave, at
   cfg11's shard pack (D·B rows) and merge, at cfg2's Solve RPC in a
   sidecar, and at the dense largest bin bucket (B=8192), and the card's
   launch floor (a one-element in-place add), each the median of 100
   device times from CUDA events, queued behind a device sleep so that no
   host gap is timed.

No fallback may hide the card: every Solver the script makes is kept,
and after each phase each must have no FaultInjector attached and exactly
the ``degraded_counts`` its phase allowed (none but cfg7's wave split, the
injected rungs and the remote phase's two dark pools). A real CUDA fault
is retried and then raises (``DeviceLostError`` when it took the
context, as phase 19 shows), failing its phase.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX and nothing of the JAX package, and checks that at the end.
"""

import json
import os
import statistics
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
SOLVES = 12
SMALL_PASSES = 12
CONSOLIDATION_PASSES = 8
WAVE_SOLVES = 1            # cfg7 solves per path, the paths in turns
WAVE_CUT_PODS = 320        # cfg7's cut for the card-against-CPU wave split
WAVE_CUT_G_LIMIT = 64      # its injected group ceiling: 5 waves
LADDER_PASSES = 4          # cfg10 steady passes of the mid-microloop fault
LADDER_FAULT_PASS = 1      # the pass the fault lands on
WEATHER_RECOVERY = 40      # recovery passes after the squall
API_WATCH_QUEUE_BOUND = 1 << 18  # per-watcher queue: the wave's 100k events
API_POD_STRIDE = 4         # the api phase's cut of the cfg5 wave (1 = whole)
API_REST_PODS = 1000       # of them POSTed one by one over REST
API_CLI_PODS = 2000        # cfg10's pods POSTed to the CLI over REST
API_CLI_STOP_SECONDS = 30  # main must return this soon after its stop event
API_TOKEN = "chip-smoke-api-token"
MESH_SHARDS = 8            # the mesh phase's shards (--mesh 8)
MESH_SOLVES = 3            # cfg11 solves per path, the three paths in turns
MESH_LEGS = 2              # link legs of a steady pass on the mesh, and of
MESH_LEGS_MERGE = 4        # one that re-ran the tail-bin merge (+2 a regrow)
MESH_RANK_SOLVES = 3       # cfg11 solves per path of the rank step, in turns
MESH_RANK_SECONDS = 60     # the rank step must end within this
LOST_RANK_TIMEOUT_S = 20.0  # the lost-rank child's group timeout (s)
LOST_RANK_SECONDS = 420    # the lost-rank child must end in this
LOST_RANK_CARDS = 4        # cards the lost-rank step needs
SIDECAR_START_SECONDS = 180  # the sidecar process must serve within this
REMOTE_SOLVE_DEADLINE = 30.0  # the pools' solve deadline (s), the hang's apart
REMOTE_HANG_DEADLINE = 3.0  # the solve deadline of the hang step (s)
REMOTE_TURNS = 5           # cfg2 Solve RPCs and in-process solves, in turns
REMOTE_HEALTH_CALLS = 20   # Health RPCs timed
REMOTE_WINDOW_THREADS = 8  # concurrent Solve RPCs into the solve window
REMOTE_CHURN = 250         # pods that leave and arrive before the second pass
WARM_LATER_SOLVES = 5      # cfg5 solves timed after a child's first one
CACHE_G_BUCKETS = (32,)    # the compile-cache children's boot ladder, cut
CACHE_B_BUCKETS = (2048,)  # to cfg5's own shape (G=31, B=2048)
CHILD_SECONDS = 600        # a child process of phases 15 and 19 must end in this
PROFILED_SOLVES = 2        # cfg5 solves inside the profiling session
# the trace spans of the device pack calls (solver/solve.py)
PACK_SPANS = ("solver.pack", "solver.pack_micro", "solver.pack_probe",
              "solver.pack_sharded", "solver.pack_merge")
BENCH_ITERS = 3            # timed solves of the bench phase's cfg5 row
BENCH_SMOKE_SECONDS = 300  # the bench's --smoke child must end in this
TOOLS_CLI_PODS = 2000      # cfg10's pods applied to the CLI child with kpctl
TOOLS_CLI_SECONDS = 300    # the CLI child must serve, bind and stop in this
# 1.5 minutes: the squall's evidence gate (more than 100 real interruption
# messages handled) needs that much churn; one minute handled 88 to 100-odd
TOOLS_SOAK_ARGS = ("--minutes", "1.5", "--weather", "squall",
                   "--fault-schedule", "10:device-error,40:clear")
TOOLS_SOAK_SECONDS = 600   # the soak child must end in this
# the soak's gates that only this host's speed can fail: the SLO latency
# burn over the run (a pass slower than the 200 ms budget for long enough)
SOAK_LATENCY_GATES = ("soak: sustained latency burn",)
DEVICE_LOST_SECONDS = 120  # the sticky-error child's run_passes deadline
# phase 21: the CI gates (karpenter_provider_aws_tpu_torch/tools/smoke_*.py,
# tools.gate.GATES)
CI_GATES_AT_ONCE = 3       # gate processes at once (each mostly host-bound)
CI_SECONDS = 300           # each drift, lint and gate process must end in this
# the failover steps, each on a fresh pool over the two sidecars after one
# warm cfg2 solve: step -> (fault on the sidecars, problem of the solve)
REMOTE_FAILOVER_STEPS = {"kill": ("kill", "cfg2"), "hang": ("hang", "cfg2"),
                         "junk": ("junk", "cfg2"), "dark": ("dark", "cfg2"),
                         "cfg3": (None, "cfg3")}
# what the reference's pool decides in each (tests/test_torch_remote.py
# holds the JAX package's and the port's pools to it on the CPU)
_ONE_FAILOVER = {"solved_by": 1, "failovers": 1, "local_solves": 0,
                 "degraded_reason": ""}
_EXHAUSTED = {"solved_by": None, "states": [0, 0], "failovers": 2,
              "local_solves": 1, "degraded_reason": "pool-exhausted",
              "reasons": ["sidecar-unreachable", "sidecar-unreachable"]}
REMOTE_FAILOVER_EXPECTED = {
    "kill": {**_ONE_FAILOVER, "states": [0, 0], "reasons": ["sidecar-unreachable"]},
    "hang": {**_ONE_FAILOVER, "states": [2, 0], "reasons": ["sidecar-hung"]},
    "junk": {**_ONE_FAILOVER, "states": [0, 0], "reasons": ["sidecar-unreachable"]},
    "dark": _EXHAUSTED,
    "cfg3": _EXHAUSTED,
}


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


_PHASE = {}


def _phase(name: str) -> None:
    """Start the next phase; print the wall seconds of the one before."""
    now = time.perf_counter()
    if _PHASE:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t']:.1f} s", flush=True)
        _PHASE.setdefault("seconds", {})[_PHASE["name"]] = now - _PHASE["t"]
    _PHASE.update(name=name, t=now)
    if name:
        print(f"== {name}", flush=True)


def _kernel_cases(dev):
    """(name, tmask, zcmask, price) on the card for cheapest_offering:
    every case of ``ops/offering_cases.py``, made from numpy seeds."""
    from karpenter_provider_aws_tpu_torch.measure import on_device
    from karpenter_provider_aws_tpu_torch.ops import offering_cases
    for name, make in offering_cases.kernel_cases().items():
        yield (name,) + on_device(make(), dev)


def _node_rows(plan):
    return [(n.node_pool, n.instance_type, n.zone, n.capacity_type,
             sorted(n.pods)) for n in plan.new_nodes]


def _same_plan(a, b) -> bool:
    return (_node_rows(a) == _node_rows(b)
            and a.existing_assignments == b.existing_assignments
            and a.unschedulable == b.unschedulable
            and a.new_node_cost == b.new_node_cost)


def _node_multiset(plan):
    return sorted((n.instance_type, n.zone, len(n.pods)) for n in plan.new_nodes)


def _steady_state(torch, workloads, lattice, oa):
    """Phase 5: cfg10 under the microloop harness; returns its numbers and
    the last pass's problem."""
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    pods, pools, shapes = workloads.config10_steady_state()
    churn = workloads.SteadyStateChurn(lattice, pods, shapes)
    solver = Solver(lattice)
    referee = Solver(lattice, pipeline=False)
    rebuild = Solver(lattice)
    if solver.device.type != "cuda" or referee.device.type != "cuda":
        raise AssertionError("cfg10: a Solver is not on the card")
    passes = workloads.STEADY_PASSES
    rows, stages, rebuild_ms, launches_per_pass = [], {}, [], []
    pre = pre_link = None
    oa.LAUNCHES = 0
    for pass_i, res, plan, ms, legs in workloads.steady_state_passes(
            solver, lattice, pools, churn, passes):
        torch.cuda.synchronize()
        launched = oa.LAUNCHES
        if pass_i < 0:
            print(f"cold: full build ({res.problem.G} groups, {res.problem.E} "
                  f"existing bins), solve and priming solve_delta "
                  f"{ms:.1f} ms", flush=True)
            pre = dict(solver.pipeline_stats)
            pre_link = dict(solver.link_stats)
        else:
            launches_per_pass.append(launched)
            for k, v in plan.stage_ms.items():
                stages.setdefault(k, []).append(v)
        # referee 1: the same problem through the sequential path
        same = referee.solve(res.problem)
        # referee 2: a scratch build of the same cluster, fully rebuilt
        t = time.perf_counter()
        scratch = rebuild.solve(build_problem(churn.pods, pools, lattice,
                                              existing=list(churn.existing)))
        full_ms = (time.perf_counter() - t) * 1e3
        placed = sum(len(n.pods) for n in plan.new_nodes) + sum(
            len(v) for v in plan.existing_assignments.values())
        ok_same = _same_plan(plan, same)
        ok_scratch = (_node_multiset(plan) == _node_multiset(scratch)
                      and abs(plan.new_node_cost - scratch.new_node_cost) <= 1e-6)
        if pass_i >= 0:
            rebuild_ms.append(full_ms)
            rows.append({"pass": pass_i, "ms": ms, "legs": legs,
                         "incremental": res.incremental,
                         "dirty_groups": len(res.dirty_groups),
                         "launches": launched, "full_rebuild_ms": full_ms})
            print(f"pass {pass_i}: {ms:.3f} ms, legs {legs}, incremental "
                  f"{res.incremental} ({len(res.dirty_groups)} dirty groups), "
                  f"{launched} launch(es), {len(plan.new_nodes)} new nodes, "
                  f"{placed}/{len(churn.pods)} pods placed; full rebuild "
                  f"{full_ms:.3f} ms; == sequential {ok_same}, "
                  f"== scratch {ok_scratch}", flush=True)
        if not (ok_same and ok_scratch):
            raise AssertionError(f"cfg10 pass {pass_i}: the plan differs from "
                                 f"a referee (same problem {ok_same}, "
                                 f"scratch build {ok_scratch})")
        if plan.unschedulable or placed != len(churn.pods):
            raise AssertionError(f"cfg10 pass {pass_i}: placed {placed}/"
                                 f"{len(churn.pods)}, "
                                 f"{len(plan.unschedulable)} unschedulable")
        oa.LAUNCHES = 0
    st = solver.pipeline_stats
    d = {k: st[k] - pre[k] for k in ("micro_solves", "micro_aborts",
                                     "micro_skipped_syncs", "micro_fetches",
                                     "delta_solves")}
    legs = [r["legs"] for r in rows]
    incremental = sum(r["incremental"] for r in rows)
    nochurn = passes // workloads.STEADY_NOCHURN_EVERY
    upload = solver.link_stats["upload_bytes"] - pre_link["upload_bytes"]
    fetch = solver.link_stats["fetch_bytes"] - pre_link["fetch_bytes"]
    pass_ms = [r["ms"] for r in rows]
    out = {
        "pods": len(churn.pods), "existing_nodes": len(churn.existing),
        "groups": res.problem.G, "passes": passes,
        "pass_p50_ms": statistics.median(pass_ms), "pass_min_ms": min(pass_ms),
        "pass_max_ms": max(pass_ms),
        "full_rebuild_p50_ms": statistics.median(rebuild_ms),
        "upload_bytes_per_pass": upload / passes,
        "fetch_bytes_per_pass": fetch / passes,
        "legs_per_pass": legs, "launches_per_pass": launches_per_pass,
        "stage_p50_ms": {k: statistics.median(v) for k, v in stages.items()},
        **d,
    }
    print(f"cfg10: pass p50 {out['pass_p50_ms']:.3f} ms (min "
          f"{out['pass_min_ms']:.3f}, max {out['pass_max_ms']:.3f}) over "
          f"{passes} passes; full rebuild p50 {out['full_rebuild_p50_ms']:.3f} "
          f"ms; upload {upload / passes:.1f} B/pass, fetch {fetch / passes:.1f} "
          f"B/pass; legs {legs}; launches {launches_per_pass}; compute p50 "
          f"{out['stage_p50_ms'].get('compute', 0.0):.3f} ms, download p50 "
          f"{out['stage_p50_ms'].get('download', 0.0):.3f} ms; {d}", flush=True)
    if incremental != passes or d["micro_solves"] != incremental:
        raise AssertionError(f"cfg10: {incremental} incremental builds, "
                             f"{d['micro_solves']} microloop passes of {passes}")
    if d["micro_aborts"] != 0:
        raise AssertionError(f"cfg10: {d['micro_aborts']} microloop aborts")
    if d["micro_skipped_syncs"] != nochurn:
        raise AssertionError(f"cfg10: {d['micro_skipped_syncs']} skipped "
                             f"fetches, expected {nochurn}")
    if max(legs) > 2:
        raise AssertionError(f"cfg10: a pass paid more than 2 legs: {legs}")
    if min(launches_per_pass) < 1:
        raise AssertionError(f"cfg10: a pass never launched the kernel: "
                             f"{launches_per_pass}")
    return out, res.problem


def _split(stack, result, wall_ms):
    """A pass's wall time split: the problem build, the solve (its
    ``solve_seconds``, whose stages are in ``stage_ms``), the launch loop,
    and the rest (explain, limits, bookkeeping)."""
    t = stack.timing
    solve_ms = (result.plan.solve_seconds * 1e3
                if result.plan is not None else 0.0)
    build = t.get("build", 0.0)
    loop = t.get("launch_loop", 0.0)
    return {"wall_ms": wall_ms, "build_ms": build, "solve_ms": solve_ms,
            "stage_ms": (dict(result.plan.stage_ms)
                         if result.plan is not None else {}),
            "launch_loop_ms": loop, "create_ms": t.get("create", 0.0),
            "rest_ms": wall_ms - build - solve_ms - loop}


def _fmt_split(d):
    return (f"wall {d['wall_ms']:.3f} ms = build {d['build_ms']:.3f} + solve "
            f"{d['solve_ms']:.3f} (stages "
            f"{ {k: round(v, 3) for k, v in d['stage_ms'].items()} }) + launch "
            f"loop {d['launch_loop_ms']:.3f} (CloudProvider.create "
            f"{d['create_ms']:.3f}) + rest {d['rest_ms']:.3f}")


def _check_pass(name, result):
    """No fallback may hide the card: a degraded pass, a launch failure or
    an unschedulable pod fails the phase."""
    if result.degraded:
        raise AssertionError(f"{name}: degraded pass ({result.degraded_reason})")
    if result.launch_failures:
        raise AssertionError(f"{name}: {result.launch_failures} launch failures")
    if result.pods_unschedulable:
        raise AssertionError(f"{name}: {result.pods_unschedulable} "
                             f"unschedulable pods")
    if result.plan is not None and result.plan.solver_path != "device":
        raise AssertionError(f"{name}: solver path {result.plan.solver_path}")


def _registered(name, stack, n_pods):
    c = stack.cluster
    phases = c.pod_phase_counts()
    unregistered = [k for k, cl in c.claims.items()
                    if cl.phase.value != "Initialized"]
    if unregistered or len(c.nodes) != len(c.claims):
        raise AssertionError(f"{name}: {len(unregistered)} claims did not "
                             f"register ({len(c.nodes)} nodes, "
                             f"{len(c.claims)} claims)")
    if phases["bound"] != n_pods or c.pending_pods():
        raise AssertionError(f"{name}: {phases} after registration, "
                             f"expected {n_pods} bound")


def _provisioner(torch, workloads, lattice, oa, cpu_plan):
    """Phase 6: the provisioning controller on the card."""
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.solver import Solver

    out, launches = {}, {}
    max_err = 0.0
    # (a) the cfg5 wave
    pods, pools, existing = workloads.config5_full_scale()
    if existing:
        raise AssertionError("cfg5 has no existing nodes to mirror")
    stack = workloads.ProvisionerStack(lattice, pools, Solver(lattice))
    if stack.solver.device.type != "cuda":
        raise AssertionError("provisioner: the Solver is not on the card")
    for p in pods:
        stack.cluster.add_pod(p)
    oa.LAUNCHES = 0
    result, wall = stack.provision()
    torch.cuda.synchronize()
    launches["provisioner_cfg5"] = oa.LAUNCHES
    _check_pass("cfg5 wave", result)
    plan = result.plan
    phases = stack.cluster.pod_phase_counts()
    launched_claims = all(c.phase.value == "Launched"
                          for c in stack.cluster.claims.values())
    split = _split(stack, result, wall)
    print(f"cfg5 wave: {len(result.created_claims)} claims, {result.launched} "
          f"launched, {result.pods_scheduled} pods scheduled, "
          f"{launches['provisioner_cfg5']} kernel launch(es); {_fmt_split(split)}",
          flush=True)
    if launches["provisioner_cfg5"] < 1:
        raise AssertionError("cfg5 wave: the kernel never launched")
    if (result.launched != len(result.created_claims) or not launched_claims
            or phases["nominated"] != len(pods) or result.pods_scheduled != len(pods)):
        raise AssertionError(f"cfg5 wave: {phases}, {result.launched} of "
                             f"{len(result.created_claims)} claims launched")
    if _node_rows(plan) != _node_rows(cpu_plan) \
            or plan.existing_assignments != cpu_plan.existing_assignments:
        raise AssertionError("cfg5 wave: the provisioner's plan differs from "
                             "the CPU plan")
    print(f"cfg5 wave: plan == cpu plan, node by node ({len(plan.new_nodes)} "
          f"nodes, ${plan.new_node_cost:.2f}/hr)", flush=True)
    reg_ms = stack.register()
    _registered("cfg5 wave", stack, len(pods))
    print(f"cfg5 wave: registration of {len(stack.cluster.nodes)} nodes bound "
          f"{len(pods)} pods in {reg_ms:.3f} ms", flush=True)
    out["cfg5_wave"] = {**split, "claims": len(result.created_claims),
                        "registration_ms": reg_ms,
                        "launches": launches["provisioner_cfg5"]}

    # (b) cfg10 through the provisioner
    pods, pools, shapes = workloads.config10_steady_state()
    solver = Solver(lattice)
    stack = workloads.ProvisionerStack(lattice, pools, solver)
    for p in pods:
        stack.cluster.add_pod(p)
    oa.LAUNCHES = 0
    result, wall = stack.provision()
    torch.cuda.synchronize()
    first_launches = oa.LAUNCHES
    _check_pass("cfg10 first wave", result)
    split = _split(stack, result, wall)
    reg_ms = stack.register()
    _registered("cfg10 first wave", stack, len(pods))
    print(f"cfg10 first wave: {len(result.created_claims)} claims, "
          f"{first_launches} kernel launch(es); {_fmt_split(split)}; "
          f"registration {reg_ms:.3f} ms", flush=True)
    out["cfg10_first_wave"] = {**split, "claims": len(result.created_claims),
                               "registration_ms": reg_ms}
    referee = Solver(lattice, pipeline=False)
    builder = stack.provisioner.inc_builder
    rows = []
    launches["provisioner_cfg10"] = 0
    for stage, churn, passes in (
            ("rate", workloads.ProvisionerChurn(shapes), workloads.STEADY_PASSES),
            ("small", workloads.SmallChurn(shapes), SMALL_PASSES)):
        for k in range(passes):
            gone, added, nochurn = churn.churn(stack.cluster, k)
            for _ in range(2):
                stack.provisioner.batch_ready()
                stack.clock.step(0.6)
            ref = None
            if not nochurn:
                ref = referee.solve(workloads.referee_problem(stack))
            pre_link = dict(solver.link_stats)
            pre_stats = dict(solver.pipeline_stats)
            pre_inc = builder.incremental_builds
            oa.LAUNCHES = 0
            if nochurn:
                result, wall = stack.provision()
            else:
                (result, wall), inputs = measure.captured_main_path_inputs(
                    stack.provision)
            torch.cuda.synchronize()
            launched = oa.LAUNCHES
            launches["provisioner_cfg10"] += launched
            _check_pass(f"cfg10 {stage} pass {k}", result)
            full = builder.incremental_builds == pre_inc
            same = None
            if ref is not None:
                same = all(
                    workloads.plan_digest(result.plan, stack.cluster.pods, exact)
                    == workloads.plan_digest(ref, stack.cluster.pods, exact)
                    for exact in ((False, True) if full else (False,)))
                # the referee ran the same kernel: hold the pass's own
                # kernel inputs against the plain version too
                max_err = max(max_err, measure.check_exact(
                    f"cfg10 {stage} pass {k} inputs", oa.cheapest_offering(*inputs),
                    oa.cheapest_offering_ref(*inputs)))
            split = _split(stack, result, wall)
            reg_ms = stack.register()
            row = {"stage": stage, "pass": k, "nochurn": nochurn,
                   "arrived": len(added), "left": len(gone),
                   "incremental": not full,
                   "reason": builder.last_reason,
                   "delta": solver.pipeline_stats["delta_solves"]
                   - pre_stats["delta_solves"],
                   "launches": launched, "registration_ms": reg_ms,
                   "legs": sum(solver.link_stats[d + "_legs"]
                               - pre_link[d + "_legs"] for d in ("upload", "fetch")),
                   "bytes": sum(solver.link_stats[d + "_bytes"]
                                - pre_link[d + "_bytes"] for d in ("upload", "fetch")),
                   "claims": len(result.created_claims), **split}
            rows.append(row)
            print(f"cfg10 {stage} pass {k}: -{len(gone)} +{len(added)} pods, "
                  f"incremental {row['incremental']} "
                  f"({row['reason'] or 'delta'}), delta {row['delta']}, "
                  f"{launched} launch(es), {row['claims']} claims, legs "
                  f"{row['legs']}, {row['bytes']} B; {_fmt_split(split)}; "
                  f"registration {reg_ms:.3f} ms; == scratch referee {same}",
                  flush=True)
            if same is False:
                raise AssertionError(f"cfg10 {stage} pass {k}: the plan differs "
                                     f"from the scratch referee")
            if not nochurn and launched < 1:
                raise AssertionError(f"cfg10 {stage} pass {k}: the kernel "
                                     f"never launched")
    st = solver.pipeline_stats
    co = stack.provisioner.stats()
    churned = [r for r in rows if not r["nochurn"]]
    walls = [r["wall_ms"] for r in churned]
    summary = {
        "passes": len(rows), "churned": len(churned),
        "pass_p50_ms": statistics.median(walls), "pass_min_ms": min(walls),
        "pass_max_ms": max(walls),
        "delta_solves": st["delta_solves"], "micro_solves": st["micro_solves"],
        "micro_aborts": st["micro_aborts"],
        "incremental_builds": builder.incremental_builds,
        "full_builds": builder.full_builds,
        "journal_ticks": co["journal_ticks"], "journal_takes": co["journal_takes"],
        "journal_take_fallbacks": co["journal_take_fallbacks"],
        "launches": launches["provisioner_cfg10"],
    }
    for stage in ("rate", "small"):
        sel = [r for r in churned if r["stage"] == stage]
        summary[stage] = {k: statistics.median([r[k] for r in sel]) for k in (
            "wall_ms", "build_ms", "solve_ms", "launch_loop_ms", "rest_ms",
            "registration_ms", "legs", "bytes")}
        summary[stage]["wall_min_ms"] = min(r["wall_ms"] for r in sel)
        summary[stage]["wall_max_ms"] = max(r["wall_ms"] for r in sel)
        summary[stage]["incremental"] = sum(r["incremental"] for r in sel)
        summary[stage]["reasons"] = sorted({r["reason"] for r in sel})
        print(f"cfg10 {stage} churn, p50 over {len(sel)} churned passes: "
              f"{ {k: (round(v, 3) if isinstance(v, float) else v) for k, v in summary[stage].items()} }",
              flush=True)
    print(f"cfg10 through the provisioner: pass p50 {summary['pass_p50_ms']:.3f} ms "
          f"(min {summary['pass_min_ms']:.3f}, max {summary['pass_max_ms']:.3f}); "
          f"delta_solves {st['delta_solves']}, incremental_builds "
          f"{builder.incremental_builds}, full_builds {builder.full_builds}, "
          f"micro_aborts {st['micro_aborts']}; journal ticks {co['journal_ticks']}, "
          f"takes {co['journal_takes']}, fallbacks {co['journal_take_fallbacks']}",
          flush=True)
    if st["delta_solves"] < 1 or builder.incremental_builds < 1:
        raise AssertionError(f"cfg10: the delta path never ran (last builder "
                             f"reason {builder.last_reason!r})")
    if st["micro_aborts"]:
        raise AssertionError(f"cfg10: {st['micro_aborts']} microloop aborts")
    if stack.cluster.pending_pods():
        raise AssertionError(f"cfg10: {len(stack.cluster.pending_pods())} pods "
                             f"left pending")
    print(f"cfg10: each churned pass's own kernel inputs matched the plain "
          f"version exactly ({len(churned)} passes)", flush=True)
    out["cfg10"] = {**summary, "rows": rows}
    out["max_abs_err"] = max_err
    return out, launches


def _consolidation(torch, workloads, lattice, oa):
    """Phase 7: cfg4's fleet (500 under-utilized nodes) through the
    consolidation stack on the card; returns its numbers, its launches and
    the first probe dispatch's kernel inputs."""
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.ops import binpack
    from karpenter_provider_aws_tpu_torch.solver import Solver

    solver = Solver(lattice)
    if solver.device.type != "cuda":
        raise AssertionError("consolidation: the Solver is not on the card")
    t = time.perf_counter()
    stack = workloads.config4_fleet_stack(lattice, solver)
    seed_ms = (time.perf_counter() - t) * 1e3
    ctrl, eng = stack.disruption, stack.disruption.engine
    cost0, unpriced = workloads.fleet_cost(stack)
    print(f"cfg4 fleet: {len(stack.cluster.nodes)} nodes, "
          f"{stack.cluster.pod_phase_counts()['bound']} pods bound, "
          f"${cost0:.4f}/hr over the priced offerings ({unpriced} nodes on "
          f"offerings the catalog does not price), seeded in {seed_ms:.1f} ms",
          flush=True)
    n_nodes = len(stack.cluster.nodes)
    n_pods = stack.cluster.pod_phase_counts()["bound"]
    if (n_nodes != len(stack.cluster.claims) or n_pods != 3 * n_nodes
            or stack.cluster.pending_pods()):
        raise AssertionError("cfg4: the fleet did not seed")

    # per-pass records, filled by wrappers around the stack's own objects
    rec = {}
    orig_probe = solver.probe_batch
    orig_pack = binpack.pack_probe_fused
    orig_what_if = ctrl._what_if
    orig_referee = eng.referee
    orig_build = eng._whatif_problem
    orig_accept = eng.note_accept
    orig_provision = stack.provisioner.provision_once

    def probe_batch(problems):
        before = oa.LAUNCHES
        t = time.perf_counter()
        out = orig_probe(problems)
        lp = solver.last_probe
        rec["dispatches"].append({
            "K": lp["K"], "padded": lp["padded"], "G": lp["G"], "B": lp["B"],
            "wall_ms": (time.perf_counter() - t) * 1e3,
            "launches": oa.LAUNCHES - before,
            "problems": list(problems), "summary": lp["summary"]})
        return out

    def pack_probe_fused(*a, **kw):
        # CUDA events around the batched pack's launches: the span from the
        # card reaching the first to finishing the last
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        out = orig_pack(*a, **kw)
        ev1.record()
        rec["pack_events"].append((ev0, ev1))
        return out

    def what_if(removed):
        before = oa.LAUNCHES
        t = time.perf_counter()
        plan, price = orig_what_if(removed)
        rec["what_ifs"].append({"ms": (time.perf_counter() - t) * 1e3,
                                "launches": oa.LAUNCHES - before,
                                "degraded": plan.degraded,
                                "path": plan.solver_path})
        return plan, price

    def referee(removed, plan, **kw):
        rec["in_referee"] = True
        t = time.perf_counter()
        try:
            ok, ratio = orig_referee(removed, plan, **kw)
        finally:
            rec["in_referee"] = False
        rec["referee"].append({"ms": (time.perf_counter() - t) * 1e3,
                               "claims": sorted(c.name for c in removed),
                               "ok": ok, "ratio": ratio})
        return ok, ratio

    def whatif_problem(*a, **kw):
        t = time.perf_counter()
        out = orig_build(*a, **kw)
        if not rec["in_referee"]:
            rec["build_ms"] += (time.perf_counter() - t) * 1e3
        return out

    def note_accept(removed, savings):
        rec["accepted"].append((sorted(c.name for c in removed), savings))
        return orig_accept(removed, savings)

    def provision_once():
        t = time.perf_counter()
        result = orig_provision()
        rec["ms"]["provision"] += (time.perf_counter() - t) * 1e3
        rec["provisions"].append(result)
        return result

    def timed(name, fn):
        def run():
            t = time.perf_counter()
            try:
                return fn()
            finally:
                rec["ms"][name] += (time.perf_counter() - t) * 1e3
        return run

    orig_reconciles = {name: getattr(stack, name).reconcile
                       for name in ("lifecycle", "disruption", "termination")}

    solver.probe_batch = probe_batch
    binpack.pack_probe_fused = pack_probe_fused
    ctrl._what_if = what_if
    eng.referee = referee
    eng._whatif_problem = whatif_problem
    eng.note_accept = note_accept
    stack.provisioner.provision_once = provision_once
    for name, fn in orig_reconciles.items():
        getattr(stack, name).reconcile = timed(name, fn)

    def poll_batch():
        # the provisioner's batch window closes on the clock, as between
        # the Operator's passes
        for _ in range(2):
            stack.provisioner.batch_ready()
            stack.clock.step(0.6)

    rows, launches_per_pass, max_err = [], [], 0.0
    first = None
    stack.clock.step(workloads.CFG4_CONSOLIDATE_AFTER + 1.0)
    try:
        for k in range(CONSOLIDATION_PASSES):
            rec.update(dispatches=[], pack_events=[], what_ifs=[], referee=[],
                       accepted=[], provisions=[], build_ms=0.0,
                       in_referee=False,
                       ms=dict.fromkeys(("provision", "lifecycle", "disruption",
                                         "termination"), 0.0))
            poll_batch()
            before_cost, _ = workloads.fleet_cost(stack)
            claims_before = set(stack.cluster.claims)
            in_flight_before = list(ctrl._in_flight)
            counters_before = dict(eng.counters)
            oa.LAUNCHES = 0
            t = time.perf_counter()
            _, inputs = measure.captured_kernel_inputs(stack.run_once)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            launched = oa.LAUNCHES
            launches_per_pass.append(launched)
            stack.clock.step(stack.registration_delay + 0.1)
            after_cost, _ = workloads.fleet_cost(stack)
            for i, inp in enumerate(inputs):
                max_err = max(max_err, measure.check_exact(
                    f"cfg4 pass {k} kernel call {i} inputs",
                    oa.cheapest_offering(*inp), oa.cheapest_offering_ref(*inp)))
            new_actions = [a for a in ctrl._in_flight if a not in in_flight_before]
            disp = rec["dispatches"]
            dev_ms = [e0.elapsed_time(e1) for e0, e1 in rec["pack_events"]]
            row = {
                "pass": k, "wall_ms": wall_ms, "launches": launched,
                "kernel_calls_checked": len(inputs),
                "dispatches": [{kk: d[kk] for kk in ("K", "padded", "G", "B",
                                                     "wall_ms", "launches")}
                               for d in disp],
                "pack_device_span_ms": dev_ms,
                "build_ms": rec["build_ms"],
                "what_ifs": [(w["ms"], w["launches"]) for w in rec["what_ifs"]],
                "referee_ms": [r["ms"] for r in rec["referee"]],
                "accepted": [(len(c), s) for c, s in rec["accepted"]],
                "removed": len(claims_before - set(stack.cluster.claims)),
                "removed_claims": sorted(claims_before - set(stack.cluster.claims)),
                "decided": sum(len(a.claims) for a in new_actions),
                "replacements": sum(len(a.replacements) for a in new_actions),
                "controller_ms": dict(rec["ms"]),
                "cost_before": before_cost, "cost_after": after_cost,
                "pending_after": len(stack.cluster.pending_pods()),
                "host_fallbacks": eng.counters["host_fallbacks"]
                - counters_before["host_fallbacks"],
            }
            rows.append(row)
            print(f"cfg4 pass {k}: "
                  + "; ".join(f"K={d['K']} (padded {d['padded']}) G={d['G']} "
                              f"B={d['B']}, dispatch wall {d['wall_ms']:.3f} ms, "
                              f"{d['launches']} launch(es)" for d in row["dispatches"])
                  + f"; pack device span {[round(x, 3) for x in dev_ms]} ms; "
                  f"host build of the what-if problems {rec['build_ms']:.3f} ms; "
                  f"exact what-ifs {[round(w[0], 3) for w in row['what_ifs']]} ms "
                  f"({[w[1] for w in row['what_ifs']]} launches); referee "
                  f"{[round(x, 3) for x in row['referee_ms']]} ms; decided to "
                  f"remove {row['decided']} nodes with {row['replacements']} "
                  f"replacement(s), {row['removed']} terminated; fleet "
                  f"${before_cost:.4f}/hr -> ${after_cost:.4f}/hr; "
                  f"{row['pending_after']} pods pending; pass wall "
                  f"{wall_ms:.3f} ms (controllers "
                  f"{ {n: round(v, 3) for n, v in rec['ms'].items()} } ms); "
                  f"{launched} kernel launch(es), "
                  f"{len(inputs)} kernel calls' inputs exact", flush=True)
            # the phase's gates
            if row["host_fallbacks"]:
                raise AssertionError(f"cfg4 pass {k}: {row['host_fallbacks']} "
                                     f"host fallbacks")
            for d in row["dispatches"]:
                if d["launches"] != 1:
                    raise AssertionError(f"cfg4 pass {k}: a probe dispatch "
                                         f"launched the kernel {d['launches']} times")
            for w in rec["what_ifs"]:
                if w["launches"] != 1 or w["degraded"] or w["path"] != "device":
                    raise AssertionError(f"cfg4 pass {k}: an exact what-if "
                                         f"launched {w['launches']} times "
                                         f"(degraded {w['degraded']}, {w['path']})")
            for res in rec["provisions"]:
                _check_pass(f"cfg4 pass {k} provisioning", res)
            passed = [r["claims"] for r in rec["referee"] if r["ok"]]
            for names, _ in rec["accepted"]:
                if names not in passed:
                    raise AssertionError(f"cfg4 pass {k}: an accepted removal "
                                         f"({len(names)} nodes) was not refereed")
            if after_cost > before_cost:
                raise AssertionError(f"cfg4 pass {k}: fleet $/hr went up, "
                                     f"{before_cost} -> {after_cost}")
            if k == 0:
                if not rec["accepted"]:
                    raise AssertionError("cfg4: the first pass consolidated nothing")
                if len(disp) != 1:
                    raise AssertionError(f"cfg4: the first pass made {len(disp)} "
                                         f"probe dispatches")
                first = disp[0]
                first["inputs"] = next(
                    inp for inp in inputs
                    if inp[0].shape[0] == first["padded"] * first["B"])
    finally:
        solver.probe_batch = orig_probe
        binpack.pack_probe_fused = orig_pack
        ctrl._what_if = orig_what_if
        eng.referee = orig_referee
        eng._whatif_problem = orig_build
        eng.note_accept = orig_accept
        stack.provisioner.provision_once = orig_provision
        for name, fn in orig_reconciles.items():
            getattr(stack, name).reconcile = fn

    # the evictees of the last pass's terminations take their pass
    poll_batch()
    if stack.cluster.pending_pods():
        result = stack.provisioner.provision_once()
        _check_pass("cfg4 final provisioning", result)
        stack.register()
    end_cost, _ = workloads.fleet_cost(stack)
    if stack.cluster.pending_pods():
        raise AssertionError(f"cfg4: {len(stack.cluster.pending_pods())} pods "
                             f"left pending at the end")
    if end_cost > rows[-1]["cost_after"]:
        raise AssertionError("cfg4: the final provisioning raised the fleet $/hr")

    # batched against unbatched on the card: every probe of the first
    # dispatch alone
    cols = binpack.ProbeSummary._fields
    ci = cols.index("new_cost")

    def same_row(a, b):
        counts = all(a[j] == b[j] for j in range(len(cols)) if j != ci)
        return counts and (a[ci] == b[ci]
                           or abs(a[ci] - b[ci]) <= 1e-6 * abs(b[ci]))

    summ = first["summary"]
    for i, p in enumerate(first["problems"]):
        orig_probe([p])
        if not same_row(solver.last_probe["summary"][0], summ[i]):
            raise AssertionError(f"cfg4: probe {i} of the first dispatch alone "
                                 f"{solver.last_probe['summary'][0]} != batched "
                                 f"{summ[i]}")
    print(f"cfg4: each of the first dispatch's {len(first['problems'])} probes "
          f"alone (K=1) equals its batched row", flush=True)
    # card against CPU: the largest prefix and one single (the first pass's
    # dispatch holds every prefix, largest last, then the singles)
    n_prefix = len(first["problems"]) - ctrl.MAX_SINGLE_PROBES
    picks = {"largest prefix": n_prefix - 1, "first single": n_prefix}
    cpu = Solver(lattice, device="cpu")
    for name, i in picks.items():
        t = time.perf_counter()
        cpu.probe_batch([first["problems"][i]])
        got = cpu.last_probe["summary"][0]
        if not same_row(summ[i], got):
            raise AssertionError(f"cfg4: the {name} probe on the card {summ[i]} "
                                 f"!= on the CPU {got}")
        print(f"cfg4: the {name} probe (E={first['problems'][i].E}, "
              f"{int(first['problems'][i].count.sum())} pods) on the card == on "
              f"the CPU ({(time.perf_counter() - t):.1f} s on the CPU): "
              f"{dict(zip(cols, summ[i].tolist()))}", flush=True)
    # the device's busy time in one dispatch of the first pass's problems
    wall_ms, dev_ms, n_kernels = measure.profiled_device_ms(
        lambda: orig_probe(first["problems"]))
    print(f"cfg4: one probe dispatch of {len(first['problems'])} probes under "
          f"the profiler: wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms "
          f"({n_kernels} kernels), idle share {1.0 - dev_ms / wall_ms:.3f}",
          flush=True)

    st = eng.stats()
    out = {
        "nodes": n_nodes, "pods": n_pods, "seed_ms": seed_ms,
        "fleet_cost_start": cost0, "fleet_cost_end": end_cost,
        "unpriced_nodes": unpriced, "nodes_end": len(stack.cluster.nodes),
        "passes": rows, "engine": st,
        "first_dispatch": {k: first[k] for k in ("K", "padded", "G", "B",
                                                 "wall_ms", "launches")},
        "profiled_dispatch": {"wall_ms": wall_ms, "device_ms": dev_ms,
                              "kernels": n_kernels,
                              "idle_share": 1.0 - dev_ms / wall_ms},
        "max_abs_err": max_err,
    }
    print(f"cfg4: {CONSOLIDATION_PASSES} passes, {st['accepted']:.0f} removals "
          f"accepted, {st['nodes_consolidated']:.0f} nodes consolidated, "
          f"${cost0:.4f}/hr -> ${end_cost:.4f}/hr, {len(stack.cluster.nodes)} "
          f"nodes; referee {st['referee_checks']:.0f} checks, "
          f"{st['referee_rejects']:.0f} rejects; host fallbacks "
          f"{st['host_fallbacks']:.0f}; launches per pass {launches_per_pass}",
          flush=True)
    return out, sum(launches_per_pass), launches_per_pass, first["inputs"]


def _operator(torch, workloads, lattice, oa, cpu_plan, consol):
    """Phase 8: the Operator in direct mode on the card (``Operator`` with
    no device: ``cuda``). (a) cfg4's fleet through 8 ``run_once`` passes,
    each deciding as the consolidation phase's stack did; (b) the cfg5
    wave through one forced pass, its plan equal to the CPU plan, then
    registration. Returns its numbers and launches."""
    from karpenter_provider_aws_tpu_torch import introspect
    from karpenter_provider_aws_tpu_torch.metrics import lint_exposition
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock

    def on_card(op, name):
        if op.device.type != "cuda" or op.solver.device.type != "cuda":
            raise AssertionError(f"{name}: the Operator's Solver is on "
                                 f"{op.solver.device}, not the card")

    def capture_provisions(op, into):
        orig = op.provisioner.provision_once

        def provision_once(*a, **kw):
            result = orig(*a, **kw)
            into.append(result)
            return result
        op.provisioner.provision_once = provision_once

    def check_surfaces(op, name):
        """Every introspection provider reports, /metrics lints clean, and
        the SLO cost referee raised nothing."""
        snap = introspect.registry().collect()
        bad = {k: v["error"] for k, v in snap.items() if "error" in v}
        if bad:
            raise AssertionError(f"{name}: introspection providers failed: {bad}")
        problems = lint_exposition(op.metrics.render())
        if problems:
            raise AssertionError(f"{name}: /metrics lint: {problems[:5]}")
        slo = op.slo.stats()
        if slo["referee_errors"]:
            raise AssertionError(f"{name}: {slo['referee_errors']} SLO "
                                 f"cost-referee errors")
        print(f"{name}: {len(snap)} introspection providers report, /metrics "
              f"lints clean ({len(op.metrics.render().splitlines())} lines), "
              f"SLO referee {slo['referee_runs']} run(s), "
              f"{slo['referee_errors']} errors", flush=True)
        return slo

    out = {}
    # (a) cfg4's fleet
    t = time.perf_counter()
    op = workloads.config4_fleet_operator(lattice)
    seed_ms = (time.perf_counter() - t) * 1e3
    on_card(op, "operator cfg4")
    cost0, unpriced = workloads.fleet_cost(op)
    if (cost0 != consol["fleet_cost_start"] or unpriced != consol["unpriced_nodes"]
            or len(op.cluster.nodes) != consol["nodes"]):
        raise AssertionError("operator cfg4: the fleet did not seed as the "
                             "stack's did")
    print(f"operator cfg4: {len(op.cluster.nodes)} nodes seeded in "
          f"{seed_ms:.1f} ms, ${cost0:.4f}/hr", flush=True)
    ms = workloads.time_controllers(op)
    provisions = []
    capture_provisions(op, provisions)
    eng = op.disruption.engine
    delay = op.options.registration_delay
    op.clock.step(workloads.CFG4_CONSOLIDATE_AFTER + 1.0)
    rows = []
    for k in range(CONSOLIDATION_PASSES):
        for _ in range(2):
            op.provisioner.batch_ready()
            op.clock.step(0.6)
        before = set(op.cluster.claims)
        fallbacks = eng.counters["host_fallbacks"]
        ms.clear()
        provisions.clear()
        oa.LAUNCHES = 0
        t = time.perf_counter()
        op.run_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        launched = oa.LAUNCHES
        op.clock.step(delay + 0.1)
        removed = sorted(before - set(op.cluster.claims))
        cost, _ = workloads.fleet_cost(op)
        ref = consol["passes"][k]
        row = {"pass": k, "wall_ms": wall_ms, "launches": launched,
               "removed": len(removed), "cost_after": cost,
               "controller_ms": dict(ms),
               "pending_after": len(op.cluster.pending_pods())}
        rows.append(row)
        print(f"operator cfg4 pass {k}: {len(removed)} nodes removed, fleet "
              f"${cost:.4f}/hr, {launched} kernel launch(es) through the "
              f"Operator, wall {wall_ms:.3f} ms (controllers "
              f"{ {n: round(v, 3) for n, v in ms.items()} } ms)", flush=True)
        for res in provisions:
            _check_pass(f"operator cfg4 pass {k} provisioning", res)
        if eng.counters["host_fallbacks"] != fallbacks:
            raise AssertionError(f"operator cfg4 pass {k}: host fallback")
        if removed != ref["removed_claims"] or cost != ref["cost_after"]:
            raise AssertionError(
                f"operator cfg4 pass {k}: removed {len(removed)} nodes to "
                f"${cost}/hr, the stack removed {ref['removed']} to "
                f"${ref['cost_after']}/hr")
        if launched != ref["launches"] or launched < 1:
            raise AssertionError(f"operator cfg4 pass {k}: {launched} kernel "
                                 f"launches, the stack's pass {ref['launches']}")
    # the evictees of the last pass's terminations take their pass, as in
    # the consolidation phase
    for _ in range(2):
        op.provisioner.batch_ready()
        op.clock.step(0.6)
    if op.cluster.pending_pods():
        _check_pass("operator cfg4 final provisioning",
                    op.provisioner.provision_once())
        op.clock.step(delay + 0.1)
        op.lifecycle.reconcile()
    end_cost, _ = workloads.fleet_cost(op)
    if op.cluster.pending_pods() or end_cost != consol["fleet_cost_end"]:
        raise AssertionError(f"operator cfg4: ${end_cost}/hr and "
                             f"{len(op.cluster.pending_pods())} pods pending at "
                             f"the end, the stack ${consol['fleet_cost_end']}/hr")
    print(f"operator cfg4: every pass decided as the stack's (removed claims "
          f"and $/hr), ${cost0:.4f}/hr -> ${end_cost:.4f}/hr, "
          f"{len(op.cluster.nodes)} nodes", flush=True)
    slo4 = check_surfaces(op, "operator cfg4")
    out["cfg4"] = {"passes": rows, "fleet_cost_end": end_cost, "seed_ms": seed_ms,
                   "engine": eng.stats(), "slo": slo4}

    # (b) the cfg5 wave
    # the wave's 1,840 nodes need /20 subnets (workloads.wave_cloud): the
    # fake network's default /24s stop a wave at ~250 launches a zone
    pods, pools, existing = workloads.config5_full_scale()
    clock = FakeClock()
    op = Operator(options=Options(registration_delay=workloads.REGISTRATION_DELAY),
                  lattice=lattice, cloud=workloads.wave_cloud(clock), clock=clock,
                  node_pools=pools)
    on_card(op, "operator cfg5")
    ms = workloads.time_controllers(op)
    provisions = []
    capture_provisions(op, provisions)
    referee = []
    orig_referee = op.slo.maybe_cost_referee

    def maybe_cost_referee(plan, build):
        t = time.perf_counter()
        ratio = orig_referee(plan, build)
        referee.append(((time.perf_counter() - t) * 1e3, ratio))
        return ratio
    op.slo.maybe_cost_referee = maybe_cost_referee
    for p in pods:
        op.cluster.add_pod(p)
    oa.LAUNCHES = 0
    t = time.perf_counter()
    op.run_once(force_provision=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    launched = oa.LAUNCHES
    wave_ms = dict(ms)
    if len(provisions) != 1:
        raise AssertionError(f"operator cfg5: {len(provisions)} provisioning passes")
    result = provisions[0]
    _check_pass("operator cfg5 wave", result)
    plan = result.plan
    referee_ms = sum(r[0] for r in referee)
    ratios = [r[1] for r in referee if r[1] is not None]
    print(f"operator cfg5 wave: {len(result.created_claims)} claims, "
          f"{result.launched} launched, {result.pods_scheduled} pods scheduled, "
          f"{launched} kernel launch(es) through the Operator; pass wall "
          f"{wall_ms:.3f} ms (controllers "
          f"{ {n: round(v, 3) for n, v in wave_ms.items()} } ms)", flush=True)
    print(f"operator cfg5 wave: of it the SLO cost referee (host FFD) "
          f"{referee_ms:.3f} ms, cost ratio {ratios}", flush=True)
    if launched < 1:
        raise AssertionError("operator cfg5: the kernel never launched")
    if _node_rows(plan) != _node_rows(cpu_plan) \
            or plan.existing_assignments != cpu_plan.existing_assignments:
        raise AssertionError("operator cfg5: the plan differs from the CPU plan")
    if result.launched != len(result.created_claims) \
            or result.pods_scheduled != len(pods):
        raise AssertionError(f"operator cfg5: {result.launched} of "
                             f"{len(result.created_claims)} claims launched, "
                             f"{result.pods_scheduled} pods scheduled")
    if not ratios or not all(r <= 1.02 for r in ratios):
        raise AssertionError(f"operator cfg5: SLO referee cost ratio {ratios}")
    print(f"operator cfg5 wave: plan == cpu plan, node by node "
          f"({len(plan.new_nodes)} nodes, ${plan.new_node_cost:.2f}/hr)",
          flush=True)
    # registration: the lifecycle controller alone, as the provisioner
    # phase registers (a whole pass would also let disruption act on the
    # fresh nodes)
    reg_rounds, reg = 0, []
    while reg_rounds < 5 and not all(
            op.cluster.node_for_claim(c.name) is not None
            for c in op.cluster.snapshot_claims()):
        op.clock.step(op.options.registration_delay + 0.1)
        ms.clear()
        t = time.perf_counter()
        op.lifecycle.reconcile()
        reg.append((time.perf_counter() - t) * 1e3)
        reg_rounds += 1
    _registered("operator cfg5", op, len(pods))
    print(f"operator cfg5 wave: registration of {len(op.cluster.nodes)} nodes "
          f"bound {len(pods)} pods in {reg_rounds} lifecycle pass(es), "
          f"{[round(w, 3) for w in reg]} ms", flush=True)
    slo5 = check_surfaces(op, "operator cfg5")
    out["cfg5_wave"] = {"wall_ms": wall_ms, "controller_ms": wave_ms,
                        "referee_ms": referee_ms, "referee_ratios": ratios,
                        "claims": len(result.created_claims), "launches": launched,
                        "registration_ms": reg, "slo": slo5}
    launches = {"operator_cfg4": sum(r["launches"] for r in rows),
                "operator_cfg5": launched}
    return out, launches


# every Solver the script makes, and the rungs off the device path each
# may have taken (id -> expected degraded_counts; absent = none)
_SOLVERS = []
_ALLOWED = {}


def _track_solvers(solver_cls) -> None:
    """Keep every Solver the script makes (the Operator's included), so
    that ``_check_solvers`` can hold each to the rungs it was allowed."""
    init = solver_cls.__init__

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        _SOLVERS.append(self)
    solver_cls.__init__ = tracked


def _check_solvers(torch, name) -> None:
    """No fallback hides the card: every Solver made so far ends with no
    FaultInjector attached and exactly the ``degraded_counts`` its phase
    allowed (none, unless a fault was injected or the wave split is the
    point). On the card a real CUDA fault raises once its retry failed,
    but a retry that recovered leaves only a plan that passes: its count
    fails the phase here."""
    torch.cuda.synchronize()
    for s in _SOLVERS:
        want = _ALLOWED.get(id(s), {})
        if s.faults is not None:
            raise AssertionError(f"{name}: a Solver ends with a FaultInjector "
                                 f"attached ({s.faults})")
        if dict(s.degraded_counts) != want:
            raise AssertionError(f"{name}: a Solver left the device path: "
                                 f"degraded_counts {s.degraded_counts}, "
                                 f"expected {want}")
    print(f"{name}: all {len(_SOLVERS)} Solvers so far off the device path "
          f"only where allowed", flush=True)


def _referee(problem):
    """The first-fit-decreasing referee's plan of ``problem``: the native
    referee (C++, ~0.1-0.2 s on cfg5), held to the Python ``ffd_oracle``
    on cfg5 in phase 17 (node count equal, cost within 1e-5), which takes
    10-26 s on cfg5, cfg7 and cfg11; the Python oracle for a problem out
    of the native referee's scope."""
    from karpenter_provider_aws_tpu_torch.native import native_ffd_pack
    from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle
    plan = native_ffd_pack(problem)
    return plan if plan is not None else ffd_oracle(problem)


def _placed(plan) -> int:
    return sum(len(n.pods) for n in plan.new_nodes) + sum(
        len(v) for v in plan.existing_assignments.values())


def _wave_split(torch, workloads, lattice, oa):
    """Phase 9: (a) cfg7, 4,608 distinct signatures, through the wave split
    on the card, sequential and pipelined; (b) its first 320 pods under
    ``FaultInjector(g_limit=64)``, card against CPU. Returns its numbers,
    launches and the last wave's kernel inputs."""
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.solver import FaultInjector, Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    pods, pools, _ = workloads.config7_highG_wave_split()
    t = time.perf_counter()
    problem = build_problem(pods, pools, lattice)
    build_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    oracle = _referee(problem)
    ceiling = Solver._WAVE_G_TARGET
    waves = -(-problem.G // ceiling)
    print(f"cfg7: {len(pods)} pods, G={problem.G} (build {build_ms:.1f} ms), "
          f"{waves} waves of <= {ceiling} groups expected; ffd referee "
          f"{oracle.num_new_nodes} nodes, ${oracle.new_node_cost:.3f}/hr "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    solvers = {"cfg7_sequential": Solver(lattice, pipeline=False),
               "cfg7_pipelined": Solver(lattice)}
    first, inputs, wave_b = None, None, None
    e2e = {path: [] for path in solvers}
    stages = {path: {} for path in solvers}
    order = []
    for i in range(WAVE_SOLVES):
        order += list(solvers) if i % 2 == 0 else list(solvers)[::-1]
    solves = {path: 0 for path in solvers}
    launched_per_solve = set()
    for path in order:
        s = solvers[path]
        pre = s.pipeline_stats["prefetched_waves"]
        first_of_path = solves[path] == 0
        oa.LAUNCHES = 0
        t = time.perf_counter()
        if first_of_path:
            # the first solve of each path also captures every wave's
            # kernel inputs (five small copies against seconds of issue)
            plan, captured = measure.captured_kernel_inputs(
                lambda: s.solve(problem))
        else:
            plan = s.solve(problem)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = oa.LAUNCHES
        launched_per_solve.add(launched)
        solves[path] += 1
        prefetched = s.pipeline_stats["prefetched_waves"] - pre
        ratio = plan.new_node_cost / oracle.new_node_cost
        placed = _placed(plan)
        print(f"{path} solve {solves[path]}{' (inputs captured)' if first_of_path else ''}: "
              f"{ms:.1f} ms, {plan.solver_path}/{plan.degraded_reason}, "
              f"{plan.waves} waves, {launched} launches, {len(plan.new_nodes)} "
              f"nodes ${plan.new_node_cost:.3f}/hr (ratio {ratio:.6f}), {placed} "
              f"placed, prefetched {prefetched}", flush=True)
        if (plan.solver_path, plan.degraded_reason, plan.waves,
                plan.device_retries) != ("wave-split", "g-overflow", waves, 0):
            raise AssertionError(f"{path}: {plan.solver_path}/"
                                 f"{plan.degraded_reason}, {plan.waves} waves, "
                                 f"{plan.device_retries} retries")
        if launched != waves:
            raise AssertionError(f"{path}: {launched} kernel launches, "
                                 f"expected {waves}")
        if placed != len(pods) or plan.unschedulable:
            raise AssertionError(f"{path}: placed {placed}/{len(pods)}, "
                                 f"{len(plan.unschedulable)} unschedulable")
        if not ratio <= 1.02:
            raise AssertionError(f"{path}: cost ratio {ratio} above 1.02")
        if prefetched != (waves - 1 if s.pipeline else 0):
            raise AssertionError(f"{path}: {prefetched} prefetched waves")
        if any(k.startswith("__wave") for k in plan.existing_assignments):
            raise AssertionError(f"{path}: a wave's pseudo bin leaked")
        if first is None:
            first = plan
        elif not _same_plan(plan, first):
            raise AssertionError(f"{path}: the plan differs from "
                                 f"{order[0]}'s first plan")
        if first_of_path:
            if len(captured) != waves:
                raise AssertionError(f"{path}: {len(captured)} kernel calls "
                                     f"captured, expected {waves}")
            wave_b = [int(c[0].shape[0]) for c in captured]
            inputs = captured[-1]
        e2e[path].append(ms)
        for k, v in plan.stage_ms.items():
            stages[path].setdefault(k, []).append(v)
    for path, s in solvers.items():
        _ALLOWED[id(s)] = {"wave_split": solves[path]}
    tm, zc, pr = inputs
    err = measure.check_exact("cfg7 last wave", oa.cheapest_offering(tm, zc, pr),
                              oa.cheapest_offering_ref(tm, zc, pr))
    out = {"pods": len(pods), "groups": problem.G, "waves": waves,
           "wave_B": wave_b, "nodes": len(first.new_nodes),
           "cost": first.new_node_cost, "oracle_cost": oracle.new_node_cost,
           "oracle_nodes": oracle.num_new_nodes, "max_abs_err": err}
    for path in solvers:
        med = {k: statistics.median(v) for k, v in stages[path].items()}
        out[path] = {"e2e_p50_ms": statistics.median(e2e[path]),
                     "e2e_ms": e2e[path], "stage_p50_ms": med}
        print(f"{path}: e2e p50 {out[path]['e2e_p50_ms']:.3f} ms over "
              f"{WAVE_SOLVES} solves {[round(x, 3) for x in e2e[path]]}; stage "
              f"p50 ms { {k: round(v, 3) for k, v in med.items()} }", flush=True)
    print(f"cfg7: sequential and pipelined plans equal node by node; wave B "
          f"{wave_b}; last wave's kernel inputs exact against the plain "
          f"version", flush=True)

    # (b) a cut of cfg7 under an injected group ceiling, card against CPU
    cut = pods[:WAVE_CUT_PODS]
    plans = {}
    for name, kw in (("card", {}), ("cpu", {"device": "cpu"})):
        s = Solver(lattice, **kw)
        s.inject_faults(FaultInjector(g_limit=WAVE_CUT_G_LIMIT))
        prob = build_problem(cut, pools, lattice)
        oa.LAUNCHES = 0
        t = time.perf_counter()
        plan = s.solve(prob)
        if s.device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        fired = dict(s.faults.fired)
        s.inject_faults(None)
        _ALLOWED[id(s)] = {"wave_split": 1}
        print(f"cfg7 cut, {name}: G={prob.G}, {plan.solver_path}, {plan.waves} "
              f"waves, {oa.LAUNCHES} launches, {len(plan.new_nodes)} nodes "
              f"${plan.new_node_cost:.3f}/hr, {ms:.1f} ms, fired {fired}",
              flush=True)
        want_waves = -(-prob.G // WAVE_CUT_G_LIMIT)
        if (plan.solver_path, plan.waves, fired) != (
                "wave-split", want_waves, {"g_overflow": 1}):
            raise AssertionError(f"cfg7 cut, {name}: {plan.solver_path}, "
                                 f"{plan.waves} waves, fired {fired}")
        if name == "card" and oa.LAUNCHES != want_waves:
            raise AssertionError(f"cfg7 cut: {oa.LAUNCHES} launches on the card")
        if _placed(plan) != len(cut) or plan.unschedulable:
            raise AssertionError(f"cfg7 cut, {name}: placed {_placed(plan)}")
        plans[name] = plan
    if not _same_plan(plans["card"], plans["cpu"]):
        raise AssertionError("cfg7 cut: the card's plan differs from the CPU's")
    print(f"cfg7 cut ({len(cut)} pods, g_limit {WAVE_CUT_G_LIMIT}, "
          f"{plans['card'].waves} waves): card plan == cpu plan, node by node",
          flush=True)
    out["cut"] = {"pods": len(cut), "g_limit": WAVE_CUT_G_LIMIT,
                  "waves": plans["card"].waves}
    # every solve launched ``waves`` times (checked above): the one reading
    (per_solve,) = launched_per_solve
    launches = {"cfg7_per_solve": per_solve}
    return out, launches, inputs


def _ladder(torch, workloads, lattice, oa):
    """Phase 10: each rung of the degradation ladder forced on the card by
    a FaultInjector, on cfg10's problem, each on a fresh Solver with a
    FakeClock; then a fault mid-microloop on cfg10's steady passes."""
    from karpenter_provider_aws_tpu_torch.solver import FaultInjector, Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock

    pods, pools, shapes = workloads.config10_steady_state()
    # the 20k pending pods alone (their own bins, so that a b_limit of 32
    # exhausts the table rather than cutting the existing nodes off)
    problem = build_problem(pods, pools, lattice)
    out = {}

    def run(name, faults):
        clock = FakeClock()
        s = Solver(lattice, clock=clock)
        if faults is not None:
            s.inject_faults(faults)
        t0 = clock.monotonic()
        oa.LAUNCHES = 0
        t = time.perf_counter()
        plan = s.solve(problem)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        row = {"path": plan.solver_path, "reason": plan.degraded_reason,
               "retries": plan.device_retries, "launches": oa.LAUNCHES,
               "degraded_counts": dict(s.degraded_counts),
               "fired": dict(faults.fired) if faults else {},
               "backoff_s": clock.monotonic() - t0, "ms": ms}
        out[name] = row
        print(f"ladder {name}: {row}", flush=True)
        return s, plan, row

    _, ref, row = run("unfaulted", None)
    if row["path"] != "device" or row["launches"] < 1 or ref.degraded:
        raise AssertionError(f"ladder unfaulted: {row}")
    cases = (
        ("device_errors=1", FaultInjector(device_errors=1),
         ("device", "", 1, {"device_retry": 1}, {"device_error": 1})),
        ("device_errors=2", FaultInjector(device_errors=2),
         ("host-ffd", "device-error", 1, {"device_retry": 1, "host_ffd": 1},
          {"device_error": 2})),
        ("b_limit=32", FaultInjector(b_limit=32),
         ("host-ffd", "b-exhausted", 0, {"host_ffd": 1}, {"b_exhausted": 1})),
    )
    for name, faults, want in cases:
        s, plan, row = run(name, faults)
        got = (row["path"], row["reason"], row["retries"],
               row["degraded_counts"], row["fired"])
        if got != want:
            raise AssertionError(f"ladder {name}: {got}, expected {want}")
        if abs(row["backoff_s"] - 0.05 * row["retries"]) > 1e-9:
            raise AssertionError(f"ladder {name}: the clock advanced "
                                 f"{row['backoff_s']} s")
        if name == "device_errors=1":
            if not _same_plan(plan, ref) or row["launches"] < 1:
                raise AssertionError(f"ladder {name}: the retried plan differs "
                                     f"from the unfaulted one")
        elif name == "device_errors=2":
            if row["launches"] != 0:
                raise AssertionError(f"ladder {name}: {row['launches']} launches "
                                     f"on the failed attempts")
            if not _same_plan(plan, s.solve_host_ffd(problem)):
                raise AssertionError(f"ladder {name}: the plan differs from "
                                     f"solve_host_ffd")
        elif row["launches"] < 1:
            raise AssertionError(f"ladder {name}: the overflowing pack never "
                                 f"launched")
        if _placed(plan) != len(pods):
            raise AssertionError(f"ladder {name}: placed {_placed(plan)}")
        counts = dict(s.degraded_counts)
        s.inject_faults(None)
        oa.LAUNCHES = 0
        again = s.solve(problem)
        torch.cuda.synchronize()
        if (dict(s.degraded_counts) != counts or again.solver_path != "device"
                or not _same_plan(again, ref) or oa.LAUNCHES < 1):
            raise AssertionError(f"ladder {name}: after inject_faults(None) "
                                 f"{again.solver_path}, {s.degraded_counts}")
        _ALLOWED[id(s)] = counts

    # real failures on the card raise instead of landing on the host FFD: a
    # launch that fails is retried once, a kernel that does not build is not
    from karpenter_provider_aws_tpu_torch.errors import (KernelBuildError,
                                                          SolverDeviceError)

    def failing_launch():
        return lambda *a: 700     # cudaErrorIllegalAddress

    def failing_build():
        raise KernelBuildError("nvcc failed for offering_argmin.cu")

    launcher = oa._launcher
    for name, fake, raised, want in (
            ("launch fails", failing_launch, SolverDeviceError,
             {"device_retry": 1}),
            ("build fails", failing_build, KernelBuildError, {})):
        clock = FakeClock()
        s = Solver(lattice, clock=clock)
        oa._launcher = fake
        try:
            s.solve(problem)
        except raised as e:
            got = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError(f"ladder {name}: the solve did not raise")
        finally:
            oa._launcher = launcher
        counts = dict(s.degraded_counts)
        print(f"ladder {name}: raised {got}; degraded_counts {counts}; clock "
              f"{clock.monotonic():.2f} s", flush=True)
        if counts != want:
            raise AssertionError(f"ladder {name}: degraded_counts {counts}, "
                                 f"expected {want}")
        oa.LAUNCHES = 0
        again = s.solve(problem)
        torch.cuda.synchronize()
        if again.degraded or not _same_plan(again, ref) or oa.LAUNCHES < 1:
            raise AssertionError(f"ladder {name}: the next solve "
                                 f"{again.solver_path}, {oa.LAUNCHES} launches")
        out[name] = {"raised": got, "degraded_counts": counts}
        _ALLOWED[id(s)] = counts

    # a fault mid-microloop, on one of cfg10's steady passes
    churn = workloads.SteadyStateChurn(lattice, pods, shapes)
    s = Solver(lattice, clock=FakeClock())
    referee = Solver(lattice, pipeline=False)
    rows = []
    for pass_i, res, plan, ms, legs in workloads.steady_state_passes(
            s, lattice, pools, churn, LADDER_PASSES):
        torch.cuda.synchronize()
        st = dict(s.pipeline_stats)
        if pass_i >= 0:
            same = _same_plan(plan, referee.solve(res.problem))
            rows.append({"pass": pass_i, "micro_aborts": st["micro_aborts"],
                         "micro_solves": st["micro_solves"],
                         "faulted": pass_i == LADDER_FAULT_PASS,
                         "equal_to_sequential": same})
            print(f"ladder microloop pass {pass_i}: {ms:.3f} ms, "
                  f"{rows[-1]}", flush=True)
            if not same:
                raise AssertionError(f"ladder microloop pass {pass_i}: the plan "
                                     f"differs from the sequential referee")
        if pass_i == LADDER_FAULT_PASS:
            if s.faults is None or s.faults.fired != {"device_error": 1} \
                    or st["micro_aborts"] != aborts0 + 1:
                raise AssertionError(f"ladder microloop: the fault did not "
                                     f"abort the pass ({st['micro_aborts']})")
            s.inject_faults(None)
        if pass_i == LADDER_FAULT_PASS - 1:
            aborts0 = st["micro_aborts"]
            s.inject_faults(FaultInjector(device_errors=1))
    if rows[-1]["micro_aborts"] != 1 or rows[-1]["micro_solves"] != \
            rows[LADDER_FAULT_PASS]["micro_solves"] + (
                len(rows) - 1 - LADDER_FAULT_PASS):
        raise AssertionError(f"ladder microloop: {rows[-1]}")
    out["microloop"] = rows
    return out


def _weather(torch, workloads, oa):
    """Phase 11: the squall scenario against cfg4's fleet in an Operator on
    the card (``workloads.weather_operator``, the real catalog): 60 ticks
    of 1 s with 2 pods a tick, then 40 recovery passes with the injector
    cleared, as the JAX package's tools/smoke_weather.py runs it."""
    from karpenter_provider_aws_tpu_torch.apis import Pod
    from karpenter_provider_aws_tpu_torch.weather import WeatherSimulator, named

    lattice = workloads.real_lattice()
    scenario = named("squall")
    t = time.perf_counter()
    op, sim = workloads.weather_operator(lattice, scenario)
    seed_ms = (time.perf_counter() - t) * 1e3
    if op.solver.device.type != "cuda":
        raise AssertionError("weather: the Operator's Solver is not on the card")
    queue = op.interruption_queue
    ms = workloads.time_controllers(op)
    price_v0 = lattice.price_version
    cost0, _ = workloads.fleet_cost(op)
    provisions = []
    orig = op.provisioner.provision_once

    def provision_once(*a, **kw):
        fired0 = dict(op.solver.faults.fired) if op.solver.faults else {}
        l0 = oa.LAUNCHES
        result = orig(*a, **kw)
        fired = dict(op.solver.faults.fired) if op.solver.faults else {}
        provisions.append((result, oa.LAUNCHES - l0, fired != fired0))
        return result
    op.provisioner.provision_once = provision_once
    # an injected fault consumed by the microloop aborts its pass and takes
    # no rung: count those, so that rungs + micro faults equal the faults
    from karpenter_provider_aws_tpu_torch.errors import SolverDeviceError
    micro_faults = [0]
    solve_micro = op.solver._solve_micro

    def counted_micro(*a, **kw):
        try:
            return solve_micro(*a, **kw)
        except SolverDeviceError as e:
            if e.injected:
                micro_faults[0] += 1
            raise
    op.solver._solve_micro = counted_micro
    print(f"weather: cfg4's {len(op.cluster.nodes)} nodes seeded in "
          f"{seed_ms:.1f} ms, ${cost0:.4f}/hr; squall over "
          f"{scenario.duration_seconds:.0f} s", flush=True)
    rows, serial = [], 0
    rungs = {}

    def one_pass(phase, add):
        nonlocal serial
        for cpu, mem in add:
            serial += 1
            op.cluster.add_pod(Pod(name=f"w{serial}",
                                   requests={"cpu": cpu, "memory": mem}))
        ms.clear()
        provisions.clear()
        oa.LAUNCHES = 0
        t = time.perf_counter()
        op.run_once(force_provision=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        for result, launched, faulted in provisions:
            plan = result.plan
            if plan is None:
                if result.degraded:
                    raise AssertionError(f"weather {phase}: a pass failed to "
                                         f"solve ({result.degraded_reason})")
                continue
            rung = plan.solver_path + (f"/{plan.degraded_reason}"
                                       if plan.degraded else "") + (
                f" after {plan.device_retries} retry" if plan.device_retries
                else "")
            rungs[rung] = rungs.get(rung, 0) + 1
            if plan.solver_path == "host-ffd" and \
                    plan.degraded_reason != "device-error":
                raise AssertionError(f"weather {phase}: host FFD for "
                                     f"{plan.degraded_reason}")
            solved = bool(plan.new_nodes or plan.existing_assignments)
            if solved and not faulted and launched < 1:
                raise AssertionError(f"weather {phase}: an un-faulted pass "
                                     f"solved without launching the kernel")
        rows.append({"phase": phase, "wall_ms": wall, "launches": oa.LAUNCHES,
                     "controller_ms": dict(ms)})

    ticks = int(scenario.duration_seconds / scenario.tick_seconds)
    for _ in range(ticks):
        one_pass("storm", [("500m", "1Gi")] * 2)
        op.clock.step(scenario.tick_seconds)
        sim.advance()
    storm_ticks = sim.ticks
    faults = op.solver.faults
    fired = dict(faults.fired) if faults is not None else {}
    counts = dict(op.solver.degraded_counts)
    storm_micro_faults = micro_faults[0]
    wstats = sim.stats()
    sim.stop()
    op.solver.inject_faults(None)
    for r in range(WEATHER_RECOVERY):
        one_pass("recovery", [("250m", "512Mi")] if r % 4 == 0 else [])
        op.clock.step(10.0)
    # the last recovery pass's consolidation evicted pods that take their
    # provisioning pass only in the next one, as in the operator phase:
    # provisioning and registration alone (no more disruption) place them
    evictees = len(op.cluster.pending_pods())
    if evictees:
        provisions.clear()
        op.provisioner.provision_once()
        op.clock.step(op.options.registration_delay + 0.1)
        op.lifecycle.reconcile()
        for result, _launched, _faulted in provisions:
            _check_pass("weather: the last evictees' pass", result)
    print(f"weather: {evictees} pods evicted by the last recovery pass's "
          f"consolidation, placed by one provisioning pass", flush=True)
    slo = op.slo.update()
    intr = op.interruption.stats()
    claimed = {c.provider_id for c in op.cluster.claims.values() if c.provider_id}
    leaked = [x for x in op.cloud.list_instances()
              if x.provider_id not in claimed]
    cost1, _ = workloads.fleet_cost(op)
    replay = WeatherSimulator.replay(scenario, lattice, storm_ticks, seed=sim.seed)
    holds = op.disruption.engine.counters["weather_holds"]

    def p50(phase, key=None):
        xs = [r["wall_ms"] if key is None else r["controller_ms"].get(key, 0.0)
              for r in rows if r["phase"] == phase]
        return statistics.median(xs)
    split = {ph: {name: p50(ph, name) for name, _a, _m
                  in workloads.OPERATOR_CONTROLLERS} for ph in ("storm", "recovery")}
    out = {"ticks": storm_ticks, "timeline_events": len(sim.timeline),
           "last_evictees": evictees,
           "fired": fired, "degraded_counts": counts, "rungs": rungs,
           "micro_faults": storm_micro_faults,
           "messages_sent": wstats["messages_sent"], "junk_sent": wstats["junk_sent"],
           "received_malformed": intr.get("received_malformed", 0),
           "handler_errors": intr.get("handler_errors", 0),
           "weather_holds": holds, "latency_burn": slo["latency_burn"],
           "cost_burn": slo["cost_burn"], "latency_p50_ms": slo["latency_p50_ms"],
           "fleet_cost_before": cost0, "fleet_cost_after": cost1,
           "price_versions": lattice.price_version - price_v0,
           "storm_pass_p50_ms": p50("storm"),
           "recovery_pass_p50_ms": p50("recovery"),
           "controller_p50_ms": split,
           "launches": sum(r["launches"] for r in rows)}
    for ph in ("storm", "recovery"):
        print(f"weather {ph}: pass wall p50 {out[ph + '_pass_p50_ms']:.3f} ms "
              f"(controllers p50 { {k: round(v, 3) for k, v in split[ph].items()} })",
              flush=True)
    print(f"weather: rungs taken by provisioning passes {rungs}; fired {fired}; "
          f"degraded_counts {counts}; microloop faults {storm_micro_faults}; "
          f"messages {wstats['messages_sent']} (junk "
          f"{wstats['junk_sent']}, malformed counted "
          f"{out['received_malformed']}), handler errors "
          f"{out['handler_errors']}, weather holds {holds}; fleet "
          f"${cost0:.4f}/hr -> ${cost1:.4f}/hr; latency burn "
          f"{slo['latency_burn']}, cost burn {slo['cost_burn']}", flush=True)
    failures = []
    if lattice.price_version == price_v0:
        failures.append("the lattice was never repriced")
    if sum(counts.values()) == 0:
        failures.append(f"the ladder never engaged ({counts})")
    if counts.get("device_retry", 0) + counts.get("host_ffd", 0) \
            + out["micro_faults"] != fired.get("device_error", 0):
        failures.append(f"rungs {counts} and {out['micro_faults']} microloop "
                        f"faults do not add up to the injected {fired}")
    if dict(op.solver.degraded_counts) != counts:
        failures.append(f"the ladder moved during recovery: "
                        f"{op.solver.degraded_counts} after {counts}")
    if wstats["messages_sent"] == 0 or wstats["junk_sent"] == 0:
        failures.append(f"the storm sent no messages ({wstats})")
    if out["received_malformed"] == 0:
        failures.append("junk was sent but none counted malformed")
    if out["handler_errors"] != 0 or len(queue) != 0:
        failures.append(f"handler errors {out['handler_errors']}, "
                        f"{len(queue)} messages stranded")
    if holds <= 0:
        failures.append("the consolidation engine was never held")
    if op.cluster.pending_pods():
        failures.append(f"{len(op.cluster.pending_pods())} pods pending")
    if leaked:
        failures.append(f"{len(leaked)} instances leaked")
    if slo["cost_burn"] > 1.0:
        failures.append(f"cost burn {slo['cost_burn']} > 1.0")
    if replay != sim.timeline:
        failures.append("the replayed timeline differs from the recorded one")
    if failures:
        raise AssertionError("weather: " + "; ".join(failures))
    _ALLOWED[id(op.solver)] = counts
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(method, url, doc=None, token=None, raw=False):
    """One REST call; an error status raises (urllib's HTTPError)."""
    import urllib.request
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url, method=method, headers=headers,
        data=None if doc is None else json.dumps(doc).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = resp.read()
    return body.decode() if raw else json.loads(body)


class _PodWatch:
    """``GET /apis/pods?watch=1`` over HTTP in a thread: the pods it saw
    bound, and any error that ended the stream early."""

    def __init__(self, base, token):
        import threading
        self.url = f"{base}/apis/pods?watch=1&resourceVersion=0"
        self.token = token
        self.bound = set()
        self.events = 0
        self.error = None
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, name="pod-watch",
                                       daemon=True)
        self.thread.start()

    def _run(self):
        import urllib.request
        req = urllib.request.Request(
            self.url, headers={"Authorization": f"Bearer {self.token}"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                while not self.stop.is_set():
                    line = resp.readline()
                    if not line:
                        raise RuntimeError("the watch stream ended")
                    ev = json.loads(line)
                    if ev["type"] == "ERROR":
                        raise RuntimeError(f"the watch stream failed: {ev}")
                    self.events += 1
                    obj = ev.get("object") or {}
                    if obj.get("spec", {}).get("nodeName"):
                        self.bound.add(obj["metadata"]["name"])
        except Exception as e:
            if not self.stop.is_set():
                self.error = e


def _api(torch, workloads, oa):
    """Phase 12: the API stratum on the card. (a) The cfg5 wave through
    an API-mode Operator, fed over REST and the bulk verb; (b) the port's
    CLI with the async runtime under leader election. Returns its numbers
    and launches."""
    import threading
    from karpenter_provider_aws_tpu_torch import cli, kube
    from karpenter_provider_aws_tpu_torch.apis import NodePool, serde
    from karpenter_provider_aws_tpu_torch.apis import wellknown as wk
    from karpenter_provider_aws_tpu_torch.kube.httpserver import serve
    from karpenter_provider_aws_tpu_torch.metrics import lint_exposition
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.operator import runtime as rt_mod
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock

    out, launches = {}, {}

    # (a) the cfg5 wave in API mode
    pods, pools, _ = workloads.config5_full_scale()
    pods = pods[::API_POD_STRIDE]
    lattice = workloads.real_lattice()
    clock = FakeClock()
    server = kube.FakeAPIServer(clock=clock,
                                watch_queue_bound=API_WATCH_QUEUE_BOUND)
    kube.install_default_indexes(server)
    kube.install_admission(server)
    httpd = serve(server, 0, token=API_TOKEN)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    watch = None
    metrics_httpd = None
    ms = {}
    try:
        t = time.perf_counter()
        for p in pools:
            _http("POST", f"{base}/apis/nodepools", serde.nodepool_to_dict(p),
                  API_TOKEN)
        ms["rest_pools"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        op = Operator(options=Options(
            registration_delay=workloads.REGISTRATION_DELAY),
            lattice=lattice, cloud=workloads.wave_cloud(clock), clock=clock,
            api_server=server)
        ms["operator_build"] = (time.perf_counter() - t) * 1e3
        if op.device.type != "cuda" or op.solver.device.type != "cuda":
            raise AssertionError(f"api: the Operator's Solver is on "
                                 f"{op.solver.device}, not the card")
        if server.watch_queue_bound != API_WATCH_QUEUE_BOUND:
            raise AssertionError("api: the server's watch bound changed")
        metrics_httpd = cli.start_server(op, 0)
        watch = _PodWatch(base, API_TOKEN)
        t = time.perf_counter()
        for p in pods[:API_REST_PODS]:
            _http("POST", f"{base}/apis/pods", serde.pod_to_dict(p), API_TOKEN)
        ms["rest_create"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        errs = kube.KubeClient(server).create_pods(pods[API_REST_PODS:])
        ms["bulk_create"] = (time.perf_counter() - t) * 1e3
        if any(errs):
            raise AssertionError(f"api: bulk create failed: "
                                 f"{[e for e in errs if e][:3]}")
        t = time.perf_counter()
        op.sync_once()
        ms["informer_sync"] = (time.perf_counter() - t) * 1e3
        if len(op.cluster.pods) != len(pods):
            raise AssertionError(f"api: the mirror holds {len(op.cluster.pods)} "
                                 f"of {len(pods)} pods after the sync")
        # the pass, split: the solve, the ApiWriter's writes, the rest
        results = []
        solve_ms, writer_ms = [0.0], {}
        orig_provision = op.provisioner.provision_once

        def provision_once(*a, **kw):
            results.append(orig_provision(*a, **kw))
            return results[-1]
        op.provisioner.provision_once = provision_once
        orig_solve = op.solver.solve_relaxed

        def solve_relaxed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig_solve(*a, **kw)
            finally:
                solve_ms[0] += (time.perf_counter() - t0) * 1e3
        op.solver.solve_relaxed = solve_relaxed
        for verb in ("create_claim", "update_claim_status", "register_node",
                     "bind_pods", "bind_pod"):
            fn = getattr(op.writer, verb)

            def timed(*a, _fn=fn, _verb=verb, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    writer_ms[_verb] = writer_ms.get(_verb, 0.0) + \
                        (time.perf_counter() - t0) * 1e3
            setattr(op.writer, verb, timed)
        oa.LAUNCHES = 0
        t = time.perf_counter()
        op.run_once(force_provision=True)
        torch.cuda.synchronize()
        ms["pass"] = (time.perf_counter() - t) * 1e3
        launched = oa.LAUNCHES
        ms["solve"] = solve_ms[0]
        ms["writer_in_pass"] = sum(writer_ms.values())
        pass_writer = dict(writer_ms)
        if len(results) != 1:
            raise AssertionError(f"api: {len(results)} provisioning passes")
        result = results[0]
        _check_pass("api cfg5 wave", result)
        if launched != 1:
            raise AssertionError(f"api: {launched} kernel launches in the "
                                 f"pass, expected 1")
        writer_ms.clear()
        t = time.perf_counter()
        rounds = 0
        while rounds < 5 and not all(o["spec"].get("nodeName")
                                     for o in server.list("pods")[0]):
            clock.step(op.options.registration_delay + 0.1)
            op.sync_once()
            op.lifecycle.reconcile()
            op.sync_once()
            rounds += 1
        ms["registration"] = (time.perf_counter() - t) * 1e3
        ms["writer_in_registration"] = sum(writer_ms.values())
        # server truth
        pod_objs = server.list("pods")[0]
        unbound = [o["metadata"]["name"] for o in pod_objs
                   if not o["spec"].get("nodeName")]
        if len(pod_objs) != len(pods) or unbound:
            raise AssertionError(f"api: {len(unbound)} of {len(pod_objs)} pods "
                                 f"unbound in the server")
        claims = server.list("nodeclaims")[0]
        nodes = server.list("nodes")[0]
        plan = result.plan
        claim_set = sorted((o["spec"]["instanceType"], o["spec"]["zone"],
                            o["spec"]["capacityType"]) for o in claims)
        plan_set = sorted((n.instance_type, n.zone, n.capacity_type)
                          for n in plan.new_nodes)
        if claim_set != plan_set or len(nodes) != len(claims) or \
                {o["spec"]["nodeClaim"] for o in nodes} \
                != {o["metadata"]["name"] for o in claims}:
            raise AssertionError(f"api: {len(claims)} claims and {len(nodes)} "
                                 f"nodes in the server, the plan has "
                                 f"{len(plan.new_nodes)} nodes")
        t = time.perf_counter()
        while (len(watch.bound) < len(pods) and watch.thread.is_alive()
               and time.perf_counter() - t < 120):
            time.sleep(0.05)
        ms["watch_drain"] = (time.perf_counter() - t) * 1e3
        if watch.error is not None or len(watch.bound) != len(pods):
            raise AssertionError(f"api: the HTTP watch saw {len(watch.bound)} "
                                 f"of {len(pods)} bindings ({watch.error})")
        # the plan against the CPU plan of the same pods under the pools as
        # admission stored them (defaulting adds the reference's default
        # requirements: by design, ROADMAP Queue C)
        admitted = [serde.nodepool_from_dict(o["spec"])
                    for o in server.list("nodepools")[0]]
        t = time.perf_counter()
        cpu_api_plan = Solver(lattice, device="cpu").solve_relaxed(
            pods, admitted)
        ms["cpu_reference"] = (time.perf_counter() - t) * 1e3
        if _node_rows(plan) != _node_rows(cpu_api_plan) \
                or plan.new_node_cost != cpu_api_plan.new_node_cost:
            raise AssertionError("api: the card's plan differs from the CPU "
                                 "plan under the admitted pools")
        problems = lint_exposition(_http(
            "GET", f"http://127.0.0.1:{metrics_httpd.server_address[1]}"
            "/metrics", raw=True))
        if problems:
            raise AssertionError(f"api: /metrics lint: {problems[:5]}")
        dvars = _http("GET", f"{base}/debug/vars", token=API_TOKEN)
        if "watch_hub" not in dvars.get("providers", {}):
            raise AssertionError("api: /debug/vars over REST has no watch_hub")
        stats = server.stats()
        print(f"api cfg5 wave: {len(pods)} pods ({API_REST_PODS} over REST, "
              f"{len(pods) - API_REST_PODS} bulk), pools as admitted "
              f"{[(p.name, len(p.requirements)) for p in admitted]}", flush=True)
        print(f"api cfg5 wave: plan {len(plan.new_nodes)} nodes, "
              f"${plan.new_node_cost:.2f}/hr == the CPU plan under the admitted "
              f"pools, node by node; {launched} kernel launch in the pass; "
              f"{len(pod_objs)} of {len(pods)} pods bound in the server, "
              f"{len(claims)} claims, {len(nodes)} nodes; the HTTP watch saw "
              f"{len(watch.bound)} bindings in {watch.events} events", flush=True)
        print(f"api cfg5 wave: wall ms {ms}", flush=True)
        print(f"api cfg5 wave: ApiWriter ms in the pass {pass_writer}, in "
              f"registration {writer_ms}; {rounds} registration round(s)",
              flush=True)
        print(f"api cfg5 wave: watch hub {stats}; /metrics lints clean, "
              f"/debug/vars over REST has {len(dvars['providers'])} providers",
              flush=True)
        out["cfg5_wave"] = {
            "pods": len(pods), "rest_pods": API_REST_PODS,
            "nodes": len(plan.new_nodes), "cost": plan.new_node_cost,
            "launches": launched, "wall_ms": ms, "writer_ms_pass": pass_writer,
            "writer_ms_registration": dict(writer_ms),
            "registration_rounds": rounds, "watch_events": watch.events,
            "watch_hub": stats, "stage_ms": dict(plan.stage_ms)}
        launches["api_cfg5_wave"] = launched
    finally:
        if watch is not None:
            watch.stop.set()
        if metrics_httpd is not None:
            metrics_httpd.shutdown()
        httpd.shutdown()

    # (b) the port's CLI in process: no --device (cuda), the async
    # runtime, elected through the apiserver's lease
    runtimes = []
    rt_init = rt_mod.ControllerRuntime.__init__

    def track(self, *a, **kw):
        rt_init(self, *a, **kw)
        runtimes.append(self)
    rt_mod.ControllerRuntime.__init__ = track
    api_port, metrics_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{api_port}"
    stop = threading.Event()
    rc = []
    failed = []

    def run_main():
        try:
            rc.append(cli.main([f"--api-port={api_port}",
                                f"--metrics-port={metrics_port}",
                                "--async-runtime", "--step", "0.5",
                                "--log-level", "WARNING"], stop_event=stop))
        except BaseException as e:
            failed.append(e)
            raise
    cfg10, _, _ = workloads.config10_steady_state()
    cli_pods = cfg10[:API_CLI_PODS]
    ms = {}
    oa.LAUNCHES = 0
    thread = threading.Thread(target=run_main, name="cli-main", daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        while True:
            try:
                _http("GET", f"{base}/apis/nodepools")
                break
            except OSError:
                if failed or time.perf_counter() - t0 > 300:
                    raise AssertionError(f"api cli: the REST surface never "
                                         f"came up ({failed})")
                time.sleep(0.1)
        ms["rest_up"] = (time.perf_counter() - t0) * 1e3
        _http("POST", f"{base}/apis/nodepools",
              serde.nodepool_to_dict(NodePool(name="steady")))
        t = time.perf_counter()
        for p in cli_pods:
            d = serde.pod_to_dict(p)
            d["nodeSelector"] = {**d["nodeSelector"], wk.LABEL_NODEPOOL: "steady"}
            _http("POST", f"{base}/apis/pods", d)
        ms["rest_create"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        while True:
            items = _http("GET", f"{base}/apis/pods")["items"]
            bound = sum(1 for o in items if o["spec"].get("nodeName"))
            if bound == len(cli_pods):
                break
            if failed or time.perf_counter() - t > 300:
                raise AssertionError(f"api cli: {bound} of {len(cli_pods)} "
                                     f"pods bound ({failed})")
            time.sleep(0.25)
        ms["bind_all"] = (time.perf_counter() - t) * 1e3
        lease = _http("GET", f"{base}/apis/leases/karpenter-tpu-leader-election")
        holder = lease["spec"]["holder"]
        if holder != f"{os.uname().nodename}-{os.getpid()}":
            raise AssertionError(f"api cli: the lease is held by {holder}")
        problems = lint_exposition(_http(
            "GET", f"http://127.0.0.1:{metrics_port}/metrics", raw=True))
        if problems:
            raise AssertionError(f"api cli: /metrics lint: {problems[:5]}")
        claims = _http("GET", f"{base}/apis/nodeclaims")["items"]
    finally:
        stop.set()
        t = time.perf_counter()
        thread.join(API_CLI_STOP_SECONDS)
        ms["stop"] = (time.perf_counter() - t) * 1e3
        rt_mod.ControllerRuntime.__init__ = rt_init
    cli_launched = oa.LAUNCHES
    if thread.is_alive() or rc != [0] or failed:
        raise AssertionError(f"api cli: main returned {rc} ({failed}), "
                             f"alive={thread.is_alive()} after "
                             f"{API_CLI_STOP_SECONDS} s")
    if len(runtimes) != 1 or runtimes[0].error_counts:
        raise AssertionError(f"api cli: controller ticks raised: "
                             f"{[r.error_counts for r in runtimes]}")
    if cli_launched < 1:
        raise AssertionError("api cli: the kernel never launched")
    print(f"api cli: {len(cli_pods)} REST-posted pods bound on {len(claims)} "
          f"claims under the lease of {holder}; {cli_launched} kernel "
          f"launch(es); main returned 0 {ms['stop']:.1f} ms after its stop "
          f"event; wall ms {ms}", flush=True)
    out["cli"] = {"pods": len(cli_pods), "claims": len(claims),
                  "launches": cli_launched, "wall_ms": ms}
    launches["api_cli"] = cli_launched
    return out, launches


def _mesh(torch, workloads, lattice, oa):
    """Phase 13: the sharded solve on an 8-shard mesh, batched on the card.
    (a) cfg11 (200k pods) on a mesh-native Solver, sequential and
    pipelined, against the single-device solve in turns; (b) cfg9 against
    the single-device plan and the capped full-dissolve problem; (c)
    cfg10's steady passes on the mesh; (d) an Operator booted with
    ``mesh="8"`` through one forced cfg9 pass; (e) cfg11 one shard per
    card (``_mesh_ranks``); (f) a lost rank on four cards (``_lost_rank``).
    Returns its numbers, its launches and the kernel inputs of the shard
    pack and the merge."""
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.apis import serde
    from karpenter_provider_aws_tpu_torch.metrics import lint_exposition
    from karpenter_provider_aws_tpu_torch.ops import binpack
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.parallel import plan_mesh
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock

    def canon(plan):
        return json.dumps(serde.plan_semantic_dict(plan), sort_keys=True)

    # the batched pack: one card's plan of --mesh 8 (on several cards
    # plan_mesh puts the shards on ranks, step (e))
    plan8 = plan_mesh(str(MESH_SHARDS), ranks=1)
    mesh = plan8.mesh
    if (plan8.devices, plan8.source, mesh.shards, mesh.ranks) != (
            MESH_SHARDS, "forced", MESH_SHARDS, 1):
        raise AssertionError(f"mesh: plan_mesh planned {plan8}")
    out, launches = {}, {}

    # (a) cfg11, 200k pods on the mesh
    pods, pools, existing = workloads.config11_200k_sharded()
    t = time.perf_counter()
    problem = build_problem(pods, pools, lattice, existing=existing)
    build_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    oracle = _referee(problem)
    oracle_s = time.perf_counter() - t
    print(f"cfg11: {len(pods)} pods, {problem.G} groups, build_problem "
          f"{build_ms:.1f} ms; ffd referee {oracle.num_new_nodes} nodes, "
          f"${oracle.new_node_cost:.2f}/hr ({oracle_s:.1f} s)", flush=True)
    if len(pods) != 200_000:
        raise AssertionError(f"cfg11: {len(pods)} pods, not 200,000")
    t = time.perf_counter()
    cpu_plan = Solver(lattice, device="cpu", mesh=plan_mesh(
        str(MESH_SHARDS), device="cpu").mesh).solve(problem)
    cpu_s = time.perf_counter() - t
    print(f"cfg11 cpu mesh plan: {len(cpu_plan.new_nodes)} nodes "
          f"({cpu_s:.1f} s)", flush=True)

    paths = {"cfg11_mesh_sequential": Solver(lattice, pipeline=False, mesh=mesh),
             "cfg11_mesh_pipelined": Solver(lattice, mesh=mesh),
             "cfg11_single": Solver(lattice)}
    captured, in_merge = [], [False]
    orig_offering, orig_seeded = binpack.cheapest_offering, binpack.pack_packed_seeded

    def capture(tm, zc, pr):
        captured.append((in_merge[0], (tm.clone(), zc.clone(), pr.clone())))
        return orig_offering(tm, zc, pr)

    def seeded(*a, **kw):
        in_merge[0] = True
        try:
            return orig_seeded(*a, **kw)
        finally:
            in_merge[0] = False

    cold = {}
    for name, solver in paths.items():
        meshed = name != "cfg11_single"
        if solver.device.type != "cuda" or solver.mesh_devices != (
                MESH_SHARDS if meshed else 1):
            raise AssertionError(f"{name}: Solver on {solver.device} with "
                                 f"{solver.mesh_devices} shard(s)")
        oa.LAUNCHES = 0
        if name == "cfg11_mesh_pipelined":
            binpack.cheapest_offering, binpack.pack_packed_seeded = capture, seeded
        t = time.perf_counter()
        try:
            plan = solver.solve(problem)
            torch.cuda.synchronize()
        finally:
            binpack.cheapest_offering = orig_offering
            binpack.pack_packed_seeded = orig_seeded
        cold_ms = (time.perf_counter() - t) * 1e3
        launches[name] = oa.LAUNCHES
        placed = _placed(plan)
        ratio = plan.new_node_cost / oracle.new_node_cost
        print(f"{name}: {len(plan.new_nodes)} nodes, ${plan.new_node_cost:.2f}/hr, "
              f"{placed} pods placed, {len(plan.unschedulable)} unschedulable, "
              f"ratio to the oracle {ratio:.6f}, path {plan.solver_path}, "
              f"{plan.mesh_devices} shard(s), {launches[name]} kernel "
              f"launch(es), cold solve {cold_ms:.1f} ms", flush=True)
        if plan.unschedulable or placed != len(pods) or plan.degraded:
            raise AssertionError(f"{name}: placed {placed}/{len(pods)}, "
                                 f"degraded {plan.degraded}")
        if not ratio <= 1.02:
            raise AssertionError(f"{name}: cost ratio {ratio} above 1.02")
        if launches[name] < 1:
            raise AssertionError(f"{name}: the kernel never launched")
        if meshed:
            if plan.mesh_devices != MESH_SHARDS:
                raise AssertionError(f"{name}: plan on {plan.mesh_devices} shards")
            if canon(plan) != canon(cpu_plan):
                raise AssertionError(f"{name}: the card's mesh plan differs "
                                     f"from the CPU mesh plan")
            print(f"{name}: plan == cpu mesh plan (plan_semantic_dict)",
                  flush=True)
        cold[name] = plan
    # the pipelined cold solve's launches, split by the call that made them
    shard_rows = [c for merged, c in captured if not merged]
    merge_rows = [c for merged, c in captured if merged]
    launches["cfg11_mesh_shards"] = len(shard_rows)
    launches["cfg11_mesh_merge"] = len(merge_rows)
    if ((len(shard_rows), len(merge_rows)) != (1, 1)
            or len(shard_rows) + len(merge_rows)
            != launches["cfg11_mesh_pipelined"]):
        raise AssertionError(
            f"cfg11: {len(shard_rows)} shard-pack and {len(merge_rows)} "
            f"merge kernel calls in a solve of "
            f"{launches['cfg11_mesh_pipelined']} launch(es), not 1 + 1")
    shard_B = [c[0].shape[0] // MESH_SHARDS for c in shard_rows]
    print(f"cfg11 mesh: shard-pack kernel calls at B per shard {shard_B} "
          f"({[c[0].shape[0] for c in shard_rows]} rows), merge calls at "
          f"{[c[0].shape[0] for c in merge_rows]} rows; shard imbalance "
          f"{paths['cfg11_mesh_pipelined'].stats()['mesh_shard_imbalance']}",
          flush=True)
    single, meshed_plan = cold["cfg11_single"], cold["cfg11_mesh_pipelined"]
    print(f"cfg11: mesh ${meshed_plan.new_node_cost:.2f}/hr against single "
          f"${single.new_node_cost:.2f}/hr "
          f"({meshed_plan.new_node_cost / single.new_node_cost:.6f})", flush=True)

    e2e = {name: [] for name in paths}
    stages = {name: {} for name in paths}
    per_solve = {name: [] for name in paths}
    order = list(paths)
    for i in range(MESH_SOLVES):
        for name in (order[i % 3:] + order[:i % 3]):
            oa.LAUNCHES = 0
            t = time.perf_counter()
            p = paths[name].solve(build_problem(pods, pools, lattice,
                                                existing=existing))
            torch.cuda.synchronize()
            e2e[name].append((time.perf_counter() - t) * 1e3)
            per_solve[name].append(oa.LAUNCHES)
            for k, v in p.stage_ms.items():
                stages[name].setdefault(k, []).append(v)
            if not _same_plan(p, cold[name]):
                raise AssertionError(f"{name}: a repeated solve changed the plan")
    cfg11 = {"pods": len(pods), "groups": problem.G, "build_ms": build_ms,
             "oracle_cost": oracle.new_node_cost, "oracle_s": oracle_s,
             "cpu_mesh_s": cpu_s, "shard_B": shard_B,
             "merge_rows": [c[0].shape[0] for c in merge_rows],
             "shard_imbalance":
                 paths["cfg11_mesh_pipelined"].stats()["mesh_shard_imbalance"]}
    for name in paths:
        ms = e2e[name]
        cfg11[name] = {
            "e2e_p50_ms": statistics.median(ms), "e2e_ms": ms,
            "stage_p50_ms": {k: statistics.median(v)
                             for k, v in stages[name].items()},
            "launches_per_solve": per_solve[name],
            "nodes": len(cold[name].new_nodes),
            "cost": cold[name].new_node_cost}
        print(f"{name}: e2e p50 {statistics.median(ms):.3f} ms over "
              f"{MESH_SOLVES} solves (min {min(ms):.3f}, max {max(ms):.3f}); "
              f"stage p50 ms { {k: round(v, 3) for k, v in cfg11[name]['stage_p50_ms'].items()} }; "
              f"launches {per_solve[name]}", flush=True)
    wall_ms, device_ms, n_kernels = measure.profiled_device_ms(
        lambda: paths["cfg11_mesh_pipelined"].solve(problem))
    cfg11["profiled"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                         "kernels": n_kernels, "idle": 1.0 - device_ms / wall_ms}
    print(f"cfg11 mesh under the profiler: {device_ms:.3f} ms of device time "
          f"in {n_kernels} kernels in a {wall_ms:.3f} ms wall: idle share "
          f"{1.0 - device_ms / wall_ms:.4f}", flush=True)
    out["cfg11"] = cfg11
    launches["cfg11_mesh"] = launches["cfg11_mesh_pipelined"]

    # (b) cfg9 against the single-device plan; the capped full dissolve
    pods9, pools9, _ = workloads.config9_sharded_16k()
    problem9 = build_problem(pods9, pools9, lattice)
    oa.LAUNCHES = 0
    mesh9 = paths["cfg11_mesh_pipelined"].solve(problem9)
    torch.cuda.synchronize()
    launches["cfg9_mesh"] = oa.LAUNCHES
    single9 = paths["cfg11_single"].solve(problem9)
    ratio9 = mesh9.new_node_cost / single9.new_node_cost
    print(f"cfg9: {len(pods9)} pods, mesh {len(mesh9.new_nodes)} nodes "
          f"${mesh9.new_node_cost:.2f}/hr against single {len(single9.new_nodes)} "
          f"nodes ${single9.new_node_cost:.2f}/hr: ratio {ratio9:.6f}, "
          f"{launches['cfg9_mesh']} launch(es)", flush=True)
    for name, p in (("mesh", mesh9), ("single", single9)):
        if p.unschedulable or _placed(p) != len(pods9) or p.degraded:
            raise AssertionError(f"cfg9 {name}: placed {_placed(p)}/{len(pods9)}")
    if not ratio9 <= 1.02 or mesh9.mesh_devices != MESH_SHARDS:
        raise AssertionError(f"cfg9: mesh against single {ratio9}")
    big, capped = workloads.mesh_parity_problem()
    single_c = Solver(big).solve(capped)
    mesh_c = Solver(big, mesh=mesh).solve(capped)
    if mesh_c.mesh_devices != MESH_SHARDS or canon(mesh_c) != canon(single_c):
        raise AssertionError("capped full dissolve: the mesh plan differs from "
                             "the single-device plan")
    print(f"capped full dissolve: mesh plan == single-device plan, byte for "
          f"byte ({len(mesh_c.new_nodes)} nodes, ${mesh_c.new_node_cost:.2f}/hr)",
          flush=True)
    out["cfg9"] = {"pods": len(pods9), "mesh_cost": mesh9.new_node_cost,
                   "single_cost": single9.new_node_cost, "ratio": ratio9,
                   "launches": launches["cfg9_mesh"],
                   "capped_full_dissolve_identical": True}

    # (c) cfg10's steady passes on the mesh
    solver, churn, pools10, passes = workloads.delta_on_mesh_passes(lattice,
                                                                    mesh)
    referee = Solver(lattice, pipeline=False, mesh=mesh)
    rebuild = Solver(lattice, mesh=mesh)
    rows = []
    oa.LAUNCHES = 0
    pre = None
    for pass_i, res, plan, ms, legs in passes:
        torch.cuda.synchronize()
        launched = oa.LAUNCHES
        st = dict(solver.pipeline_stats)
        same = referee.solve(res.problem)
        scratch = rebuild.solve(build_problem(churn.pods, pools10, lattice,
                                              existing=list(churn.existing)))
        ok_same = canon(plan) == canon(same)
        ok_scratch = (_node_multiset(plan) == _node_multiset(scratch)
                      and abs(plan.new_node_cost - scratch.new_node_cost) <= 1e-6)
        if pass_i < 0:
            print(f"delta on mesh, cold: full build, solve and priming "
                  f"solve_delta {ms:.1f} ms", flush=True)
        else:
            merged = st["micro_merge_solves"] > pre["micro_merge_solves"]
            regrows = st["micro_merge_regrows"] - pre["micro_merge_regrows"]
            row = {"pass": pass_i, "ms": ms, "legs": legs, "launches": launched,
                   "incremental": res.incremental,
                   "micro": st["micro_solves"] - pre["micro_solves"],
                   "aborts": st["micro_aborts"] - pre["micro_aborts"],
                   "hit": st["resident_problem_hits"]
                   - pre["resident_problem_hits"],
                   "skipped": st["micro_skipped_syncs"]
                   - pre["micro_skipped_syncs"],
                   "merged": merged, "regrows": regrows,
                   "merge_reused": st["micro_merge_skips"]
                   - pre["micro_merge_skips"]}
            rows.append(row)
            print(f"delta on mesh pass {pass_i}: {ms:.3f} ms, legs {legs}, "
                  f"{launched} launch(es), merge ran {merged} (reused "
                  f"{row['merge_reused']}, regrows {regrows}), skipped fetch "
                  f"{row['skipped']}; == sequential {ok_same}, == scratch "
                  f"{ok_scratch}", flush=True)
            bound = (MESH_LEGS_MERGE if merged else MESH_LEGS) + 2 * regrows
            if not (res.incremental and row["micro"] == 1 and row["hit"] == 1
                    and row["aborts"] == 0 and plan.mesh_devices == MESH_SHARDS):
                raise AssertionError(f"delta on mesh pass {pass_i}: not a "
                                     f"resident microloop pass on the mesh: {row}")
            if legs > bound:
                raise AssertionError(f"delta on mesh pass {pass_i}: {legs} legs, "
                                     f"bound {bound}")
        if not (ok_same and ok_scratch):
            raise AssertionError(f"delta on mesh pass {pass_i}: the plan differs "
                                 f"from a referee (same problem {ok_same}, "
                                 f"scratch build {ok_scratch})")
        if plan.unschedulable or _placed(plan) != len(churn.pods):
            raise AssertionError(f"delta on mesh pass {pass_i}: "
                                 f"{len(plan.unschedulable)} unschedulable")
        pre = dict(solver.pipeline_stats)
        oa.LAUNCHES = 0
    if sum(r["skipped"] for r in rows) != len(rows) // workloads.STEADY_NOCHURN_EVERY:
        raise AssertionError("delta on mesh: the no-churn passes did not skip "
                             "their fetch")
    pass_ms = [r["ms"] for r in rows]
    launches["cfg10_delta_on_mesh"] = sum(r["launches"] for r in rows)
    out["cfg10_delta_on_mesh"] = {
        "passes": len(rows), "pass_p50_ms": statistics.median(pass_ms),
        "legs_per_pass": [r["legs"] for r in rows],
        "launches_per_pass": [r["launches"] for r in rows],
        "merge_passes": sum(r["merged"] for r in rows),
        "merge_reuses": sum(r["merge_reused"] for r in rows),
        "regrows": sum(r["regrows"] for r in rows)}
    print(f"delta on mesh: pass p50 {statistics.median(pass_ms):.3f} ms over "
          f"{len(rows)} passes, legs {out['cfg10_delta_on_mesh']['legs_per_pass']}, "
          f"launches {out['cfg10_delta_on_mesh']['launches_per_pass']}", flush=True)

    # (d) the Operator booted with mesh="8": one forced cfg9 pass
    clock = FakeClock()
    op = Operator(options=Options(mesh=str(MESH_SHARDS),
                                  registration_delay=workloads.REGISTRATION_DELAY),
                  lattice=lattice, cloud=workloads.wave_cloud(clock), clock=clock,
                  node_pools=pools9)
    if (op.solver.device.type != "cuda" or op.mesh_plan.devices != MESH_SHARDS
            or op.solver.mesh_devices != MESH_SHARDS):
        raise AssertionError(f"mesh Operator: Solver on {op.solver.device}, "
                             f"{op.solver.mesh_devices} shard(s)")
    results = []
    orig_provision = op.provisioner.provision_once

    def provision_once(*a, **kw):
        r = orig_provision(*a, **kw)
        results.append(r)
        return r
    op.provisioner.provision_once = provision_once
    for p in pods9:
        op.cluster.add_pod(p)
    oa.LAUNCHES = 0
    t = time.perf_counter()
    op.run_once(force_provision=True)
    torch.cuda.synchronize()
    op_ms = (time.perf_counter() - t) * 1e3
    launches["operator_cfg9_mesh"] = oa.LAUNCHES
    if len(results) != 1:
        raise AssertionError(f"mesh Operator: {len(results)} provisioning passes")
    _check_pass("mesh Operator cfg9", results[0])
    op_plan = results[0].plan
    op.emit_gauges()
    text = op.metrics.render()
    gauge = f"karpenter_solver_mesh_devices {float(MESH_SHARDS)}"
    problems = lint_exposition(text)
    print(f"mesh Operator cfg9: {len(results[0].created_claims)} claims, "
          f"{results[0].pods_scheduled} pods scheduled, plan on "
          f"{op_plan.mesh_devices} shards, {launches['operator_cfg9_mesh']} "
          f"launch(es), pass wall {op_ms:.3f} ms; /metrics has '{gauge}': "
          f"{gauge in text.splitlines()}, lint problems {len(problems)}", flush=True)
    if (op_plan.mesh_devices != MESH_SHARDS or launches["operator_cfg9_mesh"] < 1
            or results[0].pods_scheduled != len(pods9)):
        raise AssertionError("mesh Operator: the pass did not solve cfg9 on the "
                             "mesh")
    if _node_rows(op_plan) != _node_rows(mesh9):
        raise AssertionError("mesh Operator: the plan differs from cfg9's mesh "
                             "plan")
    if gauge not in text.splitlines() or problems:
        raise AssertionError(f"mesh Operator: /metrics lacks '{gauge}' or lints "
                             f"{problems[:3]}")
    out["operator_cfg9"] = {"wall_ms": op_ms, "claims": len(results[0].created_claims),
                            "launches": launches["operator_cfg9_mesh"]}

    # (e) one shard per card: cfg11 through the rank program
    out["cfg11_ranks"], rank_launches, rank0_rows = _mesh_ranks(
        torch, oa, lattice, pods, pools, existing, problem,
        paths["cfg11_mesh_pipelined"], paths["cfg11_single"], canon)
    launches.update(rank_launches)

    # (f) a lost rank over NCCL, on four cards
    out["lost_rank"] = _lost_rank(torch)
    return out, launches, shard_rows[-1], merge_rows[-1], rank0_rows


def _gone(pid: int) -> bool:
    """Whether process ``pid`` has exited (a zombie awaiting its reaper
    too)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _mesh_ranks(torch, oa, lattice, pods, pools, existing, problem, batched,
                single, canon):
    """Phase 13, step (e): cfg11 through the rank program over NCCL on
    every visible card, against the batched pack (``batched``, a Solver on
    the 8-shard batched mesh) and the single-device solve. Returns its
    numbers, its launches and rank 0's shard-pack kernel inputs."""
    import numpy as np

    from karpenter_provider_aws_tpu_torch.ops import binpack
    from karpenter_provider_aws_tpu_torch.parallel import (plan_mesh, ranks,
                                                           sharded,
                                                           solver_mesh)
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    t_step = time.perf_counter()
    cards = torch.cuda.device_count()
    W = min(MESH_SHARDS, cards)
    planned = plan_mesh(str(MESH_SHARDS))
    if planned.ranks != W:
        raise AssertionError(f"mesh ranks: plan_mesh put {MESH_SHARDS} shards "
                             f"on {planned.ranks} ranks with {cards} card(s)")
    # on one card plan_mesh plans the batched pack, with no group: force
    # the rank program there with a group of one rank
    mesh = planned.mesh if W > 1 else solver_mesh(MESH_SHARDS, ranks=1,
                                                  group=True)
    t = time.perf_counter()
    rs = ranks.acquire(mesh, torch.device("cuda"))
    acquire_ms = (time.perf_counter() - t) * 1e3
    solver = Solver(lattice, mesh=mesh)
    if solver.device.type != "cuda" or solver.mesh_ranks != W:
        raise AssertionError(f"mesh ranks: Solver on {solver.device}, "
                             f"{solver.mesh_ranks} rank(s)")
    print(f"mesh ranks: {MESH_SHARDS} shards on {W} rank(s) over NCCL "
          f"({[str(d) for d in rs.devices]}), blocks {mesh.blocks()}; "
          f"workers spawned and joined in {rs.spawn_ms:.1f} ms", flush=True)

    packs = []
    orig_pack, orig_offering = sharded.sharded_pack, binpack.cheapest_offering

    def recorded(*a, **kw):
        before = oa.LAUNCHES
        sp = orig_pack(*a, **kw)
        packs.append((sp.packed.cpu().numpy().tobytes(),
                      np.float32(float(sp.total_cost)).tobytes(),
                      int(sp.total_nodes), int(sp.total_leftover),
                      tuple(sp.packed.shape), oa.LAUNCHES - before))
        return sp

    captured = []

    def capture(tm, zc, pr):
        captured.append((tm.clone(), zc.clone(), pr.clone()))
        return orig_offering(tm, zc, pr)

    sharded.sharded_pack = recorded
    try:
        oa.LAUNCHES = 0
        binpack.cheapest_offering = capture
        t = time.perf_counter()
        try:
            plan = solver.solve(problem)
            torch.cuda.synchronize()
        finally:
            binpack.cheapest_offering = orig_offering
        cold_ms = (time.perf_counter() - t) * 1e3
        launched = oa.LAUNCHES
        ranked, per_rank, last = packs[:], list(rs.last["launches"]), dict(rs.last)
        packs.clear()
        ref = batched.solve(problem)
        torch.cuda.synchronize()
        reference = packs[:]
    finally:
        sharded.sharded_pack = orig_pack
    same_plan = canon(plan) == canon(ref)
    same_bytes = [p[:5] for p in ranked] == [p[:5] for p in reference]
    print(f"mesh ranks cfg11: {len(plan.new_nodes)} nodes, "
          f"${plan.new_node_cost:.2f}/hr, plan == batched pack's {same_plan}; "
          f"{len(ranked)} sharded pack(s), stacked {ranked[0][4]} buffer and "
          f"float32 total byte-identical {same_bytes}; launches per rank "
          f"{per_rank} (sum {sum(per_rank)}, counted at rank 0 around the "
          f"pack {ranked[-1][5]}), {launched} in the solve; broadcast "
          f"{last['bcast_bytes']} B, gathered {last['gather_bytes']} B a pack; "
          f"cold solve {cold_ms:.1f} ms", flush=True)
    if not same_plan or plan.mesh_devices != MESH_SHARDS or plan.degraded:
        raise AssertionError("mesh ranks: the plan differs from the batched "
                             "pack's")
    if not same_bytes:
        raise AssertionError("mesh ranks: the stacked shard buffer or the "
                             "float32 total differs from the batched pack's")
    if len(per_rank) != W or min(per_rank) < 1 or sum(per_rank) != ranked[-1][5]:
        raise AssertionError(f"mesh ranks: launches per rank {per_rank}, "
                             f"{ranked[-1][5]} counted at rank 0")
    rows0 = mesh.blocks()[0][1] - mesh.blocks()[0][0]
    if len(captured) < 2 or captured[0][0].shape[0] % rows0:
        raise AssertionError(f"mesh ranks: rank 0 made {len(captured)} kernel "
                             f"call(s), the first of "
                             f"{captured[0][0].shape[0] if captured else 0} rows "
                             f"for {rows0} shard(s)")

    paths = {"cfg11_ranks": solver, "cfg11_batched": batched,
             "cfg11_single": single}
    cold = {"cfg11_ranks": plan, "cfg11_batched": ref}
    e2e = {name: [] for name in paths}
    stages = {name: {} for name in paths}
    order = list(paths)
    for i in range(MESH_RANK_SOLVES):
        for name in (order[i % 3:] + order[:i % 3]):
            t = time.perf_counter()
            p = paths[name].solve(build_problem(pods, pools, lattice,
                                                existing=existing))
            torch.cuda.synchronize()
            e2e[name].append((time.perf_counter() - t) * 1e3)
            for k, v in p.stage_ms.items():
                stages[name].setdefault(k, []).append(v)
            if name in cold and not _same_plan(p, cold[name]):
                raise AssertionError(f"{name}: a repeated solve changed the plan")
    out = {"cards": cards, "ranks": W, "devices": [str(d) for d in rs.devices],
           "blocks": mesh.blocks(), "spawn_ms": rs.spawn_ms,
           "acquire_ms": acquire_ms, "cold_ms": cold_ms,
           "launches_per_rank": per_rank, "launches_in_solve": launched,
           "bcast_bytes": last["bcast_bytes"],
           "gather_bytes": last["gather_bytes"],
           "plan_equal": same_plan, "bytes_equal": same_bytes,
           "rank0_rows": int(captured[0][0].shape[0])}
    for name in paths:
        ms = e2e[name]
        out[name] = {"e2e_p50_ms": statistics.median(ms), "e2e_ms": ms,
                     "stage_p50_ms": {k: statistics.median(v)
                                      for k, v in stages[name].items()}}
        print(f"{name}: e2e p50 {statistics.median(ms):.3f} ms over "
              f"{MESH_RANK_SOLVES} solves (min {min(ms):.3f}, max {max(ms):.3f}); "
              f"stage p50 ms { {k: round(v, 3) for k, v in out[name]['stage_p50_ms'].items()} }",
              flush=True)
    # cfg10's steady passes on the ranks: the microloop's resident buffer
    # reaches them as its delta; each plan equal to a sequential solve of
    # the same problem on the batched mesh
    from karpenter_provider_aws_tpu_torch import workloads
    solver10, _churn, _pools10, passes = workloads.delta_on_mesh_passes(
        lattice, mesh)
    referee = Solver(lattice, pipeline=False, mesh=batched.mesh)
    rows, pre = [], None
    for pass_i, res, plan_p, ms, legs in passes:
        torch.cuda.synchronize()
        if canon(plan_p) != canon(referee.solve(res.problem)):
            raise AssertionError(f"mesh ranks cfg10 pass {pass_i}: the plan "
                                 f"differs from the batched mesh's")
        st = dict(solver10.pipeline_stats)
        if pass_i >= 0:
            merged = st["micro_merge_solves"] > pre["micro_merge_solves"]
            regrows = st["micro_merge_regrows"] - pre["micro_merge_regrows"]
            bound = (MESH_LEGS_MERGE if merged else MESH_LEGS) + 2 * regrows
            rows.append({"pass": pass_i, "ms": ms, "legs": legs,
                         "resident": solver10._ranks.last.get("resident"),
                         "micro": st["micro_solves"] - pre["micro_solves"]})
            if not (res.incremental and rows[-1]["micro"] == 1) or legs > bound:
                raise AssertionError(f"mesh ranks cfg10 pass {pass_i}: "
                                     f"{rows[-1]}, bound {bound}")
        pre = st
    out["cfg10_delta"] = {
        "passes": len(rows), "pass_p50_ms": statistics.median(
            r["ms"] for r in rows),
        "legs_per_pass": [r["legs"] for r in rows],
        "resident": [r["resident"] for r in rows]}
    print(f"mesh ranks cfg10: {len(rows)} delta passes on the ranks, each "
          f"plan == the batched mesh's; pass p50 "
          f"{out['cfg10_delta']['pass_p50_ms']:.3f} ms, legs "
          f"{out['cfg10_delta']['legs_per_pass']}, the resident buffer sent "
          f"as {out['cfg10_delta']['resident']}", flush=True)
    pids = rs.pids()
    ranks.shutdown_all()
    left = ranks.live_workers() + [p for p in pids if not _gone(p)]
    step_s = time.perf_counter() - t_step
    out["step_s"] = step_s
    print(f"mesh ranks: closed; workers left {left}; the step took "
          f"{step_s:.1f} s", flush=True)
    if left:
        raise AssertionError(f"mesh ranks: workers still alive {left}")
    if step_s > MESH_RANK_SECONDS:
        raise AssertionError(f"mesh ranks: the step took {step_s:.1f} s, "
                             f"over {MESH_RANK_SECONDS} s")
    return out, {"cfg11_ranks": launched,
                 "cfg11_ranks_per_rank": per_rank}, captured[0]


def _remote(torch, workloads, lattice, oa):
    """Phase 14: the remote solver on the card. (a) A sidecar process on
    the card serving an Operator's cfg2 pass; (b) cfg2's Solve RPC to an
    in-process sidecar, its kernel launch captured; (c) failover through
    a SolverPool over two sidecars; (d) the solve window under 8
    concurrent RPCs; (e) replication of (a)'s Operator to a standby; (f)
    the RPC's wall against the in-process solve, its bytes and split, and
    Health. Returns its numbers, its launches and (b)'s kernel inputs."""
    import shutil
    import subprocess
    import tempfile
    import threading
    from karpenter_provider_aws_tpu_torch import introspect, measure, trace
    from karpenter_provider_aws_tpu_torch.apis import serde
    from karpenter_provider_aws_tpu_torch.metrics import lint_exposition
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.operator.leaderelection import (
        LeaderElector, MemoryLeaseStore)
    from karpenter_provider_aws_tpu_torch.parallel import rpc
    from karpenter_provider_aws_tpu_torch.parallel.pool import SolverPool
    from karpenter_provider_aws_tpu_torch.parallel.sidecar import (
        ChaosSidecar, SolverClient, serve)
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.state import replication
    from karpenter_provider_aws_tpu_torch.state.cluster import ClusterState
    from karpenter_provider_aws_tpu_torch.trace import FlightRecorder
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock

    failover = "solver pool failover: "

    def canon(plan, core=False):
        """The plan as plan_semantic_dict; ``core`` drops what a failover
        or the local rung adds (its warnings, degraded and the reason)."""
        d = serde.plan_semantic_dict(plan)
        if core:
            d["warnings"] = [w for w in d["warnings"] if not w.startswith(failover)]
            for k in ("degraded", "degradedReason"):
                d.pop(k, None)
        return json.dumps(d, sort_keys=True)

    pods2, pools2, _ = workloads.config2_selectors_taints()
    pods3, pools3, _ = workloads.config3_affinity_spread()
    local = Solver(lattice)
    plan2 = local.solve_relaxed(pods2, pools2)
    plan3 = local.solve_relaxed(pods3, pools3)
    print(f"cfg2: {len(pods2)} pods, {len(pools2)} pools, in-process card plan "
          f"{len(plan2.new_nodes)} nodes ${plan2.new_node_cost:.2f}/hr; cfg3: "
          f"{len(pods3)} pods, {len(plan3.new_nodes)} nodes", flush=True)
    out, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="remote-")
    proc, sidecars, servers, closers = None, [], [], []
    try:
        # (a) the sidecar as its own process on the card, and an Operator
        # delegating to it
        address = f"unix:{tmp}/s.sock"
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_provider_aws_tpu_torch.parallel.sidecar",
             "--address", address, "--device", "cuda", "--trace"],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines, up = [], threading.Event()

        def drain():
            for line in proc.stdout:
                lines.append(line.rstrip())
                if "serving on" in line:
                    up.set()
        threading.Thread(target=drain, daemon=True).start()
        while not up.wait(0.5):
            if proc.poll() is not None or time.perf_counter() - t > SIDECAR_START_SECONDS:
                raise AssertionError(f"remote: the sidecar process did not come "
                                     f"up (rc {proc.poll()}):\n" + "\n".join(lines[-30:]))
        start_s = time.perf_counter() - t
        print(f"sidecar process: {lines[-1]} ({start_s:.1f} s to serve)", flush=True)
        clock = FakeClock()
        op = Operator(options=Options(registration_delay=workloads.REGISTRATION_DELAY,
                                      solver_address=address,
                                      solver_solve_deadline=REMOTE_SOLVE_DEADLINE),
                      lattice=lattice, cloud=workloads.wave_cloud(clock), clock=clock,
                      node_pools=pools2)
        closers.append(op.solver.close)
        if not isinstance(op.solver, SolverPool) or op.solver.device.type != "cuda":
            raise AssertionError(f"remote Operator: solver {type(op.solver).__name__} "
                                 f"on {op.solver.device}")
        results = []
        orig_provision = op.provisioner.provision_once

        def provision_once(*a, **kw):
            r = orig_provision(*a, **kw)
            results.append(r)
            return r
        op.provisioner.provision_once = provision_once
        for p in pods2:
            op.cluster.add_pod(p)
        oa.LAUNCHES = 0
        t = time.perf_counter()
        op.run_once(force_provision=True)
        torch.cuda.synchronize()
        op_ms = (time.perf_counter() - t) * 1e3
        local_launches = oa.LAUNCHES
        if len(results) != 1:
            raise AssertionError(f"remote Operator: {len(results)} provisioning passes")
        _check_pass("remote Operator cfg2", results[0])
        st = op.solver.pool_stats()
        op.emit_gauges()
        text = op.metrics.render()
        gauges = ["karpenter_solver_pool_endpoints 1.0",
                  "karpenter_solver_pool_healthy_endpoints 1.0",
                  "karpenter_solver_pool_local_solves 0.0",
                  f'karpenter_solver_pool_breaker_state{{endpoint="{address}"}} 0.0']
        problems = lint_exposition(text)
        print(f"remote Operator cfg2: {len(results[0].created_claims)} claims, "
              f"{results[0].pods_scheduled} pods scheduled, pass wall {op_ms:.3f} ms, "
              f"pool delegated {st['delegated_solves']} local {st['local_solves']} "
              f"failovers {st['failovers']}, {local_launches} launch(es) in this "
              f"process; /metrics lint problems {len(problems)}", flush=True)
        if (st["delegated_solves"], st["local_solves"], st["failovers"]) != (1, 0, 0) \
                or local_launches != 0:
            raise AssertionError(f"remote Operator: not one delegated solve ({st}, "
                                 f"{local_launches} local launches)")
        missing = [g for g in gauges if g not in text.splitlines()]
        if missing or problems:
            raise AssertionError(f"remote Operator: /metrics lacks {missing} or lints "
                                 f"{problems[:3]}")
        if canon(results[0].plan) != canon(plan2):
            raise AssertionError("remote Operator: the sidecar's plan differs from "
                                 "the in-process card plan")
        print("remote Operator cfg2: plan == in-process card plan "
              "(plan_semantic_dict)", flush=True)
        # no registration here: a pass over the registered wave would ship
        # every bound pod with its node's labels, which puts the Solve
        # request over the 4 MiB limit (the local rung, as the reference's)
        out["operator_cfg2"] = {"wall_ms": op_ms, "sidecar_start_s": start_s,
                                "claims": len(results[0].created_claims),
                                "pool": st}

        # (e) replication: the Operator serves its mirror to a standby
        source = replication.ReplicationSource(op.cluster)
        raddr = f"unix:{tmp}/r.sock"
        servers.append(replication.serve_replication(
            replication.ReplicationService(source), raddr))
        elector = LeaderElector(MemoryLeaseStore(), "leader", 15.0, op.clock)
        if not elector.try_acquire_or_renew():
            raise AssertionError("replication: the leader did not take its lease")
        op.wire_handoff(elector, source=source)
        rclient = replication.ReplicationClient(raddr)
        closers.append(rclient.close)
        replica = replication.StandbyReplica(ClusterState(), rclient)

        def mirror(c):
            with c._lock:
                return json.dumps({
                    "pods": [serde.pod_to_dict(p) for _, p in sorted(c.pods.items())],
                    "nodes": [serde.node_to_dict(n) for _, n in sorted(c.nodes.items())],
                    "claims": [serde.nodeclaim_to_dict(x)
                               for _, x in sorted(c.claims.items())],
                    "leases": [serde.lease_to_dict(x) for _, x in sorted(c.leases.items())],
                    "pdbs": [serde.pdb_to_dict(x) for _, x in sorted(c.pdbs.items())],
                    "pvcs": [serde.pvc_to_dict(x) for _, x in sorted(c.pvcs.items())]},
                    sort_keys=True)

        t = time.perf_counter()
        if not replica.sync_once():
            raise AssertionError(f"replication: the snapshot failed: {replica.stats()}")
        snap_ms = (time.perf_counter() - t) * 1e3
        snap_bytes = len(json.dumps(
            replication.ReplicationSource(op.cluster).snapshot_doc()))
        if mirror(replica.cluster) != mirror(op.cluster):
            raise AssertionError("replication: the standby's snapshot differs")
        gone = sorted(op.cluster.pods)[:REMOTE_CHURN]
        for name in gone:
            op.cluster.delete_pod(name)
        for p in pods2[:REMOTE_CHURN]:
            op.cluster.add_pod(serde.pod_from_dict({**serde.pod_to_dict(p),
                                                    "name": p.name + "-b"}))
        results.clear()
        op.run_once(force_provision=True)
        torch.cuda.synchronize()
        _check_pass("remote Operator second pass", results[0])
        st = op.solver.pool_stats()
        if (st["delegated_solves"], st["local_solves"], st["failovers"]) != (2, 0, 0):
            raise AssertionError(f"remote Operator: the second pass was not "
                                 f"delegated ({st})")
        t = time.perf_counter()
        if not replica.sync_once():
            raise AssertionError(f"replication: the delta failed: {replica.stats()}")
        delta_ms = (time.perf_counter() - t) * 1e3
        rst = replica.stats()
        if (rst["snapshots"], rst["deltas"]) != (1, 1) or \
                mirror(replica.cluster) != mirror(op.cluster):
            raise AssertionError(f"replication: the standby's mirror differs after "
                                 f"the delta ({rst})")
        if not replica.promotion_ready() or replica.stats()["stale_promotions"]:
            raise AssertionError(f"replication: promotion_ready refused ({replica.stats()})")
        ho = op.handoff_stats()
        print(f"replication: snapshot of {len(op.cluster.pods)} pods "
              f"({snap_bytes} B) in {snap_ms:.3f} ms, delta of {rst['delta_pods']} "
              f"pods after a second delegated pass in {delta_ms:.3f} ms; mirror == "
              f"leader's; promotion_ready; source {ho['source_snapshots']} "
              f"snapshot(s) {ho['source_deltas']} delta(s)", flush=True)
        out["replication"] = {"snapshot_ms": snap_ms, "snapshot_bytes": snap_bytes,
                              "delta_ms": delta_ms, "delta_pods": rst["delta_pods"],
                              "delegated_solves": op.solver.pool_stats()["delegated_solves"]}

        # (f) cfg2's RPC against the in-process solve, in turns; Health
        client = SolverClient(address, timeout=REMOTE_SOLVE_DEADLINE)
        closers.append(client.close)
        marks = {}
        call = client._solve

        def timed_call(request, **kw):
            marks["sent"], marks["req_bytes"] = time.perf_counter(), len(request)
            resp = call(request, **kw)
            marks["answered"], marks["resp_bytes"] = time.perf_counter(), len(resp)
            return resp
        client._solve = timed_call
        walls = {"rpc": [], "in_process": []}
        split = {"serialize": [], "wire_and_sidecar": [], "decode": []}
        for i in range(REMOTE_TURNS):
            for path in (("rpc", "in_process") if i % 2 == 0 else ("in_process", "rpc")):
                t = time.perf_counter()
                plan = client.solve(pods2, pools2) if path == "rpc" \
                    else local.solve_relaxed(pods2, pools2)
                torch.cuda.synchronize()
                end = time.perf_counter()
                walls[path].append((end - t) * 1e3)
                if path == "rpc":
                    split["serialize"].append((marks["sent"] - t) * 1e3)
                    split["wire_and_sidecar"].append((marks["answered"] - marks["sent"]) * 1e3)
                    split["decode"].append((end - marks["answered"]) * 1e3)
                if canon(plan) != canon(plan2):
                    raise AssertionError(f"remote: a repeated {path} solve changed the plan")
        # one traced call: the sidecar's spans come back in the response
        rec = FlightRecorder(ring=16, retained=4, latency_budget_ms=1e9)
        trace.enable(rec)
        try:
            with trace.span("chip.remote") as root:
                client.solve(pods2, pools2)
            spans = {s.name: s.duration * 1e3 for s in rec.get(root.trace_id)}
        finally:
            trace.disable()
            trace.get_tracer().recorder = None
        health = []
        for _ in range(REMOTE_HEALTH_CALLS):
            t = time.perf_counter()
            doc = client.health()
            health.append((time.perf_counter() - t) * 1e3)
        if not doc["ok"] or doc["types"] != lattice.T:
            raise AssertionError(f"remote: Health answered {doc}")
        p50 = {k: statistics.median(v) for k, v in walls.items()}
        print(f"cfg2 Solve RPC: p50 {p50['rpc']:.3f} ms against in-process "
              f"solve_relaxed {p50['in_process']:.3f} ms ({REMOTE_TURNS} each, in "
              f"turns); request {marks['req_bytes']} B, response "
              f"{marks['resp_bytes']} B; split p50 ms "
              f"{ {k: round(statistics.median(v), 3) for k, v in split.items()} }; "
              f"the sidecar's spans (traced call) ms "
              f"{ {k: round(v, 3) for k, v in spans.items() if k in ('sidecar.solve', 'solver.solve_relaxed')} }; "
              f"Health p50 {statistics.median(health):.3f} ms over "
              f"{REMOTE_HEALTH_CALLS}", flush=True)
        out["cfg2_rpc"] = {"rpc_ms": walls["rpc"], "in_process_ms": walls["in_process"],
                           "rpc_p50_ms": p50["rpc"], "in_process_p50_ms": p50["in_process"],
                           "request_bytes": marks["req_bytes"],
                           "response_bytes": marks["resp_bytes"],
                           "split_p50_ms": {k: statistics.median(v)
                                            for k, v in split.items()},
                           "sidecar_spans_ms": {k: spans.get(k) for k in (
                               "sidecar.solve", "solver.solve_relaxed")},
                           "health_p50_ms": statistics.median(health)}

        # (b) the kernel behind the wire: two in-process sidecars on the card
        for i in range(2):
            sc = ChaosSidecar(Solver(lattice), f"unix:{tmp}/b{i}.sock").start()
            sidecars.append(sc)
        bclient = SolverClient(sidecars[0].address, timeout=REMOTE_SOLVE_DEADLINE)
        closers.append(bclient.close)
        bclient.solve(pods2, pools2)        # the sidecar Solver's first solve
        oa.LAUNCHES = 0
        plan, captured = measure.captured_kernel_inputs(
            lambda: bclient.solve(pods2, pools2))
        launches["sidecar_cfg2"] = oa.LAUNCHES
        if launches["sidecar_cfg2"] != 1 or len(captured) != 1:
            raise AssertionError(f"remote: {launches['sidecar_cfg2']} launches and "
                                 f"{len(captured)} captured calls in one Solve RPC")
        if canon(plan) != canon(plan2):
            raise AssertionError("remote: the in-process sidecar's plan differs")
        tm, zc, pr = captured[0]
        max_err = measure.check_exact("sidecar cfg2 inputs", oa.cheapest_offering(tm, zc, pr),
                                      oa.cheapest_offering_ref(tm, zc, pr))
        print(f"sidecar cfg2: {launches['sidecar_cfg2']} kernel launch in one Solve "
              f"RPC (B={tm.shape[0]} T={tm.shape[1]} ZC={zc.shape[1]}), exact "
              f"against the plain version", flush=True)

        # (c) failover through a pool over the two sidecars
        cut = {}

        def before(step, pool):
            closers.append(pool.close)
            if REMOTE_FAILOVER_EXPECTED[step]["local_solves"]:
                _ALLOWED[id(pool)] = {"pool-exhausted": 1}
            oa.LAUNCHES = 0

        def after(step, pool):
            cut[step] = oa.LAUNCHES

        def make_pool(deadline):
            return SolverPool(lattice, ",".join(sc.address for sc in sidecars),
                              clock=FakeClock(), solve_deadline=deadline)

        def drained():
            # the released handler goes on to solve; let it finish
            while sidecars[0].server._active:
                time.sleep(0.05)

        steps = []
        for step, row, plan, wall_ms in _failover_steps(
                make_pool, sidecars, {"cfg2": (pods2, pools2), "cfg3": (pods3, pools3)},
                {"hang": REMOTE_HANG_DEADLINE}, REMOTE_SOLVE_DEADLINE,
                before=before, after=after, after_hang=drained):
            torch.cuda.synchronize()
            print(f"failover {step}: {row}, wall {wall_ms:.3f} ms", flush=True)
            if row != REMOTE_FAILOVER_EXPECTED[step]:
                raise AssertionError(f"failover {step}: {row}, the reference decides "
                                     f"{REMOTE_FAILOVER_EXPECTED[step]}")
            want = plan3 if REMOTE_FAILOVER_STEPS[step][1] == "cfg3" else plan2
            if canon(plan, core=True) != canon(want, core=True):
                raise AssertionError(f"failover {step}: the plan differs from the "
                                     f"in-process plan")
            steps.append({"step": step, "wall_ms": wall_ms, **row})
        launches["pool_local_cfg3"] = cut["cfg3"]
        hang = next(s for s in steps if s["step"] == "hang")
        print(f"failover: every decision as the reference's; the hang's wall "
              f"{hang['wall_ms']:.3f} ms against the {REMOTE_HANG_DEADLINE} s solve "
              f"deadline plus one failover; cfg3's local rung "
              f"{launches['pool_local_cfg3']} launch(es)", flush=True)
        if launches["pool_local_cfg3"] < 1:
            raise AssertionError("failover cfg3: the local rung never launched the kernel")
        out["failover"] = steps

        # (d) the solve window: concurrent RPCs to one sidecar
        for sc in sidecars:
            sc.kill()
        waddr = f"unix:{tmp}/w.sock"
        wsolver = Solver(lattice)
        servers.append(serve(wsolver, waddr))
        base1, pools1, _ = workloads.config1_parity()
        problems1 = [[serde.pod_from_dict({**serde.pod_to_dict(p), "name": f"w{i}-{p.name}"})
                      for p in base1[:len(base1) - 5 * i]]
                     for i in range(REMOTE_WINDOW_THREADS)]
        serial = [canon(Solver(lattice).solve_relaxed(p, pools1)) for p in problems1]
        wclient = SolverClient(waddr, timeout=REMOTE_SOLVE_DEADLINE)
        closers.append(wclient.close)
        wclient.solve(problems1[0], pools1)
        before = introspect.registry().collect()["solve_window"]
        barrier = threading.Barrier(REMOTE_WINDOW_THREADS)
        got = {}

        def caller(i):
            barrier.wait()
            got[i] = canon(wclient.solve(problems1[i], pools1))
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(REMOTE_WINDOW_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        window_ms = (time.perf_counter() - t) * 1e3
        after = introspect.registry().collect()["solve_window"]
        batches = after["batches"] - before["batches"]
        coalesced = after["coalesced"] - before["coalesced"]
        print(f"solve window: {REMOTE_WINDOW_THREADS} concurrent Solve RPCs of "
              f"distinct cfg1-sized problems in {batches} drain(s), {coalesced} "
              f"coalesced, {window_ms:.3f} ms", flush=True)
        if [got.get(i) for i in range(REMOTE_WINDOW_THREADS)] != serial:
            raise AssertionError("solve window: a plan differs from its serial solve")
        if batches < 1 or coalesced < 2:
            raise AssertionError(f"solve window: {batches} drains, {coalesced} coalesced")
        out["window"] = {"rpcs": REMOTE_WINDOW_THREADS, "batches": batches,
                         "coalesced": coalesced, "wall_ms": window_ms}
        launches["remote_operator_cfg2_local"] = local_launches
    finally:
        for close in closers:
            close()
        for sc in sidecars:
            sc.kill()
        for server in servers:
            server.stop(None)
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["max_abs_err"] = max_err
    return out, launches, (tm, zc, pr)


def _failover_steps(make_pool, sidecars, problems, deadlines, deadline,
                    before=None, after=None, after_hang=None):
    """The remote phase's failover steps (``REMOTE_FAILOVER_STEPS``), on
    either package's objects: for each step the two ``sidecars`` are
    restored, ``make_pool(solve deadline)`` builds a fresh pool over them
    (``deadlines`` by fault, else ``deadline``), one cfg2 solve warms it
    (endpoint 0 answers), the fault lands and the step's problem is
    solved once, between ``before(step, pool)`` and ``after(step,
    pool)``. Yields (step, its decisions, the plan, wall ms); the
    decisions are what ``REMOTE_FAILOVER_EXPECTED`` holds."""
    failover = "solver pool failover: "
    for step, (fault, problem) in REMOTE_FAILOVER_STEPS.items():
        for sc in sidecars:
            sc.restore()
        pool = make_pool(deadlines.get(fault, deadline))
        pool.solve_relaxed(*problems["cfg2"])
        if fault == "kill":
            sidecars[0].kill()
        elif fault == "hang":
            sidecars[0].set_hang(True)
        elif fault == "junk":
            sidecars[0].set_junk(True)
        elif fault == "dark":
            for sc in sidecars:
                sc.kill()
        if before is not None:
            before(step, pool)
        t = time.perf_counter()
        plan = pool.solve_relaxed(*problems[problem])
        wall_ms = (time.perf_counter() - t) * 1e3
        if after is not None:
            after(step, pool)
        if fault == "hang":
            sidecars[0].set_hang(False)
            if after_hang is not None:
                after_hang()
        st = pool.pool_stats()
        row = {"solved_by": pool._last_ep,
               "states": [st["ep0_state"], st["ep1_state"]],
               "failovers": st["failovers"], "local_solves": st["local_solves"],
               "degraded_reason": plan.degraded_reason,
               "reasons": sorted(w.rsplit(": ", 1)[1] for w in plan.warnings
                                 if w.startswith(failover))}
        yield step, row, plan, wall_ms


# ---- phases 15-17 and 19: warm start, profiling, the native referee and
# the sticky device error (their child processes run this file with a mode)

_CHILD_MODES = ("--cold-first-solve", "--warm-first-solve",
                "--cold-profiled-solve", "--device-lost", "--tools-cli",
                "--cache-first-solve", "--lost-rank")


def _child_result(mode: str, timeout: float = CHILD_SECONDS, env=None):
    """Run this script as a child process in ``mode`` (a fresh CUDA
    context; ``env`` its environment, this one's by default), killed at
    ``timeout``; (exit code, its result dict, output tail)."""
    import subprocess
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), mode],
                          cwd=HERE, capture_output=True, text=True,
                          timeout=timeout, env=env)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("CHILD "):
            result = json.loads(line[len("CHILD "):])
    tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-25:])
    return proc.returncode, result, tail


def _trace_breakdown(path: str, top: int = 12):
    """Of a Chrome trace of ``torch.profiler``: the device kernels (count,
    summed ms), the CUDA runtime and driver calls summed by name (count,
    ms; the ``top`` largest), and the pack spans."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    api, kernels = {}, [0, 0.0]
    spans = []
    for e in events:
        cat, name, dur = e.get("cat", ""), e.get("name", ""), e.get("dur", 0)
        if cat == "kernel":
            kernels[0] += 1
            kernels[1] += dur / 1e3
        elif cat in ("cuda_runtime", "cuda_driver"):
            row = api.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += dur / 1e3
        elif cat == "user_annotation" and name in PACK_SPANS:
            spans.append((name, dur / 1e3))
    ranked = sorted(api.items(), key=lambda kv: -kv[1][1])[:top]
    return {"kernels": kernels[0], "kernel_ms": kernels[1],
            "api_ms_by_call": {k: {"count": c, "ms": ms}
                               for k, (c, ms) in ranked},
            "api_ms": sum(ms for _, ms in api.values()),
            "pack_spans": spans}


def _child_first_solve(torch, mode: str) -> int:
    """A fresh process's first cfg5 solve: ``--cold-first-solve`` times it
    as it comes, ``--warm-first-solve`` after the boot warmup ladder on a
    background thread (waited for through ``on_done``), and
    ``--cold-profiled-solve`` under ``start_profiling`` for the breakdown
    of the cold cost. Then ``WARM_LATER_SOLVES`` more solves. Prints one
    ``CHILD {json}`` line."""
    import tempfile
    import threading
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    from karpenter_provider_aws_tpu_torch.solver import Solver

    out = {"mode": mode}
    t = time.perf_counter()
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config5_full_scale()
    out["setup_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["context_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    solver = Solver(lattice)
    torch.cuda.synchronize()
    out["solver_init_ms"] = (time.perf_counter() - t) * 1e3
    # the kernel library's load (dlopen; built by the parent), timed where
    # the wrapper first asks for it
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    real_load, loads = cuda_build.load, []

    def load(name):
        t = time.perf_counter()
        lib = real_load(name)
        loads.append((time.perf_counter() - t) * 1e3)
        return lib

    cuda_build.load = load

    def segments():
        return int(torch.cuda.memory_stats().get("segment.all.allocated", 0))

    if mode == "--warm-first-solve":
        done = threading.Event()
        oa.LAUNCHES = 0
        t = time.perf_counter()
        thread = solver.warmup(node_pools_count=len(pools),
                               g_buckets=Solver.BOOT_G_BUCKETS,
                               b_buckets=Solver.BOOT_B_BUCKETS,
                               probes=True, background=True,
                               on_done=done.set)
        if not done.wait(CHILD_SECONDS / 2):
            raise AssertionError("the warmup ladder did not end")
        out["warmup_ms"] = (time.perf_counter() - t) * 1e3
        thread.join(60)
        out["warmup_launches"] = oa.LAUNCHES
        # each (G, B) bucket: two packs (without and with existing bins)
        # and a probe pack at each of the first two K
        out["warmup_buckets"] = len(Solver.BOOT_G_BUCKETS) * len(
            Solver.BOOT_B_BUCKETS)
        out["warmup_segments"] = segments()
    trace_dir = None
    if mode == "--cold-profiled-solve":
        trace_dir = tempfile.mkdtemp(prefix="cold-trace-")
        solver.start_profiling(trace_dir)
    seg0 = segments()
    oa.LAUNCHES = 0
    t = time.perf_counter()
    plan = solver.solve_relaxed(pods, pools, existing=existing)
    torch.cuda.synchronize()
    out["first_solve_ms"] = (time.perf_counter() - t) * 1e3
    out["first_solve_launches"] = oa.LAUNCHES
    out["first_solve_new_segments"] = segments() - seg0
    out["first_solve_stage_ms"] = plan.stage_ms
    # e2e less the stages: build_problem, relaxation and the host around
    out["first_solve_rest_ms"] = out["first_solve_ms"] - sum(
        plan.stage_ms.values())
    out["library_load_ms"] = loads[0] if loads else None
    if trace_dir is not None:
        path = solver.stop_profiling()
        out["breakdown"] = _trace_breakdown(path)
        import shutil
        shutil.rmtree(trace_dir, ignore_errors=True)
    placed = sum(len(n.pods) for n in plan.new_nodes)
    out["plan"] = {"nodes": len(plan.new_nodes), "placed": placed,
                   "cost": plan.new_node_cost,
                   "unschedulable": len(plan.unschedulable)}
    later, rest = [], []
    for _ in range(WARM_LATER_SOLVES):
        t = time.perf_counter()
        p = solver.solve_relaxed(pods, pools, existing=existing)
        torch.cuda.synchronize()
        later.append((time.perf_counter() - t) * 1e3)
        rest.append(later[-1] - sum(p.stage_ms.values()))
    out["later_ms"] = later
    out["later_rest_p50_ms"] = statistics.median(rest)
    out["later_p50_ms"] = statistics.median(later)
    out["later_new_segments"] = segments() - seg0 - out["first_solve_new_segments"]
    print("CHILD " + json.dumps(out), flush=True)
    return 0


def _child_cache_first_solve(torch) -> int:
    """A process started as the CLI starts on ``COMPILE_CACHE_DIR`` (set by
    the parent): the CLI's options from its parser and the environment,
    the Operator (which points both builds at the directory before its
    Solver is built), the CLI's ``--warm-start`` ladder (ahead of time:
    every kernel source built into the cache first, each shape's analysis
    recorded), then cfg5's first solve through the Operator's Solver.
    Prints one ``CHILD`` line: the compiles this process ran, with their
    seconds, each build's directory and library, the ladder's wall,
    launches and captured shapes (the ladder cut to ``CACHE_G_BUCKETS`` x
    ``CACHE_B_BUCKETS``), and the first solve's launches and plan."""
    from karpenter_provider_aws_tpu_torch import cli, workloads
    from karpenter_provider_aws_tpu_torch.native import build as native_build
    from karpenter_provider_aws_tpu_torch.operator import Operator
    from karpenter_provider_aws_tpu_torch.ops import cuda_build
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    from karpenter_provider_aws_tpu_torch.solver import costmodel

    from karpenter_provider_aws_tpu_torch.solver import Solver

    out = {"mode": "--cache-first-solve",
           "cache": os.environ.get("COMPILE_CACHE_DIR", "")}
    # the ladder's depth, cut to cfg5's shape (the full ladder runs in the
    # --warm-first-solve child)
    Solver.BOOT_G_BUCKETS, Solver.BOOT_B_BUCKETS = (CACHE_G_BUCKETS,
                                                    CACHE_B_BUCKETS)
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config5_full_scale()
    args = cli.build_parser().parse_args(["--warm-start"])
    opts = cli.options_from_args(args)
    t = time.perf_counter()
    op = Operator(options=opts, lattice=lattice, node_pools=pools,
                  device=args.device)
    out["operator_ms"] = (time.perf_counter() - t) * 1e3
    out["build_dirs"] = [str(cuda_build.BUILD_DIR), str(native_build.BUILD_DIR)]
    oa.LAUNCHES = 0
    t = time.perf_counter()
    thread = cli.warm_start(op, opts)
    thread.join(CHILD_SECONDS / 2)
    if thread.is_alive():
        raise AssertionError("the warmup ladder did not end")
    out["warmup_ms"] = (time.perf_counter() - t) * 1e3
    out["warmup_launches"] = oa.LAUNCHES
    out["compiled"] = {**{f"nvcc {k}": v
                          for k, v in cuda_build.BUILD_SECONDS.items()},
                       **{f"g++ {k}": v
                          for k, v in native_build.BUILD_SECONDS.items()}}
    out["build_logs"] = sorted(cuda_build.BUILD_LOGS) + sorted(
        native_build.BUILD_LOGS)
    out["libraries"] = [str(cuda_build.library_path(n))
                        for n in cuda_build.sources()] + [
        str(native_build.library_path())]
    shapes = costmodel.model().summary()["shapes"]
    out["captured"] = sorted(k for k, r in shapes.items()
                             if r["flops"] > 0 and r["peak_bytes"] > 0)
    out["models"] = {k: shapes[k] for k in out["captured"]}
    oa.LAUNCHES = 0
    t = time.perf_counter()
    plan = op.solver.solve_relaxed(pods, pools, existing=existing)
    torch.cuda.synchronize()
    out["first_solve_ms"] = (time.perf_counter() - t) * 1e3
    out["first_solve_launches"] = oa.LAUNCHES
    out["plan"] = {"nodes": len(plan.new_nodes),
                   "placed": sum(len(n.pods) for n in plan.new_nodes),
                   "cost": plan.new_node_cost,
                   "unschedulable": len(plan.unschedulable)}
    print("CHILD " + json.dumps(out), flush=True)
    return 0


def _child_lost_rank(torch) -> int:
    """A10b on the cards: cfg11 through the rank program over NCCL, one
    rank a card, the group timeout cut to ``LOST_RANK_TIMEOUT_S``. Three
    Solvers in turn, each on a fresh set of workers: the first has a worker
    killed in the middle of a pack, the second a worker stopped (alive,
    silent) there; each such solve must raise ``DeviceLostError`` from
    ``RanksLost``, the Solver must report its device lost and no worker of
    the set may be left, the kill within the group timeout and the stall
    at it. Each Solver's first solve, and the third's, must give the same
    plan. Prints one ``CHILD`` line."""
    import signal

    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch.apis import serde
    from karpenter_provider_aws_tpu_torch.errors import DeviceLostError
    from karpenter_provider_aws_tpu_torch.parallel import plan_mesh, ranks
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    ranks.GROUP_TIMEOUT_S = LOST_RANK_TIMEOUT_S
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config11_200k_sharded()
    problem = build_problem(pods, pools, lattice, existing=existing)
    mesh = plan_mesh(str(MESH_SHARDS)).mesh
    out = {"cards": torch.cuda.device_count(), "ranks": int(mesh.ranks),
           "timeout_s": LOST_RANK_TIMEOUT_S, "steps": []}
    wait, sets, healthy = ranks.Ranks._wait, [], None
    for fault in ("kill", "stall", None):
        solver = Solver(lattice, mesh=mesh)
        t = time.perf_counter()
        plan = solver.solve(problem)
        torch.cuda.synchronize()
        step = {"fault": fault,
                "first_solve_s": time.perf_counter() - t}
        rs = solver._ranks
        canon = json.dumps(serde.plan_semantic_dict(plan), sort_keys=True)
        healthy = healthy or canon
        step.update(plan_equal=canon == healthy,
                    fresh_set=all(rs is not old for old in sets),
                    spawn_s=rs.spawn_ms / 1e3, pids=rs.pids())
        sets.append(rs)
        out["steps"].append(step)
        if fault is None:
            break
        victim = rs._procs[0 if fault == "kill" else -1]
        fired = []

        def faulting_wait(self, works, rs=rs, victim=victim, fault=fault):
            if self is rs and not fired:
                os.kill(victim.pid, signal.SIGKILL if fault == "kill"
                        else signal.SIGSTOP)
                fired.append(time.perf_counter())
            return wait(self, works)

        ranks.Ranks._wait = faulting_wait
        raised = None
        try:
            solver.solve(problem)
        except DeviceLostError as e:
            raised = e
        finally:
            ranks.Ranks._wait = wait
        step["raise_s"] = time.perf_counter() - fired[0] if fired else None
        chain, e = [], raised
        while e is not None and len(chain) < 8:
            chain.append(type(e).__name__)
            e = e.__cause__ or e.__context__
        step.update(raised=chain, device_lost=solver.device_lost is not None,
                    broken=rs.broken,
                    left=[p for p in rs.pids() if not _gone(p)])
    ranks.shutdown_all()
    out["left_at_end"] = ranks.live_workers() + [
        p for rs in sets for p in rs.pids() if not _gone(p)]
    print("CHILD " + json.dumps(out), flush=True)
    return 0


def _lost_rank(torch):
    """Phase 13, step (f): a lost rank over NCCL (``_child_lost_rank`` in a
    child process, so that no aborted communicator touches this one's
    cards). It needs ``LOST_RANK_CARDS`` cards: on fewer it prints so and
    checks nothing. Returns its record (None when skipped)."""
    cards = torch.cuda.device_count()
    if cards < LOST_RANK_CARDS:
        print(f"lost rank: needs {LOST_RANK_CARDS} cards, {cards} visible; "
              f"not run", flush=True)
        return None
    t = time.perf_counter()
    rc, res, tail = _child_result("--lost-rank", timeout=LOST_RANK_SECONDS)
    wall_s = time.perf_counter() - t
    if rc != 0 or res is None:
        raise AssertionError(f"lost rank: rc {rc}\n{tail}")
    res["wall_s"] = wall_s
    timeout = res["timeout_s"]
    for step in res["steps"]:
        print(f"lost rank, {step['fault'] or 'fresh'}: "
              f"{res['ranks']} ranks on {res['cards']} cards, workers "
              f"spawned in {step['spawn_s']:.2f} s, first cfg11 solve "
              f"{step['first_solve_s']:.2f} s, plan equal "
              f"{step['plan_equal']}, fresh set {step['fresh_set']}"
              + (f"; {step['fault']} mid-pack: raised {step['raised']} "
                 f"{step['raise_s']:.2f} s later, device lost "
                 f"{step['device_lost']}, workers left {step['left']}"
                 if step["fault"] else ""), flush=True)
        if not (step["plan_equal"] and step["fresh_set"]
                and step["spawn_s"] < timeout):
            raise AssertionError(f"lost rank: {step}")
        if step["fault"] is None:
            continue
        on_time = (step["raise_s"] is not None
                   and (step["raise_s"] < timeout if step["fault"] == "kill"
                        else timeout <= step["raise_s"] < 2 * timeout))
        if not (step["raised"][:1] == ["DeviceLostError"]
                and "RanksLost" in step["raised"] and step["device_lost"]
                and not step["left"] and on_time):
            raise AssertionError(f"lost rank: {step}")
    if res["left_at_end"] or len(res["steps"]) != 3:
        raise AssertionError(f"lost rank: {res}")
    from karpenter_provider_aws_tpu_torch import measure
    print(f"lost rank: the child took {wall_s:.1f} s; nvidia-smi: "
          f"{measure.card_line()}", flush=True)
    return res


def _child_device_lost(torch) -> int:
    """A real sticky error on the card: an Operator (direct mode, the wall
    clock, a batch window of 0 s) with cfg10's 20,000 pending pods runs
    the CLI's single-threaded loop (``cli.run_passes``); the Solver's first
    pack first indexes a CUDA tensor out of range (a device-side assert,
    monkeypatched in here, not a knob of the package). The loop must end
    with ``EXIT_DEVICE_LOST`` right after that pass. Prints one ``CHILD``
    line (the passes, how many began after the error, whether a
    one-element op still runs) and exits with the loop's code."""
    import threading
    from karpenter_provider_aws_tpu_torch import cli, workloads
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.ops import binpack

    lattice = workloads.real_lattice()
    pods, pools, _ = workloads.config10_steady_state()
    op = Operator(options=Options(batch_idle_duration=0.0,
                                  batch_max_duration=0.0),
                  lattice=lattice, node_pools=pools)
    for p in pods:
        op.cluster.add_pod(p)
    real_pack, fired = binpack.pack_packed_efused, []

    def pack(*args, **kwargs):
        if not fired:
            fired.append(time.perf_counter())
            t = torch.zeros(4, device="cuda")
            t[torch.tensor([t.numel()], device="cuda")]   # device-side assert
        return real_pack(*args, **kwargs)

    binpack.pack_packed_efused = pack
    passes = []
    real_run = op.run_once

    def run_once(*args, **kwargs):
        passes.append(op.solver.device_lost is not None)
        return real_run(*args, **kwargs)

    op.run_once = run_once
    t = time.perf_counter()
    code = cli.run_passes(op, threading.Event(),
                          time.monotonic() + DEVICE_LOST_SECONDS, 0.0)
    wall_s = time.perf_counter() - t
    try:
        torch.ones(1, device="cuda").add_(1).cpu()
        recovered = True
    except RuntimeError:
        recovered = False
    events = [e.reason for e in op.recorder.events()]
    lost = op.solver.device_lost
    print("CHILD " + json.dumps({
        "exit_code": code, "passes": len(passes),
        "passes_after_error": sum(passes), "fired": len(fired),
        "solver_failed_events": events.count("SolverFailed"),
        "degraded_counts": dict(op.solver.degraded_counts),
        "device_lost": None if lost is None else str(lost)[:300],
        "context_recovered": recovered, "wall_s": wall_s}), flush=True)
    return code


def _warm_start(torch, oa):
    """Phase 15: cfg5's first solve in fresh processes: cold, after the
    boot warmup ladder, and cold under the profiler (the breakdown)."""
    out = {}
    for mode in _CHILD_MODES[:3]:
        rc, res, tail = _child_result(mode)
        if rc != 0 or res is None:
            raise AssertionError(f"warm start {mode}: rc {rc}\n{tail}")
        plan = res["plan"]
        if plan["unschedulable"] or plan["placed"] != 50000:
            raise AssertionError(f"warm start {mode}: plan {plan}")
        if res["first_solve_launches"] < 1:
            raise AssertionError(f"warm start {mode}: the first solve "
                                 f"launched no kernel")
        out[mode.strip("-")] = res
        print(f"{mode}: context {res['context_ms']:.1f} ms, Solver "
              f"{res['solver_init_ms']:.1f} ms"
              + (f", warmup {res['warmup_ms']:.1f} ms over "
                 f"{res['warmup_buckets']} (G, B) buckets with {res['warmup_launches']} "
                 f"kernel launches" if "warmup_ms" in res else "")
              + f"; first cfg5 solve {res['first_solve_ms']:.1f} ms "
              f"({res['first_solve_launches']} launches, "
              f"{res['first_solve_new_segments']} new allocator segments, "
              f"stages {({k: round(v, 1) for k, v in res['first_solve_stage_ms'].items()})}, "
              f"rest {res['first_solve_rest_ms']:.1f} ms, kernel library load "
              f"{res['library_load_ms']} ms); "
              f"later p50 {res['later_p50_ms']:.1f} ms (rest p50 "
              f"{res['later_rest_p50_ms']:.1f} ms) "
              f"({[round(x, 1) for x in res['later_ms']]}, "
              f"{res['later_new_segments']} new segments)", flush=True)
        if "breakdown" in res:
            b = res["breakdown"]
            print(f"  profiled first solve: {b['kernels']} kernels, "
                  f"{b['kernel_ms']:.1f} ms of device time; CUDA API "
                  f"{b['api_ms']:.1f} ms, by call "
                  f"{ {k: (v['count'], round(v['ms'], 1)) for k, v in b['api_ms_by_call'].items()} }; "
                  f"pack spans {[(n, round(ms, 1)) for n, ms in b['pack_spans']]}",
                  flush=True)
    cold, warm = out["cold-first-solve"], out["warm-first-solve"]
    if warm["warmup_launches"] < 1:
        raise AssertionError("warm start: the warmup launched no kernel")
    if {json.dumps(o["plan"], sort_keys=True) for o in out.values()} != {
            json.dumps(cold["plan"], sort_keys=True)}:
        raise AssertionError(f"warm start: the first plans differ: "
                             f"{[o['plan'] for o in out.values()]}")
    print(f"warm start: first cfg5 solve cold {cold['first_solve_ms']:.1f} ms, "
          f"warm-started {warm['first_solve_ms']:.1f} ms (warmup "
          f"{warm['warmup_ms']:.1f} ms); later p50 cold {cold['later_p50_ms']:.1f} "
          f"/ warm {warm['later_p50_ms']:.1f} ms", flush=True)
    out["compile_cache"] = _compile_cache(cold["plan"])
    return out


def _build_listing():
    """Name and modification time of every file in the package's
    ``_build/``."""
    d = os.path.join(HERE, "karpenter_provider_aws_tpu_torch", "_build")
    if not os.path.isdir(d):
        return {}
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns for n in os.listdir(d)}


def _compile_cache(cold_plan):
    """Phase 15, the compile cache: two CLI-started children on one fresh,
    empty ``COMPILE_CACHE_DIR`` (``_child_cache_first_solve``). The first
    must build both libraries (nvcc, g++) into it and nothing into
    ``_build/``; the second must load them with no compile. Both plan cfg5
    as the cold child did, their first solves launch the kernel, and the
    ahead-of-time ladder (cut to ``CACHE_G_BUCKETS`` x ``CACHE_B_BUCKETS``)
    captures each of its shapes."""
    import shutil
    import tempfile
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.solver import costmodel
    cache = tempfile.mkdtemp(prefix="compile-cache-")
    shapes = sorted(costmodel.shape_key(G, B) for G in CACHE_G_BUCKETS
                    for B in CACHE_B_BUCKETS)
    before = _build_listing()
    out = {}
    try:
        for label in ("cold", "warm"):
            rc, res, tail = _child_result(
                "--cache-first-solve",
                env={**os.environ, "COMPILE_CACHE_DIR": cache})
            if rc != 0 or res is None:
                raise AssertionError(f"compile cache, {label}: rc {rc}\n{tail}")
            out[label] = res
            print(f"compile cache, {label} child: compiled "
                  f"{ {k: round(v, 3) for k, v in res['compiled'].items()} } s "
                  f"(BUILD_LOGS {res['build_logs']}) into "
                  f"{sorted({os.path.dirname(x) == cache for x in res['libraries']})}"
                  f" the cache; warmup {res['warmup_ms']:.1f} ms, "
                  f"{res['warmup_launches']} launches, captured "
                  f"{res['models']}; first cfg5 solve "
                  f"{res['first_solve_ms']:.1f} ms ({res['first_solve_launches']} "
                  f"launches), plan {res['plan']}; nvidia-smi: "
                  f"{measure.card_line()}", flush=True)
            if res["build_dirs"] != [cache, cache] or not all(
                    os.path.dirname(x) == cache and os.path.isfile(x)
                    for x in res["libraries"]):
                raise AssertionError(f"compile cache, {label}: built into "
                                     f"{res['build_dirs']}: {res['libraries']}")
            if res["plan"] != cold_plan or res["first_solve_launches"] < 1:
                raise AssertionError(f"compile cache, {label}: plan "
                                     f"{res['plan']} (cold {cold_plan}), "
                                     f"{res['first_solve_launches']} launches")
            if res["captured"] != shapes:
                raise AssertionError(f"compile cache, {label}: captured "
                                     f"{res['captured']}")
        cold, warm = out["cold"], out["warm"]
        if cold["build_logs"] != ["offering_argmin", "ffd"]:
            raise AssertionError(f"compile cache: the cold child compiled "
                                 f"{cold['build_logs']}")
        if warm["build_logs"] or warm["libraries"] != cold["libraries"]:
            raise AssertionError(f"compile cache: the warm child compiled "
                                 f"{warm['build_logs']}, loaded "
                                 f"{warm['libraries']}")
        if sorted(os.listdir(cache)) != sorted(
                os.path.basename(x) for x in cold["libraries"]):
            raise AssertionError(f"compile cache: {os.listdir(cache)}")
        if _build_listing() != before:
            raise AssertionError("compile cache: a child wrote into _build/")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    print(f"compile cache: cold child compiled in "
          f"{sum(out['cold']['compiled'].values()):.3f} s, the warm child "
          f"compiled nothing; _build/ untouched", flush=True)
    return out


def _profiling(torch, lattice, oa, pods, pools, existing):
    """Phase 16: ``PROFILED_SOLVES`` cfg5 solves between
    ``start_profiling`` and ``stop_profiling``: the trace must exist and
    name the ``solver.pack`` span and the cheapest-offering kernel."""
    import shutil
    import tempfile
    from karpenter_provider_aws_tpu_torch.solver import Solver, costmodel
    solver = Solver(lattice)
    # the device cost model's capture of the boot ladder: a meta-device
    # trace of each shape, no launch
    before = oa.LAUNCHES
    t = time.perf_counter()
    captured = solver.capture_cost_model(node_pools_count=len(pools),
                                         g_buckets=Solver.BOOT_G_BUCKETS,
                                         b_buckets=Solver.BOOT_B_BUCKETS)
    capture_s = time.perf_counter() - t
    after = oa.LAUNCHES
    print(f"profiling: capture_cost_model captured {captured} shapes of "
          f"{len(Solver.BOOT_G_BUCKETS) * len(Solver.BOOT_B_BUCKETS)} in "
          f"{capture_s:.2f} s; kernel launches {before} before, {after} after",
          flush=True)
    if captured != len(Solver.BOOT_G_BUCKETS) * len(Solver.BOOT_B_BUCKETS) \
            or after != before:
        raise AssertionError(f"profiling: captured {captured}, launches "
                             f"{before} -> {after}")
    solver.solve_relaxed(pods, pools, existing=existing)   # outside the trace
    torch.cuda.synchronize()
    trace_dir = tempfile.mkdtemp(prefix="profile-")
    try:
        solver.start_profiling(trace_dir)
        oa.LAUNCHES = 0
        walls = []
        try:
            for _ in range(PROFILED_SOLVES):
                t = time.perf_counter()
                solver.solve_relaxed(pods, pools, existing=existing)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
        finally:
            path = solver.stop_profiling()
        launches = oa.LAUNCHES
        if path is None or not os.path.isfile(path):
            raise AssertionError(f"profiling: no trace file ({path})")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        # a span shows twice (host and device timelines): count the host's
        packs = [e for e in events if e.get("name") == "solver.pack"
                 and e.get("cat") == "user_annotation"]
        kernels = [n for n in names if "cheapest_offering_kernel" in n]
        b = _trace_breakdown(path)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    print(f"profiling: {PROFILED_SOLVES} cfg5 solves {[round(w, 1) for w in walls]} ms "
          f"under the profiler, {launches} kernel launches; trace "
          f"{size} bytes, {len(packs)} solver.pack spans, {len(kernels)} "
          f"cheapest_offering_kernel events; {b['kernels']} kernels, "
          f"{b['kernel_ms']:.1f} ms of device time", flush=True)
    if len(packs) != PROFILED_SOLVES or len(kernels) < PROFILED_SOLVES \
            or launches != PROFILED_SOLVES:
        raise AssertionError(f"profiling: {len(packs)} pack spans, "
                             f"{len(kernels)} kernel events, {launches} "
                             f"launches for {PROFILED_SOLVES} solves")
    key = costmodel.model().last_shape
    rec = costmodel.model().summary()["shapes"].get(key, {})
    print(f"profiling: cfg5 solved at {key}: {rec.get('flops', 0):.0f} flops, "
          f"{rec.get('bytes_accessed', 0):.0f} bytes accessed, peak "
          f"{rec.get('peak_bytes', 0):.0f} bytes (the pack's analysis); "
          f"last_vs_model {rec.get('last_vs_model')} over {rec.get('solves')} "
          f"solves", flush=True)
    if not (rec.get("flops", 0) > 0 and rec.get("bytes_accessed", 0) > 0
            and rec.get("peak_bytes", 0) > 0):
        raise AssertionError(f"profiling: no analysis of cfg5's shape {key}")
    return {"walls_ms": walls, "launches": launches,
            "capture": {"shapes": captured, "seconds": capture_s,
                        "launches": after - before, "cfg5_shape": key,
                        "cfg5_model": rec},
            "launches_per_solve": launches / PROFILED_SOLVES,
            "trace_bytes": size, "pack_spans": len(packs),
            "kernel_events": len(kernels), "kernels": b["kernels"],
            "kernel_ms": b["kernel_ms"]}


def _native(problem):
    """Phase 17: the native FFD referee on cfg5, built from the checkout's
    ``ffd.cc`` into the port's ``_build/``: its node count and cost must
    equal the Python ``ffd_oracle``'s; both are timed."""
    from karpenter_provider_aws_tpu_torch.native import build as native_build
    from karpenter_provider_aws_tpu_torch.native import native_ffd_pack
    from karpenter_provider_aws_tpu_torch.solver.oracle import ffd_oracle
    repo_lib = os.path.join(HERE, "native", "libffd.so")
    before = os.stat(repo_lib).st_mtime_ns if os.path.exists(repo_lib) else None
    t = time.perf_counter()
    lib = native_build.ensure_built()
    build_s = time.perf_counter() - t
    if lib is None:
        raise AssertionError("native: ffd.cc did not build (no g++?)")
    want = os.path.join(HERE, "karpenter_provider_aws_tpu_torch", "_build")
    lib_path = native_build.library_path()
    if os.path.dirname(os.path.abspath(str(lib_path))) != want \
            or not os.path.isfile(lib_path):
        raise AssertionError(f"native: built {lib_path}, not in {want}")
    after = os.stat(repo_lib).st_mtime_ns if os.path.exists(repo_lib) else None
    if after != before:
        raise AssertionError("native: the port wrote native/libffd.so")
    t = time.perf_counter()
    nat = native_ffd_pack(problem)
    native_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    py = ffd_oracle(problem)
    python_ms = (time.perf_counter() - t) * 1e3
    if nat is None or nat.leftover != 0:
        raise AssertionError(f"native: no plan or pods left over ({nat})")
    rel = abs(nat.new_node_cost - py.new_node_cost) / py.new_node_cost
    print(f"native referee: built in {build_s:.2f} s; cfg5 {nat.num_new_nodes} "
          f"nodes ${nat.new_node_cost:.4f}/hr in {native_ms:.1f} ms; Python "
          f"ffd_oracle {py.num_new_nodes} nodes ${py.new_node_cost:.4f}/hr in "
          f"{python_ms:.1f} ms (relative cost difference {rel:.2e})", flush=True)
    if nat.num_new_nodes != py.num_new_nodes or not rel <= 1e-5:
        raise AssertionError("native: node count or cost differs from the "
                             "Python oracle's")
    return {"build_s": build_s, "native_ms": native_ms, "python_ms": python_ms,
            "nodes": nat.num_new_nodes, "cost": nat.new_node_cost,
            "python_cost": py.new_node_cost, "rel_cost_diff": rel}


def _bench(torch, lattice, oa, cpu_plan):
    """Phase 18: the port's bench: its ``--smoke`` child, then the cfg5
    row in this process with the kernel parity check, its launches
    counted. Returns (the phase's record, the row's launches)."""
    import subprocess
    from karpenter_provider_aws_tpu_torch import bench, workloads
    from karpenter_provider_aws_tpu_torch.solver import Solver
    t = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "karpenter_provider_aws_tpu_torch.bench",
         "--smoke"], cwd=HERE, capture_output=True, text=True,
        timeout=BENCH_SMOKE_SECONDS)
    smoke_s = time.perf_counter() - t
    lines = child.stdout.strip().splitlines()
    if child.returncode != 0 or not lines:
        raise AssertionError(f"bench --smoke: rc {child.returncode}\n"
                             f"{child.stdout[-2000:]}\n{child.stderr[-3000:]}")
    smoke = json.loads(lines[-1])
    name = torch.cuda.get_device_name(0)
    if smoke.get("metric") != "e2e_p50_latency_cfg1_100pods_parity" \
            or smoke["detail"]["device"].get("name") != name:
        raise AssertionError(f"bench --smoke: last line {lines[-1]}")
    print(f"bench --smoke: {smoke_s:.1f} s, cfg1 e2e p50 {smoke['value']} ms, "
          f"device {smoke['detail']['device']}", flush=True)

    solver = Solver(lattice)
    oa.LAUNCHES = 0
    t = time.perf_counter()
    _, row = bench.run_config("cfg5_50k_full_lattice",
                              workloads.config5_full_scale, lattice, solver,
                              also_uncapped=True, iters=BENCH_ITERS)
    row_launches = oa.LAUNCHES
    row["kernel_parity"] = bench.kernel_parity_check(lattice, solver.device)
    row_s = time.perf_counter() - t
    launches = oa.LAUNCHES
    parity_launches = launches - row_launches
    solves = BENCH_ITERS + 1   # the cold solve and the timed ones
    print(f"bench cfg5 row: {row_s:.1f} s; {json.dumps(row)}", flush=True)
    want = {"new_nodes": len(cpu_plan.new_nodes),
            "plan_cost_per_hour": round(cpu_plan.new_node_cost, 2),
            "unschedulable": 0, "referee": "native",
            "uncapped_referee": "native"}
    got = {k: row.get(k) for k in want}
    if got != want or (want["new_nodes"], want["plan_cost_per_hour"]) \
            != (1840, 2938.00):
        raise AssertionError(f"bench cfg5 row: {got}, want {want}")
    if not row["cost_vs_ffd_oracle"] <= 1.02:
        raise AssertionError(f"bench cfg5 row: cost_vs_ffd_oracle "
                             f"{row['cost_vs_ffd_oracle']}")
    kp = row["kernel_parity"]
    if not (kp.get("checked") and kp.get("prices_identical")
            and kp.get("choices_identical")):
        raise AssertionError(f"bench cfg5 row: kernel parity {kp}")
    if row["device"].get("name") != name:
        raise AssertionError(f"bench cfg5 row: device {row['device']}")
    # the row counts its own launches; the parity check's are the rest
    if row["kernel_launches"] != row_launches or row_launches != solves \
            or parity_launches != 1:
        raise AssertionError(
            f"bench cfg5 row: {row['kernel_launches']} launches counted by "
            f"the row, {row_launches} by the phase, for {solves} solves; "
            f"{parity_launches} by the parity check, want 1")
    print(f"bench cfg5 row: {launches} kernel launches ({row_launches} over "
          f"{solves} solves + {parity_launches} parity check)", flush=True)
    return {"smoke_seconds": smoke_s, "smoke_row": smoke, "cfg5_row": row,
            "cfg5_row_seconds": row_s, "launches": launches,
            "row_launches": row_launches, "parity_launches": parity_launches,
            "solves": solves}, launches


def _child_tools_cli(argv) -> int:
    """The ``--tools-cli`` child of phase 20: the port's CLI (``cli.main``
    with ``argv``), with the kernel launches of every provisioning pass
    counted on the pass's own thread. Ends on SIGTERM; prints one JSON
    line: each pass's pending pods, launches and pods scheduled, the
    launches of the whole run and ``main``'s exit code."""
    import threading
    from karpenter_provider_aws_tpu_torch import cli
    from karpenter_provider_aws_tpu_torch.controllers import provisioning
    from karpenter_provider_aws_tpu_torch.ops import binpack
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    mine = threading.local()
    passes = []
    launch = binpack.cheapest_offering

    def counted_launch(*a, **k):
        before = oa.LAUNCHES
        try:
            return launch(*a, **k)
        finally:
            mine.launches = getattr(mine, "launches", 0) + oa.LAUNCHES - before

    provision_once = provisioning.Provisioner.provision_once

    def counted_pass(self):
        mine.launches = 0
        pending = len(self.cluster.pending_pods())
        result = provision_once(self)
        passes.append({"pending": pending, "launches": mine.launches,
                       "scheduled": result.pods_scheduled})
        return result

    binpack.cheapest_offering = counted_launch
    provisioning.Provisioner.provision_once = counted_pass
    oa.LAUNCHES = 0
    rc = cli.main(argv)
    print(json.dumps({"tools_cli": {"passes": passes, "launches": oa.LAUNCHES,
                                    "rc": rc}}), flush=True)
    return 0 if rc == 0 else 1


def _kpctl(base, *args, timeout=120):
    """``python -m karpenter_provider_aws_tpu_torch.tools.kpctl --server
    base *args`` from the checkout; returns its exit code and output."""
    import subprocess
    r = subprocess.run(
        [sys.executable, "-m", "karpenter_provider_aws_tpu_torch.tools.kpctl",
         "--server", base, *args], cwd=HERE, capture_output=True, text=True,
        timeout=timeout)
    return r.returncode, r.stdout, r.stderr


def _tools(torch, workloads, oa):
    """Phase 20: the entry module on the card against the CPU, the CLI as
    a child process driven by kpctl, and the soak. Returns the phase's
    record and its launches."""
    import gzip
    import signal
    import subprocess
    import tempfile
    from karpenter_provider_aws_tpu_torch import entry
    from karpenter_provider_aws_tpu_torch.apis import serde
    from karpenter_provider_aws_tpu_torch.apis import wellknown as wk
    from karpenter_provider_aws_tpu_torch.operator import Operator, Options
    from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock
    out, launches = {}, {}
    card = torch.cuda.get_device_name(0)

    # (a) the entry module: one pack on the card against the CPU
    t = time.perf_counter()
    fn, args = entry.entry()
    if args[0].device.type != "cuda":
        raise AssertionError(f"tools entry: args on {args[0].device}")
    oa.LAUNCHES = 0
    res = fn(*args)
    torch.cuda.synchronize()
    launches["entry"] = oa.LAUNCHES
    cpu_fn, cpu_args = entry.entry(device="cpu")
    cpu_res = cpu_fn(*cpu_args)
    fields = [(k, getattr(res, k), getattr(cpu_res, k))
              for k in res._fields if k != "state"]
    fields += [(f"state.{k}", getattr(res.state, k), getattr(cpu_res.state, k))
               for k in res.state._fields]
    differ = [k for k, a, b in fields if not torch.equal(a.cpu(), b)]
    if differ or launches["entry"] != 1:
        raise AssertionError(f"tools entry: {launches['entry']} launches, "
                             f"fields differing from the CPU: {differ}")
    oa.LAUNCHES = 0
    dry = entry.dryrun_multichip(8)
    torch.cuda.synchronize()
    launches["entry_dryrun_multichip"] = oa.LAUNCHES
    dry_cpu = entry.dryrun_multichip(8, device="cpu")
    plans = [(f"mesh {k}", dry["mesh_plans"][k], dry_cpu["mesh_plans"][k])
             for k in sorted(dry_cpu["mesh_plans"])]
    plans.append(("overflow", dry["overflow_plan"], dry_cpu["overflow_plan"]))
    differ = [n for n, a, b in plans if serde.plan_semantic_dict(a)
              != serde.plan_semantic_dict(b)]
    probe = [[(r.feasible, r.n_new, r.new_cost, r.new_cap_type, r.flex)
              for r in d["probes"]] for d in (dry, dry_cpu)]
    if differ or probe[0] != probe[1] or len(plans) != 4 \
            or launches["entry_dryrun_multichip"] < 1:
        raise AssertionError(f"tools dryrun_multichip: plans differing from "
                             f"the CPU {differ}, probes {probe}, "
                             f"{launches['entry_dryrun_multichip']} launches")
    out["entry"] = {"pack_launches": launches["entry"],
                    "dryrun_launches": launches["entry_dryrun_multichip"],
                    "plans_equal": [n for n, _, _ in plans],
                    "seconds": time.perf_counter() - t}
    print(f"tools entry: the pack on the card == the CPU's, field for field, "
          f"{launches['entry']} launch; dryrun_multichip(8): "
          f"{[n for n, _, _ in plans]} plans and {len(probe[0])} probes == "
          f"the CPU's, {launches['entry_dryrun_multichip']} launches",
          flush=True)

    # (b) the CLI as a child process on the card, driven by kpctl
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tools-")
    api_port, metrics_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{api_port}"
    log_path = os.path.join(tmp, "cli.log")
    ms = {}
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tools-cli",
             f"--api-port={api_port}", f"--metrics-port={metrics_port}",
             "--async-runtime", "--step", "0.5", "--log-level", "WARNING",
             "--cluster-name", "my-cluster",   # the example's cluster
             "--batch-idle-duration", "2", "--batch-max-duration", "120"],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            try:
                _http("GET", f"{base}/apis/nodepools")
                break
            except OSError:
                if child.poll() is not None \
                        or time.perf_counter() - t0 > TOOLS_CLI_SECONDS:
                    raise AssertionError(
                        f"tools cli: the REST surface never came up (rc "
                        f"{child.poll()})\n{open(log_path).read()[-3000:]}")
                time.sleep(0.2)
        ms["rest_up"] = (time.perf_counter() - t0) * 1e3
        rc, so, se = _kpctl(base, "apply", "-f",
                            os.path.join(HERE, "examples", "general-purpose.yaml"))
        if rc != 0 or "nodepools/general-purpose created" not in so:
            raise AssertionError(f"tools kpctl apply example: rc {rc}\n{so}\n{se}")
        cfg10, _, _ = workloads.config10_steady_state()
        pods = cfg10[:TOOLS_CLI_PODS]
        docs = []
        for p in pods:
            d = serde.pod_to_dict(p)
            d["nodeSelector"] = {**d["nodeSelector"],
                                 wk.LABEL_NODEPOOL: "general-purpose"}
            docs.append({"kind": "pods", "spec": d})
        pods_path = os.path.join(tmp, "pods.json")
        with open(pods_path, "w") as f:
            json.dump(docs, f)
        t = time.perf_counter()
        rc, so, se = _kpctl(base, "apply", "-f", pods_path, timeout=600)
        ms["kpctl_apply_pods"] = (time.perf_counter() - t) * 1e3
        if rc != 0 or so.count(" created") != len(pods):
            raise AssertionError(f"tools kpctl apply pods: rc {rc}, "
                                 f"{so.count(' created')} created\n{se[-2000:]}")
        t = time.perf_counter()
        while True:
            items = _http("GET", f"{base}/apis/pods")["items"]
            bound = sum(1 for o in items if o["spec"].get("nodeName"))
            if bound == len(pods):
                break
            if child.poll() is not None or time.perf_counter() - t > TOOLS_CLI_SECONDS:
                raise AssertionError(f"tools cli: {bound} of {len(pods)} pods "
                                     f"bound (rc {child.poll()})")
            time.sleep(0.25)
        ms["bind_all"] = (time.perf_counter() - t) * 1e3
        got = {}
        for kind in ("nodeclaims", "nodes", "pods", "nodepools", "nodeclasses"):
            rc, so, se = _kpctl(base, "get", kind, "-o", "json")
            if rc != 0:
                raise AssertionError(f"tools kpctl get {kind}: rc {rc}\n{se}")
            got[kind] = json.loads(so)
        node_of = {o["metadata"]["name"]: o["spec"]["nodeClaim"]
                   for o in got["nodes"]}
        pods_of = {}
        for o in got["pods"]:
            pods_of.setdefault(node_of.get(o["spec"].get("nodeName")),
                               []).append(o["metadata"]["name"])
        claim_rows = sorted(
            (o["spec"]["nodePool"], o["spec"]["instanceType"],
             o["spec"]["zone"], o["spec"]["capacityType"],
             sorted(pods_of.get(o["metadata"]["name"], [])))
            for o in got["nodeclaims"])
        admitted = [serde.nodepool_from_dict(o["spec"])
                    for o in got["nodepools"]]
        classes = {o["spec"]["name"]: serde.nodeclass_from_dict(o["spec"])
                   for o in got["nodeclasses"]}
        # the CPU plan of the same pods: one provisioning pass of an
        # Operator on the CPU over the pools and classes as admitted (the
        # CLI's default lattice, its cluster's subnets)
        t = time.perf_counter()
        ref = Operator(options=Options(cluster_name="my-cluster"),
                       node_pools=admitted, node_classes=classes,
                       clock=FakeClock(), device="cpu")
        for d in docs:   # the pods as applied: on the example's pool
            ref.cluster.add_pod(serde.pod_from_dict(d["spec"]))
        cpu_plan = ref.provisioner.provision_once().plan
        ms["cpu_reference"] = (time.perf_counter() - t) * 1e3
        if claim_rows != sorted(_node_rows(cpu_plan)) or cpu_plan.unschedulable:
            import collections
            raise AssertionError(
                f"tools cli: {len(claim_rows)} claims in the server differ "
                f"from the CPU plan's {len(cpu_plan.new_nodes)} nodes under "
                f"the admitted pools {[p.name for p in admitted]}: "
                f"{collections.Counter(r[:4] + (len(r[4]),) for r in claim_rows)}"
                f" against {collections.Counter(r[:4] + (len(r[4]),) for r in _node_rows(cpu_plan))}")
        rc, so, se = _kpctl(base, "top", "--once")
        solver_row = next((ln for ln in so.splitlines()
                           if ln.startswith("SOLVER")), "")
        if rc != 0 or f"device cuda:0 ({card})" not in solver_row:
            raise AssertionError(f"tools kpctl top: rc {rc}, SOLVER row "
                                 f"{solver_row!r}\n{se}")
        name = pods[0].name
        rc, so, se = _kpctl(base, "explain", "pod", name)
        if rc != 0 or "Outcome: scheduled" not in so:
            raise AssertionError(f"tools kpctl explain pod {name}: rc {rc}\n"
                                 f"{so}\n{se}")
        explain = so.strip().splitlines()
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
        try:
            child.wait(API_CLI_STOP_SECONDS)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    tail = open(log_path).read().strip().splitlines()
    res = json.loads(tail[-1]) if tail and tail[-1].startswith("{") else None
    if child.returncode != 0 or res is None:
        raise AssertionError(f"tools cli: the child exited {child.returncode}"
                             f"\n{chr(10).join(tail[-30:])}")
    solving = [p for p in res["tools_cli"]["passes"] if p["pending"]]
    if not solving or any(p["launches"] < 1 for p in solving):
        raise AssertionError(f"tools cli: passes with pending pods and their "
                             f"launches {solving}")
    launches["cli_kpctl"] = res["tools_cli"]["launches"]
    out["cli"] = {"pods": len(pods), "claims": len(claim_rows),
                  "passes_with_pending": solving,
                  "launches": launches["cli_kpctl"], "wall_ms": ms,
                  "solver_row": solver_row, "explain": explain[:3]}
    print(f"tools cli: {len(pods)} pods applied with kpctl, bound on "
          f"{len(claim_rows)} claims == the CPU plan under the admitted pools "
          f"{[p.name for p in admitted]}, node by node; passes with pending "
          f"pods (pending, launches): "
          f"{[(p['pending'], p['launches']) for p in solving]}; "
          f"{launches['cli_kpctl']} launches in the child; wall ms {ms}",
          flush=True)
    print(f"tools kpctl top: {solver_row}", flush=True)
    print(f"tools kpctl explain pod {name}: {' | '.join(explain[:2])}",
          flush=True)

    # (c) the soak on the card
    soak_out = os.path.join(tmp, "SOAK_gpu_timeseries.json.gz")
    weather_out = os.path.join(tmp, "WEATHER_gpu_squall.json.gz")
    t = time.perf_counter()
    soak = subprocess.run(
        [sys.executable, "-m", "karpenter_provider_aws_tpu_torch.tools.soak",
         *TOOLS_SOAK_ARGS, "--out", soak_out, "--weather-out", weather_out],
        cwd=tmp, capture_output=True, text=True, timeout=TOOLS_SOAK_SECONDS,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [HERE] + [x for x in [os.environ.get("PYTHONPATH")] if x])})
    soak_s = time.perf_counter() - t
    lines = soak.stdout.splitlines()
    gates_line = [ln for ln in lines if ln.startswith("soak: failed gates ")]
    if not gates_line or not os.path.exists(weather_out):
        raise AssertionError(f"tools soak: rc {soak.returncode}, no verdict\n"
                             f"{soak.stdout[-3000:]}\n{soak.stderr[-3000:]}")
    failed = json.loads(gates_line[-1][len("soak: failed gates "):])
    with gzip.open(weather_out, "rt") as f:
        wdoc = json.load(f)
    rec = wdoc["soak"]
    checks = {
        "pending pods": rec["pending"] == 0,
        "leaked instances": rec["leaked"] == 0,
        "orphaned leases": rec["orphan_leases"] == 0,
        "cost burn <= 1.0": wdoc["slo"]["cost_burn"] <= 1.0,
        "ladder engaged": bool(wdoc["degraded_counts"]),
        "timeline == replay": bool(wdoc["replay_match"]),
        "on the card": rec["device"].startswith("cuda"),
        "kernel launched": rec["kernel_launches"] >= 1,
    }
    latency = [g for g in failed if g.startswith(SOAK_LATENCY_GATES)]
    other = [g for g in failed if g not in latency]
    print(f"tools soak: exit code {soak.returncode} after {soak_s:.1f} s; "
          f"{rec['pods_churned']} pods churned; latency burn "
          f"{wdoc['slo']['latency_burn']} (p50 "
          f"{wdoc['slo'].get('latency_p50_ms')} ms), cost burn "
          f"{wdoc['slo']['cost_burn']}; degraded {wdoc['degraded_counts']}; "
          f"checks {checks}", flush=True)
    print(f"tools soak: latency gates failed {latency}; other gates failed "
          f"{other}", flush=True)
    if not all(checks.values()) or other \
            or (soak.returncode != 0 and not latency) \
            or (soak.returncode == 0 and failed):
        raise AssertionError(f"tools soak: rc {soak.returncode}, checks "
                             f"{checks}, failed gates {failed}\n"
                             f"{soak.stdout[-3000:]}\n{soak.stderr[-2000:]}")
    # the soak process's own count of kernel launches
    launches["soak"] = rec["kernel_launches"]
    if launches["soak"] < 1:
        raise AssertionError("tools soak: the kernel never launched")
    out["soak"] = {"exit_code": soak.returncode, "seconds": soak_s,
                   "launches": launches["soak"],
                   "pods_churned": rec["pods_churned"], "slo": wdoc["slo"],
                   "degraded_counts": wdoc["degraded_counts"],
                   "checks": checks, "latency_gates_failed": latency}
    return out, launches


def _run_group(cmd, timeout):
    """``cmd`` from the checkout in a process group of its own, the whole
    group killed at ``timeout`` or when it ends (a gate's children too);
    (exit code or None when killed, stdout, stderr, seconds)."""
    import signal
    import subprocess
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    if rc is None:
        out, err = proc.communicate()
    return rc, out, err, time.perf_counter() - t


def _ci_gates():
    """Phase 21: the port's CI. The drift and lint checks once, then each
    CI gate (``python -m karpenter_provider_aws_tpu_torch.tools.smoke_<name>
    --device cuda``) as a child process, ``CI_GATES_AT_ONCE`` at a time,
    each killed at ``CI_SECONDS``. Returns the phase's record and the
    kernel launches of each gate's processes."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from karpenter_provider_aws_tpu_torch.tools.gate import GATES
    mod = "karpenter_provider_aws_tpu_torch.tools"
    out = {"checks": {}, "gates": {}}
    for name, args in (("drift crds", (f"{mod}.gen_crds", "--check")),
                       ("drift docs", (f"{mod}.gen_docs", "--check")),
                       ("lint", (f"{mod}.lint.run", "--check"))):
        rc, so, se, secs = _run_group([sys.executable, "-m", *args],
                                      CI_SECONDS)
        last = (so.strip().splitlines() or [""])[-1]
        print(f"ci {name}: exit code {rc} in {secs:.1f} s: {last}",
              flush=True)
        if rc != 0:
            raise AssertionError(f"ci {name}: exit code {rc}\n"
                                 f"{so[-3000:]}\n{se[-3000:]}")
        out["checks"][name] = {"seconds": secs, "last_line": last}

    def gate(name):
        return name, _run_group(
            [sys.executable, "-m", f"{mod}.smoke_{name}", "--device", "cuda"],
            CI_SECONDS)

    launches, failed = {}, []
    with ThreadPoolExecutor(CI_GATES_AT_ONCE) as ex:
        for name, (rc, so, se, secs) in ex.map(gate, GATES):
            lines = so.strip().splitlines()
            summary = lines[-1] if lines else ""
            try:
                dev = json.loads(lines[-2])
            except (IndexError, ValueError):
                dev = {}
            ok = (rc == 0 and dev.get("gate") == name
                  and str(dev.get("device", "")).startswith("cuda:0")
                  and re.search(r"smoke(: |_\w+: )OK \(", summary)
                  and (dev.get("kernel_launches", 0) >= 1
                       or not dev.get("solved", True)))
            print(f"ci gate {name}: exit code {rc} in {secs:.1f} s; "
                  f"{dev}; {summary}", flush=True)
            if not ok:
                failed.append(name)
                print(f"ci gate {name} output tail:\n"
                      + "\n".join((so + se).splitlines()[-30:]),
                      flush=True)
            launches[name] = dev.get("kernel_launches", 0)
            out["gates"][name] = {"exit_code": rc, "seconds": secs,
                                  "device": dev.get("device"),
                                  "solved": dev.get("solved"),
                                  "launches": launches[name],
                                  "summary": summary}
    if failed:
        raise AssertionError(f"ci gates failed on the card: {failed}")
    return out, launches


def _device_lost():
    """Phase 19: the sticky-error child (``_child_device_lost``)."""
    from karpenter_provider_aws_tpu_torch import cli
    rc, res, tail = _child_result("--device-lost")
    print(f"device lost: child exit code {rc}; {res}", flush=True)
    if res is None:
        raise AssertionError(f"device lost: the child printed no result "
                             f"(rc {rc})\n{tail}")
    res["child_exit_code"] = rc
    if res["context_recovered"]:
        # the context came back: the loop must have gone on planning
        if rc != 0 or res["device_lost"] is not None:
            raise AssertionError(f"device lost: recovered, yet {res}")
    elif rc != cli.EXIT_DEVICE_LOST or res["passes_after_error"] != 0 \
            or res["device_lost"] is None or res["fired"] != 1:
        raise AssertionError(f"device lost: the process did not end after "
                             f"the sticky error: rc {rc}, {res}\n{tail}")
    return res


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return _fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this smoke needs a card")
    try:
        import karpenter_provider_aws_tpu_torch as port
    except ImportError as e:
        return _fail(f"the port package is not next to chip_smoke.py: {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        return _fail(f"imported the port from {port.__file__}, not from {HERE}")
    if len(sys.argv) > 1:
        if sys.argv[1] not in _CHILD_MODES:
            return _fail(f"unknown mode {sys.argv[1]!r}")
        if sys.argv[1] == "--device-lost":
            return _child_device_lost(torch)
        if sys.argv[1] == "--tools-cli":
            return _child_tools_cli(sys.argv[2:])
        if sys.argv[1] == "--cache-first-solve":
            return _child_cache_first_solve(torch)
        if sys.argv[1] == "--lost-rank":
            return _child_lost_rank(torch)
        return _child_first_solve(torch, sys.argv[1])
    try:
        return _run(torch)
    except Exception:
        traceback.print_exc()
        return _fail("a phase failed (traceback above)")


def _run(torch) -> int:
    from karpenter_provider_aws_tpu_torch import workloads
    from karpenter_provider_aws_tpu_torch import measure
    from karpenter_provider_aws_tpu_torch.ops import cuda_build, offering_cases
    from karpenter_provider_aws_tpu_torch.ops import offering_argmin as oa
    from karpenter_provider_aws_tpu_torch.solver import Solver
    from karpenter_provider_aws_tpu_torch.solver.problem import build_problem

    _track_solvers(Solver)

    # ---- 1. card
    _phase("card")
    print(f"nvidia-smi: {measure.card_line()}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda")

    # ---- 2. build
    _phase("build")
    t = time.perf_counter()
    path = cuda_build.build("offering_argmin")
    build_s = time.perf_counter() - t
    print(f"built offering_argmin -> {os.path.relpath(path, HERE)}")
    for line in cuda_build.BUILD_LOGS.get("offering_argmin", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    print(f"build seconds: {build_s:.3f}", flush=True)

    # ---- 3. kernels against their plain versions
    _phase("kernels")
    max_err = 0.0
    for name, tm, zc, pr in _kernel_cases(dev):
        err = measure.check_exact(name, oa.cheapest_offering(tm, zc, pr),
                             oa.cheapest_offering_ref(tm, zc, pr))
        max_err = max(max_err, err)
        print(f"cheapest_offering {name}: B={tm.shape[0]} T={tm.shape[1]} "
              f"ZC={zc.shape[1]} exact match", flush=True)

    # ---- 4. main path at full width, sequential and pipelined
    _phase("main path: cfg5 (50k pods x real catalog), sequential and pipelined")
    lattice = workloads.real_lattice()
    pods, pools, existing = workloads.config5_full_scale()
    print(f"lattice T={lattice.T} Z={lattice.Z} C={lattice.C}; "
          f"{len(pods)} pods, {len(pools)} pools", flush=True)
    problem = build_problem(pods, pools, lattice, existing=existing)
    t = time.perf_counter()
    oracle = _referee(problem)
    print(f"ffd referee: {oracle.num_new_nodes} nodes, "
          f"${oracle.new_node_cost:.2f}/hr ({time.perf_counter() - t:.1f} s)",
          flush=True)
    t = time.perf_counter()
    cpu_plan = Solver(lattice, device="cpu").solve_relaxed(
        pods, pools, existing=existing)
    print(f"cpu plan: {len(cpu_plan.new_nodes)} nodes "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    launches = {}
    solvers = {}
    for path, pipelined in (("cfg5_sequential", False), ("cfg5_pipelined", True)):
        solver = Solver(lattice) if pipelined else Solver(lattice, pipeline=False)
        if solver.device.type != "cuda" or solver.pipeline is not pipelined:
            raise AssertionError(f"{path}: Solver on {solver.device}, "
                                 f"pipeline={solver.pipeline}")
        oa.LAUNCHES = 0
        t = time.perf_counter()
        plan = solver.solve_relaxed(pods, pools, existing=existing)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
        launches[path] = oa.LAUNCHES
        print(f"{path}: kernel launches in one solve: {launches[path]}")
        if launches[path] <= 0:
            raise AssertionError(f"{path}: the kernel never launched")
        placed = sum(len(n.pods) for n in plan.new_nodes) + sum(
            len(v) for v in plan.existing_assignments.values())
        ratio = plan.new_node_cost / oracle.new_node_cost
        print(f"{path}: {len(plan.new_nodes)} nodes, ${plan.new_node_cost:.2f}/hr, "
              f"{placed} pods placed, {len(plan.unschedulable)} unschedulable, "
              f"cost ratio to the oracle {ratio:.6f}, pipelined={plan.pipelined}, "
              f"cold solve {cold_s * 1e3:.1f} ms", flush=True)
        if plan.unschedulable or placed != len(pods) or len(pods) != 50000:
            raise AssertionError(f"{path}: placed {placed}/{len(pods)}, "
                                 f"{len(plan.unschedulable)} unschedulable")
        if not ratio <= 1.02:
            raise AssertionError(f"{path}: cost ratio {ratio} above 1.02")
        if plan.pipelined is not pipelined:
            raise AssertionError(f"{path}: plan.pipelined={plan.pipelined}")
        if _node_rows(plan) != _node_rows(cpu_plan) \
                or plan.existing_assignments != cpu_plan.existing_assignments:
            raise AssertionError(f"{path}: the card's plan differs from the CPU plan")
        print(f"{path}: card plan == cpu plan, node by node", flush=True)
        solvers[path] = solver

    # e2e of both paths in turns (sequential, pipelined, then pipelined,
    # sequential, ...), so that the host's drift falls on both alike
    e2e = {path: [] for path in solvers}
    stages = {path: {} for path in solvers}
    for i in range(SOLVES):
        for path in (list(solvers) if i % 2 == 0 else list(solvers)[::-1]):
            t = time.perf_counter()
            p = solvers[path].solve_relaxed(pods, pools, existing=existing)
            torch.cuda.synchronize()
            e2e[path].append((time.perf_counter() - t) * 1e3)
            for k, v in p.stage_ms.items():
                stages[path].setdefault(k, []).append(v)
            if _node_rows(p) != _node_rows(cpu_plan):
                raise AssertionError(f"{path}: a repeated solve changed the plan")
    cfg5 = {}
    for path, ms in e2e.items():
        cfg5[path] = {"e2e_p50_ms": statistics.median(ms), "e2e_ms": ms,
                      "stage_p50_ms": {k: statistics.median(v)
                                       for k, v in stages[path].items()}}
        print(f"{path}: e2e p50 {statistics.median(ms):.3f} ms over {SOLVES} "
              f"solves (min {min(ms):.3f}, max {max(ms):.3f}); stage p50 ms "
              f"{ {k: round(v, 3) for k, v in cfg5[path]['stage_p50_ms'].items()} }",
              flush=True)
    wins = sum(a < b for a, b in zip(e2e["cfg5_pipelined"], e2e["cfg5_sequential"]))
    print(f"pipelined faster than sequential in {wins} of {SOLVES} turns; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
          flush=True)
    print("(pipelined stages: compute is the host's issue time, download "
          "holds the wait for the card)", flush=True)
    _check_solvers(torch, "main path")

    # ---- 5. steady state
    _phase(f"steady state: cfg10 (20k pods, 120 nodes, "
           f"{workloads.STEADY_PASSES} passes)")
    steady, steady_problem = _steady_state(torch, workloads, lattice, oa)
    launches["cfg10_steady_state"] = sum(steady["launches_per_pass"])
    _check_solvers(torch, "steady state")

    # ---- 6. the provisioning controller
    _phase("provisioner: the cfg5 wave and cfg10 through provision_once")
    prov, prov_launches = _provisioner(torch, workloads, lattice, oa, cpu_plan)
    launches.update(prov_launches)
    max_err = max(max_err, prov["max_abs_err"])
    _check_solvers(torch, "provisioner")

    # ---- 7. consolidation: cfg4's fleet
    _phase("consolidation: cfg4 (500 under-utilized nodes x real catalog)")
    consol, launches["cfg4_consolidation"], consol_per_pass, probe_inputs = \
        _consolidation(torch, workloads, lattice, oa)
    max_err = max(max_err, consol["max_abs_err"])
    _check_solvers(torch, "consolidation")

    # ---- 8. the Operator in direct mode: cfg4's fleet and the cfg5 wave
    _phase("operator: cfg4's fleet and the cfg5 wave through Operator.run_once")
    operator, op_launches = _operator(torch, workloads, lattice, oa, cpu_plan,
                                      consol)
    launches.update(op_launches)
    _check_solvers(torch, "operator")

    # ---- 9. the wave split: cfg7 on the card, and a cut card against CPU
    _phase("wave split: cfg7 (4,608 distinct signatures x real catalog)")
    oa.LAUNCHES = 0
    wave, wave_launches, cfg7_inputs = _wave_split(torch, workloads, lattice, oa)
    launches.update(wave_launches)
    max_err = max(max_err, wave["max_abs_err"])
    _check_solvers(torch, "wave split")

    # ---- 10. the degradation ladder, each rung forced by a FaultInjector
    _phase("ladder: injected faults on cfg10's problem and steady passes")
    ladder = _ladder(torch, workloads, lattice, oa)
    _check_solvers(torch, "ladder")

    # ---- 11. weather: the squall against cfg4's fleet in an Operator
    _phase("weather: the squall against cfg4's fleet through Operator.run_once")
    weather = _weather(torch, workloads, oa)
    launches["weather"] = weather["launches"]
    _check_solvers(torch, "weather")

    # ---- 12. the API stratum: the cfg5 wave in API mode, and the CLI
    _phase("api: the cfg5 wave through API mode, and the port's CLI")
    api, api_launches = _api(torch, workloads, oa)
    launches.update(api_launches)
    _check_solvers(torch, "api")

    # ---- 13. the sharded solve: 8 shards batched on the card
    _phase("mesh: cfg11 (200k pods), cfg9, delta and the Operator on 8 shards, "
           "and cfg11 one shard per card")
    mesh, mesh_launches, mesh_shard_inputs, mesh_merge_inputs, \
        rank0_inputs = _mesh(torch, workloads, lattice, oa)
    launches.update(mesh_launches)
    _check_solvers(torch, "mesh")

    # ---- 14. the remote solver: sidecars, the pool, the window, replication
    _phase("remote: the sidecar on the card, failover, the window and replication")
    remote, remote_launches, sidecar_inputs = _remote(torch, workloads, lattice, oa)
    launches.update(remote_launches)
    max_err = max(max_err, remote["max_abs_err"])
    _check_solvers(torch, "remote")

    # ---- 15. warm start: cfg5's first solve in fresh processes
    _phase("warm start: cfg5's first solve, cold and after the boot ladder")
    warm_start = _warm_start(torch, oa)
    launches["warmup_ladder"] = warm_start["warm-first-solve"]["warmup_launches"]

    # ---- 16. profiling: cfg5 solves inside a profiler session
    _phase("profiling: cfg5 solves between start_profiling and stop_profiling")
    profiling = _profiling(torch, lattice, oa, pods, pools, existing)
    launches["cfg5_profiled"] = profiling["launches"]
    _check_solvers(torch, "profiling")

    # ---- 17. the native FFD referee on cfg5
    _phase("native: the C++ FFD referee on cfg5 against the Python oracle")
    native = _native(problem)

    # ---- 18. the port's bench: its --smoke child and the cfg5 row
    _phase("bench: the bench's --smoke child and its cfg5 row with kernel parity")
    bench_phase, launches["bench_cfg5_row"] = _bench(torch, lattice, oa, cpu_plan)
    _check_solvers(torch, "bench")

    # ---- 19. a sticky device error in a child process
    _phase("device lost: a device-side assert in an Operator's pass")
    device_lost = _device_lost()

    # ---- 20. the operator's tools: the entry module, the CLI with kpctl,
    # the soak
    _phase("tools: the entry module, the CLI driven by kpctl, and the soak")
    tools, tools_launches = _tools(torch, workloads, oa)
    launches.update(tools_launches)
    _check_solvers(torch, "tools")

    # ---- 21. the port's CI: drift, lint and the twelve gates on the card
    _phase("ci gates: drift, lint and the twelve smoke gates on the card")
    ci_gates, ci_launches = _ci_gates()

    # ---- 22. kernel times: the main paths' own inputs, the dense largest
    # bucket, the launch floor
    _phase("kernel timing")
    solver = Solver(lattice)
    _, cfg5_inputs = measure.captured_main_path_inputs(
        lambda: solver.solve_relaxed(pods, pools, existing=existing))
    _, cfg10_inputs = measure.captured_main_path_inputs(
        lambda: Solver(lattice, pipeline=False).solve(steady_problem))
    timed = {}
    for name, (tm, zc, pr) in (
            ("cfg5", cfg5_inputs), ("cfg10", cfg10_inputs),
            ("cfg4_probe", probe_inputs), ("cfg7_last_wave", cfg7_inputs),
            ("cfg11_mesh_shards", mesh_shard_inputs),
            ("cfg11_mesh_merge", mesh_merge_inputs),
            ("cfg11_rank0_shards", rank0_inputs),
            ("sidecar_cfg2", sidecar_inputs),
            ("dense", measure.on_device(offering_cases.dense_case(), dev))):
        max_err = max(max_err, measure.check_exact(
            f"{name} inputs", oa.cheapest_offering(tm, zc, pr),
            oa.cheapest_offering_ref(tm, zc, pr)))
        ms, waited_k = measure.device_times_ms(lambda: oa.cheapest_offering(tm, zc, pr))
        plain_ms, waited_p = measure.device_times_ms(
            lambda: oa.cheapest_offering_ref(tm, zc, pr))
        bound_ms, bound_by, nbytes, n_ops = measure.bound(tm, zc, pr)
        B, T = tm.shape
        ZC = zc.shape[1]
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "shape": {"B": B, "T": T, "ZC": ZC}}
        print(f"cheapest_offering, {name} B={B} T={T} ZC={ZC}: kernel {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms (median of 100 device times; host waited "
              f"{waited_k * 1e3:.1f} / {waited_p * 1e3:.1f} ms after enqueue); "
              f"bound {bound_ms * 1e3:.4f} us by {bound_by} ({nbytes} bytes, "
              f"{n_ops} compares)", flush=True)
    floor_ms = measure.launch_floor_ms(dev)
    print(f"launch floor (one-element in-place add): {floor_ms:.6f} ms", flush=True)
    _check_solvers(torch, "kernel timing")

    # ---- nothing of JAX was loaded
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "karpenter_provider_aws_tpu"
                    or m.startswith("karpenter_provider_aws_tpu."))
    if leaked:
        raise AssertionError(f"modules of JAX or the JAX package loaded: {leaked[:5]}")

    _phase("")
    total_s = time.perf_counter() - T0
    print(f"total seconds of the script: {total_s:.1f}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "cheapest_offering", "route": "cuda",
        "source": "karpenter_provider_aws_tpu_torch/csrc/offering_argmin.cu",
        "replaces": "karpenter_provider_aws_tpu/ops/offering_argmin.py:92",
        "launches": launches["provisioner_cfg5"], "max_abs_err": max_err,
        **timed["cfg5"], "library_ms": None,
        "launches_by_path": launches, "launch_floor_ms": floor_ms,
        "cfg10": {**timed["cfg10"], "launches": launches["cfg10_steady_state"],
                  "launches_per_pass": steady["launches_per_pass"]},
        "cfg4_probe": {**timed["cfg4_probe"],
                       "launches": launches["cfg4_consolidation"],
                       "launches_per_pass": consol_per_pass,
                       "launches_per_probe_dispatch": 1},
        "cfg7_last_wave": {**timed["cfg7_last_wave"],
                           "launches": launches["cfg7_per_solve"],
                           "launches_per_solve": launches["cfg7_per_solve"],
                           "wave_B": wave["wave_B"]},
        "cfg11_mesh_shards": {**timed["cfg11_mesh_shards"], "library_ms": None,
                              "launches": launches["cfg11_mesh_shards"],
                              "launches_per_solve": launches["cfg11_mesh_shards"],
                              "shard_B": mesh["cfg11"]["shard_B"]},
        "cfg11_mesh_merge": {**timed["cfg11_mesh_merge"], "library_ms": None,
                             "launches": launches["cfg11_mesh_merge"],
                             "launches_per_solve": launches["cfg11_mesh_merge"]},
        "cfg11_rank0_shards": {**timed["cfg11_rank0_shards"], "library_ms": None,
                               "launches": launches["cfg11_ranks"],
                               "launches_per_rank":
                                   launches["cfg11_ranks_per_rank"],
                               "ranks": mesh["cfg11_ranks"]["ranks"]},
        "cfg10_delta_on_mesh": {"launches": launches["cfg10_delta_on_mesh"]},
        "sidecar_cfg2": {**timed["sidecar_cfg2"], "library_ms": None,
                         "launches": launches["sidecar_cfg2"],
                         "launches_per_rpc": launches["sidecar_cfg2"]},
        "pool_local_cfg3": {"launches": launches["pool_local_cfg3"]},
        "warmup_ladder": {
            "launches": launches["warmup_ladder"],
            "launches_per_bucket": launches["warmup_ladder"] / max(
                warm_start["warm-first-solve"]["warmup_buckets"], 1)},
        "cfg5_profiled": {"launches": launches["cfg5_profiled"],
                          "launches_per_solve": profiling["launches_per_solve"]},
        "bench_cfg5_row": {"launches": launches["bench_cfg5_row"],
                           "launches_per_solve": bench_phase["row_launches"]
                           / bench_phase["solves"],
                           "solves": bench_phase["solves"],
                           "parity_check_launches":
                               bench_phase["parity_launches"]},
        "entry": {"launches": launches["entry"],
                  "dryrun_multichip_launches":
                      launches["entry_dryrun_multichip"]},
        "cli_kpctl": {"launches": launches["cli_kpctl"],
                      "passes_with_pending": tools["cli"]["passes_with_pending"]},
        "soak": {"launches": launches["soak"]},
        "ci_gates": {"launches": sum(ci_launches.values()),
                     "launches_by_gate": ci_launches},
        "dense": timed["dense"],
    }], "cfg5": cfg5, "cfg10": {k: v for k, v in steady.items()
                                if k != "launches_per_pass"},
        "consolidation": consol, "operator": operator,
        "wave_split": wave, "ladder": ladder, "weather": weather, "api": api,
        "mesh": mesh, "remote": {k: v for k, v in remote.items()
                                 if k != "max_abs_err"},
        "warm_start": warm_start, "profiling": profiling, "native": native,
        "bench": bench_phase,
        "device_lost": device_lost, "tools": tools, "ci_gates": ci_gates,
        "provisioner": {"cfg5_wave": prov["cfg5_wave"],
                        "cfg10_first_wave": prov["cfg10_first_wave"],
                        "cfg10": {k: v for k, v in prov["cfg10"].items()
                                  if k != "rows"}},
        "phase_seconds": _PHASE["seconds"], "total_seconds": total_s}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
