"""The structured unschedulable-reason taxonomy.

The reference answers "why is this pod pending" with `FailedScheduling`
events and nodeclaim status conditions; until this module the repo
answered it with free-text strings — `solver/oracle.py` emitted ONE
generic "does not fit any existing node or new-node shape" for three
distinct causes, and nothing machine-readable survived to the metric or
event surface. Every unschedulable reason is now a bounded enum CODE
plus a human detail, carried as ``"<code>: <detail>"`` on
``NodePlan.unschedulable`` (and therefore across the sidecar wire's
``unschedulable`` map unchanged), on `FailedScheduling` events, and as
the ``code`` label of ``karpenter_pods_unschedulable_reasons_total``.

Codes are DECLARED here and nowhere else: the graftlint ``reason-code``
rule (tools/lint/rules.py ReasonRule) fails any ``reason(...)`` call or
``code=`` label literal not in :data:`CODES` — the same
declaration-lockstep discipline the metrics rule enforces for series
names. Add a code by adding a constant; the lint, the docs table
(docs/reference/explain.md), and every consumer stay in step.
"""

from __future__ import annotations

# ---- the bounded code set -------------------------------------------------

# pre-solve: the pod's requests name a resource axis the lattice does
# not model; no amount of capacity helps
UNKNOWN_RESOURCE = "unknown-resource"
# problem build: no (nodepool, instance-type, zone, capacity-type)
# offering is compatible with the pod's requirements at all
NO_OFFERING = "no-offering"
# problem build: every compatible offering exists in the catalog but is
# currently held out of the market (ICE / unavailable mask) — weather-
# caused pending, distinct from genuine infeasibility
ICE_HOLD = "ice-hold"
# problem build: zone anti-affinity demands more zones than are eligible
ZONE_ANTI_AFFINITY = "zone-anti-affinity"
# pack: the pod fits neither existing capacity nor any new-node shape
# (the device decode's generic leftover; the host-FFD rung refines it)
NO_FIT = "no-fit"
# host FFD: only existing capacity could host this pod (no compatible
# pool can open a node for it) and none of it fits
NO_EXISTING_FIT = "no-existing-fit"
# host FFD: compatible pools exist but no empty node of any feasible
# type can hold the pod (+ daemonset overhead)
NO_NEW_NODE_SHAPE = "no-new-node-shape"
# host FFD: hostname self-affinity pinned the group to one bin and that
# bin is full
SINGLE_BIN_FULL = "single-bin-full"
# host FFD: a hostname-affinity presence requirement no bin satisfies
# and the group cannot self-seed
AFFINITY_PRESENCE = "affinity-presence"
# provisioning: the plan's node was dropped by NodePool spec.limits and
# no fallback pool could take the pods
POOL_LIMITS = "pool-limits"
# provisioning: the solve itself failed; the whole batch stays pending
# for the next pass (partial-result guard)
SOLVE_ERROR = "solve-error"
# control-plane degradation provenance (parallel/pool.py SolverPool;
# docs/reference/solver-pool.md): these ride NodePlan.degraded_reason
# (and the karpenter_solver_degraded_total reason label), never a pod's
# unschedulable reason — the pool's job is that pods still place.
# sidecar RPC missed its solve deadline: the endpoint accepted the
# connection and stalled (a hung process, the failure mode a flat
# connect error never surfaces); its breaker opens immediately
SIDECAR_HUNG = "sidecar-hung"
# sidecar RPC failed any other way: connection refused/reset, or the
# endpoint answered with something that is not a NodePlan (junk body,
# connection died mid-response)
SIDECAR_UNREACHABLE = "sidecar-unreachable"
# every pool endpoint's breaker is open: the pass ran on the LOCAL
# solver — the final ladder rung below the whole sidecar fleet
POOL_EXHAUSTED = "pool-exhausted"
# operator-handoff provenance (state/replication.py +
# operator/leaderelection.py; docs/reference/handoff.md): these ride the
# standby's cutover ladder and the writer's fencing gate, never a pod's
# unschedulable reason.
# the standby's journal anchor fell out of the leader's dirty-journal
# window (or is from another life of the mirror): the delta stream
# cannot answer and the standby re-snapshots / the promoted operator
# full-rebuilds — the same always-correct fallback the delta solve path
# takes on a coalescer miss
STALE_ANCHOR = "stale-anchor"
# the leader streams a snapshot format this standby does not speak:
# refuse to apply it (a half-understood snapshot is worse than a cold
# start) and keep rebuilding from scratch
SNAPSHOT_VERSION_MISMATCH = "snapshot-version-mismatch"
# a side-effectful write was attempted under a fencing token the lease
# store no longer carries: a demoted (zombie) leader's in-flight
# eviction/claim write, rejected instead of raced
FENCED_WRITE_REJECTED = "fenced-write-rejected"
# consolidation provenance (solver/consolidate.py ConsolidationEngine;
# docs/reference/consolidation.md): these answer "why was this node NOT
# consolidated" — they ride the per-node explain ledger
# (`kpctl explain node`) and the karpenter_disruption_consolidation_
# skips_total code label, never a pod's unschedulable reason.
# a PodDisruptionBudget leaves zero eviction headroom for a pod on the
# node: the node cannot drain (reference Unconsolidatable event)
NOT_CONSOLIDATABLE_PDB = "not-consolidatable-pdb"
# the NodePool's disruption budget window currently allows zero (or too
# few) voluntary disruptions: the decision is deferred, not rejected
NOT_CONSOLIDATABLE_BUDGET = "not-consolidatable-budget"
# the what-if repack found no plan that saves money — or the device
# plan lost to the host FFD referee's costing of the same what-if by
# more than the ≤2% envelope (the savings referee rule)
CONSOLIDATION_NO_SAVINGS = "consolidation-no-savings"
# the weather advisory holds voluntary consolidation: an active storm
# or spot-crash regime window — consolidating INTO distressed capacity
# trades a standing node for one about to be reclaimed or repriced
CONSOLIDATION_WEATHER_HOLD = "consolidation-weather-hold"
# spot-to-spot replacement consolidation gated off: the feature flag is
# disabled, or the replacement lacks the minimum instance-type
# flexibility the reference demands (SpotToSpotConsolidation)
CONSOLIDATION_SPOT_GUARD = "consolidation-spot-guard"

CODES = frozenset({
    UNKNOWN_RESOURCE, NO_OFFERING, ICE_HOLD, ZONE_ANTI_AFFINITY,
    NO_FIT, NO_EXISTING_FIT, NO_NEW_NODE_SHAPE, SINGLE_BIN_FULL,
    AFFINITY_PRESENCE, POOL_LIMITS, SOLVE_ERROR,
    SIDECAR_HUNG, SIDECAR_UNREACHABLE, POOL_EXHAUSTED,
    STALE_ANCHOR, SNAPSHOT_VERSION_MISMATCH, FENCED_WRITE_REJECTED,
    NOT_CONSOLIDATABLE_PDB, NOT_CONSOLIDATABLE_BUDGET,
    CONSOLIDATION_NO_SAVINGS, CONSOLIDATION_WEATHER_HOLD,
    CONSOLIDATION_SPOT_GUARD,
})

# the parse-failure sentinel for strings minted before the taxonomy (or
# by an older sidecar across the wire) — NOT a member of CODES, so the
# lint can never accept it as a declared literal
UNCODED = "uncoded"


def reason(code: str, detail: str = "") -> str:
    """Render a coded unschedulable reason: ``"<code>: <detail>"`` (or
    the bare code with no detail). The inverse of :func:`code_of`."""
    assert code in CODES, f"undeclared reason code {code!r}"
    return f"{code}: {detail}" if detail else code


def code_of(reason_str: str) -> str:
    """The taxonomy code of a reason string; :data:`UNCODED` for
    free-text strings minted before the taxonomy (an old sidecar across
    the wire must not crash the metric/event path)."""
    head = reason_str.split(":", 1)[0].strip()
    return head if head in CODES else UNCODED


def detail_of(reason_str: str) -> str:
    """The human detail of a coded reason ("" when none)."""
    if code_of(reason_str) == UNCODED:
        return reason_str
    parts = reason_str.split(":", 1)
    return parts[1].strip() if len(parts) > 1 else ""
