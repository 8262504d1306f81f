"""Decision explainability: constraint-elimination ledgers + audit ring.

The observability stack answers *how fast* (traces, stage timings, SLO
burn) and *how contended* (profiler, lock-order witness); this module
answers *why this decision* — the question the reference's
`FailedScheduling` events and nodeclaim status conditions exist for.

During problem build, every signature group gets a **candidate-
elimination ledger**: how many (and which, top-k) instance-type × zone ×
capacity-type offerings each constraint stage removed —

    offered → resource-fit → requirements → pools → ice → narrowing

— computed per GROUP, so the cost is O(G × stages) dot products over the
[T] axis (the per-(zone,captype)-pattern offering counts are memoized),
never O(pods × 759). After the solve, the provisioning controller folds
the plan's outcome on top (placed/unplaced per group, the chosen
offering + runner-up + price delta per created claim, unschedulable
reason codes from solver/taxonomy.py) into a :class:`PassExplanation`,
and a bounded :class:`DecisionAuditRing` keyed by pass/trace id serves
it everywhere the existing stack taught us to look: the ``explain``
introspection provider, ``/debug/explain`` on both HTTP servers, and
``kpctl explain pod|nodeclaim|pass``.

Ledgers survive the delta path: `IncrementalProblemBuilder` patches a
retained group's ledger copy-on-write (`GroupLedger.with_count`) — the
stage counts are count-independent and `recheck_narrow` already proved
the one count-dependent decision (price narrowing) unchanged, so a
delta-built pass explains identically to a full rebuild
(tests/test_explain.py parity test).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import taxonomy

# ledger stage names, waterfall order (docs/reference/explain.md)
STAGE_OFFERED = "offered"
STAGE_RESOURCES = "resource-fit"
STAGE_REQUIREMENTS = "requirements"
STAGE_POOLS = "pools"
STAGE_ICE = "ice"
STAGE_NARROWING = "narrowing"
STAGES = (STAGE_OFFERED, STAGE_RESOURCES, STAGE_REQUIREMENTS,
          STAGE_POOLS, STAGE_ICE, STAGE_NARROWING)

_MAX_EXAMPLES = 3


@dataclass(frozen=True)
class StageRow:
    """One waterfall row: offerings remaining after this stage, how many
    the stage removed, and up to top-k concrete eliminated offerings."""

    stage: str
    remaining: int
    eliminated: int
    examples: Tuple[str, ...] = ()

    def to_doc(self) -> dict:
        d = {"stage": self.stage, "remaining": self.remaining,
             "eliminated": self.eliminated}
        if self.examples:
            d["examples"] = list(self.examples)
        return d


@dataclass(frozen=True)
class GroupLedger:
    """Per-signature-group elimination record. Count-independent except
    the ``pods`` field — exactly what lets the incremental builder patch
    a retained group's ledger with :meth:`with_count` instead of
    recomputing (the narrowing stage's count-dependence is guarded by
    recheck_narrow, which forces a full rebuild on any flip)."""

    label: str                     # human request label ("cpu=500m ...")
    signature: str                 # the group's interned signature repr
    pods: int
    stages: Tuple[StageRow, ...]
    pools_ok: int = 0              # compatible NodePools
    pools_total: int = 0
    notes: Tuple[str, ...] = ()    # affinity/topology-class constraints

    @property
    def remaining(self) -> int:
        return self.stages[-1].remaining if self.stages else 0

    def blame(self) -> str:
        """The stage that first took the group to zero offerings, or ""
        while offerings remain."""
        if self.remaining > 0:
            return ""
        prev = None
        for row in self.stages:
            if row.remaining == 0 and (prev is None or prev.remaining > 0):
                return row.stage
            prev = row
        return self.stages[0].stage if self.stages else ""

    def blame_code(self) -> str:
        """Refine a zero-offering group into a taxonomy code: an ICE-
        zeroed group is weather-caused pending (ice-hold), anything else
        is genuinely incompatible (no-offering)."""
        b = self.blame()
        if not b:
            return ""
        return taxonomy.ICE_HOLD if b == STAGE_ICE else taxonomy.NO_OFFERING

    def with_count(self, pods: int) -> "GroupLedger":
        """Copy-on-write count patch for the incremental build path."""
        return self if pods == self.pods else replace(self, pods=pods)

    def to_doc(self) -> dict:
        return {
            "label": self.label, "pods": self.pods,
            "poolsOk": self.pools_ok, "poolsTotal": self.pools_total,
            "remaining": self.remaining, "blame": self.blame(),
            "stages": [s.to_doc() for s in self.stages],
            **({"notes": list(self.notes)} if self.notes else {}),
        }


def request_label(vec: np.ndarray) -> str:
    """A human label for a group's request vector ("cpu=500m
    memory=1024Mi"), rendered from the non-zero axes. The implicit
    one-pod occupancy every real pod carries is dropped — it is not a
    user request."""
    from ..apis.resources import vec_to_quantities
    q = vec_to_quantities(vec)
    if q.get("pods") == "1":
        del q["pods"]
    parts = [f"{k}={v}" for k, v in q.items()]
    return " ".join(parts) or "(no requests)"


class LedgerCapture:
    """Per-build elimination accounting. One instance per build_problem
    call; the per-(availability, zone-mask, captype-mask) PATTERN type
    counts are memoized, so each group's stage rows cost a handful of
    [T] dot products — groups stamped from the same deployment share
    every pattern."""

    def __init__(self, lattice):
        base = getattr(lattice, "base_available", None)
        self.base = base if base is not None else lattice.available
        self.masked = lattice.available
        self.lattice = lattice
        self.offered = int(self.base.sum())
        self._counts: Dict[tuple, np.ndarray] = {}
        self._gone: Optional[np.ndarray] = None   # base & ~masked, lazy
        self._ones_z = np.ones((lattice.Z,), dtype=bool)
        self._ones_c = np.ones((lattice.C,), dtype=bool)

    def _per_type(self, which: str, zm: np.ndarray,
                  cm: np.ndarray) -> np.ndarray:
        key = (which, zm.tobytes(), cm.tobytes())
        c = self._counts.get(key)
        if c is None:
            av = self.base if which == "base" else self.masked
            c = (av & zm[None, :, None]
                 & cm[None, None, :]).sum(axis=(1, 2)).astype(np.int64)
            self._counts[key] = c
        return c

    def count(self, which: str, tm: np.ndarray, zm: np.ndarray,
              cm: np.ndarray) -> int:
        return int(self._per_type(which, zm, cm) @ tm)

    def _examples(self, tmask: np.ndarray, zm: np.ndarray, cm: np.ndarray,
                  gone: np.ndarray, k: int = _MAX_EXAMPLES) -> Tuple[str, ...]:
        """Up to k concrete offerings in (tmask × zm × cm) present in
        ``gone`` (a [T,Z,C] bool of eliminated cells). Early-exits at k."""
        lat = self.lattice
        out: List[str] = []
        for ti in np.nonzero(tmask)[0]:
            cells = gone[ti] & zm[:, None] & cm[None, :]
            for zi, ci in np.argwhere(cells):
                out.append(f"{lat.names[ti]}/{lat.zones[zi]}/"
                           f"{lat.capacity_types[ci]}")
                if len(out) >= k:
                    return tuple(out)
        return tuple(out)

    def ledger(self, vec: np.ndarray, fits_t: np.ndarray,
               req_tmask: np.ndarray, zm: np.ndarray, cm: np.ndarray,
               pool_tmask: np.ndarray, pool_zmask: np.ndarray,
               pool_cmask: np.ndarray, final_tmask: Optional[np.ndarray],
               signature: str, pods: int, pools_ok: int, pools_total: int,
               notes: Sequence[str] = ()) -> GroupLedger:
        """Build one group's waterfall. ``fits_t`` = types whose empty
        node holds one pod; ``req_tmask``/``zm``/``cm`` = the compiled
        requirement masks (pre-narrowing); ``pool_*`` = the union of
        compatible pools' masks; ``final_tmask`` = the narrowed type
        mask actually shipped (None when narrowing didn't engage)."""
        rows: List[StageRow] = [StageRow(STAGE_OFFERED, self.offered, 0)]

        def push(stage, remaining, examples=()):
            rows.append(StageRow(stage, remaining,
                                 max(rows[-1].remaining - remaining, 0),
                                 tuple(examples)))

        push(STAGE_RESOURCES,
             self.count("base", fits_t, self._ones_z, self._ones_c))
        tm_req = fits_t & req_tmask
        push(STAGE_REQUIREMENTS, self.count("base", tm_req, zm, cm))
        tm_pool = tm_req & pool_tmask
        zm_pool = zm & pool_zmask
        cm_pool = cm & pool_cmask
        push(STAGE_POOLS, self.count("base", tm_pool, zm_pool, cm_pool))
        r_ice = self.count("masked", tm_pool, zm_pool, cm_pool)
        ex: Tuple[str, ...] = ()
        if r_ice < rows[-1].remaining:
            if self._gone is None:
                # once per build, not per ICE-affected group (an ice-age
                # pass can touch most groups)
                self._gone = self.base & ~self.masked
            ex = self._examples(tm_pool, zm_pool, cm_pool, self._gone)
        push(STAGE_ICE, r_ice, ex)
        if final_tmask is not None:
            tm_f = tm_pool & final_tmask
            r_nar = self.count("masked", tm_f, zm_pool, cm_pool)
            gone_types = np.nonzero(tm_pool & ~tm_f)[0][:_MAX_EXAMPLES]
            push(STAGE_NARROWING, r_nar,
                 tuple(self.lattice.names[t] for t in gone_types))
        return GroupLedger(
            label=request_label(vec), signature=signature, pods=pods,
            stages=tuple(rows), pools_ok=pools_ok, pools_total=pools_total,
            notes=tuple(notes))


_UNPLACED_DETAILS = {
    taxonomy.ICE_HOLD: "all compatible offerings currently unavailable",
    taxonomy.NO_OFFERING: "no compatible nodepool/instance-type offering",
    taxonomy.NO_EXISTING_FIT:
        "only existing capacity could host this pod and none fits",
    taxonomy.NO_NEW_NODE_SHAPE:
        "no empty node of any feasible type can hold this pod",
    taxonomy.NO_FIT: "does not fit any existing node or new-node shape",
}


def unplaced_reason(group, fallback: str = taxonomy.NO_FIT) -> str:
    """The coded reason for a pod the packer could not place. The
    group's ledger refines it — a group whose offerings were zeroed by
    the ICE stage is weather-caused pending, not a shape problem — and
    ``fallback`` carries the packer's own distinction (the host-FFD rung
    knows no-existing-fit from no-new-node-shape; the device decode only
    knows no-fit)."""
    led = getattr(group, "ledger", None)
    code = (led.blame_code() if led is not None else "") or fallback
    return taxonomy.reason(code, _UNPLACED_DETAILS.get(code, ""))


# ---- pass-level explanation -----------------------------------------------

# bounds keeping one PassExplanation's footprint sane at 50k-pod scale:
# group entries keep the interesting ones (unplaced first, then largest),
# placements/unschedulable maps cap with an overflow count
MAX_GROUP_ENTRIES = 256
MAX_UNSCHEDULABLE = 4096
MAX_PLACEMENTS = 4096


@dataclass
class GroupOutcome:
    ledger: GroupLedger
    placed: int = 0
    unplaced: int = 0
    code: str = ""                  # reason code when unplaced > 0
    dropped: bool = False           # eliminated at build (never packed)

    def to_doc(self) -> dict:
        return {**self.ledger.to_doc(), "placed": self.placed,
                "unplaced": self.unplaced, "code": self.code,
                "dropped": self.dropped}


@dataclass
class PassExplanation:
    pass_id: int
    trace_id: str
    t: float
    pods: int
    groups: List[GroupOutcome] = field(default_factory=list)
    groups_total: int = 0                       # before MAX_GROUP_ENTRIES
    unschedulable: Dict[str, str] = field(default_factory=dict)  # pod->reason
    unschedulable_total: int = 0
    pod_group: Dict[str, int] = field(default_factory=dict)  # pod->groups idx
    placements: Dict[str, str] = field(default_factory=dict)  # pod->node
    placements_total: int = 0
    claims: Dict[str, dict] = field(default_factory=dict)  # claim->rationale
    eliminations: Dict[str, int] = field(default_factory=dict)  # stage->n
    reason_counts: Dict[str, int] = field(default_factory=dict)  # code->pods
    degraded_reason: str = ""
    note: str = ""

    def to_doc(self, full: bool = True) -> dict:
        d = {
            "pass": self.pass_id, "traceId": self.trace_id,
            "t": round(self.t, 3), "pods": self.pods,
            "groups": self.groups_total,
            "unschedulable": self.unschedulable_total,
            "placements": self.placements_total,
            "reasons": dict(self.reason_counts),
            "eliminations": dict(self.eliminations),
        }
        if self.degraded_reason:
            d["degradedReason"] = self.degraded_reason
        if self.note:
            d["note"] = self.note
        if full:
            d["groupDetails"] = [g.to_doc() for g in self.groups]
            d["claims"] = dict(self.claims)
        return d


def explain_pass(problem, plan, pass_id: int, trace_id: str,
                 now: float) -> PassExplanation:
    """Fold a solved plan's outcome onto the problem's ledgers. Cheap on
    the steady path: the pod→group index is only built when the pass has
    unschedulable pods, and placement maps cover THIS pass's placements
    (new binds/claims), never the whole cluster."""
    expl = PassExplanation(pass_id=pass_id, trace_id=trace_id, t=now,
                           pods=0)
    unsched = dict(plan.unschedulable) if plan is not None else {}
    expl.unschedulable_total = len(unsched)
    for name, r in unsched.items():
        code = taxonomy.code_of(r)
        expl.reason_counts[code] = expl.reason_counts.get(code, 0) + 1

    groups = list(getattr(problem, "groups", ()) or ())
    dropped = list(getattr(problem, "dropped_groups", ()) or ())
    outcomes: List[GroupOutcome] = []
    out_gi: List[int] = []      # outcome idx -> group idx (splits can
                                # SHARE a signature — never key on it)
    unplaced_by_group: Dict[int, int] = {}
    first_reason: Dict[int, str] = {}
    gi_of: Dict[str, int] = {}
    if unsched:
        # pod → group index, built ONLY when the pass has unschedulable
        # pods (the steady no-unsched path stays O(G), never O(pods))
        for gi, g in enumerate(groups + dropped):
            for n in g.pod_names:
                gi_of[n] = gi
        for n, r in unsched.items():
            gi = gi_of.get(n)
            if gi is not None:
                unplaced_by_group[gi] = unplaced_by_group.get(gi, 0) + 1
                first_reason.setdefault(gi, r)
    for gi, g in enumerate(groups + dropped):
        led = getattr(g, "ledger", None)
        if led is None:
            continue
        is_dropped = gi >= len(groups)
        n_un = (len(g.pod_names) if is_dropped
                else unplaced_by_group.get(gi, 0))
        code = ""
        if n_un:
            # the group's pods all share one signature, hence one reason
            first = first_reason.get(gi, "")
            code = taxonomy.code_of(first) if first else (
                led.blame_code() or taxonomy.NO_FIT)
        outcomes.append(GroupOutcome(
            ledger=led, placed=len(g.pod_names) - n_un, unplaced=n_un,
            code=code, dropped=is_dropped))
        out_gi.append(gi)
        expl.pods += len(g.pod_names)
        for row in led.stages:
            if row.eliminated:
                expl.eliminations[row.stage] = \
                    expl.eliminations.get(row.stage, 0) + row.eliminated
    expl.groups_total = len(outcomes)
    # keep the interesting entries: unplaced groups first, then largest
    # (ties keep build order — deterministic, and a later split never
    # shadows an earlier one)
    order = sorted(range(len(outcomes)),
                   key=lambda i: (-outcomes[i].unplaced,
                                  -outcomes[i].ledger.pods,
                                  outcomes[i].ledger.signature, i))
    kept = order[:MAX_GROUP_ENTRIES]
    expl.groups = [outcomes[i] for i in kept]
    gi_to_entry = {out_gi[i]: pos for pos, i in enumerate(kept)}

    # pod → retained-group-entry index for every (bounded) unschedulable
    # pod, via the gi_of map already built above — keyed by GROUP INDEX,
    # never signature (topology splits share signatures)
    for n, r in unsched.items():
        if len(expl.unschedulable) >= MAX_UNSCHEDULABLE:
            break
        expl.unschedulable[n] = r
        gi = gi_of.get(n)
        if gi is not None and gi in gi_to_entry:
            expl.pod_group[n] = gi_to_entry[gi]

    # this pass's placements onto existing capacity (claim placements are
    # appended by the provisioner as claims are created)
    if plan is not None:
        for node_name, pods in plan.existing_assignments.items():
            for p in pods:
                expl.placements_total += 1
                if len(expl.placements) < MAX_PLACEMENTS:
                    expl.placements[p] = node_name
    expl.degraded_reason = getattr(plan, "degraded_reason", "") or ""
    return expl


def add_placements(expl: PassExplanation, plan) -> None:
    """Fold a retry-round plan's existing-capacity placements into an
    already-built pass explanation (the limit-fallback loop re-solves
    dropped pods and may bind them onto existing nodes — symmetric with
    add_claim for the retry rounds' new claims)."""
    for node_name, pods in plan.existing_assignments.items():
        for p in pods:
            if p in expl.placements:
                continue
            expl.placements_total += 1
            if len(expl.placements) < MAX_PLACEMENTS:
                expl.placements[p] = node_name


def add_unschedulable(expl: PassExplanation, name: str,
                      reason_str: str) -> None:
    """Fold a late unschedulable pod (limit-fallback drop, retry-round
    leftover) into an already-built pass explanation."""
    if name in expl.unschedulable:
        return
    code = taxonomy.code_of(reason_str)
    expl.reason_counts[code] = expl.reason_counts.get(code, 0) + 1
    expl.unschedulable_total += 1
    if len(expl.unschedulable) < MAX_UNSCHEDULABLE:
        expl.unschedulable[name] = reason_str


def add_claim(expl: PassExplanation, claim_name: str, node,
              runner_up: Optional[Tuple[str, float]] = None) -> None:
    """Record a created claim's placement rationale: the chosen offering
    and (when the bin had launch flexibility) the runner-up type with
    its price delta."""
    doc = {
        "nodePool": node.node_pool,
        "instanceType": node.instance_type, "zone": node.zone,
        "capacityType": node.capacity_type,
        "pricePerHour": round(float(node.price_per_hour), 6),
        "pods": len(node.pods),
        "flexibleTypes": len(node.feasible_types),
    }
    if runner_up is not None:
        doc["runnerUpType"] = runner_up[0]
        doc["runnerUpPricePerHour"] = round(float(runner_up[1]), 6)
        doc["runnerUpPriceDelta"] = round(
            float(runner_up[1]) - float(node.price_per_hour), 6)
    expl.claims[claim_name] = doc
    for p in node.pods:
        expl.placements_total += 1
        if len(expl.placements) < MAX_PLACEMENTS:
            expl.placements[p] = claim_name


# ---- the bounded per-pass decision-audit ring -----------------------------

class DecisionAuditRing:
    """Bounded ring of PassExplanations keyed by pass/trace id — the
    store behind the ``explain`` introspection provider, /debug/explain,
    and ``kpctl explain``. Thread-safe; stats() is flat numeric so the
    sampler rings (and therefore soak artifacts) carry the per-pass
    reason-code histogram as ordinary per-subsystem series."""

    # per-node decision entries kept (newest wins; move-to-end on update)
    NODE_LEDGER_MAX = 256

    def __init__(self, size: int = 64):
        self._ring: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self.passes_recorded = 0
        self._reason_totals: Dict[str, int] = {}
        self._elim_totals: Dict[str, int] = {}
        # node -> latest "why was this node NOT disrupted" decision (the
        # consolidation engine's skip codes land here: kpctl explain node)
        self._node_ledger: "OrderedDict[str, dict]" = OrderedDict()

    def record(self, expl: PassExplanation) -> None:
        with self._lock:
            self._ring.append(expl)
            self.passes_recorded += 1
            for code, n in expl.reason_counts.items():
                self._reason_totals[code] = \
                    self._reason_totals.get(code, 0) + n
            for stage, n in expl.eliminations.items():
                self._elim_totals[stage] = \
                    self._elim_totals.get(stage, 0) + n

    def record_node(self, node_name: str, code: str, detail: str = "",
                    t: float = 0.0) -> None:
        """Record a per-node skip decision (taxonomy-coded). Counted into
        the same reason totals the pass explanations feed, so the skip
        codes surface in stats()/soak series as reason_* like every other
        code; the per-node entry keeps only the LATEST decision with a
        per-(node, code) repeat count."""
        assert code in taxonomy.CODES, code
        with self._lock:
            self._reason_totals[code] = self._reason_totals.get(code, 0) + 1
            prev = self._node_ledger.pop(node_name, None)
            seen = (prev["count"] if prev is not None
                    and prev["code"] == code else 0)
            self._node_ledger[node_name] = {
                "node": node_name, "code": code, "detail": detail,
                "t": round(float(t), 3), "count": seen + 1}
            while len(self._node_ledger) > self.NODE_LEDGER_MAX:
                self._node_ledger.popitem(last=False)

    def headroom_probe(self) -> Dict[str, float]:
        """Audit-ring occupancy (introspect/headroom.py). ``kind="ring"``
        — evicting the oldest pass explanation is the retention policy
        /debug/explain documents; "drops" counts evicted passes."""
        with self._lock:
            depth = len(self._ring)
            return {"depth": float(depth),
                    "capacity": float(self._ring.maxlen or 0),
                    "drops": float(max(self.passes_recorded - depth, 0)),
                    "kind": "ring"}

    # ---- lookups ---------------------------------------------------------

    def _snapshot(self) -> List[PassExplanation]:
        with self._lock:
            return list(self._ring)

    def find_pass(self, pass_id: Optional[int] = None
                  ) -> Optional[PassExplanation]:
        snap = self._snapshot()
        if not snap:
            return None
        if pass_id is None:
            return snap[-1]
        for e in reversed(snap):
            if e.pass_id == pass_id or e.trace_id == str(pass_id):
                return e
        return None

    def find_pod(self, name: str) -> Optional[dict]:
        """Newest-first search: the pod's current reason + ledger (when
        unschedulable) or its placement (when this ring saw it bind)."""
        for e in reversed(self._snapshot()):
            if name in e.unschedulable:
                r = e.unschedulable[name]
                doc = {"pod": name, "pass": e.pass_id,
                       "traceId": e.trace_id, "outcome": "unschedulable",
                       "code": taxonomy.code_of(r), "reason": r}
                gi = e.pod_group.get(name)
                if gi is not None:
                    doc["group"] = e.groups[gi].to_doc()
                return doc
            if name in e.placements:
                target = e.placements[name]
                doc = {"pod": name, "pass": e.pass_id,
                       "traceId": e.trace_id, "outcome": "scheduled",
                       "node": target}
                if target in e.claims:
                    doc["rationale"] = e.claims[target]
                return doc
        return None

    def find_claim(self, name: str) -> Optional[dict]:
        for e in reversed(self._snapshot()):
            if name in e.claims:
                return {"nodeclaim": name, "pass": e.pass_id,
                        "traceId": e.trace_id, "rationale": e.claims[name]}
        return None

    def find_node(self, name: str) -> Optional[dict]:
        """The node's latest skip decision ("why was this node NOT
        consolidated"), recorded by the consolidation engine."""
        with self._lock:
            entry = self._node_ledger.get(name)
            return dict(entry) if entry is not None else None

    # ---- surfaces --------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """The ``explain`` introspection provider: flat numeric, so
        kpctl top's EXPLAIN row and the sampler's soak series both read
        it directly."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
            out: Dict[str, float] = {
                "passes": float(self.passes_recorded),
                "ring": float(len(self._ring)),
                "last_pass": float(last.pass_id) if last else 0.0,
                "last_unschedulable": float(
                    last.unschedulable_total) if last else 0.0,
                "last_groups": float(last.groups_total) if last else 0.0,
                "node_entries": float(len(self._node_ledger)),
            }
            for code, n in sorted(self._reason_totals.items()):
                out["reason_" + code.replace("-", "_")] = float(n)
            for stage, n in sorted(self._elim_totals.items()):
                out["elim_" + stage.replace("-", "_")] = float(n)
            return out

    def doc(self, query: Dict[str, List[str]]) -> dict:
        """The /debug/explain JSON document (both HTTP servers route
        here via introspect.debug_doc)."""
        def q(key):
            v = query.get(key, [])
            return v[0] if v else None

        if q("pod"):
            found = self.find_pod(q("pod"))
            return found if found is not None else {
                "pod": q("pod"), "found": False,
                "message": "pod not seen in the decision-audit ring "
                           "(already scheduled before the ring, or never "
                           "pending)"}
        if q("nodeclaim"):
            found = self.find_claim(q("nodeclaim"))
            return found if found is not None else {
                "nodeclaim": q("nodeclaim"), "found": False,
                "message": "nodeclaim not in the decision-audit ring"}
        if q("node"):
            found = self.find_node(q("node"))
            return found if found is not None else {
                "node": q("node"), "found": False,
                "message": "node has no recorded skip decision (it was "
                           "consolidated, never a candidate, or the entry "
                           "aged out of the node ledger)"}
        if q("pass"):
            try:
                pid = int(q("pass"))
            except ValueError:
                pid = q("pass")   # trace id form
            e = self.find_pass(pid)
            return (e.to_doc(full=True) if e is not None
                    else {"pass": q("pass"), "found": False})
        with self._lock:
            snap = list(self._ring)
            reasons = dict(self._reason_totals)
            elims = dict(self._elim_totals)
        return {
            "passes": [e.to_doc(full=False) for e in snap],
            "recorded": self.passes_recorded,
            "reasons": reasons, "eliminations": elims,
        }
