"""graftlint rules: one fixture-testable checker class per invariant.

Every rule consumes a parsed module (``check_module(tree, relpath,
source)``) and returns ``Violation``s, so tests can compile violating
and clean snippets from strings without touching the repo tree
(tests/test_torch_lint.py). File scoping lives in ``applies_to`` — the runner
filters, the checker itself never does, which is what makes the
fixtures honest.

The rules are deliberately name-heuristic where they have to be (a
Python AST cannot know an object's type): a ``with`` target counts as a
lock when its terminal identifier looks like one (``_lock``,
``_solve_lock``, ``_locks[kind]``, ``_cond``), and taint tracking in
the frozen-envelope rule is lexical, not flow-sensitive. False
negatives are possible; false positives go to the baseline with a
stated reason (baseline.py).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

PACKAGE = "karpenter_provider_aws_tpu_torch"


@dataclass(frozen=True)
class Violation:
    rule: str
    file: str          # repo-relative posix path
    line: int
    context: str       # enclosing def qualname, or "<module>"
    call: str          # the resolved offending call/symbol
    message: str

    def __str__(self) -> str:
        return (f"{self.file}:{self.line}: [{self.rule}] {self.message} "
                f"(in {self.context})")


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an attribute chain rooted at a Name, else None
    (string-literal receivers like ``", ".join`` resolve to None — they
    can never be lock handles or module calls)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def module_aliases(tree: ast.AST) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(module aliases, from-imported names): ``import time as _time``
    maps ``_time`` -> ``time``; ``from datetime import datetime`` maps
    ``datetime`` -> ``datetime.datetime`` — so a renamed import cannot
    dodge a rule."""
    mods: Dict[str, str] = {}
    names: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mods[a.asname] = a.name
                else:
                    mods[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                names[a.asname or a.name] = f"{node.module}.{a.name}"
    return mods, names


def resolve_call(func: ast.AST, mods: Dict[str, str],
                 names: Dict[str, str]) -> Optional[str]:
    """The canonical dotted name of a call target with import aliases
    substituted: ``_time.monotonic`` -> ``time.monotonic``."""
    d = dotted(func)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    if head in names:
        d = names[head] + (("." + rest) if rest else "")
    elif head in mods:
        d = mods[head] + (("." + rest) if rest else "")
    return d


class _ContextVisitor(ast.NodeVisitor):
    """Base visitor tracking the enclosing class/def qualname."""

    def __init__(self):
        self._stack: List[str] = []

    @property
    def context(self) -> str:
        return ".".join(self._stack) or "<module>"

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


class Rule:
    name = "rule"

    def applies_to(self, relpath: str) -> bool:
        raise NotImplementedError

    def check_module(self, tree: ast.AST, relpath: str,
                     source: str = "") -> List[Violation]:
        raise NotImplementedError


# ---- rule 1: clock discipline ---------------------------------------------

class ClockRule(Rule):
    """No raw ``time.time()``/``time.monotonic()``/``time.sleep()``/
    ``datetime.now()`` outside ``utils/clock.py``: everything on a
    FakeClock-reachable path must read the injected ``utils/clock``
    Clock, or deterministic-stratum tests and ``--weather`` replay can
    observe wall time. Genuinely wall-clock-only sites (process uptime,
    artifact timestamps) are baselined with a reason.

    ``time.perf_counter`` stays legal: interval self-measurement
    (profiler overhead, lock wait timing) is about the real host, never
    about simulated time."""

    name = "clock-discipline"
    BANNED = {
        "time.time", "time.monotonic", "time.sleep",
        "datetime.now", "datetime.utcnow",
        "datetime.datetime.now", "datetime.datetime.utcnow",
    }
    EXEMPT = {f"{PACKAGE}/utils/clock.py"}

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(PACKAGE + "/") and relpath not in self.EXEMPT

    def check_module(self, tree, relpath, source=""):
        mods, names = module_aliases(tree)
        rule = self

        class V(_ContextVisitor):
            out: List[Violation] = []

            def visit_Call(self, node):
                d = resolve_call(node.func, mods, names)
                if d in rule.BANNED:
                    self.out.append(Violation(
                        rule.name, relpath, node.lineno, self.context, d,
                        f"raw wall-clock call {d}() — route through the "
                        "injected utils/clock Clock (or baseline a "
                        "wall-clock-only site with a reason)"))
                self.generic_visit(node)

        v = V()
        v.out = []
        v.visit(tree)
        return v.out


# ---- rule 2: lock discipline ----------------------------------------------

_LOCKISH = re.compile(r"(^|_)(lock|locks|rlock|mutex|cond|condition)$", re.I)
_SOLVE_LOCKISH = re.compile(r"solve_lock", re.I)


def _lock_name(expr: ast.AST) -> Optional[str]:
    """The terminal identifier of a ``with`` target that might be a
    lock: ``self._lock`` -> ``_lock``, ``self._locks[kind]`` ->
    ``_locks``, ``lock`` -> ``lock``."""
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


class LockRule(Rule):
    """No blocking call lexically inside a ``with <instrumented-lock>``
    body (PR 7/8 spent two PRs profiling convoys out of exactly these
    spans), and no ``stats()`` method acquiring the solver solve lock
    (the PR 5 pin: a snapshot must never queue behind a device solve).

    Blocking means: any ``.sleep()`` (including clock sleeps — a
    FakeClock step under a lock is still a design smell), ``.result()``
    (Future waits), ``urlopen``/``requests.*`` (HTTP), and
    ``.block_until_ready()`` (device dispatch sync). Calls inside
    nested ``def``/``lambda`` bodies run later, outside the hold, and
    are not flagged."""

    name = "lock-discipline"
    _REQUESTS = re.compile(r"^requests\.(get|post|put|patch|delete|head|"
                           r"request|Session)\b")

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(PACKAGE + "/")

    @classmethod
    def _blocking(cls, d: str) -> bool:
        return (d == "time.sleep" or d.endswith(".sleep")
                or d.endswith(".result")
                or d == "urlopen" or d.endswith(".urlopen")
                or d.endswith(".block_until_ready")
                or bool(cls._REQUESTS.match(d)))

    def check_module(self, tree, relpath, source=""):
        mods, names = module_aliases(tree)
        rule = self

        class V(_ContextVisitor):
            def __init__(self):
                super().__init__()
                self.out: List[Violation] = []
                self._held: List[str] = []   # lock-ish with nesting
                self._in_stats = 0

            def visit_FunctionDef(self, node):
                # a nested def's body executes outside the lexical hold
                held, self._held = self._held, []
                self._in_stats += node.name == "stats"
                super().visit_FunctionDef(node)
                self._in_stats -= node.name == "stats"
                self._held = held

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                held, self._held = self._held, []
                self.generic_visit(node)
                self._held = held

            def visit_With(self, node):
                locks = [n for n in (_lock_name(i.context_expr)
                                     for i in node.items)
                         if n and _LOCKISH.search(n)]
                for n in locks:
                    if self._in_stats and _SOLVE_LOCKISH.search(n):
                        self.out.append(Violation(
                            rule.name, relpath, node.lineno, self.context,
                            f"stats:{n}",
                            "stats() acquires the solver solve lock — a "
                            "snapshot must never queue behind an in-flight "
                            "device solve"))
                self._held.extend(locks)
                self.generic_visit(node)
                del self._held[len(self._held) - len(locks):]

            visit_AsyncWith = visit_With

            def visit_Call(self, node):
                d = resolve_call(node.func, mods, names)
                if d:
                    if self._held and rule._blocking(d):
                        self.out.append(Violation(
                            rule.name, relpath, node.lineno, self.context, d,
                            f"blocking call {d}() while holding lock "
                            f"{self._held[-1]!r} — move it outside the "
                            "hold (the out-of-lock fan-out discipline)"))
                    if self._in_stats and d.endswith(".acquire") \
                            and _SOLVE_LOCKISH.search(d):
                        self.out.append(Violation(
                            rule.name, relpath, node.lineno, self.context,
                            f"stats:{d}",
                            "stats() acquires the solver solve lock"))
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        return v.out


# ---- rule 3: determinism --------------------------------------------------

class DeterminismRule(Rule):
    """``weather/`` and ``solver/`` must be pure functions of their
    seeds: no module-level ``random.*`` (the process-global RNG any
    import can perturb), no unseeded ``Random()``, no ``numpy.random``
    module functions, no ``datetime.now()``. The weather contract —
    every decision a pure function of (scenario, seed, tick) — and the
    solver's replayable plans both die the moment shared RNG state
    leaks in."""

    name = "determinism"
    SCOPES = (f"{PACKAGE}/weather/", f"{PACKAGE}/solver/")
    _DATETIME = {"datetime.now", "datetime.utcnow",
                 "datetime.datetime.now", "datetime.datetime.utcnow"}

    def __init__(self, scopes: Optional[Tuple[str, ...]] = None):
        if scopes is not None:
            self.SCOPES = scopes

    def applies_to(self, relpath: str) -> bool:
        return any(relpath.startswith(s) for s in self.SCOPES)

    def check_module(self, tree, relpath, source=""):
        mods, names = module_aliases(tree)
        rule = self

        class V(_ContextVisitor):
            def __init__(self):
                super().__init__()
                self.out: List[Violation] = []

            def _flag(self, node, d, msg):
                self.out.append(Violation(
                    rule.name, relpath, node.lineno, self.context, d, msg))

            def visit_Call(self, node):
                d = resolve_call(node.func, mods, names)
                if d:
                    if d in rule._DATETIME:
                        self._flag(node, d,
                                   f"{d}() in a determinism-critical "
                                   "module — wall time is not a function "
                                   "of (scenario, seed, tick)")
                    elif d in ("random.Random", "random.SystemRandom"):
                        if not node.args and not node.keywords:
                            self._flag(node, d,
                                       "unseeded Random() — derive the "
                                       "seed from (scenario, seed, tick)")
                    elif d.startswith("random."):
                        self._flag(node, d,
                                   f"module-level {d}() uses the "
                                   "process-global RNG — use a seeded "
                                   "Random instance")
                    elif d.startswith(("numpy.random.", "np.random.")) \
                            and not d.endswith((".default_rng",
                                                ".Generator")):
                        self._flag(node, d,
                                   f"{d}() uses numpy's global RNG — "
                                   "use a seeded Generator")
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        return v.out


# ---- rule 4: frozen-envelope discipline -----------------------------------

class FrozenEnvelopeRule(Rule):
    """Watch/informer handler code must not mutate event envelopes:
    since PR 8 every stored envelope is ONE frozen object shared by the
    store, the history ring, and every subscriber queue — a handler
    mutating it would corrupt every other consumer. Mutation requires a
    ``copy.deepcopy`` thaw first (deepcopy returns a private mutable
    copy by design).

    A handler is any function in the scoped modules whose parameters
    include both ``obj`` and ``old`` (the ``Handler`` signature in
    kube/informer.py) or whose name starts with ``_on_``. Taint is
    lexical: the two envelope params, plus any name assigned from a
    subscript/attribute of a tainted name; a deepcopy assignment
    clears the taint."""

    name = "frozen-envelope"
    SCOPES = (f"{PACKAGE}/kube/informer.py", f"{PACKAGE}/operator/sync.py",
              f"{PACKAGE}/kube/eventsink.py")
    MUTATORS = {"append", "extend", "insert", "pop", "popitem", "remove",
                "clear", "update", "setdefault", "sort", "reverse",
                "add", "discard"}
    _THAWS = {"copy.deepcopy", "deepcopy"}

    def __init__(self, scopes: Optional[Tuple[str, ...]] = None):
        if scopes is not None:
            self.SCOPES = scopes

    def applies_to(self, relpath: str) -> bool:
        return relpath in self.SCOPES

    @staticmethod
    def _root(node: ast.AST) -> Optional[str]:
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    @staticmethod
    def _own_exprs(st: ast.stmt):
        """The statement's OWN expressions (test/iter/value/targets...),
        never the statement lists nested under it — those recurse
        separately so taint state is updated in source order."""
        for _field, val in ast.iter_fields(st):
            for v in (val if isinstance(val, list) else [val]):
                if isinstance(v, ast.expr):
                    yield v
                elif isinstance(v, ast.withitem):
                    yield v.context_expr
                    if v.optional_vars is not None:
                        yield v.optional_vars

    def check_module(self, tree, relpath, source=""):
        rule = self
        mods, names = module_aliases(tree)
        out: List[Violation] = []

        def check_handler(fn: ast.FunctionDef, qual: str) -> None:
            params = {a.arg for a in (fn.args.args + fn.args.kwonlyargs)}
            tainted: Set[str] = params & {"obj", "old"}
            if not tainted:
                return

            def flag(node, call, msg):
                out.append(Violation(rule.name, relpath, node.lineno,
                                     qual, call, msg))

            def check_expr(expr: ast.expr) -> None:
                for node in ast.walk(expr):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr in rule.MUTATORS \
                            and rule._root(node.func.value) in tainted:
                        flag(node,
                             f"{rule._root(node.func.value)}."
                             f"{node.func.attr}",
                             f"mutator .{node.func.attr}() on a frozen "
                             "event envelope — deepcopy-thaw first")

            def scan(stmts: List[ast.stmt]) -> None:
                # SOURCE ORDER: taint transfer must see statements in
                # execution order, or a later rebind would retroactively
                # launder an earlier mutation (and vice versa) — the
                # reason this is not an ast.walk
                for st in stmts:
                    if isinstance(st, (ast.Assign, ast.AnnAssign)):
                        targets = (st.targets
                                   if isinstance(st, ast.Assign)
                                   else [st.target])
                        val = st.value
                        if val is not None:
                            check_expr(val)
                        for t in targets:
                            if isinstance(t, (ast.Subscript, ast.Attribute)) \
                                    and rule._root(t) in tainted:
                                flag(st, f"{rule._root(t)}[...]=",
                                     "item/attribute assignment on a "
                                     "frozen event envelope — "
                                     "deepcopy-thaw first")
                        name_targets = {t.id for t in targets
                                        if isinstance(t, ast.Name)}
                        is_thaw = (isinstance(val, ast.Call) and
                                   resolve_call(val.func, mods, names)
                                   in rule._THAWS)
                        if is_thaw or val is None:
                            tainted.difference_update(name_targets)
                        elif rule._root(val) in tainted:
                            tainted.update(name_targets)
                        else:
                            tainted.difference_update(name_targets)
                    elif isinstance(st, ast.AugAssign):
                        check_expr(st.value)
                        if rule._root(st.target) in tainted:
                            flag(st, f"{rule._root(st.target)}+=",
                                 "augmented assignment on a frozen event "
                                 "envelope — deepcopy-thaw first")
                    elif isinstance(st, ast.Delete):
                        for t in st.targets:
                            if isinstance(t, ast.Subscript) \
                                    and rule._root(t) in tainted:
                                flag(st, f"del {rule._root(t)}[...]",
                                     "del on a frozen event envelope — "
                                     "deepcopy-thaw first")
                    else:
                        for e in rule._own_exprs(st):
                            check_expr(e)
                        for field in ("body", "orelse", "finalbody"):
                            sub = getattr(st, field, None)
                            if sub:
                                scan(sub)
                        for h in getattr(st, "handlers", None) or ():
                            scan(h.body)

            scan(fn.body)

        class V(_ContextVisitor):
            def visit_FunctionDef(self, node):
                self._stack.append(node.name)
                if node.name.startswith("_on_") or \
                        {"obj", "old"} <= {a.arg for a in node.args.args}:
                    check_handler(node, self.context)
                self.generic_visit(node)
                self._stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

        V().visit(tree)
        return out


# ---- rule 5: metrics discipline -------------------------------------------

class MetricsRule(Rule):
    """Every ``karpenter_*`` series name a registry call uses anywhere
    in the package must be DECLARED in metrics.py (the one catalog
    dashboards port from) and PRESENT in the regenerated
    docs/reference/metrics.md — an undeclared series is invisible to
    the docs generator and to ``wire_core_metrics`` consumers; a
    declared-but-undocumented one means the docs are stale."""

    name = "metrics-discipline"
    METRICS_PY = f"{PACKAGE}/metrics.py"
    _KINDS = {"counter", "gauge", "histogram", "get"}

    def __init__(self, declared: Optional[Set[str]] = None,
                 docs_text: Optional[str] = None):
        self.declared = declared if declared is not None else set()
        self.docs_text = docs_text if docs_text is not None else ""

    @staticmethod
    def collect_declared(metrics_source: str) -> Set[str]:
        """Series names declared by metrics.py: the literal first arg of
        every counter/gauge/histogram registration call."""
        tree = ast.parse(metrics_source)
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("counter", "gauge", "histogram") \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.add(node.args[0].value)
        return out

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith(PACKAGE + "/")
                and relpath != self.METRICS_PY)

    def check_module(self, tree, relpath, source=""):
        out: List[Violation] = []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._KINDS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if not name.startswith("karpenter_"):
                continue
            ctx = "<module>"
            if name not in self.declared:
                out.append(Violation(
                    self.name, relpath, node.lineno, ctx, name,
                    f"series {name} is not declared in metrics.py — "
                    "add it to wire_core_metrics/wire_lattice_metrics"))
            elif self.docs_text and name not in self.docs_text:
                out.append(Violation(
                    self.name, relpath, node.lineno, ctx, name,
                    f"series {name} is missing from docs/reference/"
                    "metrics.md — run the gen_docs tool"))
        return out


# ---- rule 6: reason-code discipline ---------------------------------------

class ReasonRule(Rule):
    """Every unschedulable reason-code string literal must be DECLARED
    in solver/taxonomy.py — the bounded enum events, metrics labels,
    ``NodePlan.unschedulable``, and the sidecar wire all carry
    (docs/reference/explain.md). Same declaration-lockstep discipline
    as the metrics rule: an undeclared literal is invisible to
    ``code_of`` (it parses as "uncoded") and to the docs table.

    Flagged sites: the first argument of any ``reason(...)`` /
    ``taxonomy.reason(...)`` call (the taxonomy's constructor — the
    assert there catches it at runtime, this catches it at lint time),
    and any LITERAL ``code=`` keyword (metric label / explain field).
    Variables are never flagged — the taxonomy constructor's assert
    owns the dynamic path."""

    name = "reason-code"
    TAXONOMY_PY = f"{PACKAGE}/solver/taxonomy.py"

    def __init__(self, declared: Optional[Set[str]] = None):
        self.declared = declared if declared is not None else set()

    @staticmethod
    def collect_declared(taxonomy_source: str) -> Set[str]:
        """Codes declared by solver/taxonomy.py: every module-level
        ``NAME = "literal"`` string constant assignment — EXCEPT the
        ``UNCODED`` parse-failure sentinel, which is deliberately not a
        member of the taxonomy (reason('uncoded', ...) must stay a lint
        error exactly like any other undeclared literal)."""
        tree = ast.parse(taxonomy_source)
        out: Set[str] = set()
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str) \
                    and not any(isinstance(t, ast.Name)
                                and t.id == "UNCODED"
                                for t in node.targets):
                out.add(node.value.value)
        return out

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith(PACKAGE + "/")
                and relpath != self.TAXONOMY_PY)

    def check_module(self, tree, relpath, source=""):
        mods, names = module_aliases(tree)
        out: List[Violation] = []

        class V(_ContextVisitor):
            def visit_Call(v, node):
                d = resolve_call(node.func, mods, names)
                tail = d.rsplit(".", 1)[-1] if d else None
                if tail == "reason" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and node.args[0].value not in self.declared:
                    out.append(Violation(
                        self.name, relpath, node.lineno, v.context,
                        node.args[0].value,
                        f"reason code {node.args[0].value!r} is not "
                        "declared in solver/taxonomy.py — add the "
                        "constant (and the docs table entry)"))
                for kw in node.keywords:
                    if kw.arg == "code" \
                            and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str) \
                            and kw.value.value not in self.declared:
                        out.append(Violation(
                            self.name, relpath, node.lineno, v.context,
                            kw.value.value,
                            f"code= label literal {kw.value.value!r} is "
                            "not declared in solver/taxonomy.py"))
                v.generic_visit(node)

        V().visit(tree)
        return out


# ---- rule 7: bounded-resource discipline ----------------------------------

class BoundedResourceRule(Rule):
    """Every bounded buffer a production module constructs —
    ``deque(maxlen=...)`` is the repo's ring/queue idiom — must be
    visible to the saturation observatory (introspect/headroom.py):
    the module either defines a ``headroom_probe`` method/function
    (the convention every instrumented structure follows — the operator
    wires it into the HeadroomRegistry) or calls ``register_probe``
    directly. A bound without a probe is a silent cliff: the structure
    fills, drops, and nothing forecast it (docs/reference/headroom.md).

    The check is module-granular by design: a module that exposes ONE
    probe for several internal rings (slo.py's latency+cost pair) is
    compliant — the probe contract reports the fullest. A genuinely
    probe-free bound (a test fake's history buffer) goes to the
    baseline with a reason, same as every other rule."""

    name = "bounded-resource"
    _DEQUE = {"collections.deque", "deque"}

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(PACKAGE + "/")

    @staticmethod
    def _has_probe(tree: ast.AST, mods, names) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == "headroom_probe":
                return True
            if isinstance(node, ast.Call):
                d = resolve_call(node.func, mods, names)
                if d and d.rsplit(".", 1)[-1] == "register_probe":
                    return True
        return False

    def check_module(self, tree, relpath, source=""):
        mods, names = module_aliases(tree)
        rule = self
        probed = self._has_probe(tree, mods, names)

        class V(_ContextVisitor):
            def __init__(self):
                super().__init__()
                self.out: List[Violation] = []

            def visit_Call(self, node):
                d = resolve_call(node.func, mods, names)
                bounded = False
                if d in rule._DEQUE:
                    # deque(iterable, maxlen) positional, or maxlen= kw
                    # with a non-None bound (maxlen=None is unbounded —
                    # a different problem, not this rule's)
                    if len(node.args) >= 2:
                        bounded = True
                    for kw in node.keywords:
                        if kw.arg == "maxlen" and not (
                                isinstance(kw.value, ast.Constant)
                                and kw.value.value is None):
                            bounded = True
                if bounded and not probed:
                    self.out.append(Violation(
                        rule.name, relpath, node.lineno, self.context,
                        "deque(maxlen)",
                        "bounded buffer with no headroom probe — give "
                        "the module a headroom_probe() (or call "
                        "register_probe) so the saturation observatory "
                        "can forecast it, or baseline with a reason"))
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        return v.out


def default_rules(repo_root) -> List[Rule]:
    """The seven project rules, wired against the real metrics catalog,
    docs, and reason taxonomy (run.py's configuration)."""
    from pathlib import Path
    root = Path(repo_root)
    declared: Set[str] = set()
    docs_text = ""
    mp = root / PACKAGE / "metrics.py"
    if mp.exists():
        declared = MetricsRule.collect_declared(mp.read_text())
    docs = root / "docs" / "reference" / "metrics.md"
    if docs.exists():
        docs_text = docs.read_text()
    codes: Set[str] = set()
    tp = root / PACKAGE / "solver" / "taxonomy.py"
    if tp.exists():
        codes = ReasonRule.collect_declared(tp.read_text())
    return [ClockRule(), LockRule(), DeterminismRule(),
            FrozenEnvelopeRule(),
            MetricsRule(declared=declared, docs_text=docs_text),
            ReasonRule(declared=codes),
            BoundedResourceRule()]
