"""Replays of the JAX package's own test files against both packages
(shared helpers; no tests of their own).

A replayed file is loaded twice: once as it is, and once with every
``karpenter_provider_aws_tpu`` import pointed at the port. Each of its
tests then runs on both copies, with its own checks, on the same inputs
(the files build them from fixed seeds and a ``FakeClock``). On the port
side ``Operator`` and ``Solver`` get ``device="cpu"`` unless the test
names a device. While a test runs, every object of the kinds in
``RECORDED`` that it makes (the Operator, FakeCloud, the domain
providers, metric registries, interruption queues) is recorded, and at
its end the two packages' objects are compared kind by kind, in the order
they were made:

- the Operator: claims, nodes with their labels, pod bindings, events
  (less those a wall-clock measurement raises, ``WALL_TIME_EVENTS``),
  the disruption controller's in-flight actions and engine counters, its
  Solver's ``degraded_counts``, and the names of the introspection
  providers;
- FakeCloud: every call it served (launches, tags, terminations, in
  order) and its instances with their tags. The garbage collector's
  existence checks fan out over a thread pool in both packages, so the
  order within a run of consecutive ``FANOUT_CALLS`` follows the threads:
  each such run is compared as a sorted list (the same calls, in any
  order), every other call in order;
- each domain provider: the contents of its TTL cache; the pricing
  provider: the lattice's prices and price version;
- each metrics registry: its families (name, kind, labels), the value of
  every gauge and counter series (a label naming a path in the test's own
  directory, as a sidecar's address, with the package's directory masked) and the observation count of every
  histogram series. Series that measure wall time (``WALL_TIME``) and
  the build-info labels (``jax_version`` and ``backend`` name the
  runtime) are compared by presence only, and the headroom rows of
  ``WALL_TIME_RESOURCES`` not at all;
- each interruption queue: its messages and what is still pending;
- each solver ``FaultInjector``: its ceilings, the device errors still
  pending and what fired;
- each weather simulator: its seed, ticks, timeline and counters;
- each solver pool: ``pool_stats()`` but the endpoint addresses (each
  package's test runs in its own directory) and its ``degraded_counts``;
  each chaos sidecar: whether it is alive, hung and answering junk;
- each replication source: its counters; each standby replica: its
  counters and the names in its mirror;
- each fake apiserver: every stored object of every kind as its JSON
  text (the serde dict in its envelope, so key order, float formatting
  and ``resourceVersion`` are compared), the global resourceVersion, and
  ``stats()``'s counters (bulk calls and ops, bookmarks, dropped-watcher
  events, deliveries, watchers, objects). A time field of an object
  (``WALL_TIME_FIELDS``) that holds a wall-clock stamp (an epoch time,
  where a ``FakeClock`` starts at 1e6) is compared by presence only, as
  is the annotation of a claim's solver stage times
  (``WALL_TIME_ANNOTATIONS``), and the queue depths of ``stats()``
  follow the watchers' threads and are not compared.

With ``plans=True`` the replay also records the plan of every call of a
Solver's ``solve`` and ``solve_delta`` (``solve_relaxed`` calls ``solve``)
as its ``serde.plan_semantic_dict``, in call order, and compares them.
With ``buffers=True`` it records every call of the sharded pack
(``parallel.sharded.sharded_pack``, the Solver's and the test's own) and
of the seeded merge pack (``ops.binpack.pack_packed_seeded``): the
sharded pack's [D,G] split, its stacked per-shard decode buffers byte for
byte and its three totals (the float32 cost included: the port sums in
the reference's order), the merge's fused input and result bytes.

Everything is compared for equality; the only float slack is
``REL`` on the engine's savings. A test the port cannot run yet is named
in its file's ``NOT_REPLAYED`` with the roadmap item that brings it, or,
where no item will, with ``seam`` (a settled divergence of the port) or
``XLA`` (the test reads XLA's own state). A test's own ``skipif`` marks
apply on both packages. Module-level tests replay like methods
(``file::test``), and a test over a parametrized fixture of its module
replays once per value (``parametrized``).
A test whose run follows the wall clock through threads (a controller
runtime, an HTTP server, leader election) is named in its file's
``THREADED``: there the test's own checks run on both packages, and of
what both made only the kinds and counts are compared.

On the port side the CLI's ``--device`` also defaults to the CPU
(``cpu_cli=False`` keeps its own default, ``cuda``, for a test that
renders the parser's defaults).
"""

import ast
import contextlib
import inspect
import pathlib
import re
import sys
import types

import pytest

import test_torch_cases as cases

TESTS = pathlib.Path(__file__).resolve().parent
REL = 1e-5

# metric families whose values follow the wall clock (pass and solve
# latencies, lock waits, the SLO burn built on them, the headroom
# forecaster's rates over sampled rings) or name the runtime
WALL_TIME = re.compile(
    r"(duration_seconds|lock_wait|latency|slo_|_burn|build_info|"
    r"headroom_fill_rate|headroom_seconds_to_exhaustion|"
    r"karpenter_solver_)")

# events a wall-clock measurement raises: a pass slower than the SLO's
# latency budget for long enough (the JAX package's first passes compile).
# The event sink keeps them out of every apiserver on both packages, so
# that they neither appear in its store nor shift its resourceVersions
# and event names; the recorder still holds them.
WALL_TIME_EVENTS = ("SloBudgetBurn",)
# headroom rows whose depth follows the wall clock: burn captures fire on
# slow passes, and the events ring also holds the events above
WALL_TIME_RESOURCES = ("burn_captures", "events_ring")

# wire fields that carry a time, and the least value that is a
# wall-clock stamp (an epoch time; a FakeClock starts at 1e6)
WALL_TIME_FIELDS = re.compile(r"(Timestamp|Time|At|^time)$")
WALL_EPOCH = 1e9
# annotations whose values are wall-time measurements
WALL_TIME_ANNOTATIONS = ("karpenter.sh/solver-stage-ms",)

_PKG_RE = re.compile(r"\bkarpenter_provider_aws_tpu\b")

# shims for the repository's tools that a replayed test imports as modules
# of ``tools/`` on ``sys.path``: on the port side, the port's copies
KPCTL_SHIM = ("        import kpctl\n",
              "        from karpenter_provider_aws_tpu_torch.tools "
              "import kpctl\n")
SOAK_SHIM = ("        import soak\n",
             "        from karpenter_provider_aws_tpu_torch.tools "
             "import soak\n")


def jax_tests(filename):
    """``file::Class::test`` for every test method of a JAX test file,
    and ``file::test`` for every module-level test, in file order."""
    src = (TESTS / filename).read_text()
    out = []
    for node in ast.parse(src).body:
        if isinstance(node, ast.ClassDef):
            out += [f"{filename}::{node.name}::{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef)
                    and f.name.startswith("test_")]
        elif isinstance(node, ast.FunctionDef) and \
                node.name.startswith("test_"):
            out.append(f"{filename}::{node.name}")
    return out


# why a test is not replayed: the roadmap item that brings it, or a
# reason no item can remove (a settled seam of the port, or a test that
# reads XLA's own state)
NOT_REPLAYED_REASON = re.compile(r"^((A|B)\d+[a-z]?|seam|XLA)\b")


def replayed(filename, not_replayed):
    """The tests of ``filename`` to replay; ``not_replayed`` must name
    only tests that exist, each with the roadmap item that brings it or
    the reason none will (``NOT_REPLAYED_REASON``)."""
    names = jax_tests(filename)
    stale = set(not_replayed) - set(names)
    assert not stale, f"NOT_REPLAYED names no test of {filename}: {stale}"
    for name, why in not_replayed.items():
        assert NOT_REPLAYED_REASON.match(why), (name, why)
    return [n for n in names if n not in not_replayed]


def parametrized(filename, tests):
    """``(test_id, params)`` for each of ``tests`` (``file::Class::test``
    or ``file::test`` ids): one per parameter set of a test that the JAX
    file parametrizes (its ``pytest.mark.parametrize`` marks and the
    ``params`` of the module's fixtures it takes, crossed), ``{}`` for
    the others."""
    module = load(filename, cases.JAX_PKG)
    out = []
    for test_id in tests:
        parts = test_id.split("::")
        fn = getattr(module, parts[1])
        if len(parts) == 3:
            fn = getattr(fn, parts[2])
        combos = [{}]
        for name in inspect.signature(fn).parameters:
            fixture = module.__dict__.get(name)
            params = getattr(getattr(fixture, "_fixture_function_marker",
                                     None), "params", None)
            if params:
                combos = [{**c, name: v} for c in combos for v in params]
        for mark in getattr(fn, "pytestmark", ()):
            if mark.name != "parametrize":
                continue
            names, values = mark.args[0], mark.args[1]
            if isinstance(names, str):
                names = [n.strip() for n in names.split(",")]
            rows = [tuple(v.values) if hasattr(v, "values")   # pytest.param
                    else tuple(v) if len(names) > 1 else (v,)
                    for v in values]
            combos = [{**c, **dict(zip(names, row))}
                      for c in combos for row in rows]
        out += [(test_id, c) for c in combos]
    return out


def case_id(test_id, params):
    """A pytest id for a ``parametrized`` case: the test id, with its
    parameter values in brackets as pytest writes them."""
    if not params:
        return test_id
    return f"{test_id}[{'-'.join(str(v) for v in params.values())}]"


def _unported(name, item):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported ({item})")
    return stub


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Single-threaded torch for a test (autouse where a test file imports
    it). The port's CPU ops are tiny; under a parallel test run every
    worker's torch thread pool spins against the others', which made the
    long Operator and wave replays an order of magnitude slower."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_LOADED = {}


def load(filename, pkg, stubs=(), shims=()):
    """The test module ``filename`` with its imports pointed at ``pkg``.
    ``stubs`` are (source line, bound name, roadmap item): on the port
    side each such module-level import of an unported module binds a stub
    that raises when used. ``shims`` are (source text, replacement): on
    the port side the text is replaced as given, with no package
    renaming, so a replacement may import a helper of the JAX package
    that reads only plan attributes."""
    key = (filename, pkg)
    if key in _LOADED:
        return _LOADED[key]
    src = (TESTS / filename).read_text()
    if pkg == cases.TORCH_PKG:
        for line, name, item in stubs:
            assert line in src, line
            src = src.replace(line, f"{name} = _unported({name!r}, {item!r})")
        held = {}
        for i, (text, replacement) in enumerate(shims):
            assert text in src, text
            held[f"__replay_shim_{i}__"] = replacement
            src = src.replace(text, f"__replay_shim_{i}__")
        src = _PKG_RE.sub(cases.TORCH_PKG, src)
        for token, replacement in held.items():
            src = src.replace(token, replacement)
    name = f"replay_{pkg}_{pathlib.Path(filename).stem}"
    module = types.ModuleType(name)
    module.__file__ = str(TESTS / filename)
    module._unported = _unported
    module._replay_pkg = pkg
    module._module_fixtures = {}
    sys.modules[name] = module
    exec(compile(src, module.__file__, "exec"), module.__dict__)
    _LOADED[key] = module
    return module


# ---- fixtures ----

def _fixture_parts(obj):
    fn = obj._get_wrapped_function()
    return fn, obj._fixture_function_marker.scope


class _Fixtures:
    """Resolves a test's arguments from its class's and its module's
    fixtures (module or function scope, plain or generator; a generator
    fixture of module scope is made anew for each test and finalized at
    its end) and pytest's ``monkeypatch``, ``tmp_path`` and
    ``tmp_path_factory``."""

    def __init__(self, module, tmp_path, instance=None):
        self.module = module
        self.instance = instance
        self.tmp_path = tmp_path
        self.values = {}
        self.finalizers = []

    def get(self, name):
        if name in self.values:
            return self.values[name]
        if name == "monkeypatch":
            mp = pytest.MonkeyPatch()
            self.finalizers.append(mp.undo)
            value = mp
        elif name == "capsys":
            value = _Capsys()
            self.finalizers.append(value.close)
        elif name == "tmp_path":
            self.tmp_path.mkdir(parents=True, exist_ok=True)
            value = self.tmp_path
        elif name == "tmp_path_factory":
            value = _TmpPathFactory(self.tmp_path)
        elif name == "request":
            value = _NoRequest()
        else:
            obj = getattr(type(self.instance), name, None)
            bound = hasattr(obj, "_fixture_function_marker")
            if not bound:
                obj = self.module.__dict__.get(name)
            if obj is None or not hasattr(obj, "_fixture_function_marker"):
                raise LookupError(f"fixture {name!r} is not replayable")
            fn, scope = _fixture_parts(obj)
            if bound:
                fn = fn.__get__(self.instance)
            cache = self.module._module_fixtures
            shared = scope == "module" and not inspect.isgeneratorfunction(fn)
            if shared and name in cache:
                value = cache[name]
            else:
                value = self._call(fn)
                if shared:
                    cache[name] = value
        self.values[name] = value
        return value

    def _call(self, fn):
        args = {p: self.get(p) for p in inspect.signature(fn).parameters}
        if inspect.isgeneratorfunction(fn):
            gen = fn(**args)
            value = next(gen)
            self.finalizers.append(lambda: next(gen, None))
            return value
        return fn(**args)

    def close(self):
        while self.finalizers:
            self.finalizers.pop()()


class _Capsys:
    """pytest's ``capsys``, as far as ``readouterr`` goes: the test's
    standard output and error from the moment it is made."""

    def __init__(self):
        import io
        self._saved = (sys.stdout, sys.stderr)
        self._out, self._err = io.StringIO(), io.StringIO()
        sys.stdout, sys.stderr = self._out, self._err

    def readouterr(self):
        import collections
        out, err = self._out.getvalue(), self._err.getvalue()
        for buf in (self._out, self._err):
            buf.seek(0)
            buf.truncate()
        return collections.namedtuple("CaptureResult", "out err")(out, err)

    def close(self):
        sys.stdout, sys.stderr = self._saved


class _NoRequest:
    """pytest's ``request`` for a test that takes it and never reads it:
    any use fails the replay."""

    def __getattr__(self, name):
        raise LookupError(f"fixture 'request' is not replayable ({name})")


class _TmpPathFactory:
    """pytest's ``tmp_path_factory``, as far as ``mktemp`` goes."""

    def __init__(self, root):
        self._root = root

    def mktemp(self, name):
        path = self._root / name
        path.mkdir(parents=True, exist_ok=True)
        return path


# ---- what is recorded and how it is observed ----

def _tuple_items(d):
    return tuple(sorted((str(k), repr(v)) for k, v in d.items()))


def observe_operator(op):
    cl = op.cluster
    eng = op.disruption.engine
    stats = eng.stats()
    introspect = sys.modules[type(op).__module__.split(".")[0]
                             + ".introspect"]
    return {
        "claims": sorted((c.name, c.node_pool, c.instance_type, c.zone,
                          c.capacity_type, c.phase.value,
                          c.deletion_timestamp is not None)
                         for c in cl.snapshot_claims()),
        "nodes": sorted((n.name, n.node_claim, _tuple_items(n.labels))
                        for n in cl.snapshot_nodes()),
        "pods": sorted((p.name, p.node_name) for p in cl.snapshot_pods()),
        "events": [(e.time, e.type, e.reason, e.object_kind, e.object_name,
                    e.message) for e in op.recorder.events()
                   if e.reason not in WALL_TIME_EVENTS],
        "in_flight": [(a.reason, list(a.claims), list(a.replacements))
                      for a in op.disruption._in_flight],
        "degraded": dict(op.solver.degraded_counts),
        "engine": {k: v for k, v in stats.items() if k != "savings_per_hour"},
        "savings": stats["savings_per_hour"],
        "introspect": sorted(introspect.registry().names()),
    }


# cloud verbs a controller issues from a thread pool: the garbage
# collector's existence checks (``cloud_provider.get`` on 100 workers of
# ``utils.fanout.LazyPool``), whose order within one reconcile follows the
# workers' threads
FANOUT_CALLS = ("describe_instances",)


def cloud_calls(calls):
    """FakeCloud's calls as compared: each maximal run of consecutive
    ``FANOUT_CALLS`` of one verb sorted, every other call in order."""
    out, run = [], []
    for verb, args in calls:
        if run and verb != run[0][0]:
            out.extend(sorted(run))
            run = []
        if verb in FANOUT_CALLS:
            run.append((verb, repr(args)))
        else:
            out.append((verb, repr(args)))
    return out + sorted(run)


def observe_cloud(cloud):
    return {
        "calls": cloud_calls(cloud.calls),
        "instances": sorted((i.id, i.instance_type, i.zone, i.capacity_type,
                             i.state, _tuple_items(i.tags), i.image_id,
                             i.subnet_id, tuple(i.security_group_ids),
                             i.private_ip)
                            for i in cloud.instances.values()),
    }


def observe_cache(provider):
    return sorted((str(k), repr(v)) for k, v in provider._cache.items())


def observe_pricing(provider):
    lat = provider.lattice
    return {"price_version": lat.price_version, "price": lat.price.tobytes(),
            "updated": provider.last_update is not None}


# a replay runs each package's copy of a test in a directory of its own
# (``tmp_path / "jax"`` and ``tmp_path / "port"``, in ``replay``): a label
# value naming a path in it (a sidecar address) names that directory
_PKG_DIR = re.compile(r"/(jax|port)/")


def _labels(key):
    return tuple(_PKG_DIR.sub("/<pkg>/", v) if isinstance(v, str) else v
                 for v in key)


def observe_registry(reg):
    families, values, present = [], {}, set()
    for m in sorted(reg._metrics.values(), key=lambda m: m.name):
        families.append((m.name, m.kind, tuple(m.labelnames)))
        wall = bool(WALL_TIME.search(m.name))
        if m.kind == "histogram":
            for k, n in m._totals.items():
                present.add((m.name, k))
                if not wall:
                    values[(m.name, k)] = (n, tuple(m._counts[k]))
        else:
            for k, v in m._values.items():
                k = _labels(k)
                if m.name.startswith("karpenter_headroom_") \
                        and k and k[0] in WALL_TIME_RESOURCES:
                    continue
                if m.name == "karpenter_build_info":
                    present.add((m.name, k[:1]))
                    continue
                present.add((m.name, k))
                if not wall:
                    values[(m.name, k)] = v
    return {"families": families, "values": values, "present": present}


def observe_queue(queue):
    return {"name": queue.name,
            "messages": sorted((k, repr(v)) for k, v in queue._messages.items()),
            "pending": list(queue._pending)}


def observe_faults(inj):
    return {"g_limit": inj.g_limit, "b_limit": inj.b_limit,
            "device_errors": inj.device_errors, "fired": dict(inj.fired)}


def observe_pool(pool):
    return {"stats": {k: v for k, v in pool.pool_stats().items()
                      if not k.endswith("_address")},
            "degraded": dict(pool.degraded_counts)}


def observe_sidecar(sidecar):
    return {"alive": sidecar.alive, "hanging": sidecar.service._hanging,
            "junk": sidecar.service._junk}


def observe_replica(replica):
    c = replica.cluster
    return {"stats": replica.stats(),
            "pods": sorted((p.name, p.node_name) for p in c.snapshot_pods()),
            "tables": [sorted(t) for t in (c.nodes, c.claims, c.pvcs,
                                           c.storage_classes, c.leases,
                                           c.pdbs)]}


def observe_source(source):
    return source.stats()


def observe_weather(sim):
    return {"seed": sim.seed, "ticks": sim.ticks,
            "timeline": repr(sim.timeline), "counters": dict(sim.counters)}


def _mask_times(obj):
    if isinstance(obj, dict):
        return {k: ("<wall time>" if k in WALL_TIME_ANNOTATIONS
                    or (isinstance(v, (int, float))
                        and not isinstance(v, bool) and v >= WALL_EPOCH
                        and WALL_TIME_FIELDS.search(k))
                    else _mask_times(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask_times(v) for v in obj]
    return obj


# stats() counters that follow the writes alone (the queue depths follow
# the watchers' threads)
APISERVER_STATS = ("watchers", "watch_drops", "bookmarks", "objects",
                   "events_emitted", "bulk_calls", "bulk_ops",
                   "fanout_envelope_copies", "last_rv")


def observe_apiserver(server):
    import json
    objects = {}
    for kind, store in server._store.items():
        objects[kind] = [(name, json.dumps(_mask_times(env)))
                         for name, env in sorted(store.items())]
    st = server.stats()
    return {"objects": objects,
            "stats": {k: st[k] for k in APISERVER_STATS},
            "present": sorted(st)}


# (module, class) -> observer, for every kind a replayed test may make
RECORDED = {
    ("operator.operator", "Operator"): observe_operator,
    ("cloud.fake", "FakeCloud"): observe_cloud,
    ("providers.subnet", "SubnetProvider"): observe_cache,
    ("providers.securitygroup", "SecurityGroupProvider"): observe_cache,
    ("providers.instanceprofile", "InstanceProfileProvider"): observe_cache,
    ("providers.amifamily", "AMIProvider"): observe_cache,
    ("providers.launchtemplate", "LaunchTemplateProvider"): observe_cache,
    ("providers.version", "VersionProvider"): observe_cache,
    ("providers.pricing", "PricingProvider"): observe_pricing,
    ("metrics", "Registry"): observe_registry,
    ("interruption.queue", "FakeQueue"): observe_queue,
    ("solver.faults", "FaultInjector"): observe_faults,
    ("weather.simulator", "WeatherSimulator"): observe_weather,
    ("kube.apiserver", "FakeAPIServer"): observe_apiserver,
    ("parallel.pool", "SolverPool"): observe_pool,
    ("parallel.sidecar", "ChaosSidecar"): observe_sidecar,
    ("state.replication", "StandbyReplica"): observe_replica,
    ("state.replication", "ReplicationSource"): observe_source,
}


# the kinds under which plans (``plans=True``) and pack buffers
# (``buffers=True``) are recorded, already in their observed form
PLANS = ("solver.solve", "NodePlan")
BUFFERS = ("parallel.sharded", "buffers")
PLAN_ENTRY_POINTS = ("solve", "solve_delta")


def _host(x):
    """A device array of either package as a numpy array."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _wrap_sharded(orig, made):
    def sharded_pack(*args, **kwargs):
        sp = orig(*args, **kwargs)
        split = kwargs.get("count_split", args[7] if len(args) > 7 else None)
        made.append((BUFFERS, (
            "sharded", _host(split).astype("int32").tobytes(),
            _host(sp.packed).shape, _host(sp.packed).tobytes(),
            float(sp.total_cost), int(sp.total_nodes),
            int(sp.total_leftover))))
        return sp
    return sharded_pack


def _wrap_seeded(orig, made):
    def pack_packed_seeded(alloc, avail, price, buf, split, *args, **kwargs):
        out = orig(alloc, avail, price, buf, split, *args, **kwargs)
        made.append((BUFFERS, ("seeded", _host(buf).tobytes(), int(split),
                               _host(out).tobytes())))
        return out
    return pack_packed_seeded


@contextlib.contextmanager
def recording(pkg, plans=False, buffers=False, module=None, cpu_cli=True):
    """Record every object of a RECORDED kind made while this is open
    (with ``plans``, every plan a Solver's entry points return; with
    ``buffers``, every sharded and seeded pack, the test ``module``'s own
    calls included); on the port side default ``Operator`` and ``Solver``
    to the CPU, and with ``cpu_cli`` the CLI's ``--device`` too (off
    where a test renders the parser's defaults, as the docs generator
    does)."""
    made = []
    with pytest.MonkeyPatch.context() as mp:
        if buffers:
            sharded = cases.mod(pkg, "parallel.sharded")
            wrapped = _wrap_sharded(sharded.sharded_pack, made)
            mp.setattr(sharded, "sharded_pack", wrapped)
            if module is not None and "sharded_pack" in module.__dict__:
                mp.setitem(module.__dict__, "sharded_pack", wrapped)
            bp = cases.mod(pkg, "ops.binpack")
            mp.setattr(bp, "pack_packed_seeded",
                       _wrap_seeded(bp.pack_packed_seeded, made))
        if plans:
            solver_cls = cases.mod(pkg, "solver.solve").Solver
            semantic = cases.mod(pkg, "apis.serde").plan_semantic_dict
            for name in PLAN_ENTRY_POINTS:
                def entry(self, *args, _orig=getattr(solver_cls, name),
                          **kwargs):
                    plan = _orig(self, *args, **kwargs)
                    made.append((PLANS, semantic(plan)))
                    return plan

                mp.setattr(solver_cls, name, entry)
        for (modname, clsname) in RECORDED:
            cls = getattr(cases.mod(pkg, modname), clsname)
            orig = cls.__init__
            port_op = pkg == cases.TORCH_PKG and clsname == "Operator"

            def init(self, *args, _orig=orig, _kind=(modname, clsname),
                     _cpu=port_op, **kwargs):
                if _cpu:
                    kwargs.setdefault("device", "cpu")
                _orig(self, *args, **kwargs)
                made.append((_kind, self))

            mp.setattr(cls, "__init__", init)
        # the package's process-wide state starts as in a fresh process
        # and is restored afterwards, so a replay neither sees nor leaves
        # what another test of the same process did: the introspection
        # registry and its published surfaces, lock-contention accounting
        # and the device cost model
        introspect = cases.mod(pkg, "introspect")
        mp.setattr(introspect.registry(), "_providers", {})
        for name in ("_SAMPLER", "_PROFILER", "_BURN_CAPTURE", "_EXPLAIN",
                     "_HEADROOM"):
            mp.setattr(introspect, name, None)
        contention = cases.mod(pkg, "introspect.contention")
        mp.setattr(contention, "_registry", {})
        mp.setattr(contention, "_order_edges", {})
        mp.setattr(contention, "_metric_hist", None)
        costmodel = cases.mod(pkg, "solver.costmodel")
        mp.setattr(costmodel, "_MODEL", costmodel.DeviceCostModel())
        sink_cls = cases.mod(pkg, "kube.eventsink").ApiEventSink
        sink_call = sink_cls.__call__

        def sink(self, event, _call=sink_call):
            if event.reason not in WALL_TIME_EVENTS:
                _call(self, event)

        mp.setattr(sink_cls, "__call__", sink)
        if pkg == cases.TORCH_PKG and cpu_cli:
            cli = cases.mod(pkg, "cli")
            build_parser = cli.build_parser

            def parser():
                p = build_parser()
                p.set_defaults(device="cpu")
                return p

            mp.setattr(cli, "build_parser", parser)
            solver_cls = cases.mod(pkg, "solver.solve").Solver
            solver_init = solver_cls.__init__

            def sinit(self, lattice, *args, **kwargs):
                if not args and kwargs.get("device") is None:
                    kwargs["device"] = "cpu"
                solver_init(self, lattice, *args, **kwargs)

            mp.setattr(solver_cls, "__init__", sinit)
        yield made


def _observations(made):
    by_kind = {}
    for kind, obj in made:
        by_kind.setdefault(kind, []).append(
            obj if kind in (PLANS, BUFFERS) else RECORDED[kind](obj))
    return by_kind


def run_test(module, test_id, tmp_path, plans=False, params=None,
             buffers=False, cpu_cli=True):
    """Run one test of ``module`` (``file::Class::test``, or
    ``file::test`` for a module-level one, with ``params`` for its
    parametrized arguments); returns the observations of what it made,
    taken at its end."""
    parts = test_id.split("::")
    if len(parts) == 2:
        instance, fn = None, getattr(module, parts[1])
    else:
        instance = getattr(module, parts[1])()
        fn = getattr(instance, parts[2])
    for mark in getattr(fn, "pytestmark", ()):
        # the file's own skip conditions, as pytest would apply them
        if mark.name == "skipif" and any(mark.args):
            pytest.skip(mark.kwargs.get("reason", "skipif"))
    fx = _Fixtures(module, tmp_path, instance)
    fx.values.update(params or {})
    try:
        # the autouse fixtures of the test's class and module, as pytest
        # would set them up first
        for owner in ((type(instance),) if instance is not None else ()) \
                + (module,):
            for name, obj in list(vars(owner).items()):
                marker = getattr(obj, "_fixture_function_marker", None)
                if marker is not None and marker.autouse:
                    fx.get(name)
        with recording(module._replay_pkg, plans=plans, buffers=buffers,
                       module=module, cpu_cli=cpu_cli) as made:
            fn(**{p: fx.get(p) for p in inspect.signature(fn).parameters})
            return _observations(made)
    finally:
        fx.close()


def _same(j, t, where):
    if isinstance(j, dict) and isinstance(t, dict) and "savings" in j:
        assert t["savings"] == pytest.approx(j["savings"], rel=REL,
                                             abs=1e-9), f"{where}: savings"
        j = {k: v for k, v in j.items() if k != "savings"}
        t = {k: v for k, v in t.items() if k != "savings"}
    if isinstance(j, dict) and isinstance(t, dict):
        assert set(t) == set(j), f"{where}: keys {set(t) ^ set(j)}"
        for k in j:
            _same(j[k], t[k], f"{where}.{k}")
    else:
        assert t == j, f"{where} differs"


def replay(filename, test_id, tmp_path, stubs=(), shims=(), threaded=False,
           plans=False, params=None, buffers=False, cpu_cli=True):
    """Run ``test_id`` on the JAX package and on the port, and require the
    same observations of everything both made (``threaded``: only the
    kinds and counts of what both made; ``plans``: the plans of every
    solve too)."""
    obs = {}
    for pkg in (cases.JAX_PKG, cases.TORCH_PKG):
        module = load(filename, pkg, stubs, shims)
        # a short directory per package: a unix socket's path is at most
        # 107 bytes
        sub = "jax" if pkg == cases.JAX_PKG else "port"
        obs[pkg] = run_test(module, test_id, tmp_path / sub, plans=plans,
                            params=params, buffers=buffers,
                            cpu_cli=cpu_cli)
    j, t = obs[cases.JAX_PKG], obs[cases.TORCH_PKG]
    assert {k[1]: len(v) for k, v in t.items()} \
        == {k[1]: len(v) for k, v in j.items()}
    if threaded:
        return j, t
    for kind in j:
        for i, (a, b) in enumerate(zip(j[kind], t[kind])):
            _same(a, b, f"{kind[1]}[{i}]")
    return j, t
