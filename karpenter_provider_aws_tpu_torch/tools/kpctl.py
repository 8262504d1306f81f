"""kpctl — the kubectl analog for this package's REST apiserver.

The counterpart of the repository's ``tools/kpctl.py``: the same verbs,
flags, output and exit codes, run as

    python -m karpenter_provider_aws_tpu_torch.tools.kpctl --server URL VERB

It is an HTTP client of the control plane; the one thing it reads of this
package is ``debug.load_timeseries`` (``kpctl soak``). ``kpctl top``'s
SOLVER row also names the Solver's device (``cuda:0``, or ``cpu``).

The reference's operational UX is kubectl against its CRDs (the entire
website getting-started flow drives `kubectl apply/get/delete`); this is
the same surface against the control plane served by
``karpenter-tpu-controller-torch --api-port`` (kube/httpserver.py routes):

    kpctl get KIND [NAME] [-o json|yaml|wide]   k8s-style tables
    kpctl apply -f FILE                      create-or-update from YAML/JSON
    kpctl delete KIND NAME [--force]
    kpctl watch KIND [--resource-version N]  streamed events
    kpctl evict POD [--force]
    kpctl describe KIND NAME                 object + its recorded events
    kpctl api-resources                      served kinds (discovery)

Connection flags mirror kubectl's: --server (or KPCTL_SERVER), bearer
auth via --token/--token-file, TLS via --cacert (self-signed material
from deploy/gen_certs.sh) or --insecure-skip-tls-verify.

Files for apply hold one or many documents (YAML stream or JSON list),
each ``{"kind": <plural>, "spec": {...}}`` in the serde wire schema —
`kpctl apply` is how the cross-process e2e drives provisioning
(tests/test_crossprocess_e2e.py).
"""

from __future__ import annotations

import argparse
import json
import os
import ssl
import sys
import urllib.error
import urllib.request

from ..utils.clock import WALL


class Client:
    def __init__(self, server: str, token: str = None, cacert: str = None,
                 insecure: bool = False):
        self.server = server.rstrip("/")
        self.token = token
        if cacert:
            self.ctx = ssl.create_default_context(cafile=cacert)
        elif insecure:
            self.ctx = ssl.create_default_context()
            self.ctx.check_hostname = False
            self.ctx.verify_mode = ssl.CERT_NONE
        else:
            self.ctx = None

    def request(self, method: str, path: str, doc=None, stream=False,
                raw=False):
        # Accept-Encoding: gzip on non-streaming requests — the series
        # payloads a `kpctl top`/`profile` session polls are large
        # (600-sample rings x subsystems) and the server compresses them
        # ~20x (kube/httpserver.py maybe_gzip)
        r = urllib.request.Request(
            f"{self.server}{path}", method=method,
            data=None if doc is None else json.dumps(doc).encode(),
            headers={"Content-Type": "application/json",
                     **({} if stream else {"Accept-Encoding": "gzip"}),
                     **({"Authorization": f"Bearer {self.token}"}
                        if self.token else {})})
        resp = urllib.request.urlopen(r, timeout=None if stream else 30,
                                      context=self.ctx)
        st = _parse_server_time(resp.headers.get("X-Server-Time"))
        if st is not None:
            global _SERVER_NOW
            _SERVER_NOW = st
        if stream:
            return resp
        with resp:
            body = resp.read()
            if resp.headers.get("Content-Encoding") == "gzip":
                import gzip
                body = gzip.decompress(body)
            if raw:
                return body
            return json.loads(body or b"{}")


def _parse_server_time(st):
    """X-Server-Time → float epoch seconds, tolerating BOTH wire forms:
    the current plain numeric ('1234.567890') and the legacy repr() a
    pre-fix server emits under a numpy-scalar clock ('np.float64(1234.5)'
    on numpy>=2) — an old control plane must not break age rendering."""
    if st is None:
        return None
    try:
        return float(st)
    except ValueError:
        import re
        m = re.search(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?", st)
        return float(m.group(0)) if m else None


# the reference clock for AGE/LAST SEEN columns: the SERVER's clock as
# reported by its last response (the `X-Server-Time` header on every
# route, plus the `serverTime` field in list bodies), so ages render
# correctly even when the server runs a simulated clock or the client's
# wall clock is skewed — including single-object `get KIND NAME`. Falls
# back to local time against pre-serverTime servers.
_SERVER_NOW = None


def _age(created, now=None):
    if not created:
        return "<none>"
    if now is None:
        now = _SERVER_NOW if _SERVER_NOW is not None else WALL.now()
    d = max(now - float(created), 0)
    if d < 120:
        return f"{int(d)}s"
    if d < 7200:
        return f"{int(d / 60)}m"
    return f"{int(d / 3600)}h"


def _cores(v):
    """Normalize a CPU quantity to cores: '12000m' → '12', '500m' → '0.5',
    '48' stays '48'. The usage/limit pair then reads in ONE unit instead
    of mixing millicores (solver-side accounting) with cores (YAML)."""
    s = str(v)
    if not s or s == "-":
        return s or "-"
    try:
        n = float(s[:-1]) / 1000.0 if s.endswith("m") else float(s)
    except ValueError:
        return s
    return f"{n:g}"


def _mem(v):
    """Normalize a memory quantity to a common suffix (Gi when it divides
    cleanly, else Mi): '2048Mi' → '2Gi', '1.5Gi' → '1536Mi'."""
    s = str(v)
    if not s or s == "-":
        return s or "-"
    suffixes = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
                "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}
    num, mult = s, 1
    for suf, m in suffixes.items():
        if s.endswith(suf):
            num, mult = s[: -len(suf)], m
            break
    try:
        b = float(num) * mult
    except ValueError:
        return s
    gi = b / 2**30
    if gi >= 1 and float(gi).is_integer():
        return f"{gi:g}Gi"
    return f"{b / 2**20:g}Mi"


def _np_status(o):
    """A NodePool's live resource usage: the envelope's controller-owned
    status sub-map (spec/status split); falls back to the legacy in-spec
    location for objects written by an older server."""
    return ((o.get("status") or {}).get("resources")
            or o["spec"].get("statusResources", {}))


# per-kind table columns: (header, spec-path extractor)
_COLUMNS = {
    "nodeclaims": (
        ("NAME", lambda o: o["metadata"]["name"]),
        ("TYPE", lambda o: o["spec"].get("instanceType") or "<pending>"),
        ("ZONE", lambda o: o["spec"].get("zone") or ""),
        ("CAPACITY", lambda o: o["spec"].get("capacityType") or ""),
        ("PHASE", lambda o: o["spec"].get("phase", "")),
        ("NODEPOOL", lambda o: o["spec"].get("nodePool", "")),
    ),
    "nodes": (
        ("NAME", lambda o: o["metadata"]["name"]),
        ("READY", lambda o: str(bool(o["spec"].get("ready"))).lower()),
        ("TYPE", lambda o: o["spec"].get("labels", {}).get(
            "node.kubernetes.io/instance-type", "")),
        ("ZONE", lambda o: o["spec"].get("labels", {}).get(
            "topology.kubernetes.io/zone", "")),
    ),
    "pods": (
        ("NAME", lambda o: o["metadata"]["name"]),
        ("NODE", lambda o: o["spec"].get("nodeName") or "<pending>"),
        ("CPU", lambda o: o["spec"].get("requests", {}).get("cpu", "")),
        ("MEMORY", lambda o: o["spec"].get("requests", {}).get("memory", "")),
    ),
    "nodepools": (
        ("NAME", lambda o: o["metadata"]["name"]),
        ("WEIGHT", lambda o: str(o["spec"].get("weight", 0))),
        # live usage vs ceiling (the controller-owned status.resources —
        # the envelope's status sub-map, never the user spec; "-" =
        # unlimited axis), both sides normalized to one unit (cores /
        # common memory suffix) so "12000m/48" never renders as two
        # different scales
        ("CPU", lambda o: "{}/{}".format(
            _cores(_np_status(o).get("cpu", "0")),
            _cores(o["spec"].get("limits", {}).get("cpu", "-")))),
        ("MEMORY", lambda o: "{}/{}".format(
            _mem(_np_status(o).get("memory", "0")),
            _mem(o["spec"].get("limits", {}).get("memory", "-")))),
    ),
    "events": (
        ("LAST SEEN", lambda o: _age(o["spec"].get("time"))),
        ("TYPE", lambda o: o["spec"].get("type", "")),
        ("REASON", lambda o: o["spec"].get("reason", "")),
        ("OBJECT", lambda o: "{}/{}".format(
            o["spec"].get("objectKind", ""), o["spec"].get("objectName", ""))),
        ("MESSAGE", lambda o: o["spec"].get("message", "")),
    ),
}
_DEFAULT_COLUMNS = (
    ("NAME", lambda o: o["metadata"]["name"]),
    ("RV", lambda o: str(o["metadata"]["resourceVersion"])),
)


def _print_rows(rows, indent: str = "") -> None:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print(indent
              + "   ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def print_table(kind: str, objs, wide: bool = False) -> None:
    cols = list(_COLUMNS.get(kind, _DEFAULT_COLUMNS))
    if wide:
        cols += [
            ("AGE", lambda o: _age(
                o["metadata"].get("creationTimestamp"))),
            ("RV", lambda o: str(o["metadata"]["resourceVersion"])),
        ]
    rows = [[h for h, _ in cols]]
    for o in objs:
        rows.append([f(o) or "" for _, f in cols])
    _print_rows(rows)


def load_documents(path):
    """YAML stream or JSON (object or list) → [{'kind','spec'}, ...]."""
    raw = sys.stdin.read() if path == "-" else open(path).read()
    try:
        docs = json.loads(raw)
        docs = docs if isinstance(docs, list) else [docs]
    except ValueError:
        import yaml
        docs = [d for d in yaml.safe_load_all(raw) if d]
    for d in docs:
        if "kind" not in d or "spec" not in d:
            raise SystemExit(
                f"each document needs kind+spec (got {sorted(d)})")
    return docs


def _list(c: Client, kind: str):
    """List a kind and adopt the server's clock for age rendering."""
    global _SERVER_NOW
    doc = c.request("GET", f"/apis/{kind}")
    if "serverTime" in doc:
        _SERVER_NOW = doc["serverTime"]
    return doc["items"]


def cmd_get(c: Client, args) -> int:
    if args.name:
        obj = c.request("GET", f"/apis/{args.kind}/{args.name}")
        objs = [obj]
    else:
        objs = _list(c, args.kind)
    payload = objs if args.name is None else objs[0]
    if args.output == "json":
        print(json.dumps(payload, indent=2))
    elif args.output == "yaml":
        import yaml
        print(yaml.safe_dump(payload, sort_keys=False), end="")
    else:
        print_table(args.kind, objs, wide=args.output == "wide")
    return 0


def cmd_apply(c: Client, args) -> int:
    for d in load_documents(args.filename):
        kind, spec = d["kind"], d["spec"]
        name = spec.get("name", "<unnamed>")
        try:
            c.request("POST", f"/apis/{kind}", spec)
            print(f"{kind}/{name} created")
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise
            # exists: kubectl-apply semantics — replace the spec at the
            # server's current RV
            cur = c.request("GET", f"/apis/{kind}/{name}")
            cur["spec"] = spec
            c.request("PUT", f"/apis/{kind}/{name}", cur)
            print(f"{kind}/{name} configured")
    return 0


def cmd_delete(c: Client, args) -> int:
    force = "?force=1" if args.force else ""
    c.request("DELETE", f"/apis/{args.kind}/{args.name}{force}")
    print(f"{args.kind}/{args.name} deleted")
    return 0


def cmd_watch(c: Client, args) -> int:
    rv = args.resource_version
    if rv is None:
        rv = c.request("GET", f"/apis/{args.kind}")["resourceVersion"]
    resp = c.request(
        "GET", f"/apis/{args.kind}?watch=1&resourceVersion={rv}",
        stream=True)
    for line in resp:
        ev = json.loads(line)
        if ev["type"] == "HEARTBEAT":
            continue
        if ev["type"] == "BOOKMARK":
            # RV checkpoint, no object payload — remember the resume
            # point silently (docs/reference/watch.md)
            rv = ev.get("resourceVersion", rv)
            continue
        if ev["type"] == "ERROR":
            # the server dropped this watcher (410-mid-stream: queue
            # overrun or history expiry) — report and stop; re-running
            # `kpctl watch` relists, like a reflector
            print(f"ERROR\t{ev.get('code', '')} {ev.get('reason', '')}: "
                  f"{ev.get('message', '')} (re-run to relist)",
                  flush=True)
            return 1
        name = ev["object"]["metadata"]["name"]
        print(f"{ev['type']}\t{args.kind}/{name}\trv={ev['resourceVersion']}",
              flush=True)
        if args.once:
            return 0
    return 0


def cmd_api_resources(c: Client, args) -> int:
    """kubectl api-resources analog: the kinds the server serves."""
    for k in c.request("GET", "/apis")["kinds"]:
        print(k)
    return 0


def cmd_describe(c: Client, args) -> int:
    """kubectl-describe analog: the object plus its recorded events
    (the `events` kind the control plane mirrors in API mode)."""
    obj = c.request("GET", f"/apis/{args.kind}/{args.name}")
    # fetch events FIRST: the list response carries serverTime, so the
    # Age lines below render on the server's clock, not ours
    try:
        events = _list(c, "events")
    except urllib.error.HTTPError as e:
        if e.code != 404:
            raise   # auth/server failure must not read as "no events"
        events = []   # pre-events server: describe still works
    md = obj["metadata"]
    print(f"Name:             {md['name']}")
    print(f"Kind:             {args.kind}")
    print(f"UID:              {md.get('uid', '')}")
    print(f"ResourceVersion:  {md['resourceVersion']}")
    if md.get("creationTimestamp"):
        print(f"Age:              {_age(md['creationTimestamp'])}")
    if md.get("deletionTimestamp"):
        print(f"Deleting:         since {_age(md['deletionTimestamp'])} ago")
    if md.get("finalizers"):
        print(f"Finalizers:       {', '.join(md['finalizers'])}")
    print("Spec:")
    for line in json.dumps(obj["spec"], indent=2).splitlines()[1:-1]:
        print(f" {line}")
    _print_solver_provenance(obj)

    def _matches(spec) -> bool:
        # kubectl matches involvedObject kind+name; objectName alone
        # would mis-attribute (a Node shares its NodeClaim's name)
        ok = spec.get("objectKind", "").lower()
        return (spec.get("objectName") == args.name
                and ok and args.kind in (ok + "s", ok + "es"))

    if args.kind == "pods":
        _print_pod_reasons(c, args.name)
    mine = [e["spec"] for e in events if _matches(e["spec"])]
    print("Events:")
    if not mine:
        print("  <none>")
        return 0
    rows = [["TYPE", "REASON", "AGE", "MESSAGE"]]
    rows += [[e.get("type", ""), e.get("reason", ""),
              _age(e.get("time")), e.get("message", "")] for e in mine]
    _print_rows(rows, indent="  ")
    return 0


def _print_pod_reasons(c: Client, name: str) -> None:
    """The Reasons block of `kpctl describe pod`: the pod's current
    structured reason code + last elimination summary from the
    decision-audit ring (docs/reference/explain.md). Quiet against a
    pre-explain server or an empty ring — describe must keep working."""
    try:
        doc = c.request("GET", f"/debug/explain?pod={name}")
    except (urllib.error.HTTPError, urllib.error.URLError):
        return
    if not isinstance(doc, dict) or doc.get("found") is False \
            or doc.get("enabled") is False or "outcome" not in doc:
        return
    print("Reasons:")
    if doc["outcome"] == "scheduled":
        print(f"  Outcome:        scheduled -> {doc.get('node', '?')} "
              f"(pass {doc.get('pass', '?')})")
        return
    print(f"  Outcome:        {doc['outcome']} (pass {doc.get('pass', '?')})")
    print(f"  Code:           {doc.get('code', '')}")
    print(f"  Reason:         {doc.get('reason', '')}")
    g = doc.get("group")
    if g:
        blame = g.get("blame")
        elim = next((s for s in reversed(g.get("stages", []))
                     if s.get("eliminated")), None)
        if blame and elim is not None:
            ex = elim.get("examples") or []
            print(f"  Eliminated by:  {blame}: {elim['eliminated']} "
                  f"offerings" + (f" (e.g. {ex[0]})" if ex else ""))
        print(f"  Last summary:   group {g.get('label', '?')} — "
              f"{g.get('remaining', 0)} offerings remained "
              f"(kpctl explain pod {name})")


_SOLVER_ANN = "karpenter.sh/"   # apis/wellknown.py KARPENTER_PREFIX


def _print_solver_provenance(obj) -> None:
    """The solver-provenance block of `kpctl describe nodeclaims`: the
    annotations the provisioner stamped on the claim (apis/wellknown.py)
    so an operator sees WHY this claim's solve was slow or degraded —
    path taken, degradation reason, per-stage ms, and the trace id to
    pull from the flight recorder (`kpctl trace show <id>`)."""
    ann = (obj.get("spec", {}).get("annotations")
           or obj.get("metadata", {}).get("annotations") or {})
    path = ann.get(_SOLVER_ANN + "solver-path")
    if path is None:
        return
    print("Solver:")
    print(f"  Path:           {path}")
    pipelined = ann.get(_SOLVER_ANN + "solver-pipelined")
    if pipelined is not None:
        print(f"  Pipelined:      {pipelined}")
    waves = ann.get(_SOLVER_ANN + "solver-waves")
    if waves is not None:
        print(f"  Waves:          {waves}")
    mesh = ann.get(_SOLVER_ANN + "solver-mesh-devices")
    if mesh is not None:
        print(f"  Mesh:           {mesh} devices (pod-axis sharded)")
    reason = ann.get(_SOLVER_ANN + "solver-degraded-reason")
    print(f"  Degraded:       {reason if reason else 'false'}")
    stage_ms = ann.get(_SOLVER_ANN + "solver-stage-ms")
    if stage_ms:
        try:
            stages = json.loads(stage_ms)
            rendered = "  ".join(f"{k}={v:g}ms" for k, v in stages.items())
        except ValueError:
            rendered = stage_ms
        print(f"  Stages:         {rendered}")
    tp = ann.get(_SOLVER_ANN + "traceparent")
    if tp:
        parts = tp.split("-")
        if len(parts) == 4:
            print(f"  Trace:          {parts[1]}  "
                  "(kpctl trace show <id>)")


def cmd_trace(c: Client, args) -> int:
    """The flight recorder's CLI surface (docs/reference/tracing.md):

        kpctl trace list           retained + ring traces, newest first
        kpctl trace show ID        the span tree, durations + attrs
        kpctl trace export ID      Chrome trace-event JSON (Perfetto /
                                   chrome://tracing, loadable next to an
                                   xprof device trace) to -o or stdout
    """
    if args.action in ("show", "export") and not args.id:
        raise SystemExit(f"kpctl trace {args.action} needs a trace id "
                         "(see `kpctl trace list`)")
    if args.action == "list":
        doc = c.request("GET", "/debug/traces")
        rows = [["TRACE", "ROOT", "SVC", "SPANS", "DURATION", "RETAINED",
                 "AGE"]]
        for t in doc.get("traces", []):
            rows.append([
                t["traceId"], t["root"], ",".join(t.get("svc", [])),
                str(t["spans"]), f"{t['durationMs']:.1f}ms",
                t.get("retained") or "-", _age(t.get("start"))])
        if len(rows) == 1:
            print("No traces retained.")
            stats = doc.get("stats", {})
            if stats:
                print(f"(started={stats.get('started', 0)} "
                      f"completed={stats.get('completed', 0)} "
                      f"retained={stats.get('retained', 0)})")
            return 0
        _print_rows(rows)
        return 0
    if args.action == "show":
        doc = c.request("GET", f"/debug/traces/{args.id}")
        spans = doc.get("spans", [])
        by_parent = {}
        by_id = {s["spanId"]: s for s in spans}
        for s in spans:
            pid = s.get("parentId")
            key = pid if pid in by_id else None   # remote/absent parent → root
            by_parent.setdefault(key, []).append(s)

        def walk(parent, depth):
            for s in sorted(by_parent.get(parent, []),
                            key=lambda x: x["start"]):
                attrs = {k: v for k, v in s.get("attrs", {}).items()
                         if k not in ("discard",)}
                extra = ("  " + " ".join(f"{k}={v}" for k, v in attrs.items())
                         if attrs else "")
                mark = " !" if s.get("status") == "error" else ""
                print(f"{'  ' * depth}{s['name']}  "
                      f"[{s.get('svc', '?')}] {s['durationMs']:.2f}ms"
                      f"{mark}{extra}")
                walk(s["spanId"], depth + 1)

        print(f"Trace:  {args.id}  ({len(spans)} spans)")
        walk(None, 0)
        return 0
    if args.action == "export":
        doc = c.request("GET", f"/debug/traces/{args.id}?format=chrome")
        text = json.dumps(doc, indent=1)
        if args.output_file:
            with open(args.output_file, "w") as f:
                f.write(text)
            print(f"wrote {len(doc.get('traceEvents', []))} events to "
                  f"{args.output_file}")
        else:
            print(text)
        return 0
    raise SystemExit(f"unknown trace action {args.action!r}")


def _fmt_ms(ms) -> str:
    try:
        return f"{float(ms):.1f}ms"
    except (TypeError, ValueError):
        return "-"


def _render_top(doc, server: str):
    """One frame of `kpctl top` from a /debug/vars document. Providers
    the control plane hasn't registered (direct mode has no watch hub;
    tracing may be off) simply drop their row's details."""
    p = doc.get("providers", {})

    def g(provider, key, default=0):
        return p.get(provider, {}).get(key, default)

    lines = [f"kpctl top — {server}   uptime "
             f"{doc.get('uptimeSeconds', 0):.0f}s   "
             f"providers {len(p)}", ""]
    lines.append(
        f"CLUSTER   nodes {g('cluster', 'nodes'):g}   "
        f"pods {g('cluster', 'pods'):g} "
        f"({g('cluster', 'pods_pending'):g} pending, "
        f"{g('cluster', 'pods_nominated'):g} nominated)   "
        f"claims {g('cluster', 'claims'):g} "
        f"({g('cluster', 'claims_deleting'):g} deleting)")
    degraded = sum(v for k, v in p.get("solver", {}).items()
                   if k.startswith("degraded_") and isinstance(v, (int, float)))
    lines.append(
        f"SOLVER    passes {g('provisioner', 'passes'):g}   "
        f"last {_fmt_ms(g('provisioner', 'last_pass_solve_ms', None))} "
        f"({g('provisioner', 'last_pass_pods'):g} pods)   "
        f"pipeline {'on' if g('solver', 'pipeline') else 'off'}   "
        f"mesh {g('solver', 'mesh_devices', 1):g}dev "
        f"({g('solver', 'mesh_solves'):g} sharded)   "
        f"async {g('solver', 'async_solves'):g}   "
        f"delta {g('solver', 'delta_solves'):g} "
        f"({g('solver', 'delta_dirty_groups'):g} dirty grp)   "
        f"micro {g('solver', 'micro_solves'):g} "
        f"({g('solver', 'micro_last_legs'):g} legs/pass, "
        f"{g('solver', 'micro_skipped_syncs'):g} skipped syncs)   "
        f"degraded {degraded:g}"
        + (f"   device {g('solver', 'device', '')}"
           if "device" in p.get("solver", {}) else ""))
    # the solver failover pool (docs/reference/solver-pool.md): endpoint
    # health, breaker states, failovers. Absent without --solver-address.
    if "solver_pool" in p:
        sp_ = p["solver_pool"]
        n_ep = sp_.get("endpoints", 0)
        states = []
        if isinstance(n_ep, (int, float)):
            for i in range(int(n_ep)):
                st = sp_.get(f"ep{i}_state")
                states.append({0: "closed", 1: "half-open",
                               2: "open"}.get(st, "?"))
        lines.append(
            f"POOL      {n_ep:g} endpoints "
            f"({sp_.get('healthy', 0):g} healthy)   "
            f"delegated {sp_.get('delegated_solves', 0):g}   "
            f"failovers {sp_.get('failovers', 0):g}   "
            f"local {sp_.get('local_solves', 0):g}   "
            f"breakers " + (",".join(states) or "-"))
    # the operator-handoff surface (docs/reference/handoff.md): role +
    # fence token, replication stream progress, fenced-write rejections.
    # Absent until wire_handoff() attached an elector to the operator.
    if "handoff" in p:
        ho = p["handoff"]
        role = "leader" if ho.get("leader") else "standby"
        seg = [f"LEADER    {role} (fence {ho.get('fence', 0):g}, "
               f"{ho.get('transitions', 0):g} transitions)   "
               f"fenced writes {ho.get('fenced_rejections', 0):g}   "
               f"leases swept {ho.get('leases_swept', 0):g}"]
        if "replica_anchor" in ho:
            rebuilds = (ho.get("replica_stale_anchor_rebuilds", 0)
                        + ho.get("replica_version_mismatch_rebuilds", 0))
            seg.append(
                f"HANDOFF   anchor {ho.get('replica_anchor', -1):g}   "
                f"snapshots {ho.get('replica_snapshots', 0):g}   "
                f"deltas {ho.get('replica_deltas', 0):g} "
                f"({ho.get('replica_delta_pods', 0):g} pods)   "
                f"rebuilds {rebuilds:g}   "
                f"prebuilds {ho.get('replica_prebuilds', 0):g}")
        elif "source_deltas" in ho:
            seg.append(
                f"HANDOFF   serving   "
                f"snapshots {ho.get('source_snapshots', 0):g}   "
                f"deltas {ho.get('source_deltas', 0):g} "
                f"({ho.get('source_full_answers', 0):g} full answers)")
        lines.extend(seg)
    rh, rm = g("solver", "resident_hits"), g("solver", "resident_misses")
    hitpct = 100.0 * rh / (rh + rm) if (rh + rm) else 0.0
    ph = g("solver", "resident_problem_hits")
    pm = g("solver", "resident_problem_misses")
    lines.append(
        f"CACHES    resident {hitpct:.0f}% hit ({rh:g}/{rh + rm:g})   "
        f"problem {ph:g}/{ph + pm:g}   "
        f"ICE {g('ice_cache', 'live'):g}   "
        f"est-cache {g('solver', 'est_cache_entries'):g}")
    lines.append(
        f"BATCH     window {g('provisioner', 'batch_pending'):g} pods "
        f"({g('provisioner', 'batch_age_seconds'):g}s)   "
        f"cloud drains {g('cloud_batcher', 'launch_batches'):g} launch / "
        f"{g('cloud_batcher', 'terminate_batches'):g} terminate")
    writer = p.get("writer", {})
    # numeric values only: a provider that errored reports {"error": str}
    # and must drop its row's details, not crash the view
    top_verbs = sorted(((k, v) for k, v in writer.items()
                        if isinstance(v, (int, float))),
                       key=lambda kv: -kv[1])[:4]
    lines.append("WRITER    " + ("   ".join(f"{k} {v:g}"
                                            for k, v in top_verbs)
                                 or "(no writes yet)"))
    if "watch_hub" in p:
        # deepest-queue + drop readouts fold from the headroom registry's
        # reading of the same probe when the observatory is live (one
        # source of truth); the hub's own stats remain the fallback
        hrp = p.get("headroom", {})
        deepest = (hrp["api_watch_queues_depth"]
                   if isinstance(hrp.get("api_watch_queues_depth"),
                                 (int, float))
                   else g("watch_hub", "watch_deepest"))
        wdrops = (hrp["api_watch_queues_drops"]
                  if isinstance(hrp.get("api_watch_queues_drops"),
                                (int, float))
                  else g("watch_hub", "watch_drops"))
        lines.append(
            f"WATCHES   {g('watch_hub', 'watchers'):g} watchers   "
            f"queue {g('watch_hub', 'watch_queue_depth'):g} "
            f"(deepest {deepest:g}, "
            f"hw {g('watch_hub', 'watch_max_depth'):g})   "
            f"delivered {g('watch_hub', 'events_emitted'):g}   "
            f"bulk {g('watch_hub', 'bulk_ops'):g}   "
            f"drops {wdrops:g}")
    lines.append(
        f"EVENTS    {g('events', 'published'):g} published "
        f"({g('events', 'warnings'):g} warnings)")
    # the decision-audit ring (docs/reference/explain.md): last pass's
    # unschedulable count + the top cumulative reason codes
    ex = p.get("explain", {})
    if isinstance(ex.get("passes"), (int, float)):
        top_reasons = sorted(
            ((k[len("reason_"):].replace("_", "-"), v)
             for k, v in ex.items()
             if k.startswith("reason_") and isinstance(v, (int, float))),
            key=lambda kv: -kv[1])[:3]
        lines.append(
            f"EXPLAIN   passes {ex.get('passes', 0):g} "
            f"(ring {ex.get('ring', 0):g})   "
            f"last unschedulable {ex.get('last_unschedulable', 0):g}   "
            + ("reasons " + "  ".join(f"{k} {v:g}" for k, v in top_reasons)
               if top_reasons else "no unschedulable reasons recorded"))
    # the vmapped consolidation engine (docs/reference/consolidation.md):
    # batched dispatch/cache/fallback counters, accepted savings, and the
    # top skip codes ("why was this node NOT consolidated")
    co = p.get("consolidation", {})
    if isinstance(co.get("vmapped_whatifs"), (int, float)):
        top_skips = sorted(
            ((k[len("skip_"):].replace("_", "-"), v)
             for k, v in co.items()
             if k.startswith("skip_") and isinstance(v, (int, float))),
            key=lambda kv: -kv[1])[:3]
        lines.append(
            f"CONSOLIDATION dispatches {co.get('vmapped_whatifs', 0):g} "
            f"({co.get('batched_candidates', 0):g} sets)   "
            f"cached {co.get('fp_unchanged', 0):g}   "
            f"host {co.get('host_fallbacks', 0):g}   "
            f"accepted {co.get('accepted', 0):g} "
            f"({co.get('nodes_consolidated', 0):g} nodes, "
            f"${co.get('savings_per_hour', 0):.2f}/hr saved)   "
            f"referee {co.get('referee_rejects', 0):g}/"
            f"{co.get('referee_checks', 0):g} rejects"
            + ("   skips " + "  ".join(f"{k} {v:g}" for k, v in top_skips)
               if top_skips else ""))
    if "weather" in p:
        w = p["weather"]
        lines.append(
            f"WEATHER   {w.get('scenario', '?')} tick {w.get('ticks', 0):g}  "
            f" storms {w.get('storms_active', 0):g} active   "
            f"ICE {w.get('ice_pools', 0):g} pools   "
            f"spot x{w.get('spot_mult_mean', 1.0):.2f} "
            f"(max x{w.get('spot_mult_max', 1.0):.2f})   "
            f"msgs {w.get('messages_sent', 0):g} "
            f"({w.get('junk_sent', 0):g} junk)")
    if "interruption" in p:
        intr = p["interruption"]
        kinds = "   ".join(
            f"{k[len('received_'):].replace('_', '-')} {v:g}"
            for k, v in sorted(intr.items())
            if k.startswith("received_") and isinstance(v, (int, float)))
        lines.append(
            f"INTERRUPT queue {intr.get('queue_depth', 0):g}   "
            + (kinds or "(no messages)")
            + (f"   handler-errors {intr.get('handler_errors', 0):g}"
               if intr.get("handler_errors") else ""))
    # top-3 contended locks by wait p99 (the contention provider's
    # flattened `<lock>_wait_p99_ms` keys; introspect/contention.py)
    cont = p.get("contention", {})
    ranked = sorted(
        ((k[:-len("_wait_p99_ms")], v, cont.get(
            k[:-len("_wait_p99_ms")] + "_contended", 0))
         for k, v in cont.items()
         if k.endswith("_wait_p99_ms") and isinstance(v, (int, float))
         and v > 0),
        key=lambda t: -t[1])[:3]
    if cont:
        # LOCKORDER cell: the acquisition-order witness's edge/cycle
        # counts (introspect/contention.py; /debug/pprof/lockorder).
        # Numeric values only — a provider reporting the registry's
        # {"error"} shape drops the cell, not the view
        lo = p.get("lockorder", {})
        lo_cell = ""
        if isinstance(lo.get("edges"), (int, float)) \
                and isinstance(lo.get("cycles"), (int, float)):
            cyc = lo["cycles"]
            lo_cell = (f"   LOCKORDER {lo['edges']:g} edges / "
                       f"{cyc:g} cycles"
                       + (" !!DEADLOCK RISK" if cyc else ""))
        lines.append("CONTENTION " + ("   ".join(
            f"{name} p99 {_fmt_ms(p99)} ({int(n):d}x)"
            for name, p99, n in ranked) or "(no contended locks)")
            + lo_cell)
    # measured-vs-modeled device attribution (solver/costmodel.py)
    dev = p.get("device", {})
    if dev.get("last_compute_ms"):
        lines.append(
            f"DEVICE    compute {_fmt_ms(dev.get('last_compute_ms'))} "
            f"(model {_fmt_ms(dev.get('last_model_ms'))}, "
            f"{dev.get('last_vs_model', 0):.2f}x)   "
            f"shapes {dev.get('shapes', 0):g}   "
            f"hbm {dev.get('bytes_in_use', 0) / 2**20:.0f}MiB")
    prof = p.get("profiler", {})
    if prof.get("enabled"):
        lines.append(
            f"PROFILER  {prof.get('samples', 0):g} samples @ "
            f"{prof.get('hz', 0):g}Hz   "
            f"{prof.get('unique_stacks', 0):g} stacks   "
            f"overhead {prof.get('overhead_pct', 0):.1f}%")
    slo = p.get("slo", {})
    lines.append(
        f"SLO       latency burn {slo.get('latency_burn', 0):.2f} "
        f"(p50 {_fmt_ms(slo.get('latency_p50_ms'))} / "
        f"{slo.get('latency_budget_ms', 200):g}ms)   "
        f"cost burn {slo.get('cost_burn', 0):.2f} "
        f"(ratio {slo.get('cost_ratio_p50', 0):.4f})   "
        f"captures {p.get('burn_captures', {}).get('retained', 0):g}")
    # the saturation observatory (docs/reference/headroom.md): resource
    # count, the first-to-break forecast, and saturation-episode totals.
    # Numeric guard: an errored provider must drop the cell, not the view
    hrs = p.get("headroom", {})
    if isinstance(hrs.get("resources"), (int, float)):
        tte = hrs.get("min_tte_seconds", -1.0)
        first = hrs.get("first_to_break") or ""
        fcast = (f"first-to-break {first} in {tte:g}s"
                 if first and isinstance(tte, (int, float)) and tte >= 0
                 else "no exhaustion forecast")
        lines.append(
            f"HEADROOM  {hrs.get('resources', 0):g} resources   {fcast}   "
            f"saturated {hrs.get('saturated', 0):g}   "
            f"episodes {hrs.get('episodes', 0):g}   "
            f"probe-errors {hrs.get('probe_errors', 0):g}")
    fr = p.get("flight_recorder", {})
    if fr.get("enabled", True) is not False:
        lines.append(
            f"TRACES    started {fr.get('started', 0):g}   "
            f"retained {fr.get('retained', 0):g}")
    return lines


def cmd_top(c: Client, args) -> int:
    """Live terminal view of /debug/vars (docs/reference/introspection.md):
    nodes / pending pods / solver cadence / queue depths / cache hit
    rates, refreshed in place. ``--once`` prints a single frame (tests,
    scripting, piping)."""
    while True:
        # Ctrl-C can land mid-request just as easily as mid-sleep: the
        # whole iteration exits cleanly, never a traceback over the
        # cleared screen
        try:
            doc = c.request("GET", "/debug/vars")
            frame = "\n".join(_render_top(doc, c.server))
            if args.once:
                print(frame)
                return 0
            # clear + home, then one frame — flicker-free enough for a
            # status view without a curses dependency
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            WALL.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _load_folded(path) -> dict:
    """A collapsed-stack file → {folded_stack: count} (comment lines and
    blanks skipped)."""
    out = {}
    raw = sys.stdin.read() if path == "-" else open(path).read()
    for line in raw.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        stack, _, count = line.rpartition(" ")
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


def cmd_profile(c, args) -> int:
    """The sampling profiler's CLI (docs/reference/profiling.md):

        kpctl profile capture [-o FILE] [--format folded|chrome|json]
                                  snapshot the live profile — folded
                                  collapsed stacks (flamegraph.pl /
                                  speedscope input) or Chrome trace JSON
        kpctl profile top [-n N]  top frames by inclusive samples
        kpctl profile diff A B    frame-level delta of two folded files
                                  (before/after a fix; local, no server)
    """
    if args.action in ("capture", "top") and args.files:
        # stray positionals would be silently ignored — a user who
        # forgot `-o` must not get "exit 0, no file written"
        raise SystemExit(
            f"kpctl profile {args.action} takes no positional arguments "
            f"(got {args.files}); use -o FILE for capture output")
    if args.action == "capture":
        fmt = args.format
        path = ("/debug/pprof/profile" if fmt == "folded"
                else f"/debug/pprof/profile?format={fmt}")
        body = c.request("GET", path, raw=True)
        # the disabled marker differs by form: folded is a comment line,
        # chrome/json serve {"enabled": false} — both must exit 1, never
        # write a useless stub file
        disabled = body.startswith(b"# profiler disabled")
        if not disabled and fmt != "folded":
            try:
                doc = json.loads(body)
                disabled = (isinstance(doc, dict)
                            and doc.get("enabled") is False)
            except ValueError:
                pass
        if disabled:
            print("profiler is not running (start the control plane "
                  "with --profile)", file=sys.stderr)
            return 1
        if args.output_file:
            with open(args.output_file, "wb") as f:
                f.write(body)
            n = len(body.splitlines()) if fmt == "folded" else len(body)
            unit = "stacks" if fmt == "folded" else "bytes"
            print(f"wrote {n} {unit} to {args.output_file}")
        else:
            sys.stdout.write(body.decode())
        return 0
    if args.action == "top":
        doc = c.request("GET",
                        f"/debug/pprof/profile?format=json&n={args.n}")
        if not doc.get("enabled", True):
            print("profiler is not running (start the control plane "
                  "with --profile)", file=sys.stderr)
            return 1
        # % of all sampled THREAD-STACKS (a frame on every thread of an
        # N-thread process tops out at 100%, not N x 100%)
        total = max(doc.get("stack_samples", doc.get("samples", 0)), 1)
        rows = [["FRAME", "INCL", "SELF", "INCL%"]]
        for fr in doc.get("top", [])[: args.n]:
            rows.append([fr["frame"], str(fr["inclusive"]),
                         str(fr["self"]),
                         f"{100.0 * fr['inclusive'] / total:.1f}%"])
        print(f"profile: {doc.get('samples', 0)} samples @ "
              f"{doc.get('hz', 0):g}Hz, {doc.get('unique_stacks', 0)} "
              f"unique stacks, overhead {doc.get('overhead_pct', 0):.2f}%")
        _print_rows(rows)
        return 0
    if args.action == "diff":
        if len(args.files) != 2:
            raise SystemExit("kpctl profile diff needs exactly two "
                             "folded files (before after)")
        a, b = (_load_folded(p) for p in args.files)
        # per-frame inclusive deltas (a frame's count = sum of stacks
        # containing it, deduped per stack like the server's top())
        def incl(folded):
            out = {}
            for stack, n in folded.items():
                for fr in set(stack.split(";")[1:]):
                    out[fr] = out.get(fr, 0) + n
            return out
        ia, ib = incl(a), incl(b)
        deltas = sorted(((ib.get(f, 0) - ia.get(f, 0), f)
                         for f in set(ia) | set(ib)),
                        key=lambda t: -abs(t[0]))
        rows = [["DELTA", "BEFORE", "AFTER", "FRAME"]]
        for d, f in deltas[: args.n]:
            if d == 0:
                continue
            rows.append([f"{d:+d}", str(ia.get(f, 0)), str(ib.get(f, 0)), f])
        if len(rows) == 1:
            print("no frame-level differences")
            return 0
        _print_rows(rows)
        return 0
    raise SystemExit(f"unknown profile action {args.action!r}")


def cmd_soak(c, args) -> int:
    """Summarize a soak/monitor time-series artifact — a LOCAL file, no
    server needed. Reads both plain ``.json`` and gzipped ``.json.gz``
    forms (debug.load_timeseries sniffs the magic, not the suffix)."""
    from ..debug import load_timeseries
    doc = load_timeseries(args.path)
    summ = doc.get("summary", {})
    samples = doc.get("samples", [])
    print(f"soak artifact {args.path}")
    print(f"  samples {len(samples)}   wall "
          f"{summ.get('wall_seconds', 0):g}s")
    print(f"  peak nodes {summ.get('peak_nodes', 0):g}   "
          f"peak pending {summ.get('peak_pending_pods', 0):g}   "
          f"peak cost/hr {summ.get('peak_cost_per_hour', 0):g}")
    if "peak_latency_burn" in summ:
        print(f"  peak latency burn {summ['peak_latency_burn']:g}   "
              f"peak cost burn {summ.get('peak_cost_burn', 0):g}")
    if "peak_lock_wait_ms" in summ:
        # the contention provider's series envelope (debug.Monitor):
        # the worst lock wait the run ever saw, next to the burn peaks
        print(f"  peak lock wait {summ['peak_lock_wait_ms']:g}ms "
              f"({summ.get('peak_lock_wait_lock', '?')})")
    caps = (summ.get("final", {}).get("subsystems", {})
            .get("burn_captures", {}))
    if caps.get("total"):
        print(f"  burn captures {caps.get('total', 0):g} "
              f"(retained {caps.get('retained', 0):g}, "
              f"last {caps.get('last_reason', '?')})")
    final = summ.get("final", {})
    slo = final.get("subsystems", {}).get("slo", {})
    if slo:
        print(f"  final latency burn {slo.get('latency_burn', 0):g} "
              f"(p50 {slo.get('latency_p50_ms', 0):g}ms)   "
              f"warmup dropped {slo.get('warmup_dropped', 0):g}")
    solver = final.get("subsystems", {}).get("solver", {})
    if solver:
        print(f"  final delta solves {solver.get('delta_solves', 0):g}   "
              f"resident-problem hits "
              f"{solver.get('resident_problem_hits', 0):g}")
    return 0


def cmd_lockorder(c: Client, args) -> int:
    """Dump the lock-order witness (docs/reference/linting.md): the
    acquisition-order graph InstrumentedLock records, every edge's
    hold count, and any cycles — each cycle printed with ALL member
    edges' witness stacks (the code paths that can deadlock)."""
    doc = c.request("GET", "/debug/pprof/lockorder")
    if not isinstance(doc, dict) or "edges" not in doc:
        # tolerate the registry's {"error"} provider shape (and any
        # other malformed body) like the WRITER-row fix
        print(f"lockorder: unavailable ({doc.get('error', 'bad response')})"
              if isinstance(doc, dict) else "lockorder: bad response")
        return 1
    edges = doc.get("edges", {})
    cycles = doc.get("cycles", [])
    print(f"lockorder: {len(edges)} edges, {len(cycles)} cycles"
          f"{'' if doc.get('enabled', True) else '   (accounting DISABLED)'}")
    for name in sorted(edges):
        e = edges[name]
        count = e.get("count", 0) if isinstance(e, dict) else 0
        print(f"  {name}   ({count:g}x)")
        if args.stacks and isinstance(e, dict):
            for fr in e.get("stack", []):
                print(f"      {fr}")
    for cyc in cycles:
        locks = cyc.get("locks", []) if isinstance(cyc, dict) else []
        print(f"CYCLE (potential deadlock): {' -> '.join(locks)} -> "
              f"{locks[0] if locks else '?'}")
        for m in (cyc.get("edges", []) if isinstance(cyc, dict) else []):
            print(f"  witness {m.get('edge')}   ({m.get('count', 0):g}x)")
            for fr in m.get("stack", []):
                print(f"      {fr}")
    return 1 if cycles else 0


def _fmt_tte(tte) -> str:
    """Seconds-to-exhaustion cell: None = nothing forecast to break."""
    if not isinstance(tte, (int, float)):
        return "-"
    if tte >= 3600:
        return f"{tte / 3600:.1f}h"
    if tte >= 60:
        return f"{tte / 60:.1f}m"
    return f"{tte:.1f}s"


def _render_headroom(doc: dict) -> int:
    """The ranked first-to-break table from one /debug/headroom doc."""
    if not isinstance(doc, dict) or doc.get("enabled") is False \
            or "resources" not in doc:
        # tolerate the provider-less shape (operator still constructing)
        # and the registry's {"error"} shape like the lockorder command
        msg = (doc.get("message") or doc.get("error") or "bad response") \
            if isinstance(doc, dict) else "bad response"
        print(f"headroom: unavailable ({msg})")
        return 1
    rows = [["RESOURCE", "KIND", "DEPTH", "CAP", "OCC%", "HIGHWATER",
             "DROPS", "FILL/s", "EXHAUSTION"]]
    for r in doc["resources"]:
        if r.get("error"):
            rows.append([r.get("resource", "?"), "error", "-", "-", "-",
                         "-", "-", "-", str(r["error"])[:40]])
            continue
        cap = r.get("capacity", 0)
        rows.append([
            r.get("resource", "?"), r.get("kind", "queue"),
            f"{r.get('depth', 0):g}",
            f"{cap:g}" if cap else "inf",
            f"{100 * r.get('occupancy', 0):.0f}" if cap else "-",
            f"{r.get('highwater', 0):g}",
            f"{r.get('drops', 0):g}",
            f"{r.get('fill_rate', 0):.3g}",
            _fmt_tte(r.get("seconds_to_exhaustion")),
        ])
    print(f"headroom: {len(doc['resources'])} resources   "
          f"high-water fraction {doc.get('high_water_fraction', 0.9):g}   "
          f"probe errors {doc.get('probe_errors', 0):g}")
    _print_rows(rows)
    return 0


def cmd_headroom(c: Client, args) -> int:
    """The saturation observatory (docs/reference/headroom.md): every
    registered bounded resource's occupancy, monotonic high water,
    drop count, EWMA fill rate, and time-to-exhaustion forecast,
    ranked first-to-break. ``--watch`` refreshes in place."""
    while True:
        try:
            doc = c.request("GET", "/debug/headroom")
            if not args.watch:
                return _render_headroom(doc)
            sys.stdout.write("\x1b[2J\x1b[H")
            _render_headroom(doc)
            sys.stdout.flush()
            WALL.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _render_waterfall(g: dict, indent: str = "  ") -> None:
    """One group's elimination waterfall (the /debug/explain group doc):
    stage rows down to 'eliminated by ice: N offerings (...)'."""
    print(f"{indent}Group:   {g.get('label', '?')}   "
          f"({g.get('pods', 0)} pods, {g.get('poolsOk', 0)}/"
          f"{g.get('poolsTotal', 0)} nodepools compatible)")
    for n in g.get("notes", []):
        print(f"{indent}Note:    {n}")
    rows = [["STAGE", "REMAINING", "ELIMINATED", ""]]
    for s in g.get("stages", []):
        ex = s.get("examples") or []
        detail = ""
        if s.get("eliminated"):
            detail = (f"eliminated by {s['stage']}: "
                      f"{s['eliminated']} offerings")
            if ex:
                detail += f" (e.g. {', '.join(ex)})"
        rows.append([s["stage"], str(s["remaining"]),
                     str(s.get("eliminated", 0)) if s["stage"] != "offered"
                     else "-", detail])
    _print_rows(rows, indent=indent)


def _render_rationale(r: dict, indent: str = "  ") -> None:
    line = (f"{r.get('instanceType', '?')}/{r.get('zone', '?')}/"
            f"{r.get('capacityType', '?')} at "
            f"${r.get('pricePerHour', 0):g}/hr for {r.get('pods', 0)} "
            f"pod(s), {r.get('flexibleTypes', 0)} flexible types")
    print(f"{indent}Chosen:    {line}")
    if "runnerUpType" in r:
        print(f"{indent}Runner-up: {r['runnerUpType']} at "
              f"${r.get('runnerUpPricePerHour', 0):g}/hr "
              f"({r.get('runnerUpPriceDelta', 0):+g}/hr)")


def cmd_explain(c: Client, args) -> int:
    """The decision-explainability surface (docs/reference/explain.md):

        kpctl explain pod NAME        why is this pod pending — the
                                      per-stage elimination waterfall
                                      (or where it was placed, and why)
        kpctl explain nodeclaim NAME  the claim's placement rationale
                                      (chosen offering, runner-up,
                                      price delta)
        kpctl explain node NAME       why was this node NOT consolidated
                                      — the engine's latest coded skip
                                      (solver/taxonomy.py) for the node
        kpctl explain pass [ID]       one pass's full decision audit
                                      (default: the newest pass)
    """
    if args.what in ("pod", "nodeclaim", "node") and not args.name:
        raise SystemExit(f"kpctl explain {args.what} needs a name")
    if args.what == "pod":
        doc = c.request("GET", f"/debug/explain?pod={args.name}")
        if doc.get("found") is False or doc.get("enabled") is False:
            print(doc.get("message", f"pod {args.name!r} not found in "
                                     "the decision-audit ring"))
            return 1
        print(f"Pod:     {doc.get('pod')}   (pass {doc.get('pass', '?')}"
              + (f", trace {doc['traceId']}" if doc.get("traceId") else "")
              + ")")
        if doc.get("outcome") == "scheduled":
            print(f"Outcome: scheduled -> {doc.get('node', '?')}")
            if doc.get("rationale"):
                _render_rationale(doc["rationale"])
            return 0
        print(f"Outcome: {doc.get('outcome')}")
        print(f"Reason:  {doc.get('reason', '')}")
        if doc.get("group"):
            _render_waterfall(doc["group"])
        return 0
    if args.what == "nodeclaim":
        doc = c.request("GET", f"/debug/explain?nodeclaim={args.name}")
        if doc.get("found") is False or doc.get("enabled") is False:
            print(doc.get("message", f"nodeclaim {args.name!r} not found "
                                     "in the decision-audit ring"))
            return 1
        print(f"NodeClaim: {doc.get('nodeclaim')}   "
              f"(pass {doc.get('pass', '?')}"
              + (f", trace {doc['traceId']}" if doc.get("traceId") else "")
              + ")")
        _render_rationale(doc.get("rationale", {}))
        return 0
    if args.what == "node":
        doc = c.request("GET", f"/debug/explain?node={args.name}")
        if doc.get("found") is False or doc.get("enabled") is False:
            print(doc.get("message", f"node {args.name!r} has no recorded "
                                     "skip decision"))
            return 1
        print(f"Node:    {doc.get('node')}")
        print(f"Skip:    {doc.get('code', '?')}"
              + (f"   (x{doc['count']:g} this episode)"
                 if doc.get("count", 0) > 1 else ""))
        if doc.get("detail"):
            print(f"Detail:  {doc['detail']}")
        print(f"At:      t={doc.get('t', 0)}s")
        return 0
    # pass
    q = f"?pass={args.name}" if args.name else ""
    doc = c.request("GET", f"/debug/explain{q}")
    if not args.name:
        passes = doc.get("passes", [])
        if not passes:
            print("No passes recorded in the decision-audit ring.")
            return 1
        doc = c.request("GET", f"/debug/explain?pass={passes[-1]['pass']}")
    if doc.get("found") is False or doc.get("enabled") is False:
        print(f"pass {args.name!r} not in the decision-audit ring")
        return 1
    print(f"Pass:          {doc.get('pass')}"
          + (f"   trace {doc['traceId']}" if doc.get("traceId") else ""))
    print(f"Pods:          {doc.get('pods', 0)}   "
          f"groups {doc.get('groups', 0)}   "
          f"unschedulable {doc.get('unschedulable', 0)}   "
          f"placements {doc.get('placements', 0)}")
    if doc.get("degradedReason"):
        print(f"Degraded:      {doc['degradedReason']}")
    if doc.get("note"):
        print(f"Note:          {doc['note']}")
    reasons = doc.get("reasons", {})
    if reasons:
        print("Reasons:       " + "   ".join(
            f"{k} {v}" for k, v in sorted(reasons.items())))
    elim = doc.get("eliminations", {})
    if elim:
        print("Eliminations:  " + "   ".join(
            f"{k} {v}" for k, v in sorted(elim.items())))
    shown = 0
    for g in doc.get("groupDetails", []):
        if g.get("unplaced") or g.get("dropped") or shown < 3:
            print(f"-- {'UNPLACED ' if g.get('unplaced') else ''}"
                  f"{'(dropped at build) ' if g.get('dropped') else ''}"
                  f"code={g.get('code', '') or '-'} "
                  f"placed={g.get('placed', 0)} "
                  f"unplaced={g.get('unplaced', 0)}")
            _render_waterfall(g)
            shown += 1
    claims = doc.get("claims", {})
    for name, r in sorted(claims.items()):
        print(f"-- NodeClaim {name}")
        _render_rationale(r)
    return 0


def cmd_evict(c: Client, args) -> int:
    force = "?force=1" if args.force else ""
    try:
        c.request("POST", f"/apis/pods/{args.name}/eviction{force}")
    except urllib.error.HTTPError as e:
        if e.code == 429:
            print(f"pod/{args.name} eviction blocked by a "
                  "PodDisruptionBudget", file=sys.stderr)
            return 1
        raise
    print(f"pod/{args.name} evicted")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kpctl", description=__doc__)
    p.add_argument("--server", default=os.environ.get("KPCTL_SERVER"),
                   help="API base URL, e.g. https://127.0.0.1:8443 "
                        "(env KPCTL_SERVER)")
    p.add_argument("--token", default=os.environ.get("KPCTL_TOKEN"))
    p.add_argument("--token-file", default=None)
    p.add_argument("--cacert", default=None,
                   help="PEM bundle to trust (deploy/certs/tls.crt)")
    p.add_argument("--insecure-skip-tls-verify", action="store_true")
    sub = p.add_subparsers(dest="verb", required=True)

    g = sub.add_parser("get")
    g.add_argument("kind")
    g.add_argument("name", nargs="?")
    g.add_argument("-o", "--output",
                   choices=("table", "wide", "json", "yaml"),
                   default="table")
    g.set_defaults(fn=cmd_get)

    a = sub.add_parser("apply")
    a.add_argument("-f", "--filename", required=True,
                   help="YAML/JSON file of {kind, spec} documents "
                        "('-' = stdin)")
    a.set_defaults(fn=cmd_apply)

    d = sub.add_parser("delete")
    d.add_argument("kind")
    d.add_argument("name")
    d.add_argument("--force", action="store_true")
    d.set_defaults(fn=cmd_delete)

    w = sub.add_parser("watch")
    w.add_argument("kind")
    w.add_argument("--resource-version", type=int, default=None)
    w.add_argument("--once", action="store_true",
                   help="exit after the first event (scripting)")
    w.set_defaults(fn=cmd_watch)

    e = sub.add_parser("evict")
    e.add_argument("name")
    e.add_argument("--force", action="store_true")
    e.set_defaults(fn=cmd_evict)

    ds = sub.add_parser("describe")
    ds.add_argument("kind")
    ds.add_argument("name")
    ds.set_defaults(fn=cmd_describe)

    ar = sub.add_parser("api-resources")
    ar.set_defaults(fn=cmd_api_resources)

    tp = sub.add_parser(
        "top", help="live subsystem view against /debug/vars "
                    "(docs/reference/introspection.md)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit (scripting/tests)")
    tp.set_defaults(fn=cmd_top)

    tr = sub.add_parser(
        "trace", help="flight-recorder traces (requires --trace on the "
                      "control plane; docs/reference/tracing.md)")
    tr.add_argument("action", nargs="?", default="list",
                    choices=("list", "show", "export"))
    tr.add_argument("id", nargs="?", default=None,
                    help="trace id (show/export)")
    tr.add_argument("-o", "--output-file", default=None,
                    help="export: write Chrome trace-event JSON here "
                         "(default stdout)")
    tr.set_defaults(fn=cmd_trace)

    lo = sub.add_parser(
        "lockorder", help="dump the lock acquisition-order witness graph "
                          "(/debug/pprof/lockorder; docs/reference/"
                          "linting.md) — edges, cycles, witness stacks")
    lo.add_argument("--stacks", action="store_true",
                    help="also print each edge's first-witness stack "
                         "(cycle edges always print theirs)")
    lo.set_defaults(fn=cmd_lockorder)

    hrp = sub.add_parser(
        "headroom", help="ranked first-to-break table of every bounded "
                         "resource (/debug/headroom; docs/reference/"
                         "headroom.md) — occupancy, fill rate, "
                         "time-to-exhaustion forecast")
    hrp.add_argument("--watch", action="store_true",
                     help="refresh the table in place until Ctrl-C")
    hrp.add_argument("--interval", type=float, default=2.0,
                     help="watch refresh period in seconds (default 2)")
    hrp.set_defaults(fn=cmd_headroom)

    exp = sub.add_parser(
        "explain", help="why was this decision made — per-pod elimination "
                        "waterfall, claim placement rationale, pass audit "
                        "(/debug/explain; docs/reference/explain.md)")
    exp.add_argument("what", choices=("pod", "nodeclaim", "node", "pass"))
    exp.add_argument("name", nargs="?", default=None,
                     help="pod/nodeclaim name, or pass id (default: "
                          "newest pass)")
    exp.set_defaults(fn=cmd_explain)

    sk = sub.add_parser(
        "soak", help="summarize a soak time-series artifact (local file, "
                     ".json or .json.gz — no server needed)")
    sk.add_argument("path")
    sk.set_defaults(fn=cmd_soak, local=True)

    pf = sub.add_parser(
        "profile", help="sampling-profiler surface (requires --profile on "
                        "the control plane; docs/reference/profiling.md)")
    pf.add_argument("action", choices=("capture", "top", "diff"))
    pf.add_argument("files", nargs="*", default=[],
                    help="diff: two folded files (before after)")
    pf.add_argument("-o", "--output-file", default=None,
                    help="capture: write here instead of stdout")
    pf.add_argument("--format", choices=("folded", "chrome", "json"),
                    default="folded",
                    help="capture format: folded collapsed stacks "
                         "(flamegraph.pl/speedscope), Chrome trace JSON "
                         "(Perfetto), or the top-frames JSON")
    pf.add_argument("-n", type=int, default=25,
                    help="top/diff: rows to show")
    pf.set_defaults(fn=cmd_profile)

    args = p.parse_args(argv)
    if getattr(args, "verb", "") == "profile" and args.action == "diff":
        args.local = True   # diff compares two local files, no server
    c = None
    if not getattr(args, "local", False):
        if not args.server:
            raise SystemExit("--server (or KPCTL_SERVER) is required")
        token = args.token
        if args.token_file:
            token = open(args.token_file).read().strip()
        c = Client(args.server, token=token, cacert=args.cacert,
                   insecure=args.insecure_skip_tls_verify)
    try:
        rc = args.fn(c, args)
        # flush INSIDE the try: for outputs under the pipe buffer the
        # EPIPE only fires at flush time, and an interpreter-shutdown
        # flush would bypass the handler below ("Exception ignored"
        # noise, exit 120)
        sys.stdout.flush()
        return rc
    except urllib.error.HTTPError as err:
        try:
            doc = json.loads(err.read())
            msg = doc.get("message", "")
        except Exception:
            msg = ""
        print(f"error: {err.code} {msg}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # downstream closed early (`kpctl get -o json | head`): exit
        # quietly like kubectl, with the conventional 128+SIGPIPE code.
        # stdout is already broken — devnull it so interpreter shutdown
        # doesn't print a second traceback flushing the dead buffer
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 141


if __name__ == "__main__":
    raise SystemExit(main())
