"""HTTP REST surface over the FakeAPIServer — the wire-reachable seam.

In-process, controllers speak to the apiserver through KubeClient. This
module serves the SAME verbs over HTTP so an external agent (kubectl-
style tooling, a non-Python writer, another host) can drive the control
plane across a process boundary — the last step of the reference's
ingest story (its controllers talk to a remote apiserver over REST;
SURVEY §1 L0). Routes, mirroring the k8s path shapes:

    GET    /apis                           discovery → {kinds: [...]}
    GET    /apis/{kind}                    list → {items, resourceVersion}
    GET    /apis/{kind}?watch=1&resourceVersion=N
                                           chunked JSON-lines watch stream
    GET    /apis/{kind}/{name}             get → envelope
    POST   /apis/{kind}                    create (spec body) → envelope
    PUT    /apis/{kind}/{name}             update (full envelope body)
    PATCH  /apis/{kind}/{name}             merge patch {spec?, status?,
                                           finalizers?}
    DELETE /apis/{kind}/{name}[?force=1]   delete (finalizer-aware)
    POST   /apis/pods/{name}/binding       {"nodeName": ...}
    POST   /apis/pods/{name}/eviction[?force=1]

Error mapping is the real protocol's: 401 Unauthorized (bad/missing
bearer token when auth is enabled), 404 NotFound, 409 Conflict /
AlreadyExists, 410 Gone (watch too old), 422 Invalid (admission, with
causes), 429 eviction blocked by a PodDisruptionBudget.

The watch stream emits one JSON object per line ({type, object,
resourceVersion}) and a periodic heartbeat line so half-open
connections die; it ends when the client disconnects.

Transport security (the real apiserver's posture): pass ``token`` to
require ``Authorization: Bearer <token>`` on every request, and
``certfile``/``keyfile`` to serve HTTPS (deploy/gen_certs.sh mints
self-signed material at render time, the analog of the reference
chart's secret-webhook-cert.yaml). The CLI refuses to bind this
surface beyond loopback without both unless --api-insecure is given.
"""

from __future__ import annotations

import hmac
import json
import ssl
import threading
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .. import introspect, trace
from ..apis import wellknown as wk
from .apiserver import (
    KINDS, AlreadyExistsError, APIError, ConflictError,
    EvictionBlockedError, FakeAPIServer, InvalidObjectError, NotFoundError,
    TooOldError,
)

WATCH_HEARTBEAT_SECONDS = 15.0


def check_bearer(auth_header: Optional[str], token: str) -> bool:
    """Constant-time check of an ``Authorization: Bearer`` header."""
    if not auth_header or not auth_header.startswith("Bearer "):
        return False
    # bytes on both sides: compare_digest(str, str) raises on the
    # non-ASCII header an arbitrary client can send
    return hmac.compare_digest(
        auth_header[len("Bearer "):].encode("utf-8", "surrogateescape"),
        token.encode("utf-8"))


class TLSThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that performs the TLS handshake in the
    PER-CONNECTION thread (finish_request), not in accept(): wrapping the
    listening socket would run do_handshake inside serve_forever, where
    one stalled client (``nc host port`` sending nothing) blocks every
    other connection — including /healthz, so the kubelet would kill the
    pod. A handshake timeout bounds the slow-client window."""

    HANDSHAKE_TIMEOUT = 10.0

    def __init__(self, addr, handler, certfile: str, keyfile: Optional[str]):
        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.load_cert_chain(certfile, keyfile)
        super().__init__(addr, handler)

    def finish_request(self, request, client_address):
        request.settimeout(self.HANDSHAKE_TIMEOUT)
        try:
            request = self._ctx.wrap_socket(request, server_side=True)
        except (ssl.SSLError, OSError):
            # plaintext probe / handshake garbage: drop quietly
            try:
                request.close()
            except OSError:
                pass
            return
        request.settimeout(None)
        super().finish_request(request, client_address)


def maybe_gzip(body: bytes, accept_encoding: Optional[str],
               min_bytes: int = 256) -> Tuple[bytes, Optional[str]]:
    """Gzip a response body when the client advertised support.

    Returns ``(body, content_encoding-or-None)``. The introspection
    payloads this serves grew real: /debug/vars?series=1 carries 600-
    sample rings x per-subsystem series (hundreds of KB) and a kpctl
    top session polls it every 2 s — so both debug surfaces and /metrics
    honor ``Accept-Encoding: gzip``. Tiny bodies pass through (the
    header costs more than it saves)."""
    if not accept_encoding or "gzip" not in accept_encoding.lower() \
            or len(body) < min_bytes:
        return body, None
    import gzip
    return gzip.compress(body, compresslevel=6), "gzip"


def make_http_server(addr, handler, certfile: Optional[str] = None,
                     keyfile: Optional[str] = None) -> ThreadingHTTPServer:
    """The one place HTTP(S) servers are built (REST apiserver + the
    CLI's metrics/webhook server): plaintext ThreadingHTTPServer, or the
    per-connection-handshake TLS variant when a cert is given."""
    if certfile:
        return TLSThreadingHTTPServer(addr, handler, certfile, keyfile)
    return ThreadingHTTPServer(addr, handler)


def _route(path: str) -> Tuple[str, Optional[str], Optional[str]]:
    """'/apis/pods/p0/binding' → ('pods', 'p0', 'binding')."""
    parts = [p for p in path.split("/") if p]
    if len(parts) < 2 or parts[0] != "apis":
        raise NotFoundError(f"no route {path}")
    kind = parts[1]
    name = parts[2] if len(parts) > 2 else None
    sub = parts[3] if len(parts) > 3 else None
    return kind, name, sub


def serve(server: FakeAPIServer, port: int = 0,
          host: str = "127.0.0.1", token: Optional[str] = None,
          certfile: Optional[str] = None,
          keyfile: Optional[str] = None,
          queue=None) -> ThreadingHTTPServer:
    """Serve the apiserver on ``host:port`` (port 0 = ephemeral); returns
    the HTTP server (``.server_address[1]`` carries the bound port).
    Defaults to loopback: this surface is WRITE-CAPABLE — exposing it
    beyond the host is an explicit deployment decision that should come
    with ``token`` (bearer auth) and ``certfile``/``keyfile`` (TLS).

    ``queue`` (an interruption FakeQueue) additionally serves
    ``POST /queue/messages`` — the SQS-over-HTTP ingest analog (the real
    EventBridge→SQS path is an HTTP API too), so external chaos /
    integration harnesses can inject interruption events across the
    process boundary (tests/test_crossprocess_e2e.py)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # ---- plumbing --------------------------------------------------

        def handle_one_request(self):
            # TLS handshake failures (a plaintext client probing the
            # HTTPS port) surface as SSL errors mid-read: drop quietly
            try:
                super().handle_one_request()
            except ssl.SSLError:
                self.close_connection = True

        def parse_request(self):
            ok = super().parse_request()
            if not ok:
                return False
            if token is not None and not check_bearer(
                    self.headers.get("Authorization"), token):
                self._json(401, {"error": "Unauthorized",
                                 "message": "missing or bad bearer token"})
                self.close_connection = True
                return False
            return True

        def _json(self, code: int, doc) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            # every response carries the server clock, so clients can
            # anchor age rendering even off single-object GETs (the
            # list-body serverTime field covers only list responses).
            # Plain numeric, NOT repr(): under a numpy-scalar clock
            # repr() renders 'np.float64(…)' on numpy>=2, which no
            # plain float() parser accepts (kpctl tolerates both forms
            # for servers that predate this fix).
            self.send_header("X-Server-Time", f"{float(server.now()):.6f}")
            sp = trace.current()
            if sp is not None:
                # context injection: the response names the server span so
                # a client can stitch its own spans to the handled request
                self.send_header("traceparent", sp.traceparent())
            self.end_headers()
            self.wfile.write(body)

        def _req_span(self, verb: str, path: str):
            """A server span for this request. Only a request that CARRIES
            context (traceparent header) or can START a causal chain (a
            write verb) gets one — read-only polling without context would
            churn the flight-recorder ring with single-span noise."""
            if not trace.enabled():
                return nullcontext()
            tp = self.headers.get("traceparent")
            if tp is None and verb == "GET":
                return nullcontext()
            return trace.span(f"http {verb} {path}", parent=tp,
                              http_method=verb)

        def _error(self, e: Exception) -> None:
            code = (404 if isinstance(e, NotFoundError) else
                    409 if isinstance(e, (ConflictError, AlreadyExistsError))
                    else 410 if isinstance(e, TooOldError) else
                    422 if isinstance(e, InvalidObjectError) else
                    429 if isinstance(e, EvictionBlockedError) else
                    400 if isinstance(e, (APIError, ValueError, KeyError))
                    else 500)
            doc = {"error": type(e).__name__, "message": str(e)}
            if isinstance(e, InvalidObjectError):
                doc["causes"] = e.causes
            self._json(code, doc)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) if length else b"{}"
            doc = json.loads(raw or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            return doc

        # ---- verbs -----------------------------------------------------

        def do_GET(self):
            try:
                url = urlparse(self.path)
                # discovery: the kubectl api-resources flow (a real
                # apiserver serves its group/resource lists under /apis)
                if url.path.rstrip("/") == "/apis":
                    self._json(200, {"kinds": list(KINDS)})
                    return
                # the introspection surfaces (docs/reference/
                # introspection.md): /debug/statusz (human) and
                # /debug/vars (JSON; kpctl top + soak backbone)
                rendered = introspect.debug_doc(url.path,
                                                parse_qs(url.query))
                if rendered is not None:
                    body, ctype = rendered
                    body, enc = maybe_gzip(
                        body, self.headers.get("Accept-Encoding"))
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    if enc:
                        self.send_header("Content-Encoding", enc)
                    self.send_header("Content-Length", str(len(body)))
                    # every response carries the server clock (the PR 2
                    # invariant _json enforces): a kpctl session that
                    # only polls /debug/vars still anchors age rendering
                    self.send_header("X-Server-Time",
                                     f"{float(server.now()):.6f}")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # the flight recorder's read surface (kpctl trace):
                # list / get / Chrome-export retained + ring traces
                if url.path.startswith("/debug/traces"):
                    rec = trace.recorder()
                    doc = (rec.debug_doc(url.path, parse_qs(url.query))
                           if rec is not None else None)
                    if doc is None:
                        raise NotFoundError(
                            f"no trace at {url.path}" if rec is not None
                            else "tracing is not enabled (--trace)")
                    self._json(200, doc)
                    return
                kind, name, sub = _route(url.path)
                if sub is not None:
                    raise NotFoundError(f"no route {url.path}")
                q = parse_qs(url.query)
                # the name check stays FIRST: a named GET with a stray
                # watch=1 param returns the object (the pre-tracing
                # contract), never silently discards the name into a
                # kind-wide stream
                if name is None and q.get("watch", ["0"])[0] in ("1",
                                                                 "true"):
                    # never span a watch: the stream outlives any request
                    # scope and would pin its trace open
                    self._watch(kind, int(q.get("resourceVersion", ["0"])[0]))
                    return
                with self._req_span("GET", url.path):
                    if name is not None:
                        self._json(200, server.get(kind, name))
                        return
                    items, rv = server.list(kind)
                    # serverTime lets clients (kpctl) anchor AGE/LAST
                    # SEEN columns to the clock that stamped the
                    # timestamps, instead of their own wall clock
                    self._json(200, {"items": items, "resourceVersion": rv,
                                     "serverTime": float(server.now())})
            except Exception as e:
                self._error(e)

        def _watch(self, kind: str, rv: int) -> None:
            w = server.watch(kind, rv)   # raises TooOldError → 410

            def chunk(payload: bytes) -> None:
                self.wfile.write(f"{len(payload):x}\r\n".encode()
                                 + payload + b"\r\n")
                self.wfile.flush()

            # everything after subscription lives under the finally that
            # unsubscribes — a client dropping during the header writes
            # must not leak the Watch (its queue would grow forever)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while True:
                    try:
                        ev = w.get(timeout=WATCH_HEARTBEAT_SECONDS)
                    except TooOldError as e:
                        # the watcher overran its bounded server-side
                        # queue: emit the protocol's ERROR event (the
                        # 410-Gone-mid-stream analog) and end the stream
                        # — the client relists, like a reflector
                        chunk(json.dumps({
                            "type": "ERROR", "code": 410,
                            "reason": "Expired", "message": str(e),
                        }).encode() + b"\n")
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                        break
                    if ev is None:
                        chunk(b'{"type":"HEARTBEAT"}\n')
                        continue
                    chunk(json.dumps({
                        "type": ev.type, "object": ev.object,
                        "resourceVersion": ev.resource_version,
                    }).encode() + b"\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass   # client went away: normal watch teardown
            finally:
                server.stop_watch(w)

        # every write verb nests try OUTSIDE the span (like do_GET): the
        # span must SEE a handler exception on exit — status=error is
        # what the flight recorder's tail sampler keys retention on —
        # and only then does the outer except send the error response

        def do_POST(self):
            try:
                with self._req_span("POST", urlparse(self.path).path):
                    url = urlparse(self.path)
                    if url.path == "/queue/messages":
                        if queue is None:
                            raise NotFoundError("no interruption queue served")
                        mid = queue.send(self._body())
                        self._json(201, {"messageId": mid})
                        return
                    kind, name, sub = _route(url.path)
                    q = parse_qs(url.query)
                    if kind == "pods" and name is not None and sub == "binding":
                        body = self._body()
                        self._json(200, server.bind(name, body["nodeName"]))
                        return
                    if kind == "pods" and name is not None and sub == "eviction":
                        force = q.get("force", ["0"])[0] in ("1", "true")
                        self._json(200, server.evict(name, force=force))
                        return
                    if name is not None:
                        raise NotFoundError(f"no route {url.path}")
                    spec = self._body()
                    sp = trace.current()
                    if kind == "pods" and sp is not None:
                        # stamp the admission span onto the pod: the
                        # informer delivers it to the mirror, and the
                        # provisioning pass that drains this pod JOINS
                        # this trace (REST → operator causal chain)
                        spec.setdefault("annotations", {}).setdefault(
                            wk.ANNOTATION_TRACEPARENT, sp.traceparent())
                    self._json(201, server.create(kind, spec))
            except Exception as e:
                self._error(e)

        def do_PUT(self):
            try:
                with self._req_span("PUT", urlparse(self.path).path):
                    kind, name, sub = _route(urlparse(self.path).path)
                    if sub is not None:
                        raise NotFoundError(f"no route {self.path}")
                    if name is None:
                        raise NotFoundError("PUT needs a name")
                    obj = self._body()
                    if obj.get("metadata", {}).get("name") != name:
                        raise ValueError("metadata.name must match the URL")
                    self._json(200, server.update(kind, obj))
            except Exception as e:
                self._error(e)

        def do_PATCH(self):
            try:
                with self._req_span("PATCH", urlparse(self.path).path):
                    kind, name, sub = _route(urlparse(self.path).path)
                    if sub is not None:
                        raise NotFoundError(f"no route {self.path}")
                    if name is None:
                        raise NotFoundError("PATCH needs a name")
                    body = self._body()
                    self._json(200, server.patch(
                        kind, name, body.get("spec"),
                        status_patch=body.get("status"),
                        finalizers=body.get("finalizers")))
            except Exception as e:
                self._error(e)

        def do_DELETE(self):
            try:
                with self._req_span("DELETE", urlparse(self.path).path):
                    url = urlparse(self.path)
                    kind, name, sub = _route(url.path)
                    if sub is not None:
                        # e.g. DELETE /apis/pods/p0/eviction — the wrong
                        # verb must NEVER fall through to deleting the
                        # parent
                        raise NotFoundError(f"no route {url.path}")
                    if name is None:
                        raise NotFoundError("DELETE needs a name")
                    q = parse_qs(url.query)
                    force = q.get("force", ["0"])[0] in ("1", "true")
                    server.delete(kind, name, force=force)
                    self._json(200, {"status": "ok"})
            except Exception as e:
                self._error(e)

        def log_message(self, *a):   # quiet by default
            pass

    httpd = make_http_server((host, port), Handler, certfile, keyfile)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
