"""The port's gRPC wire (``parallel/rpc.py``) against grpcio, on the CPU.

- HPACK: RFC 7541's integer and literal examples, its request sequence
  without Huffman coding (C.3: the dynamic table carried across three
  header blocks) and its response sequence with a 256-byte table (C.5:
  evictions); a Huffman-coded block (C.4.1) is refused, and a peer that
  sends one gets GOAWAY with COMPRESSION_ERROR.
- grpcio interoperates with the port both ways (a grpcio client calling
  a port server, a port client calling a grpcio server) on ``unix:`` and
  on TCP: payloads of 2 MB, 4,194,304 B and 4,194,305 B, as requests and
  as responses, end with the status codes grpcio gives between two
  grpcio peers (OK, OK, RESOURCE_EXHAUSTED), and the payloads come back
  equal; so do a handler that raises (UNKNOWN), a method nobody serves
  (UNIMPLEMENTED) and a stalled handler against a 0.3 s deadline
  (DEADLINE_EXCEEDED, at the deadline).
- Several calls on one connection from a grpcio client reach the port's
  decoder as references into the dynamic table, and decode right.
- Concurrent calls multiplex on one port channel, small ones and 1.5 MB
  ones both ways at once.
- A ``unix:`` socket file left by a server killed with SIGKILL does not
  block the next bind, on either wire; a stopped server removes its file.
- A port channel fails fast (UNAVAILABLE) on a dead address, and with
  ``wait_for_ready`` reaches a server that comes up inside its deadline.

Tolerance: none.
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import pytest

from karpenter_provider_aws_tpu_torch.parallel import rpc

LIMIT = rpc.MAX_MESSAGE_BYTES
SIZES = [2_000_000, LIMIT, LIMIT + 1]
STALL_SECONDS = 3.0


# ---- HPACK ----

def test_hpack_integer_examples():
    """RFC 7541 C.1: 10 and 1337 on a 5-bit prefix, 42 on 8 bits."""
    assert rpc._encode_int(10, 5) == b"\x0a"
    assert rpc._encode_int(1337, 5) == b"\x1f\x9a\x0a"
    assert rpc._encode_int(42, 8) == b"\x2a"
    for value, bits in ((10, 5), (1337, 5), (42, 8), (2 ** 28, 7)):
        assert rpc._decode_int(rpc._encode_int(value, bits), 0, bits) == (
            value, len(rpc._encode_int(value, bits)))
    assert len(rpc.STATIC_TABLE) == 61


@pytest.mark.parametrize("block,headers,table", [
    ("400a637573746f6d2d6b65790d637573746f6d2d686561646572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")]),
    ("040c2f73616d706c652f70617468", [(":path", "/sample/path")], []),
    ("100870617373776f726406736563726574", [("password", "secret")], []),
    ("82", [(":method", "GET")], []),
], ids=["literal-indexed", "literal-not-indexed", "literal-never-indexed",
        "indexed"])
def test_hpack_literal_forms(block, headers, table):
    """RFC 7541 C.2: each field representation."""
    d = rpc.Decoder()
    assert d.decode(bytes.fromhex(block)) == headers
    assert list(d.table) == table


def test_hpack_dynamic_table_across_requests():
    """RFC 7541 C.3: three requests on one decoder; the second and third
    reference entries the first and second added."""
    d = rpc.Decoder()
    blocks = [
        "828684410f7777772e6578616d706c652e636f6d",
        "828684be58086e6f2d6361636865",
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"]
    base = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
            (":authority", "www.example.com")]
    want = [base, base + [("cache-control", "no-cache")],
            [(":method", "GET"), (":scheme", "https"),
             (":path", "/index.html"), (":authority", "www.example.com"),
             ("custom-key", "custom-value")]]
    sizes = [57, 110, 164]
    for block, headers, size in zip(blocks, want, sizes):
        assert d.decode(bytes.fromhex(block)) == headers
        assert d.size == size
    assert list(d.table) == [("custom-key", "custom-value"),
                             ("cache-control", "no-cache"),
                             (":authority", "www.example.com")]


def test_hpack_evictions_with_a_small_table():
    """RFC 7541 C.5: three responses against a 256-byte table; entries
    are evicted oldest first."""
    d = rpc.Decoder(max_table_size=256)
    date1 = "Mon, 21 Oct 2013 20:13:21 GMT"
    date2 = "Mon, 21 Oct 2013 20:13:22 GMT"
    loc = "https://www.example.com"
    cookie = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
    blocks = [
        "4803333032580770726976617465611d4d6f6e2c203231204f637420323031332032"
        "303a31333a323120474d546e1768747470733a2f2f7777772e6578616d706c652e"
        "636f6d",
        "4803333037c1c0bf",
        "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d54"
        "c05a04677a69707738666f6f3d4153444a4b48514b425a584f5157454f5049554158"
        "5157454f49553b206d61782d6167653d333630303b2076657273696f6e3d31"]
    want = [
        [(":status", "302"), ("cache-control", "private"), ("date", date1),
         ("location", loc)],
        [(":status", "307"), ("cache-control", "private"), ("date", date1),
         ("location", loc)],
        [(":status", "200"), ("cache-control", "private"), ("date", date2),
         ("location", loc), ("content-encoding", "gzip"),
         ("set-cookie", cookie)]]
    for block, headers, size in zip(blocks, want, (222, 222, 215)):
        assert d.decode(bytes.fromhex(block)) == headers
        assert d.size == size
    assert list(d.table) == [("set-cookie", cookie),
                             ("content-encoding", "gzip"), ("date", date2)]


def test_hpack_refuses_huffman_and_bad_blocks():
    """RFC 7541 C.4.1 is C.3.1 with its literal Huffman-coded: refused,
    never misread. An index past the tables and a size update above the
    advertised size are refused too."""
    with pytest.raises(rpc.HpackError, match="Huffman"):
        rpc.Decoder().decode(bytes.fromhex(
            "828684418cf1e3c2e5f23a6ba0ab90f4ff"))
    with pytest.raises(rpc.HpackError):
        rpc.Decoder().decode(b"\xbe")             # index 62, empty table
    with pytest.raises(rpc.HpackError):
        rpc.Decoder().decode(rpc._encode_int(4097, 5, 0x20))


def test_hpack_encoder_round_trip():
    headers = [(":method", "POST"), (":path", "/karpenter.solver.v1.Solver/Solve"),
               ("grpc-timeout", rpc.encode_timeout(1.5)),
               ("grpc-message", rpc._percent_encode("boom é 100%")),
               ("x-long", "v" * 300)]
    d = rpc.Decoder()
    assert d.decode(rpc.encode_headers(headers)) == headers
    assert not d.table                     # literals without indexing
    assert rpc.encode_timeout(1.5) == "1500m"
    assert (rpc.encode_timeout(0.0004), rpc.encode_timeout(0.0015001)) == \
        ("400u", "2m")                             # rounded up
    assert rpc._percent_decode(rpc._percent_encode("boom é 100%")) == \
        "boom é 100%"


def test_peer_sending_huffman_gets_goaway_compression_error(tmp_path):
    """A raw client sends C.4.1's Huffman-coded header block: the port's
    server answers GOAWAY with COMPRESSION_ERROR (9) and closes."""
    server = rpc.server(ThreadPoolExecutor(1))
    address = f"unix:{tmp_path}/h.sock"
    server.add_insecure_port(address)
    server.start()
    try:
        sock = socket.socket(socket.AF_UNIX)
        sock.connect(str(tmp_path / "h.sock"))
        block = bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff")
        sock.sendall(rpc.PREFACE + rpc._Connection._frame(rpc.SETTINGS, 0, 0)
                     + rpc._Connection._frame(
                         rpc.HEADERS, rpc.FLAG_END_HEADERS, 1, block))
        sock.settimeout(5)
        data = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
        frames = []
        while len(data) >= 9:
            length_type, _, sid = struct.unpack(">IBI", data[:9])
            length = length_type >> 8
            frames.append((length_type & 0xFF, data[9:9 + length]))
            data = data[9 + length:]
        goaway = [p for t, p in frames if t == rpc.GOAWAY]
        assert len(goaway) == 1
        assert struct.unpack(">II", goaway[0][:8])[1] == rpc.COMPRESSION_ERROR
        sock.close()
    finally:
        server.stop(None)


# ---- interop with grpcio ----

def _handler(mod):
    class Handler(mod.GenericRpcHandler):
        def service(self, details):
            if details.method == "/t.T/Echo":
                return mod.unary_unary_rpc_method_handler(lambda r, c: r)
            if details.method == "/t.T/Sized":
                return mod.unary_unary_rpc_method_handler(
                    lambda r, c: bytes(range(256)) * (int(r) // 256)
                    + b"z" * (int(r) % 256))
            if details.method == "/t.T/Raise":
                def boom(r, c):
                    raise ValueError("boom")
                return mod.unary_unary_rpc_method_handler(boom)
            if details.method == "/t.T/Stall":
                return mod.unary_unary_rpc_method_handler(
                    lambda r, c: time.sleep(STALL_SECONDS) or b"late")
            return None
    return Handler()


class _Pair:
    """A server of one package and a channel of another on one address."""

    def __init__(self, server_mod, client_mod, transport, tmp_path):
        self.server = server_mod.server(ThreadPoolExecutor(4))
        self.server.add_generic_rpc_handlers((_handler(server_mod),))
        if transport == "unix":
            address = f"unix:{tmp_path}/{server_mod.__name__[-4:]}.sock"
            self.server.add_insecure_port(address)
        else:
            port = self.server.add_insecure_port("127.0.0.1:0")
            address = f"127.0.0.1:{port}"
        self.server.start()
        self.client_mod = client_mod
        self.channel = client_mod.insecure_channel(address)

    def call(self, method, request, timeout=30.0):
        """(status name, response or None)"""
        try:
            out = self.channel.unary_unary(method)(request, timeout=timeout)
            return "OK", out
        except self.client_mod.RpcError as e:
            return e.code().name, None

    def close(self):
        self.channel.close()
        self.server.stop(None)


DIRECTIONS = {"grpcio-client-port-server": (rpc, grpc),
              "port-client-grpcio-server": (grpc, rpc)}


@pytest.fixture(params=["unix", "tcp"])
def transport(request):
    return request.param


@pytest.fixture
def pairs(transport, tmp_path):
    """Each cross pair, and grpcio against grpcio as the reference."""
    out = {name: _Pair(s, c, transport, tmp_path / name)
           for name, (s, c) in DIRECTIONS.items()}
    out["grpcio"] = _Pair(grpc, grpc, transport, tmp_path / "grpcio")
    yield out
    for p in out.values():
        p.close()


@pytest.fixture(autouse=True)
def _dirs(tmp_path):
    """A directory for each pair's socket (autouse: made before ``pairs``)."""
    for name in list(DIRECTIONS) + ["grpcio"]:
        (tmp_path / name).mkdir(exist_ok=True)


def test_sizes_each_way_match_grpcio(pairs):
    """Requests and responses of 2 MB, 4 MiB and 4 MiB + 1 byte: the
    status codes grpcio gives between grpcio peers, and the payloads
    intact."""
    for size in SIZES:
        payload = os.urandom(size)
        want = pairs["grpcio"].call("/t.T/Echo", payload)[0]
        want_resp = pairs["grpcio"].call("/t.T/Sized", str(size).encode())[0]
        for name in DIRECTIONS:
            got, echoed = pairs[name].call("/t.T/Echo", payload)
            assert got == want, (name, size, "request")
            assert echoed is None or echoed == payload
            got, body = pairs[name].call("/t.T/Sized", str(size).encode())
            assert got == want_resp, (name, size, "response")
            assert body is None or body == bytes(range(256)) * (size // 256) \
                + b"z" * (size % 256)
    assert [pairs["grpcio"].call("/t.T/Echo", b"x" * n)[0] for n in SIZES] \
        == ["OK", "OK", "RESOURCE_EXHAUSTED"]


def test_error_codes_and_deadline_match_grpcio(pairs):
    for name in list(DIRECTIONS) + ["grpcio"]:
        p = pairs[name]
        assert p.call("/t.T/Raise", b"")[0] == "UNKNOWN", name
        assert p.call("/t.T/Nobody", b"")[0] == "UNIMPLEMENTED", name
        t0 = time.perf_counter()
        assert p.call("/t.T/Stall", b"", timeout=0.3)[0] == \
            "DEADLINE_EXCEEDED", name
        assert 0.25 < time.perf_counter() - t0 < 2.0, name
        # the connection serves on after all of them
        assert p.call("/t.T/Echo", b"after") == ("OK", b"after"), name


def test_grpcio_client_reuses_its_dynamic_table(tmp_path, monkeypatch):
    """grpcio indexes its request headers: from the second call on one
    connection, the port's decoder reads references into the dynamic
    table (index 62 and up), and every call still decodes right."""
    hits = []
    entry = rpc.Decoder._entry

    def spy(self, index):
        if index > len(rpc.STATIC_TABLE):
            hits.append(index)
        return entry(self, index)

    monkeypatch.setattr(rpc.Decoder, "_entry", spy)
    p = _Pair(rpc, grpc, "unix", tmp_path)
    try:
        for i in range(6):
            method = "/t.T/Echo" if i % 2 == 0 else "/t.T/Sized"
            body = b"m%d" % i if i % 2 == 0 else b"300"
            status, out = p.call(method, body)
            assert status == "OK"
            assert out == (body if i % 2 == 0 else bytes(range(256)) + b"z" * 44)
    finally:
        p.close()
    assert len(hits) >= 5


def test_concurrent_calls_multiplex_on_one_channel(tmp_path):
    p = _Pair(grpc, rpc, "unix", tmp_path)
    results = {}

    def call(i):
        results[i] = p.call("/t.T/Echo", str(i).encode() * 5000)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    try:
        assert not any(t.is_alive() for t in threads)
        assert results == {i: ("OK", str(i).encode() * 5000)
                           for i in range(16)}
        assert p.channel._conn is not None and p.channel._conn._next_id == 33
    finally:
        p.close()


def test_large_concurrent_calls_both_ways_do_not_stall(tmp_path):
    """Sixteen threads echo 1.5 MB each at once through one port channel
    to a port server (more threads than cores, a short switch interval):
    both ends send large DATA while their readers must keep answering
    (WINDOW_UPDATE, SETTINGS ACK). Every call completes, intact."""
    p = _Pair(rpc, rpc, "unix", tmp_path)
    payloads = [os.urandom(1_500_000) for _ in range(16)]
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def call(i):
            for _ in range(2):
                results[i] = p.call("/t.T/Echo", payloads[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert results == {i: ("OK", payloads[i]) for i in range(16)}
    finally:
        sys.setswitchinterval(old)
        p.close()


_KILLED_SERVER = """
import sys, time
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, {repo!r})
{imp}
s = mod.server(ThreadPoolExecutor(1))
s.add_insecure_port({address!r})
s.start()
print("up", flush=True)
time.sleep(60)
"""


@pytest.mark.parametrize("server_mod", [rpc, grpc], ids=["port", "grpcio"])
def test_stale_socket_file_rebound_after_a_kill(server_mod, tmp_path):
    path = tmp_path / "stale.sock"
    address = f"unix:{path}"
    imp = "from karpenter_provider_aws_tpu_torch.parallel import rpc as mod" \
        if server_mod is rpc else "import grpc as mod"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILLED_SERVER.format(
            repo=repo, imp=imp, address=address)],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "up"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(10)
    assert path.exists()                       # left behind by the kill
    server = server_mod.server(ThreadPoolExecutor(1))
    server.add_generic_rpc_handlers((_handler(server_mod),))
    assert server.add_insecure_port(address) == 1
    server.start()
    channel = rpc.insecure_channel(address)
    try:
        assert channel.unary_unary("/t.T/Echo")(b"back", timeout=5) == b"back"
    finally:
        channel.close()
        server.stop(None)
    time.sleep(0.2)
    assert not path.exists()                   # a stopped server's goes


def test_bind_failure_raises_as_grpcio_does(tmp_path):
    for mod in (rpc, grpc):
        with pytest.raises(RuntimeError, match="Failed to bind"):
            mod.server(ThreadPoolExecutor(1)).add_insecure_port(
                f"unix:{tmp_path}/no/such/dir.sock")


def test_reconnect_backoff_and_wait_for_ready(tmp_path):
    """A dead address fails at once (UNAVAILABLE), and again at once
    inside the backoff window; a ``wait_for_ready`` call retries after
    the backoff and reaches a server started meanwhile."""
    address = f"unix:{tmp_path}/late.sock"
    channel = rpc.insecure_channel(address, options=[
        ("grpc.initial_reconnect_backoff_ms", 250),
        ("grpc.min_reconnect_backoff_ms", 250),
        ("grpc.max_reconnect_backoff_ms", 500)])
    echo = channel.unary_unary("/t.T/Echo")
    for _ in range(2):
        t0 = time.perf_counter()
        with pytest.raises(rpc.RpcError) as e:
            echo(b"x", timeout=5)
        assert e.value.code() == rpc.StatusCode.UNAVAILABLE
        assert time.perf_counter() - t0 < 1.0      # not the 5 s deadline
    server = rpc.server(ThreadPoolExecutor(1))
    server.add_generic_rpc_handlers((_handler(rpc),))
    threading.Timer(0.3, lambda: (server.add_insecure_port(address),
                                  server.start())).start()
    try:
        assert echo(b"ready", timeout=5, wait_for_ready=True) == b"ready"
    finally:
        channel.close()
        time.sleep(0.1)
        server.stop(None)
    with pytest.raises(ValueError, match="unsupported channel options"):
        rpc.insecure_channel(address, options=[("grpc.max_send", 1)])
