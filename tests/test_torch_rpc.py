"""The port's gRPC wire (``parallel/rpc.py``) against grpcio, on the CPU.

- HPACK: RFC 7541's integer and literal examples, its request sequence
  without Huffman coding (C.3: the dynamic table carried across three
  header blocks) and with it (C.4), and its response sequence with a
  256-byte table (C.5: evictions). The Huffman code
  (``parallel/hpack_huffman.py``) equals the table in grpcio's own
  library, round-trips every byte value, and refuses long padding,
  padding that is not all ones and an encoded EOS; a peer that sends a
  Huffman string is answered, and one that sends a bad one gets GOAWAY
  with COMPRESSION_ERROR. A raw client sending Huffman-coded headers gets
  the same answers from a grpcio server and a port server.
- Message compression: a grpcio client that compresses (gzip, deflate;
  per call and per channel) calling a port server, and a port client
  calling a grpcio server built with ``compression=Gzip``, end with the
  status codes grpcio gives between grpcio peers, the 4 MiB limit on the
  decompressed size (4,194,304 B pass, 4,194,305 B are
  RESOURCE_EXHAUSTED). A raw client's flagged message under the identity
  encoding and a corrupt gzip body get grpcio's answers (OK, INTERNAL);
  an encoding neither end reads gets UNIMPLEMENTED from the port, as the
  gRPC spec has it (grpcio 1.76 resets the stream instead).
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
import pathlib
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import zlib

import grpc
import pytest

from karpenter_provider_aws_tpu_torch.parallel import hpack_huffman, rpc

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
    """RFC 7541 C.4.1 is C.3.1 with its literal Huffman-coded: it decodes
    to the same four fields. An index past the tables and a size update
    above the advertised size are refused."""
    assert rpc.Decoder().decode(bytes.fromhex(
        "828684418cf1e3c2e5f23a6ba0ab90f4ff")) == [
            (":method", "GET"), (":scheme", "http"), (":path", "/"),
            (":authority", "www.example.com")]
    with pytest.raises(rpc.HpackError):
        rpc.Decoder().decode(b"\xbe")             # index 62, empty table
    with pytest.raises(rpc.HpackError):
        rpc.Decoder().decode(rpc._encode_int(4097, 5, 0x20))


def test_hpack_huffman_request_sequence():
    """RFC 7541 C.4: C.3's three requests with Huffman-coded literals, on
    one decoder."""
    d = rpc.Decoder()
    blocks = ["828684418cf1e3c2e5f23a6ba0ab90f4ff",
              "828684be5886a8eb10649cbf",
              "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]
    base = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
            (":authority", "www.example.com")]
    want = [base, base + [("cache-control", "no-cache")],
            [(":method", "GET"), (":scheme", "https"),
             (":path", "/index.html"), (":authority", "www.example.com"),
             ("custom-key", "custom-value")]]
    for block, headers, size in zip(blocks, want, (57, 110, 164)):
        assert d.decode(bytes.fromhex(block)) == headers
        assert d.size == size


def test_huffman_round_trips_every_byte():
    codes = hpack_huffman.CODES
    assert len(codes) == 257 and codes[hpack_huffman.EOS] == (0x3fffffff, 30)
    assert sum(2.0 ** -n for _, n in codes) == 1.0     # a complete code
    for b in range(256):
        one = bytes([b])
        assert hpack_huffman.decode(hpack_huffman.encode(one)) == one
    every = bytes(range(256)) + bytes(range(255, -1, -1))
    assert hpack_huffman.decode(hpack_huffman.encode(every)) == every
    assert hpack_huffman.encode(b"www.example.com") == bytes.fromhex(
        "f1e3c2e5f23a6ba0ab90f4ff")
    assert hpack_huffman.encode(b"") == b"" == hpack_huffman.decode(b"")


def test_huffman_decoding_errors():
    """RFC 7541 §5.2: padding longer than 7 bits, padding that is not the
    high bits of EOS, and an encoded EOS are errors; in a header block
    each is an HpackError."""
    a = hpack_huffman.encode(b"a")              # 5 bits and 3 of padding
    assert a == b"\x1f"
    for bad, why in ((a + b"\xff", "padding"),     # 11 bits of padding
                     (b"\x18", "padding"),          # padding of zeros
                     (b"\xff\xff\xff\xfc", "EOS")):   # EOS, then 2 ones
        with pytest.raises(hpack_huffman.HuffmanError, match=why):
            hpack_huffman.decode(bad)
        with pytest.raises(rpc.HpackError, match=why):
            rpc.Decoder().decode(b"\x04" + bytes([0x80 | len(bad)]) + bad)


def _grpcio_huffman_table():
    """The (code, length) pairs of grpcio's HPACK Huffman table, found in
    its own library by the first entries as little-endian uint32 pairs."""
    lib = next(pathlib.Path(grpc.__file__).parent.glob(
        "_cython/cygrpc*.so"))
    data = lib.read_bytes()
    at = data.find(struct.pack("<4I", 0x1ff8, 13, 0x7fffd8, 23))
    assert at >= 0, "no HPACK Huffman table in grpcio's library"
    return tuple(struct.unpack_from("<2I", data, at + 8 * i)
                 for i in range(257))


def test_huffman_table_equals_grpcio():
    pytest.importorskip("grpc")
    assert hpack_huffman.CODES == _grpcio_huffman_table()


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


def _raw_frames(path, frames, until_close=False):
    """Send HTTP/2 ``frames`` after the preface and a SETTINGS frame on a
    raw connection to the unix socket ``path``; (type, flags, stream,
    payload) of every frame read back until the peer closes, or, unless
    ``until_close``, until stream 1 ends or is reset: as soon as any frame
    read so far ends stream 1 or resets it, not only the last one (a peer
    may send a WINDOW_UPDATE or a PING in the same write after its
    answer, and then stay open)."""
    sock = socket.socket(socket.AF_UNIX)
    sock.connect(str(path))
    sock.sendall(rpc.PREFACE + rpc._Connection._frame(rpc.SETTINGS, 0, 0)
                 + b"".join(frames))
    sock.settimeout(5)
    data, out = b"", []
    try:
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
            while len(data) >= 9:
                length_type, flags, sid = struct.unpack(">IBI", data[:9])
                length = length_type >> 8
                if len(data) < 9 + length:
                    break
                out.append((length_type & 0xFF, flags, sid,
                            data[9:9 + length]))
                data = data[9 + length:]
            if not until_close and any(
                    sid == 1 and (ftype == rpc.RST_STREAM
                                  or flags & rpc.FLAG_END_STREAM)
                    for ftype, flags, sid, _ in out):
                break
    finally:
        sock.close()
    return out


def _answer(frames):
    """(grpc-status, or the RST_STREAM code of a stream reset before an
    answer; the message) of stream 1."""
    d = rpc.Decoder()
    fields, body = {}, b""
    for ftype, _, sid, payload in frames:
        if ftype == rpc.HEADERS:
            block = rpc._Connection._unpad(0, payload)
            fields.update(d.decode(block))
        elif ftype == rpc.DATA and sid == 1:
            body += payload
        elif ftype == rpc.RST_STREAM and sid == 1:
            if "grpc-status" in fields:
                break             # a reset after the answer (NO_ERROR)
            return f"reset {struct.unpack('>I', payload)[0]}", None
    return fields.get("grpc-status"), body[5:] if body else None


@pytest.mark.parametrize("end, after", [
    # grpcio's trailers-only answer, then a WINDOW_UPDATE and a PING in
    # the same write (the frames read when the reader timed out)
    ((rpc.HEADERS, rpc.FLAG_END_HEADERS | rpc.FLAG_END_STREAM,
      rpc.encode_headers([(":status", "200"), ("grpc-status", "12")])),
     (rpc.PING, 0, b"\0" * 8)),
    ((rpc.RST_STREAM, 0, struct.pack(">I", rpc.CANCEL)),
     (rpc.WINDOW_UPDATE, 0, struct.pack(">I", 1 << 16))),
], ids=["headers-end-stream-then-ping", "rst-stream-then-window-update"])
def test_raw_frames_stops_at_any_frame_that_ends_stream_1(tmp_path, end,
                                                          after):
    """The raw reader returns as soon as any frame read so far ends or
    resets stream 1, though a connection frame follows it in the same
    write and the peer stays open: within a second, far inside its 5 s
    socket timeout, with the ending frame in its list."""
    frame = rpc._Connection._frame
    path = tmp_path / "peer.sock"
    listener = socket.socket(socket.AF_UNIX)
    listener.bind(str(path))
    listener.listen(1)
    done = threading.Event()

    def peer():
        conn, _ = listener.accept()
        try:
            conn.recv(65536)                   # the preface and SETTINGS
            conn.sendall(frame(end[0], end[1], 1, end[2])
                         + frame(after[0], after[1], 0, after[2]))
            done.wait(10)                      # and stay open
        finally:
            conn.close()

    thread = threading.Thread(target=peer, daemon=True)
    thread.start()
    try:
        t = time.monotonic()
        frames = _raw_frames(path, [])
        took = time.monotonic() - t
    finally:
        done.set()
        thread.join(10)
        listener.close()
    assert took < 1.0, took
    assert (end[0], end[1], 1, end[2]) in frames
    assert frames[-1][0] == after[0]


def test_peer_sending_huffman_gets_goaway_compression_error(tmp_path):
    """A raw client sends C.4.1's Huffman-coded header block (a GET of
    ``/``): the port's server decodes it and answers UNIMPLEMENTED (12),
    no GOAWAY. A Huffman string with 11 bits of padding is a decoding
    error: GOAWAY with COMPRESSION_ERROR (9), and the connection
    closes."""
    server = rpc.server(ThreadPoolExecutor(1))
    address = f"unix:{tmp_path}/h.sock"
    server.add_insecure_port(address)
    server.start()
    frame = rpc._Connection._frame
    try:
        block = bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff")
        frames = _raw_frames(tmp_path / "h.sock", [frame(
            rpc.HEADERS, rpc.FLAG_END_HEADERS | rpc.FLAG_END_STREAM, 1,
            block)])
        assert not [f for f in frames if f[0] == rpc.GOAWAY]
        assert _answer(frames) == (str(rpc.StatusCode.UNIMPLEMENTED.value),
                                   None)
        bad = hpack_huffman.encode(b"www.example.com") + b"\xff"
        block = bytes.fromhex("82868441") + bytes([0x80 | len(bad)]) + bad
        frames = _raw_frames(tmp_path / "h.sock", [frame(
            rpc.HEADERS, rpc.FLAG_END_HEADERS, 1, block)], until_close=True)
        goaway = [f[3] for f in frames if f[0] == rpc.GOAWAY]
        assert len(goaway) == 1
        assert struct.unpack(">II", goaway[0][:8])[1] == rpc.COMPRESSION_ERROR
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
    """A server of one package and a channel of another on one address;
    ``compression`` builds the grpcio server or channel with it."""

    def __init__(self, server_mod, client_mod, transport, tmp_path,
                 server_compression=None, channel_compression=None):
        self.server = server_mod.server(ThreadPoolExecutor(4), **(
            {"compression": server_compression} if server_compression
            else {}))
        self.server.add_generic_rpc_handlers((_handler(server_mod),))
        if transport == "unix":
            address = f"unix:{tmp_path}/{server_mod.__name__[-4:]}.sock"
            self.server.add_insecure_port(address)
        else:
            port = self.server.add_insecure_port("127.0.0.1:0")
            address = f"127.0.0.1:{port}"
        self.server.start()
        self.client_mod = client_mod
        self.address = address
        self.channel = client_mod.insecure_channel(address, **(
            {"compression": channel_compression} if channel_compression
            else {}))

    def call(self, method, request, timeout=30.0, compression=None):
        """(status name, response or None); ``compression`` is a grpcio
        client's per-call compression."""
        kwargs = {"compression": compression} if compression else {}
        try:
            out = self.channel.unary_unary(method)(request, timeout=timeout,
                                                   **kwargs)
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
    out = {}
    for i, (name, (s, c)) in enumerate(
            list(DIRECTIONS.items()) + [("grpcio", (grpc, grpc))]):
        # a short directory name per pair: a unix socket's path holds at
        # most 107 bytes, and pytest's tmp_path grows with its run count
        (tmp_path / str(i)).mkdir()
        out[name] = _Pair(s, c, transport, tmp_path / str(i))
    yield out
    for p in out.values():
        p.close()


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


# ---- Huffman-coded headers and compressed messages ----

def _huffman_request(method, message, encoding=None, flag=0, indexed=False):
    """A request's HEADERS and DATA frames on stream 1 whose header
    strings are all Huffman-coded, as literals with incremental indexing
    (``indexed``) or without."""
    fields = [(":method", "POST"), (":scheme", "http"), (":path", method),
              (":authority", "localhost"),
              ("content-type", "application/grpc"), ("te", "trailers")]
    if encoding is not None:
        fields.append(("grpc-encoding", encoding))
    block = bytearray()
    for name, value in fields:
        block.append(0x40 if indexed else 0x00)
        for text in (name, value):
            coded = hpack_huffman.encode(text.encode("latin-1"))
            block += rpc._encode_int(len(coded), 7, 0x80) + coded
    frame = rpc._Connection._frame
    return [frame(rpc.HEADERS, rpc.FLAG_END_HEADERS, 1, bytes(block)),
            frame(rpc.DATA, rpc.FLAG_END_STREAM, 1,
                  struct.pack(">BI", flag, len(message)) + message)]


def _servers(tmp_path, mods=(rpc, grpc)):
    out = {}
    for mod in mods:
        server = mod.server(ThreadPoolExecutor(2))
        server.add_generic_rpc_handlers((_handler(mod),))
        path = tmp_path / f"{mod.__name__[-4:]}.sock"
        server.add_insecure_port(f"unix:{path}")
        server.start()
        out[mod] = (server, path)
    return out


def test_raw_huffman_headers_get_the_same_answers(tmp_path):
    """Requests whose header strings are all Huffman-coded, raw and as
    incrementally indexed literals: the same answers from a grpcio server
    and a port server (an echo, a method nobody serves)."""
    servers = _servers(tmp_path)
    try:
        answers = {}
        for mod, (_, path) in servers.items():
            answers[mod] = [_answer(_raw_frames(path, _huffman_request(
                method, body, indexed=indexed)))
                for method, body in (("/t.T/Echo", b"huffman"),
                                     ("/t.T/Nobody", b""))
                for indexed in (False, True)]
        assert answers[rpc] == answers[grpc]
        assert answers[rpc][:2] == [("0", b"huffman")] * 2
        assert [a[0] for a in answers[rpc][2:]] == ["12", "12"]
    finally:
        for server, _ in servers.values():
            server.stop(None)


def _dir(tmp_path, mod, role):
    """A directory for a socket, its name short (as ``pairs``' are)."""
    path = tmp_path / f"{role[:2]}{'p' if mod is rpc else 'g'}"
    path.mkdir()
    return path


def _gzip(data, wbits=31):
    c = zlib.compressobj(6, zlib.DEFLATED, wbits)
    return c.compress(data) + c.flush()


def test_raw_encodings_get_grpcio_answers(tmp_path):
    """A raw client's message under each ``grpc-encoding``: gzip and
    deflate bodies are read, a flagged message under the identity
    encoding is read as it stands and a corrupt gzip body is INTERNAL,
    on both servers. An encoding neither reads: UNIMPLEMENTED from the
    port (the gRPC spec's answer), a stream reset with INTERNAL_ERROR
    (2) from grpcio 1.76, whose header parser refuses the value."""
    servers = _servers(tmp_path)
    cases = [("gzip", 1, _gzip(b"zipped")), ("deflate", 1,
                                             zlib.compress(b"deflated")),
             ("gzip", 0, b"plain"), ("identity", 1, b"flagged"),
             (None, 1, b"flagged"), ("gzip", 1, b"not gzip"),
             ("gzip", 1, _gzip(b"cut")[:-4])]
    try:
        got = {mod: [_answer(_raw_frames(path, _huffman_request(
            "/t.T/Echo", body, encoding, flag))) for encoding, flag, body
            in cases] for mod, (_, path) in servers.items()}
        assert got[rpc] == got[grpc]
        assert got[rpc] == [("0", b"zipped"), ("0", b"deflated"),
                            ("0", b"plain"), ("0", b"flagged"),
                            ("0", b"flagged"), ("13", None), ("13", None)]
        assert _answer(_raw_frames(servers[rpc][1], _huffman_request(
            "/t.T/Echo", b"x", "br", 1))) == ("12", None)
        assert _answer(_raw_frames(servers[grpc][1], _huffman_request(
            "/t.T/Echo", b"x", "br", 1))) == ("reset 2", None)
    finally:
        for server, _ in servers.values():
            server.stop(None)


COMPRESSIBLE = {LIMIT: b"z" * LIMIT, LIMIT + 1: b"z" * (LIMIT + 1)}


@pytest.mark.parametrize("compression", ["Gzip", "Deflate"])
def test_grpcio_client_compressing_calls_port_server(compression, tmp_path):
    """A grpcio client compressing each call, and a grpcio channel built
    with the compression: a port server answers as a grpcio server does,
    the limit applying to the decompressed size (4,194,304 B OK,
    4,194,305 B RESOURCE_EXHAUSTED; compressible payloads, a few KB on
    the wire)."""
    algo = getattr(grpc.Compression, compression)
    seen = []
    message = rpc._message

    def spy(stream, encoding=None):
        seen.append((encoding, stream.data[0]))
        return message(stream, encoding)

    pairs = {mod: _Pair(mod, grpc, "unix", _dir(tmp_path, mod, "call"))
             for mod in (rpc, grpc)}
    channels = {mod: _Pair(mod, grpc, "unix", _dir(tmp_path, mod, "channel"),
                           channel_compression=algo) for mod in (rpc, grpc)}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rpc, "_message", spy)
            got = {mod: [p.call("/t.T/Echo", COMPRESSIBLE[n], compression=algo)
                         for n in (LIMIT, LIMIT + 1)]
                   + [channels[mod].call("/t.T/Echo", b"y" * 101_000)]
                   for mod, p in pairs.items()}
        assert [g[0] for g in got[rpc]] == [g[0] for g in got[grpc]] == [
            "OK", "RESOURCE_EXHAUSTED", "OK"]
        assert got[rpc][0][1] == COMPRESSIBLE[LIMIT]
        assert got[rpc][2][1] == b"y" * 101_000
        want = compression.lower()
        assert [e for e, flag in seen] == [want] * 3
        assert all(flag == 1 for _, flag in seen)
    finally:
        for p in list(pairs.values()) + list(channels.values()):
            p.close()


def test_port_client_calls_compressing_grpcio_server(tmp_path):
    """A grpcio server built with ``compression=Gzip`` compresses what it
    sends to a client that accepts gzip: the port's client reads it, and
    ends with the codes a grpcio client gets (4,194,304 B OK, 4,194,305 B
    RESOURCE_EXHAUSTED), random payloads included (grpcio then sends them
    uncompressed)."""
    seen = []
    message = rpc._message

    def spy(stream, encoding=None):
        seen.append((encoding, stream.data[0], len(stream.data)))
        return message(stream, encoding)

    pairs = {mod: _Pair(grpc, mod, "unix", _dir(tmp_path, mod, "client"),
                        server_compression=grpc.Compression.Gzip)
             for mod in (rpc, grpc)}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rpc, "_message", spy)
            got = {mod: [p.call("/t.T/Sized", str(n).encode())
                         for n in (LIMIT, LIMIT + 1, 300)]
                   + [p.call("/t.T/Echo", os.urandom(LIMIT))]
                   for mod, p in pairs.items()}
        assert [g[0] for g in got[rpc]] == [g[0] for g in got[grpc]] == [
            "OK", "RESOURCE_EXHAUSTED", "OK", "OK"]
        assert got[rpc][0][1] == got[grpc][0][1]
        assert got[rpc][2][1] == bytes(range(256)) + b"z" * 44
        # the Sized answers arrived gzipped, a few KB for 4 MiB
        assert [(e, flag) for e, flag, _ in seen[:3]] == [("gzip", 1)] * 3
        assert seen[0][2] < 100_000
    finally:
        for p in pairs.values():
            p.close()
