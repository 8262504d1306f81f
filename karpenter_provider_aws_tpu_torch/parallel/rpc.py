"""Unary gRPC over HTTP/2 cleartext, on the standard library alone.

The solver sidecar, the solver pool and the replication stream speak
unary gRPC with raw JSON bytes as the payload (no protobuf, no codegen).
The machine with the card has no ``grpc`` package, so this module is the
wire: the part of ``grpc``'s Python surface those modules use, under the
same names (``StatusCode``, ``RpcError``, ``GenericRpcHandler``,
``unary_unary_rpc_method_handler``, ``server``, ``insecure_channel``), over
a plain socket, ``threading`` and ``struct``. It interoperates with grpcio
in both directions.

What it speaks:

- HTTP/2 with prior knowledge on ``unix:`` paths and ``host:port``: the
  client preface, SETTINGS and their ACK, HEADERS and CONTINUATION, DATA,
  WINDOW_UPDATE, PING (acknowledged), RST_STREAM and GOAWAY. Streams are
  multiplexed on one connection per channel (odd ids). Each connection has
  a reader thread and a writer thread; every frame goes out through the
  writer's FIFO queue, so a reader never waits on a socket that its peer
  is not draining (two ends each blocked sending could otherwise hold
  each other's readers off).
  Sending honours the peer's connection and stream windows and its
  MAX_FRAME_SIZE; receiving advertises 16 MiB windows and returns what it
  consumed with WINDOW_UPDATEs.
- HPACK: the decoder keeps the 61-entry static table and the dynamic
  table (size updates, evictions) and reads every literal form, raw or
  Huffman-coded (parallel/hpack_huffman.py); a block it cannot read is
  a connection error (COMPRESSION_ERROR), never a misread header. The
  encoder sends raw literals without indexing.
- gRPC: the 5-byte length-prefixed message, read under the
  ``grpc-encoding`` its headers name: identity, ``gzip`` or ``deflate``
  (``zlib``), as grpcio reads them; another encoding is
  ``UNIMPLEMENTED``. Both ends send ``grpc-accept-encoding`` and send
  their own messages uncompressed.
  ``:status 200`` with the ``grpc-status`` and ``grpc-message`` trailers,
  ``grpc-timeout`` deadlines enforced by the client as
  ``DEADLINE_EXCEEDED`` (a handler runs to its end: the server does not
  cancel it), and grpcio's default limit of 4 MiB on a received
  message, at the server and at the client, on its length prefix and on
  its decompressed size, answered with ``RESOURCE_EXHAUSTED``. A handler that raises gives ``UNKNOWN``; a method
  no handler serves gives ``UNIMPLEMENTED``.
- Reconnects: after a failed connect a channel waits out a jittered
  backoff (the ``grpc.*_reconnect_backoff_ms`` options, grpc's defaults
  otherwise) before it tries again. A call in that window fails at once
  with ``UNAVAILABLE``, unless it passed ``wait_for_ready``, which retries
  until its deadline.
"""

from __future__ import annotations

import enum
import math
import os
import queue
import random
import re
import socket
import stat
import struct
import threading
import zlib
from collections import deque, namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.clock import WALL
from . import hpack_huffman

# grpcio's default limit on a received message, at servers and clients
MAX_MESSAGE_BYTES = 4 * 1024 * 1024

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types, flags, settings and error codes (RFC 9113)
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, \
    GOAWAY, WINDOW_UPDATE, CONTINUATION = range(10)
FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
NO_ERROR, PROTOCOL_ERROR = 0x0, 0x1
FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = 0x6, 0x7, 0x8, 0x9

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
HEADER_TABLE_SIZE = 4096
# what this end advertises for receiving: a stream's window holds the
# largest accepted message whole, the connection's is returned in halves
RECV_WINDOW = 16 * 1024 * 1024
_FRAME = struct.Struct(">IBI")   # length<<8 | type, flags, stream id
_USER_AGENT = "karpenter-port-rpc/1"
# the message encodings read, with zlib's window bits for each: gzip is
# RFC 1952's format, gRPC's "deflate" the zlib format of RFC 1950
_ENCODINGS = {"gzip": 16 + zlib.MAX_WBITS, "deflate": zlib.MAX_WBITS}
ACCEPT_ENCODING = "identity,deflate,gzip"


class StatusCode(enum.Enum):
    """gRPC status codes, with grpc's names and numbers."""
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


_CODES = {c.value: c for c in StatusCode}


class RpcError(Exception):
    """A call that ended without OK: ``code()`` and ``details()``, as on
    grpc's errors."""

    def __init__(self, code: StatusCode = StatusCode.UNKNOWN,
                 details: str = ""):
        super().__init__(code, details)
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def __str__(self) -> str:
        return (f"<RpcError of RPC that terminated with:\n\tstatus = "
                f"{self._code}\n\tdetails = \"{self._details}\">")


# ---- HPACK (RFC 7541) -----------------------------------------------------

STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""))


class HpackError(Exception):
    """A header block this decoder cannot read: the connection fails with
    COMPRESSION_ERROR."""


def _decode_int(data, pos: int, prefix_bits: int) -> Tuple[int, int]:
    mask = (1 << prefix_bits) - 1
    value = data[pos] & mask
    pos += 1
    if value < mask:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 28:
            raise HpackError("integer overflow")


def _encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    mask = (1 << prefix_bits) - 1
    if value < mask:
        return bytes([flags | value])
    out = bytearray([flags | mask])
    value -= mask
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _encode_string(s: str) -> bytes:
    raw = s.encode("latin-1")
    return _encode_int(len(raw), 7) + raw


def encode_headers(headers: Sequence[Tuple[str, str]]) -> bytes:
    """A header block of literals without indexing (new names, no
    Huffman): it leaves the peer's dynamic table as it was."""
    out = bytearray()
    for name, value in headers:
        out.append(0x00)
        out += _encode_string(name)
        out += _encode_string(value)
    return bytes(out)


class Decoder:
    """An HPACK decoder: one per connection and direction, since the
    dynamic table carries from one header block to the next."""

    def __init__(self, max_table_size: int = HEADER_TABLE_SIZE):
        self.settings_max = max_table_size
        self.max_size = max_table_size
        self.size = 0
        self.table: deque = deque()     # newest entry first

    def _entry(self, index: int) -> Tuple[str, str]:
        if index == 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HpackError(f"index {index} past the dynamic table")
        return self.table[i]

    def _evict(self) -> None:
        while self.table and self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= len(name) + len(value) + 32

    def _add(self, name: str, value: str) -> None:
        size = len(name) + len(value) + 32
        if size > self.max_size:
            # an entry larger than the table empties it (RFC 7541 §4.4)
            self.table.clear()
            self.size = 0
            return
        self.table.appendleft((name, value))
        self.size += size
        self._evict()

    def _string(self, data, pos: int) -> Tuple[str, int]:
        if pos >= len(data):
            raise HpackError("truncated string")
        huffman = data[pos] & 0x80
        length, pos = _decode_int(data, pos, 7)
        if pos + length > len(data):
            raise HpackError("truncated string")
        raw = bytes(data[pos:pos + length])
        if huffman:
            try:
                raw = hpack_huffman.decode(raw)
            except hpack_huffman.HuffmanError as e:
                raise HpackError(str(e)) from e
        return raw.decode("latin-1"), pos + length

    def decode(self, block) -> List[Tuple[str, str]]:
        headers: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:                       # indexed field
                index, pos = _decode_int(block, pos, 7)
                headers.append(self._entry(index))
            elif b & 0x40:                     # literal, incremental indexing
                index, pos = _decode_int(block, pos, 6)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                self._add(name, value)
                headers.append((name, value))
            elif b & 0x20:                     # dynamic table size update
                if headers:
                    raise HpackError("table size update after a field")
                size, pos = _decode_int(block, pos, 5)
                if size > self.settings_max:
                    raise HpackError(f"table size {size} above "
                                     f"{self.settings_max}")
                self.max_size = size
                self._evict()
            else:                              # literal, not / never indexed
                index, pos = _decode_int(block, pos, 4)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                headers.append((name, value))
        return headers


# ---- gRPC header values ---------------------------------------------------

_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
                  "n": 1e-9}


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits, rounded up; milliseconds where
    they fit (as grpcio sends them), microseconds below one."""
    units = ("u",) if seconds < 1e-3 else ("m", "S", "M", "H")
    for unit in units:
        # rounded up, less the float noise of the division
        n = max(1, math.ceil(seconds / _TIMEOUT_UNITS[unit] - 1e-6))
        if n < 10 ** 8:
            return f"{n}{unit}"
    return "99999999H"


def _percent_encode(message: str) -> str:
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in message.encode("utf-8"))


def _percent_decode(value: str) -> str:
    raw = re.sub(rb"%([0-9A-Fa-f]{2})",
                 lambda m: bytes([int(m.group(1), 16)]),
                 value.encode("latin-1"))
    return raw.decode("utf-8", errors="replace")


def _http_to_code(status: Optional[str]) -> StatusCode:
    # gRPC's table for a response that is not :status 200
    return {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
            "403": StatusCode.PERMISSION_DENIED,
            "404": StatusCode.UNIMPLEMENTED, "429": StatusCode.UNAVAILABLE,
            "502": StatusCode.UNAVAILABLE, "503": StatusCode.UNAVAILABLE,
            "504": StatusCode.UNAVAILABLE}.get(status or "",
                                               StatusCode.UNKNOWN)


def _too_large(n: int) -> str:
    return f"Received message larger than max ({n} vs. {MAX_MESSAGE_BYTES})"


# ---- addresses ------------------------------------------------------------

def parse_address(address: str):
    """``unix:PATH`` / ``unix:///ABS`` -> ("unix", path); ``host:port``,
    ``[v6]:port``, ``:port`` -> ("tcp", host, port)."""
    if address.startswith("unix:"):
        path = address[len("unix:"):]
        if path.startswith("//"):
            path = path[2:]
        if not path:
            raise ValueError(f"no path in {address!r}")
        return ("unix", path)
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"no port in address {address!r}")
    return ("tcp", host.strip("[]"), int(port))


def _listen(address: str) -> Tuple[socket.socket, int, Optional[str]]:
    kind = parse_address(address)
    if kind[0] == "unix":
        path = kind[1]
        try:
            if stat.S_ISSOCK(os.stat(path).st_mode):
                # a socket file left by a server that died: rebind over it
                os.unlink(path)
        except FileNotFoundError:
            pass
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(path)
            sock.listen(128)
        except OSError:
            sock.close()
            raise
        return sock, 1, path
    _, host, port = kind
    if host in ("", "::", "0.0.0.0"):
        infos = [(socket.AF_INET6, ("::", port)), (socket.AF_INET,
                                                  ("0.0.0.0", port))]
    else:
        infos = [(fam, addr) for fam, _, _, _, addr in socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM, flags=socket.AI_PASSIVE)]
    last = None
    for family, addr in infos:
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if family == socket.AF_INET6 and addr[0] == "::":
                sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
            sock.bind(addr)
            sock.listen(128)
        except OSError as e:
            sock.close()
            last = e
            continue
        return sock, sock.getsockname()[1], None
    raise last or OSError(f"cannot bind {address!r}")


def _connect(target, timeout: Optional[float]) -> socket.socket:
    if target[0] == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        try:
            sock.connect(target[1])
        except OSError:
            sock.close()
            raise
    else:
        sock = socket.create_connection((target[1] or "localhost", target[2]),
                                        timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock


# ---- one HTTP/2 connection ------------------------------------------------

class _ConnectionError(Exception):
    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code


class _Stream:
    def __init__(self, sid: int, send_window: int):
        self.id = sid
        self.send_window = send_window
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.data = bytearray()
        self.ended = False            # the peer sent END_STREAM
        self.reset: Optional[int] = None   # the peer's RST_STREAM code
        self.failure: Optional[Tuple[StatusCode, str]] = None
        self.done = threading.Event()

    def finished(self) -> bool:
        return self.ended or self.reset is not None or \
            self.failure is not None


class _Connection:
    """One HTTP/2 connection, either end. A reader thread takes every
    frame; a writer thread sends what ``_write`` queued, in order; senders
    wait on the condition for flow-control window."""

    def __init__(self, sock: socket.socket, client: bool, on_request=None,
                 on_close=None):
        self.sock = sock
        self.client = client
        self._buf = bytearray()
        self._out: "queue.SimpleQueue[Optional[bytes]]" = queue.SimpleQueue()
        self._writer: Optional[threading.Thread] = None
        self._open_lock = threading.Lock()   # stream ids leave in order
        self._cv = threading.Condition()
        self.streams: Dict[int, _Stream] = {}
        self._decoder = Decoder()
        self._peer_initial_window = DEFAULT_WINDOW
        self._peer_max_frame = DEFAULT_MAX_FRAME
        self._send_window = DEFAULT_WINDOW
        self._recv_unreturned = 0
        self._next_id = 1
        self._last_peer_id = 0
        self._pending_headers: Optional[Tuple[int, int, bytearray]] = None
        self._on_request = on_request
        self._on_close = on_close
        self.closed = False
        self.goaway = False
        self.close_reason = ""

    def start(self) -> "_Connection":
        settings = [(SETTINGS_INITIAL_WINDOW_SIZE, RECV_WINDOW)]
        if self.client:
            settings.append((SETTINGS_ENABLE_PUSH, 0))
        out = bytearray(PREFACE if self.client else b"")
        payload = b"".join(struct.pack(">HI", k, v) for k, v in settings)
        out += self._frame(SETTINGS, 0, 0, payload)
        out += self._frame(WINDOW_UPDATE, 0, 0,
                           struct.pack(">I", RECV_WINDOW - DEFAULT_WINDOW))
        self._write(bytes(out))
        end = "client" if self.client else "server"
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name=f"rpc-{end}-writer")
        self._writer.start()
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"rpc-{end}-reader").start()
        return self

    # ---- writing

    @staticmethod
    def _frame(ftype: int, flags: int, sid: int, payload=b"") -> bytes:
        return _FRAME.pack(len(payload) << 8 | ftype, flags, sid) + \
            bytes(payload)

    def _write(self, data: bytes) -> None:
        """Queue ``data`` for the writer thread; ConnectionError once the
        connection closed."""
        if self.closed:
            raise ConnectionError(self.close_reason)
        self._out.put(data)

    def _write_loop(self) -> None:
        try:
            while True:
                data = self._out.get()
                if data is None:
                    return
                self.sock.sendall(data)
        except OSError as e:
            self.close(f"connection lost: {e}")

    def _header_frames(self, sid: int, headers, end_stream: bool) -> bytes:
        block = encode_headers(headers)
        step = self._peer_max_frame
        chunks = [block[i:i + step] for i in range(0, len(block), step)] or \
            [b""]
        out = bytearray()
        for i, chunk in enumerate(chunks):
            flags = FLAG_END_HEADERS if i == len(chunks) - 1 else 0
            if i == 0:
                out += self._frame(HEADERS, flags | (
                    FLAG_END_STREAM if end_stream else 0), sid, chunk)
            else:
                out += self._frame(CONTINUATION, flags, sid, chunk)
        return bytes(out)

    def send_headers(self, sid: int, headers, end_stream: bool) -> None:
        self._write(self._header_frames(sid, headers, end_stream))

    def send_data(self, stream: _Stream, payload: bytes, end_stream: bool,
                  deadline: Optional[float] = None) -> bool:
        """Send ``payload`` on ``stream`` within the peer's windows and
        frame size. False when the peer finished or reset the stream
        first (a server that answered early); raises TimeoutError at the
        deadline and ConnectionError when the connection closed."""
        view = memoryview(payload)
        pos = 0
        while True:
            with self._cv:
                while True:
                    if self.closed:
                        raise ConnectionError(self.close_reason)
                    # a client stops when the server answered early, a
                    # server when the client reset the call
                    stop = stream.finished() if self.client else \
                        stream.reset is not None
                    if stop:
                        return False
                    n = min(len(view) - pos, self._send_window,
                            stream.send_window, self._peer_max_frame)
                    if n > 0 or pos == len(view):
                        break
                    wait = None if deadline is None else \
                        deadline - WALL.monotonic()
                    if wait is not None and wait <= 0:
                        raise TimeoutError
                    self._cv.wait(wait)
                self._send_window -= n
                stream.send_window -= n
            last = pos + n == len(view)
            self._write(self._frame(
                DATA, FLAG_END_STREAM if last and end_stream else 0,
                stream.id, view[pos:pos + n]))
            pos += n
            if last:
                return True

    def reset_stream(self, sid: int, code: int) -> None:
        with self._cv:
            self.streams.pop(sid, None)
        try:
            self._write(self._frame(RST_STREAM, 0, sid,
                                    struct.pack(">I", code)))
        except ConnectionError:
            pass

    # ---- reading

    def _read_exact(self, n: int) -> bytes:
        buf = self._buf
        while len(buf) < n:
            chunk = self.sock.recv(max(1 << 16, n - len(buf)))
            if not chunk:
                raise EOFError("connection closed by the peer")
            buf += chunk
        data = bytes(buf[:n])
        del buf[:n]
        return data

    def _read_loop(self) -> None:
        reason = "connection closed"
        try:
            if not self.client and self._read_exact(len(PREFACE)) != PREFACE:
                raise _ConnectionError(PROTOCOL_ERROR, "bad client preface")
            while True:
                head = self._read_exact(9)
                length_type, flags, sid = _FRAME.unpack(head)
                length, ftype = length_type >> 8, length_type & 0xFF
                sid &= 0x7FFFFFFF
                if length > DEFAULT_MAX_FRAME:
                    raise _ConnectionError(FRAME_SIZE_ERROR,
                                           f"frame of {length} bytes")
                payload = self._read_exact(length) if length else b""
                self._on_frame(ftype, flags, sid, payload)
        except HpackError as e:
            reason = f"HPACK COMPRESSION_ERROR: {e}"
            self._goaway(COMPRESSION_ERROR, reason)
        except _ConnectionError as e:
            reason = f"HTTP/2 connection error {e.code}: {e}"
            self._goaway(e.code, reason)
        except (OSError, EOFError, ValueError) as e:
            reason = f"connection lost: {e}"
        finally:
            self.close(reason, flush=True)

    def _goaway(self, code: int, reason: str) -> None:
        try:
            self._write(self._frame(GOAWAY, 0, 0, struct.pack(
                ">II", self._last_peer_id, code) + reason.encode()[:256]))
        except ConnectionError:
            pass

    def _on_frame(self, ftype: int, flags: int, sid: int, payload) -> None:
        if self._pending_headers is not None and ftype != CONTINUATION:
            raise _ConnectionError(PROTOCOL_ERROR,
                                   "header block interrupted")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            if sid == 0:
                raise _ConnectionError(PROTOCOL_ERROR, "HEADERS on stream 0")
            body = self._unpad(flags, payload)
            if flags & FLAG_PRIORITY:
                body = body[5:]
            self._pending_headers = (sid, flags, bytearray(body))
            if flags & FLAG_END_HEADERS:
                self._end_headers()
        elif ftype == CONTINUATION:
            pending = self._pending_headers
            if pending is None or pending[0] != sid:
                raise _ConnectionError(PROTOCOL_ERROR, "stray CONTINUATION")
            pending[2].extend(payload)
            if flags & FLAG_END_HEADERS:
                self._end_headers()
        elif ftype == RST_STREAM:
            (code,) = struct.unpack(">I", payload[:4])
            with self._cv:
                stream = self.streams.pop(sid, None)
                if stream is not None:
                    stream.reset = code
                    stream.done.set()
                self._cv.notify_all()
        elif ftype == SETTINGS:
            if not flags & FLAG_ACK:
                self._on_settings(payload)
        elif ftype == PING:
            if not flags & FLAG_ACK:
                self._write(self._frame(PING, FLAG_ACK, 0, payload))
        elif ftype == GOAWAY:
            last_id, _ = struct.unpack(">II", payload[:8])
            self._on_goaway(last_id & 0x7FFFFFFF)
        elif ftype == WINDOW_UPDATE:
            (inc,) = struct.unpack(">I", payload[:4])
            with self._cv:
                if sid == 0:
                    self._send_window += inc & 0x7FFFFFFF
                elif sid in self.streams:
                    self.streams[sid].send_window += inc & 0x7FFFFFFF
                self._cv.notify_all()
        elif ftype == PUSH_PROMISE:
            raise _ConnectionError(PROTOCOL_ERROR, "PUSH_PROMISE refused")
        # PRIORITY and unknown frame types are ignored

    @staticmethod
    def _unpad(flags: int, payload):
        if not flags & FLAG_PADDED:
            return payload
        pad = payload[0]
        if pad >= len(payload):
            raise _ConnectionError(PROTOCOL_ERROR, "padding past the frame")
        return payload[1:len(payload) - pad]

    def _on_settings(self, payload) -> None:
        with self._cv:
            for i in range(0, len(payload) - 5, 6):
                key, value = struct.unpack(">HI", payload[i:i + 6])
                if key == SETTINGS_INITIAL_WINDOW_SIZE:
                    delta = value - self._peer_initial_window
                    self._peer_initial_window = value
                    for stream in self.streams.values():
                        stream.send_window += delta
                elif key == SETTINGS_MAX_FRAME_SIZE:
                    self._peer_max_frame = value
            self._cv.notify_all()
        self._write(self._frame(SETTINGS, FLAG_ACK, 0))

    def _on_goaway(self, last_id: int) -> None:
        with self._cv:
            self.goaway = True
            if self.client:
                for sid in [s for s in self.streams if s > last_id]:
                    stream = self.streams.pop(sid)
                    stream.failure = (StatusCode.UNAVAILABLE,
                                      "the server went away before the call")
                    stream.done.set()
            self._cv.notify_all()

    def _on_data(self, flags: int, sid: int, payload) -> None:
        if sid == 0:
            raise _ConnectionError(PROTOCOL_ERROR, "DATA on stream 0")
        # every DATA byte, padding included, counts against the
        # connection window; return it in halves of the window
        self._recv_unreturned += len(payload)
        if self._recv_unreturned >= RECV_WINDOW // 2:
            self._write(self._frame(WINDOW_UPDATE, 0, 0, struct.pack(
                ">I", self._recv_unreturned)))
            self._recv_unreturned = 0
        body = self._unpad(flags, payload)
        with self._cv:
            stream = self.streams.get(sid)
        if stream is None:
            return       # a stream this end already finished or reset
        stream.data += body
        if len(stream.data) >= 5:
            (n,) = struct.unpack(">I", stream.data[1:5])
            if n > MAX_MESSAGE_BYTES:
                self._message_too_large(stream, n)
                return
        if flags & FLAG_END_STREAM:
            self._end_stream(stream)

    def _message_too_large(self, stream: _Stream, n: int) -> None:
        if self.client:
            stream.failure = (StatusCode.RESOURCE_EXHAUSTED, _too_large(n))
            self.reset_stream(stream.id, CANCEL)
            stream.done.set()
        else:
            self.respond(stream, None, StatusCode.RESOURCE_EXHAUSTED,
                         _too_large(n))
            self.reset_stream(stream.id, NO_ERROR)

    def _end_headers(self) -> None:
        sid, flags, block = self._pending_headers
        self._pending_headers = None
        # decode even for a stream this end dropped: the dynamic table
        # must see every block in order
        headers = self._decoder.decode(block)
        with self._cv:
            stream = self.streams.get(sid)
            if stream is None and not self.client:
                if sid % 2 == 0 or sid <= self._last_peer_id:
                    raise _ConnectionError(PROTOCOL_ERROR,
                                           f"stream id {sid} reused")
                self._last_peer_id = sid
                stream = self.streams[sid] = _Stream(
                    sid, self._peer_initial_window)
        if stream is None:
            return
        if stream.headers is None:
            stream.headers = headers
        else:
            stream.trailers = headers
        if flags & FLAG_END_STREAM:
            self._end_stream(stream)

    def _end_stream(self, stream: _Stream) -> None:
        with self._cv:
            stream.ended = True
            if self.client:
                self.streams.pop(stream.id, None)
            self._cv.notify_all()
        if self.client:
            stream.done.set()
        else:
            self._on_request(self, stream)

    def close(self, reason: str = "connection closed",
              flush: bool = False) -> None:
        """Fail the open streams and close the socket; with ``flush``,
        first give the writer a second to send what it holds (a GOAWAY)."""
        with self._cv:
            if self.closed:
                return
            self.closed = True
            self.close_reason = reason
            streams = list(self.streams.values())
            self.streams.clear()
            self._cv.notify_all()
        for stream in streams:
            if stream.failure is None:
                stream.failure = (StatusCode.UNAVAILABLE, reason)
            stream.done.set()
        self._out.put(None)
        writer = self._writer
        if flush and writer is not None and \
                writer is not threading.current_thread():
            writer.join(1.0)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        if self._on_close is not None:
            self._on_close(self)

    # ---- the client's call

    def call(self, method: str, authority: str, request: bytes,
             deadline: Optional[float]) -> _Stream:
        """Open a stream, send the request and wait for the answer (or the
        deadline). Raises RpcError for a failure before an answer."""
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", method), (":authority", authority),
                   ("content-type", "application/grpc"), ("te", "trailers"),
                   ("grpc-accept-encoding", ACCEPT_ENCODING),
                   ("user-agent", _USER_AGENT)]
        if deadline is not None:
            headers.append(("grpc-timeout", encode_timeout(
                max(deadline - WALL.monotonic(), 0.0))))
        # stream ids must reach the peer in increasing order: take the id
        # and queue the HEADERS under one lock
        with self._open_lock:
            with self._cv:
                if self.closed or self.goaway:
                    raise ConnectionError(self.close_reason or "going away")
                stream = _Stream(self._next_id, self._peer_initial_window)
                self._next_id += 2
                self.streams[stream.id] = stream
            self._write(self._header_frames(stream.id, headers, False))
        try:
            self.send_data(stream, struct.pack(">BI", 0, len(request))
                           + request, True, deadline)
        except TimeoutError:
            self.reset_stream(stream.id, CANCEL)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE, f"connection lost: {e}")
        wait = None if deadline is None else deadline - WALL.monotonic()
        if not stream.done.wait(None if wait is None else max(wait, 0.0)):
            self.reset_stream(stream.id, CANCEL)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        return stream

    # ---- the server's answer

    def respond(self, stream: _Stream, message: Optional[bytes],
                code: StatusCode = StatusCode.OK, details: str = "") -> None:
        """Answer ``stream``: the message with OK, or a trailers-only
        status. Nothing is sent once the client reset the stream."""
        if stream.reset is not None:
            return
        status = [(":status", "200"), ("content-type", "application/grpc"),
                  ("grpc-accept-encoding", ACCEPT_ENCODING)]
        trailers = [("grpc-status", str(code.value))]
        if details:
            trailers.append(("grpc-message", _percent_encode(details)))
        try:
            if message is None:
                self.send_headers(stream.id, status + trailers, True)
            else:
                self.send_headers(stream.id, status, False)
                if self.send_data(stream, struct.pack(">BI", 0, len(message))
                                  + message, False):
                    self.send_headers(stream.id, trailers, True)
        except OSError:
            pass         # the client went away; nobody waits for this answer
        with self._cv:
            self.streams.pop(stream.id, None)


def _message(stream: _Stream, encoding: Optional[str] = None) -> bytes:
    """The one message of a finished stream, decompressed under the
    ``grpc-encoding`` of its headers; RpcError for a malformed one, an
    encoding not read here, or a decompressed size over the limit."""
    data = stream.data
    if len(data) < 5:
        raise RpcError(StatusCode.INTERNAL, "no message in the stream")
    flag, n = struct.unpack(">BI", data[:5])
    if len(data) != 5 + n:
        raise RpcError(StatusCode.INTERNAL,
                       "not exactly one message in a unary call")
    body = bytes(data[5:])
    if not flag or encoding in (None, "", "identity"):
        # grpcio reads a flagged message under the identity encoding as
        # it stands
        return body
    wbits = _ENCODINGS.get(encoding)
    if wbits is None:
        raise RpcError(StatusCode.UNIMPLEMENTED,
                       f"Compression algorithm '{encoding}' is not "
                       "supported")
    inflater = zlib.decompressobj(wbits)
    try:
        out = inflater.decompress(body, MAX_MESSAGE_BYTES + 1)
    except zlib.error as e:
        raise RpcError(StatusCode.INTERNAL,
                       f"Unexpected error decompressing data for algorithm "
                       f"{encoding}: {e}") from e
    if len(out) > MAX_MESSAGE_BYTES:
        # stop at the limit: what is left is never inflated
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                       f"Received message larger than max (more than "
                       f"{MAX_MESSAGE_BYTES} vs. {MAX_MESSAGE_BYTES})")
    if not inflater.eof:
        raise RpcError(StatusCode.INTERNAL,
                       f"Unexpected error decompressing data for algorithm "
                       f"{encoding}: truncated")
    return out


# ---- server ---------------------------------------------------------------

HandlerCallDetails = namedtuple("HandlerCallDetails",
                                ("method", "invocation_metadata"))
RpcMethodHandler = namedtuple("RpcMethodHandler", ("unary_unary",))


class GenericRpcHandler:
    """Subclasses answer ``service(handler_call_details)`` with a method
    handler, or None for a method they do not serve."""

    def service(self, handler_call_details):
        raise NotImplementedError


def unary_unary_rpc_method_handler(behavior):
    """``behavior(request_bytes, context) -> response_bytes``; the context
    is None (the handlers served here read none)."""
    return RpcMethodHandler(behavior)


class Server:
    """A gRPC server: an accept thread per bound address, a reader thread
    per connection, and every call run on the executor."""

    def __init__(self, executor):
        self._executor = executor
        self._handlers: List[GenericRpcHandler] = []
        self._listeners: List[Tuple[socket.socket, Optional[str]]] = []
        self._conns = set()
        self._lock = threading.Lock()
        self._active = 0
        self._idle = threading.Condition(self._lock)
        self._stopped = False

    def add_generic_rpc_handlers(self, handlers) -> None:
        self._handlers.extend(handlers)

    def add_insecure_port(self, address: str) -> int:
        """Bind ``address``; the bound port (1 for ``unix:``). A bind that
        fails raises RuntimeError, as grpcio's does."""
        try:
            sock, port, path = _listen(address)
        except (OSError, ValueError) as e:
            raise RuntimeError(f"Failed to bind to address {address}: {e}") \
                from e
        self._listeners.append((sock, path))
        return port

    def start(self) -> None:
        for sock, _ in self._listeners:
            threading.Thread(target=self._accept_loop, args=(sock,),
                             daemon=True, name="rpc-accept").start()

    def _accept_loop(self, listener: socket.socket) -> None:
        while True:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            with self._lock:
                if self._stopped:
                    sock.close()
                    return
                conn = _Connection(sock, client=False,
                                   on_request=self._dispatch,
                                   on_close=self._forget)
                self._conns.add(conn)
            try:
                conn.start()
            except OSError:
                conn.close()

    def _forget(self, conn: _Connection) -> None:
        with self._lock:
            self._conns.discard(conn)

    def _dispatch(self, conn: _Connection, stream: _Stream) -> None:
        headers = stream.headers or []
        fields = dict(headers)
        method = fields.get(":path", "")
        metadata = tuple((k, v) for k, v in headers if not k.startswith(":"))
        details = HandlerCallDetails(method, metadata)
        handler = None
        for h in self._handlers:
            handler = h.service(details)
            if handler is not None:
                break
        if handler is None:
            conn.respond(stream, None, StatusCode.UNIMPLEMENTED,
                         "Method not found!")
            return
        try:
            request = _message(stream, fields.get("grpc-encoding"))
        except RpcError as e:
            conn.respond(stream, None, e.code(), e.details())
            return
        with self._lock:
            self._active += 1
        try:
            self._executor.submit(self._run, conn, stream, handler, request)
        except RuntimeError:      # the executor was shut down
            self._done()
            conn.respond(stream, None, StatusCode.UNAVAILABLE,
                         "the server is shutting down")

    def _run(self, conn, stream, handler, request) -> None:
        try:
            try:
                response = handler.unary_unary(request, None)
            except Exception as e:   # noqa: BLE001 — the call's status
                conn.respond(stream, None, StatusCode.UNKNOWN,
                             f"Exception calling application: {e}")
            else:
                conn.respond(stream, bytes(response))
        finally:
            self._done()

    def _done(self) -> None:
        with self._lock:
            self._active -= 1
            self._idle.notify_all()

    def stop(self, grace: Optional[float]) -> threading.Event:
        """Stop accepting; with a ``grace``, give calls in flight that long
        to finish; then close every connection (the calls left fail at
        their clients). Returns a set event, as grpcio's does once done."""
        with self._lock:
            self._stopped = True
            listeners, self._listeners = self._listeners, []
        for sock, path in listeners:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
            if path is not None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
        if grace:
            end = WALL.monotonic() + grace
            with self._lock:
                while self._active and WALL.monotonic() < end:
                    self._idle.wait(end - WALL.monotonic())
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close("the server stopped")
        done = threading.Event()
        done.set()
        return done


def server(thread_pool) -> Server:
    return Server(thread_pool)


# ---- client ---------------------------------------------------------------

_BACKOFF_MULTIPLIER = 1.6
_BACKOFF_JITTER = 0.2


class Channel:
    """A client channel: one multiplexed connection, made on first use and
    again after it closes, with grpc's reconnect backoff between failed
    connects."""

    def __init__(self, target: str, options=None):
        self._target = parse_address(target)
        if self._target[0] == "unix":
            self._authority = "localhost"
        else:
            host = self._target[1] or "localhost"
            self._authority = (f"[{host}]" if ":" in host else host) + \
                f":{self._target[2]}"
        opts = dict(options or ())
        # grpc's defaults: 1 s first backoff, 120 s ceiling, and 20 s
        # for the least time a connect attempt is given
        self._backoff_initial = opts.pop(
            "grpc.initial_reconnect_backoff_ms", 1000) / 1e3
        self._backoff_min = opts.pop("grpc.min_reconnect_backoff_ms",
                                     20000) / 1e3
        self._backoff_max = opts.pop("grpc.max_reconnect_backoff_ms",
                                     120000) / 1e3
        if opts:
            raise ValueError(f"unsupported channel options: {sorted(opts)}")
        self._lock = threading.Lock()
        self._conn: Optional[_Connection] = None
        self._backoff: Optional[float] = None
        self._retry_at = 0.0
        self._last_error = ""
        self._closed = False
        self._rng = random.Random()

    def unary_unary(self, method: str):
        def call(request: bytes, timeout: Optional[float] = None,
                 wait_for_ready: Optional[bool] = None):
            deadline = None if timeout is None else \
                WALL.monotonic() + timeout
            return self._call(method, request, deadline, bool(wait_for_ready))
        return call

    def _call(self, method: str, request: bytes, deadline: Optional[float],
              wait_for_ready: bool) -> bytes:
        for attempt in (0, 1):
            conn = self._connection(deadline, wait_for_ready)
            try:
                stream = conn.call(method, self._authority, request, deadline)
            except OSError as e:
                # the connection died before the request left: one retry
                # on a fresh connection, as grpc's transparent retry
                conn.close(f"connection lost: {e}")
                if attempt:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"connection lost: {e}")
                continue
            return self._result(stream)
        raise AssertionError("unreachable")

    def _connection(self, deadline: Optional[float],
                    wait_for_ready: bool) -> _Connection:
        while True:
            with self._lock:
                if self._closed:
                    raise RpcError(StatusCode.CANCELLED, "Channel closed!")
                conn = self._conn
                if conn is not None and not conn.closed and not conn.goaway:
                    return conn
                now = WALL.monotonic()
                if now >= self._retry_at:
                    limit = max(self._backoff_min,
                                self._backoff or self._backoff_initial)
                    if deadline is not None:
                        limit = max(min(limit, deadline - now), 1e-3)
                    try:
                        sock = _connect(self._target, limit)
                    except OSError as e:
                        self._last_error = f"{self._target}: {e}"
                        self._backoff = self._backoff_initial \
                            if self._backoff is None else min(
                                self._backoff * _BACKOFF_MULTIPLIER,
                                self._backoff_max)
                        jitter = 1 + _BACKOFF_JITTER * (
                            2 * self._rng.random() - 1)
                        self._retry_at = now + self._backoff * jitter
                    else:
                        self._backoff = None
                        self._conn = _Connection(sock, client=True).start()
                        return self._conn
                retry_at = self._retry_at
            if not wait_for_ready:
                raise RpcError(StatusCode.UNAVAILABLE,
                               "failed to connect to all addresses; last "
                               f"error: {self._last_error}")
            now = WALL.monotonic()
            if deadline is not None and retry_at >= deadline:
                WALL.sleep(max(deadline - now, 0.0))
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               "Deadline Exceeded")
            WALL.sleep(max(retry_at - now, 0.0))

    @staticmethod
    def _result(stream: _Stream) -> bytes:
        if stream.failure is not None:
            raise RpcError(*stream.failure)
        if stream.reset is not None and not stream.ended:
            raise RpcError({REFUSED_STREAM: StatusCode.UNAVAILABLE,
                            CANCEL: StatusCode.CANCELLED}.get(
                                stream.reset, StatusCode.INTERNAL),
                           f"stream reset by the peer (code {stream.reset})")
        headers = dict(stream.headers or ())
        trailers = dict(stream.trailers) if stream.trailers is not None \
            else headers
        if headers.get(":status") != "200":
            raise RpcError(_http_to_code(headers.get(":status")),
                           f"Received http2 header with status: "
                           f"{headers.get(':status')}")
        if "grpc-status" not in trailers:
            raise RpcError(StatusCode.INTERNAL,
                           "the answer carries no grpc-status")
        code = _CODES.get(int(trailers["grpc-status"]), StatusCode.UNKNOWN)
        if code is not StatusCode.OK:
            raise RpcError(code, _percent_decode(
                trailers.get("grpc-message", "")))
        return _message(stream, headers.get("grpc-encoding"))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close("Channel closed!")


def insecure_channel(target: str, options=None) -> Channel:
    return Channel(target, options)
