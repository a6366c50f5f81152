"""A minimal HTTP/2 server and client for unary gRPC, over ``socket`` and
``threading``.

The TF profiler's capture button (TensorBoard's profile plugin, xprof's
``trace``) calls ``/tensorflow.ProfilerService/Profile`` over gRPC on
cleartext HTTP/2 with prior knowledge. The card machine has no
``grpcio``, so this module speaks the protocol itself (RFC 9113, RFC 7541
and gRPC's HTTP/2 mapping), as far as unary calls need it:

- frames: the client preface, SETTINGS (and their ACK), PING (answered),
  WINDOW_UPDATE, HEADERS with CONTINUATION, DATA, RST_STREAM and GOAWAY;
  padding and priority fields are read and dropped, unknown frame types
  ignored;
- flow control: every DATA frame received is handed back at once with a
  WINDOW_UPDATE on the connection and its stream; what is sent waits for
  the peer's connection and stream windows and is cut at its
  ``MAX_FRAME_SIZE``;
- HPACK: the decoder keeps the static and the dynamic table with its
  size updates and reads integer and string literals. Strings must be
  raw: gRPC's C-core clients send non-binary headers without Huffman
  coding, and a Huffman-coded one is answered with a gRPC error that
  names it (then the connection is closed, since the dynamic table can
  no longer be kept); it is never guessed. The encoder writes literals
  that are never indexed;
- gRPC: one length-prefixed message each way, ``content-type:
  application/grpc``, the status in the trailers (``grpc-status``, a
  percent-encoded ``grpc-message``); an unknown ``:path`` answers 12
  (UNIMPLEMENTED).

Each connection has a reader thread and each call a thread of its own,
so a handler may take as long as a capture lasts while the reader goes
on answering PINGs and seeing cancellations.
"""

from __future__ import annotations

import logging
import socket
import threading
from dataclasses import dataclass, field
from typing import Callable
from urllib.parse import quote, unquote

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, RST_STREAM, SETTINGS = 0, 1, 3, 4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 5, 6, 7, 8, 9
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20

SETTINGS_INITIAL_WINDOW_SIZE, SETTINGS_MAX_FRAME_SIZE = 0x4, 0x5
NO_ERROR, PROTOCOL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, 0x3
FRAME_SIZE_ERROR, COMPRESSION_ERROR = 0x6, 0x9

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
# The HPACK table's SETTINGS_HEADER_TABLE_SIZE: the default, as neither
# side sends the setting.
HEADER_TABLE_SIZE = 4096
MAX_WINDOW = (1 << 31) - 1
# The largest request a call takes: gRPC's default receive limit.
MAX_MESSAGE = 4 << 20

# gRPC status codes (grpc/status.h).
OK, CANCELLED, UNKNOWN, INVALID_ARGUMENT = 0, 1, 2, 3
RESOURCE_EXHAUSTED, UNIMPLEMENTED, INTERNAL, UNAVAILABLE = 8, 12, 13, 14

_log = logging.getLogger(__name__)
# What grpc-message carries as it is; the rest is percent-encoded.
_PRINTABLE = "".join(chr(c) for c in range(0x20, 0x7F) if chr(c) != "%")

# RFC 7541, Appendix A.
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
    ("via", ""), ("www-authenticate", ""),
)


class GrpcError(Exception):
    """A call's non-OK status: ``code`` (grpc/status.h) and a message."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(f"gRPC status {code}: {message}")
        self.code = code
        self.message = message


class HpackError(ValueError):
    """A header block this decoder cannot read (a COMPRESSION_ERROR)."""


class HuffmanCoded(HpackError):
    """A Huffman-coded string: this decoder reads raw strings only."""


class H2ConnectionError(Exception):
    """A connection error: GOAWAY with ``code``, then close."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


# ---- HPACK ---------------------------------------------------------------------


def _read_int(data, pos: int, prefix: int) -> tuple:
    """(value, next position) of an integer with a ``prefix``-bit prefix
    (RFC 7541, 5.1)."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        byte = data[pos]
        pos += 1
        value += (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 28:
            raise HpackError("integer too large")


def _int(value: int, prefix: int, first: int = 0) -> bytes:
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _string(data: str) -> bytes:
    raw = data.encode()
    return _int(len(raw), 7) + raw


def encode_headers(headers) -> bytes:
    """A header block of ``(name, value)`` pairs: ``:status: 200`` as its
    static index, everything else as a literal never indexed with a raw
    name and value, so the peer's tables never change."""
    out = bytearray()
    for name, value in headers:
        if (name, value) == (":status", "200"):
            out.append(0x88)
        else:
            out += b"\x10" + _string(name) + _string(value)
    return bytes(out)


class HpackDecoder:
    """The receiving side's HPACK state for one connection."""

    def __init__(self):
        # The encoder's current choice, at most HEADER_TABLE_SIZE.
        self.max_size = HEADER_TABLE_SIZE
        self.table: list = []     # newest first
        self.size = 0

    def _entry(self, index: int) -> tuple:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        dynamic = index - len(STATIC_TABLE) - 1
        if index == 0 or dynamic >= len(self.table):
            raise HpackError(f"header index {index} is out of the table")
        return self.table[dynamic]

    def _evict(self) -> None:
        while self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= 32 + len(name.encode()) + len(value.encode())

    def _add(self, name: str, value: str) -> None:
        self.table.insert(0, (name, value))
        self.size += 32 + len(name.encode()) + len(value.encode())
        self._evict()

    def _read_string(self, data, pos: int, what: str) -> tuple:
        if pos >= len(data):
            raise HpackError("truncated string")
        huffman = data[pos] & 0x80
        size, pos = _read_int(data, pos, 7)
        if pos + size > len(data):
            raise HpackError("truncated string")
        if huffman:
            raise HuffmanCoded(
                f"{what} is Huffman-coded; this server reads raw HPACK "
                "strings only")
        return bytes(data[pos:pos + size]).decode("latin-1"), pos + size

    def decode(self, block: bytes) -> list:
        """The ``(name, value)`` pairs of one complete header block."""
        headers = []
        pos = 0
        while pos < len(block):
            byte = block[pos]
            if byte & 0x80:                       # indexed field
                index, pos = _read_int(block, pos, 7)
                headers.append(self._entry(index))
                continue
            if byte & 0xE0 == 0x20:               # dynamic table size update
                size, pos = _read_int(block, pos, 5)
                if size > HEADER_TABLE_SIZE:
                    raise HpackError(
                        f"table size {size} above {HEADER_TABLE_SIZE}")
                self.max_size = size
                self._evict()
                continue
            indexing = byte & 0xC0 == 0x40
            index, pos = _read_int(block, pos, 6 if indexing else 4)
            if index:
                name = self._entry(index)[0]
            else:
                name, pos = self._read_string(block, pos, "a header name")
            value, pos = self._read_string(block, pos,
                                           f"the value of {name!r}")
            headers.append((name, value))
            if indexing:
                self._add(name, value)
        return headers


# ---- frames --------------------------------------------------------------------


def frame(kind: int, flags: int, stream: int, payload: bytes = b"") -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([kind, flags])
            + stream.to_bytes(4, "big") + payload)


def _read_exact(rfile, n: int) -> bytes:
    data = rfile.read(n)
    if len(data) < n:
        raise EOFError("connection closed")
    return data


def read_frame(rfile, max_size: int = DEFAULT_MAX_FRAME) -> tuple:
    """(type, flags, stream id, payload) of the next frame."""
    head = _read_exact(rfile, 9)
    size = int.from_bytes(head[:3], "big")
    if size > max_size:
        raise H2ConnectionError(FRAME_SIZE_ERROR,
                               f"a frame of {size} bytes above {max_size}")
    stream = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
    return head[3], head[4], stream, _read_exact(rfile, size)


def _unpad(flags: int, payload: bytes, priority: bool = False) -> bytes:
    if flags & PADDED:
        if not payload or payload[0] >= len(payload):
            raise H2ConnectionError(PROTOCOL_ERROR, "bad padding")
        payload = payload[1:len(payload) - payload[0]]
    if priority and flags & PRIORITY_FLAG:
        payload = payload[5:]
    return payload


def _settings(payload: bytes) -> dict:
    if len(payload) % 6:
        raise H2ConnectionError(FRAME_SIZE_ERROR, "SETTINGS length")
    return {int.from_bytes(payload[i:i + 2], "big"):
            int.from_bytes(payload[i + 2:i + 6], "big")
            for i in range(0, len(payload), 6)}


def grpc_message(body: bytes) -> bytes:
    """``body`` with gRPC's 5-byte prefix (not compressed, its length)."""
    return b"\x00" + len(body).to_bytes(4, "big") + body


def grpc_unframe(data: bytes) -> bytes:
    """The one message of a unary call's body."""
    if len(data) < 5:
        raise GrpcError(INTERNAL, "the body holds no gRPC message")
    if data[0]:
        raise GrpcError(UNIMPLEMENTED,
                        "compressed messages are not accepted")
    size = int.from_bytes(data[1:5], "big")
    if len(data) != 5 + size:
        raise GrpcError(INTERNAL, "the body is not one gRPC message")
    return data[5:]


# ---- the server ----------------------------------------------------------------


@dataclass
class Call:
    """One unary call as its handler sees it."""

    path: str
    headers: dict
    cancelled: threading.Event = field(default_factory=threading.Event)


Handler = Callable[[bytes, Call], bytes]


@dataclass
class _Stream:
    id: int
    send_window: int
    headers: dict = field(default_factory=dict)
    body: bytearray = field(default_factory=bytearray)
    call: Call | None = None
    closed: bool = False          # reset, or our side ended


class _Connection:
    def __init__(self, server: "Server", sock: socket.socket):
        self.server = server
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self.hpack = HpackDecoder()
        self.write_lock = threading.Lock()
        self.flow = threading.Condition()
        self.send_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.streams: dict = {}
        self.last_stream = 0
        self.closed = False

    def send(self, kind: int, flags: int, stream: int,
             payload: bytes = b"") -> None:
        with self.write_lock:
            self.sock.sendall(frame(kind, flags, stream, payload))

    def run(self) -> None:
        try:
            if _read_exact(self.rfile, len(PREFACE)) != PREFACE:
                raise H2ConnectionError(PROTOCOL_ERROR, "no client preface")
            self.send(SETTINGS, 0, 0)
            while True:
                self._on_frame(*read_frame(self.rfile))
        except H2ConnectionError as exc:
            _log.warning("profiler server: HTTP/2 connection error: %s", exc)
            self._goaway(exc.code, str(exc))
        except (EOFError, OSError):
            pass
        finally:
            self.close()

    def _goaway(self, code: int, message: str) -> None:
        try:
            self.send(GOAWAY, 0, 0, self.last_stream.to_bytes(4, "big")
                      + code.to_bytes(4, "big") + message.encode()[:256])
        except OSError:
            pass

    def close(self) -> None:
        with self.flow:
            self.closed = True
            for stream in self.streams.values():
                if stream.call is not None:
                    stream.call.cancelled.set()
            self.flow.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self.server._forget(self)

    def _on_frame(self, kind: int, flags: int, sid: int,
                  payload: bytes) -> None:
        if kind == SETTINGS:
            if sid:
                raise H2ConnectionError(PROTOCOL_ERROR, "SETTINGS on a stream")
            if not flags & ACK:
                self._apply_settings(_settings(payload))
                self.send(SETTINGS, ACK, 0)
        elif kind == PING:
            if len(payload) != 8 or sid:
                raise H2ConnectionError(PROTOCOL_ERROR, "bad PING")
            if not flags & ACK:
                self.send(PING, ACK, 0, payload)
        elif kind == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif kind == HEADERS:
            self._on_headers(sid, flags, payload)
        elif kind == DATA:
            self._on_data(sid, flags, payload)
        elif kind == RST_STREAM:
            with self.flow:
                stream = self.streams.pop(sid, None)
                if stream is not None:
                    stream.closed = True
                    if stream.call is not None:
                        stream.call.cancelled.set()
                self.flow.notify_all()
        elif kind == GOAWAY:
            raise EOFError("the client went away")
        elif kind in (PUSH_PROMISE, CONTINUATION):
            raise H2ConnectionError(PROTOCOL_ERROR,
                                   f"unexpected frame type {kind}")
        # PRIORITY and unknown types: nothing to do.

    def _apply_settings(self, settings: dict) -> None:
        with self.flow:
            if SETTINGS_INITIAL_WINDOW_SIZE in settings:
                size = settings[SETTINGS_INITIAL_WINDOW_SIZE]
                if size > MAX_WINDOW:
                    raise H2ConnectionError(FLOW_CONTROL_ERROR,
                                           "initial window too large")
                delta = size - self.peer_initial_window
                self.peer_initial_window = size
                for stream in self.streams.values():
                    stream.send_window += delta
            if SETTINGS_MAX_FRAME_SIZE in settings:
                size = settings[SETTINGS_MAX_FRAME_SIZE]
                if not DEFAULT_MAX_FRAME <= size < 1 << 24:
                    raise H2ConnectionError(PROTOCOL_ERROR,
                                           "bad SETTINGS_MAX_FRAME_SIZE")
                self.peer_max_frame = size
            self.flow.notify_all()

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2ConnectionError(FRAME_SIZE_ERROR, "WINDOW_UPDATE length")
        increment = int.from_bytes(payload, "big") & 0x7FFFFFFF
        with self.flow:
            if sid == 0:
                self.send_window += increment
            elif sid in self.streams:
                self.streams[sid].send_window += increment
            self.flow.notify_all()

    def _header_block(self, sid: int, flags: int, payload: bytes) -> bytes:
        block = bytearray(_unpad(flags, payload, priority=True))
        while not flags & END_HEADERS:
            kind, flags, other, more = read_frame(self.rfile)
            if kind != CONTINUATION or other != sid:
                raise H2ConnectionError(PROTOCOL_ERROR,
                                       "a header block was interrupted")
            block += more
        return bytes(block)

    def _on_headers(self, sid: int, flags: int, payload: bytes) -> None:
        block = self._header_block(sid, flags, payload)
        try:
            headers = self.hpack.decode(block)
        except HuffmanCoded as exc:
            self._new_stream(sid)
            self._trailers_only(sid, UNIMPLEMENTED, str(exc))
            raise H2ConnectionError(COMPRESSION_ERROR, str(exc)) from exc
        except HpackError as exc:
            raise H2ConnectionError(COMPRESSION_ERROR, str(exc)) from exc
        stream = self.streams.get(sid)
        if stream is None:                    # a new call
            stream = self._new_stream(sid)
            stream.headers = dict(headers)
        if flags & END_STREAM:
            self._dispatch(stream)

    def _new_stream(self, sid: int) -> _Stream:
        if sid % 2 == 0 or sid <= self.last_stream:
            raise H2ConnectionError(PROTOCOL_ERROR, f"bad stream id {sid}")
        self.last_stream = sid
        with self.flow:
            stream = _Stream(sid, self.peer_initial_window)
            self.streams[sid] = stream
        return stream

    def _on_data(self, sid: int, flags: int, payload: bytes) -> None:
        stream = self.streams.get(sid)
        if payload:                           # hand the window back
            self.send(WINDOW_UPDATE, 0, 0, len(payload).to_bytes(4, "big"))
            if stream is not None and not flags & END_STREAM:
                self.send(WINDOW_UPDATE, 0, sid,
                          len(payload).to_bytes(4, "big"))
        if stream is None or stream.call is not None:
            return                            # reset, or already dispatched
        stream.body += _unpad(flags, payload)
        if len(stream.body) > MAX_MESSAGE + 5:
            stream.call = Call("", {})
            self._trailers_only(sid, RESOURCE_EXHAUSTED,
                                f"a request above {MAX_MESSAGE} bytes")
            self.send(RST_STREAM, 0, sid, NO_ERROR.to_bytes(4, "big"))
        elif flags & END_STREAM:
            self._dispatch(stream)

    def _dispatch(self, stream: _Stream) -> None:
        stream.call = Call(stream.headers.get(":path", ""), stream.headers)
        threading.Thread(target=self._serve, args=(stream,), daemon=True,
                         name=f"h2-call-{stream.id}").start()

    def _serve(self, stream: _Stream) -> None:
        call = stream.call
        try:
            if not stream.headers.get("content-type", "").startswith(
                    "application/grpc"):
                raise GrpcError(INTERNAL, "content-type is not gRPC")
            handler = self.server.handlers.get(call.path)
            if handler is None:
                raise GrpcError(UNIMPLEMENTED,
                                f"method {call.path!r} is not implemented")
            body = handler(grpc_unframe(bytes(stream.body)), call)
        except GrpcError as exc:
            self._trailers_only(stream.id, exc.code, exc.message)
            return
        except Exception as exc:  # noqa: BLE001 - the call's status says it
            _log.exception("profiler server: %s failed", call.path)
            self._trailers_only(stream.id, UNKNOWN,
                                f"{type(exc).__name__}: {exc}")
            return
        if call.cancelled.is_set():
            return
        try:
            self.send(HEADERS, END_HEADERS, stream.id, encode_headers(
                [(":status", "200"), ("content-type", "application/grpc")]))
            self._send_data(stream, grpc_message(body))
            self.send(HEADERS, END_HEADERS | END_STREAM, stream.id,
                      encode_headers([("grpc-status", "0")]))
        except OSError:
            return
        finally:
            self._end(stream.id)

    def _send_data(self, stream: _Stream, data: bytes) -> None:
        """``data`` on ``stream``'s DATA frames as the windows allow."""
        view = memoryview(data)
        while view:
            with self.flow:
                while not (self.closed or stream.closed) and min(
                        self.send_window, stream.send_window) <= 0:
                    self.flow.wait()
                if self.closed or stream.closed:
                    raise OSError("the stream or connection closed")
                n = min(len(view), self.send_window, stream.send_window,
                        self.peer_max_frame)
                self.send_window -= n
                stream.send_window -= n
            self.send(DATA, 0, stream.id, bytes(view[:n]))
            view = view[n:]

    def _trailers_only(self, sid: int, code: int, message: str) -> None:
        """A call's whole answer: one HEADERS frame with its status (none
        on a stream the client reset)."""
        with self.flow:
            if sid not in self.streams:
                return
        try:
            self.send(HEADERS, END_HEADERS | END_STREAM, sid, encode_headers(
                [(":status", "200"), ("content-type", "application/grpc"),
                 ("grpc-status", str(code)),
                 ("grpc-message", quote(message, safe=_PRINTABLE))]))
        except OSError:
            pass
        finally:
            self._end(sid)

    def _end(self, sid: int) -> None:
        with self.flow:
            stream = self.streams.pop(sid, None)
            if stream is not None:
                stream.closed = True


class Server:
    """Unary gRPC on ``port`` (0: a free one, read back from ``port``),
    every interface, IPv6 and IPv4 where the host has both. ``handlers``
    maps a method's ``:path`` to ``handler(request bytes, call) ->
    response bytes``; a handler raises ``GrpcError`` for another status."""

    def __init__(self, port: int, handlers: dict):
        self.handlers = dict(handlers)
        if socket.has_dualstack_ipv6():
            self.sock = socket.create_server(
                ("", port), family=socket.AF_INET6, dualstack_ipv6=True)
        else:
            self.sock = socket.create_server(("", port))
        self.port = self.sock.getsockname()[1]
        self._lock = threading.Lock()
        self._connections: set = set()
        self._closed = False
        self._thread = threading.Thread(target=self._accept, daemon=True,
                                        name=f"h2-accept-{self.port}")
        self._thread.start()

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self.sock.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    sock.close()
                    return
                conn = _Connection(self, sock)
                self._connections.add(conn)
            threading.Thread(target=conn.run, daemon=True,
                             name=f"h2-conn-{self.port}").start()

    def _forget(self, conn: _Connection) -> None:
        with self._lock:
            self._connections.discard(conn)

    def close(self) -> None:
        """Stop accepting, close every connection (their calls see
        ``cancelled``) and wait for the accept thread."""
        with self._lock:
            self._closed = True
            connections = list(self._connections)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        for conn in connections:
            conn.close()
        self._thread.join(timeout=5)


# ---- the client ----------------------------------------------------------------


def unary_call(address: str, path: str, request: bytes, *,
               timeout: float = 60.0) -> bytes:
    """One unary gRPC call on a connection of its own; the response's
    message, or ``GrpcError`` with the call's status."""
    host, _, port = address.rpartition(":")
    with socket.create_connection((host.strip("[]"), int(port)),
                                  timeout=timeout) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rfile = sock.makefile("rb")
        body = grpc_message(request)
        if len(body) > DEFAULT_MAX_FRAME:
            raise ValueError("a request above one frame")
        sock.sendall(PREFACE + frame(SETTINGS, 0, 0) + frame(
            HEADERS, END_HEADERS, 1, encode_headers([
                (":method", "POST"), (":scheme", "http"), (":path", path),
                (":authority", address), ("content-type", "application/grpc"),
                ("te", "trailers")])) + frame(DATA, END_STREAM, 1, body))
        hpack = HpackDecoder()
        data = bytearray()
        trailers: dict = {}
        while True:
            try:
                kind, flags, sid, payload = read_frame(rfile, 1 << 24)
            except EOFError:
                raise GrpcError(UNAVAILABLE, "the server closed the "
                                "connection") from None
            if kind == SETTINGS and not flags & ACK:
                sock.sendall(frame(SETTINGS, ACK, 0))
            elif kind == PING and not flags & ACK:
                sock.sendall(frame(PING, ACK, 0, payload))
            elif kind == GOAWAY and sid == 0 and not trailers:
                code = int.from_bytes(payload[4:8], "big")
                raise GrpcError(UNAVAILABLE, f"GOAWAY {code}: "
                                f"{payload[8:].decode(errors='replace')}")
            elif sid != 1:
                continue
            elif kind == RST_STREAM:
                raise GrpcError(CANCELLED, "the server reset the stream")
            elif kind == DATA:
                data += _unpad(flags, payload)
                if payload:
                    sock.sendall(frame(WINDOW_UPDATE, 0, 0,
                                       len(payload).to_bytes(4, "big"))
                                 + frame(WINDOW_UPDATE, 0, 1,
                                         len(payload).to_bytes(4, "big")))
            elif kind == HEADERS:
                block = bytearray(_unpad(flags, payload, priority=True))
                more_flags = flags
                while not more_flags & END_HEADERS:
                    _kind, more_flags, _sid, more = read_frame(rfile, 1 << 24)
                    block += more
                trailers.update(hpack.decode(bytes(block)))
            if kind in (DATA, HEADERS) and flags & END_STREAM:
                break
    status = int(trailers.get("grpc-status", UNKNOWN))
    if status != OK:
        raise GrpcError(status, unquote(trailers.get("grpc-message", "")))
    return grpc_unframe(bytes(data))
