"""AFLMux: one socket, many streams — the traffic-grade federation transport.

The stdlib HTTP/1.1 server proves the wire contract but serializes
uploaders per connection and speaks neither TLS nor auth. This module is the
layer you put in front of many concurrent clients: an h2-style multiplexed
binary framing protocol carrying the existing CRC-checked
:class:`~repro_torch.fl.service.FederationService` byte envelopes *unchanged* —
the envelope is the payload; this file only frames, interleaves, and secures
it.

Protocol (all integers little-endian):

* Connection preface: the client sends ``AFLMUX1\\n`` (8 bytes) immediately
  after connecting (and after the TLS handshake, when enabled). Anything
  else is answered with GOAWAY and a closed connection.
* Frame: ``u32 length | u8 type | u8 flags | u32 stream_id | payload`` —
  a 10-byte header. ``length`` counts payload bytes only and is capped
  (``max_frame_bytes``, default 1 MiB); an oversized or torn frame is a
  connection error (GOAWAY), not something to resynchronize past.
* Streams are client-initiated with odd, strictly increasing ids. A request
  is one HEADERS frame (JSON: route, federation, optional bearer token)
  followed by DATA frames carrying the request envelope; ``END_STREAM``
  marks the last frame. The response is one RESPONSE frame (JSON: the HTTP
  status the envelope maps to) followed by DATA frames with the response
  envelope. Frames of different streams interleave freely — one slow
  submit_stream upload never blocks a weights poll on the same socket.
* Flow control is per-stream: each sender starts with ``initial_window``
  bytes of credit and the receiver returns credit with WINDOW_UPDATE frames
  as it consumes DATA, so one firehose stream cannot starve the connection.
* PING (8-byte opaque payload, ACK flag) measures liveness without touching
  any federation — standby probes ride it. GOAWAY (``u32 last_stream_id |
  message``) promises that streams above ``last_stream_id`` were never
  processed and drains the rest — the graceful-shutdown half.

Security: ``serve_mux(..., ssl_context=...)`` wraps every connection in TLS
(:func:`server_ssl_context` builds the context from a cert/key pair, with
optional required client certificates), and a per-federation bearer token
(``FederationService(auth_token=...)``) is enforced *before* routing, so an
unauthorized request leaves coordinator state untouched.

Replay discipline is stricter than HTTP's: once a request's HEADERS frame
has been written, :class:`MuxTransport` never re-sends it — a connection
that dies mid-request surfaces ``ConnectionError`` (reads included). The
single transparent retry happens only when writing HEADERS on a previously
established (stale) connection fails: the server cannot have routed a
request whose first frame never arrived whole (a torn frame kills the
connection before dispatch), so a sent submit is never re-sent.
"""

from __future__ import annotations

import json
import socket
import ssl
import struct
import subprocess
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from repro_torch.fl import errors as E
from repro_torch.fl.service import FederationService

__all__ = [
    "MuxTransport",
    "MuxFederationServer",
    "serve_mux",
    "mux_ping",
    "probe_alive",
    "server_ssl_context",
    "client_ssl_context",
    "generate_self_signed_cert",
    "MuxProtocolError",
]

PREFACE = b"AFLMUX1\n"
_HDR = struct.Struct("<IBBI")            # length, type, flags, stream_id
_U32 = struct.Struct("<I")

T_HEADERS, T_DATA, T_RESPONSE, T_WINDOW, T_PING, T_GOAWAY = 1, 2, 3, 4, 5, 6
F_END_STREAM = 0x1
F_ACK = 0x2

MAX_FRAME_BYTES = 1 << 20                # hard cap on one frame's payload
DATA_CHUNK = 64 << 10                    # DATA frame size senders use
INITIAL_WINDOW = 4 << 20                 # per-stream send credit at open

# routes whose replay could mutate state — a MuxTransport never re-sends
# ANY request after its HEADERS frame is on the wire, but these are the
# reason the discipline exists
MUTATING_ROUTES = frozenset(
    {"submit", "submit_stream", "grow", "shrink", "promote"})


class MuxProtocolError(E.BadRequest):
    """A frame-level protocol violation (bad preface, torn or oversized
    frame, unknown frame type, corrupt HEADERS). Connection-fatal: framing
    is lost, so the peer answers GOAWAY and closes rather than guessing at
    resynchronization."""

    code = "bad_request"


class _StaleConn(Exception):
    """Internal: writing HEADERS failed on a previously established
    connection — nothing of the request reached the peer's router, so ONE
    retry on a fresh connection is safe for every route."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def _read_exact(rfile, n: int) -> bytes:
    """Read exactly n bytes; b"" at a clean boundary start, else raises
    MuxProtocolError on a torn read."""
    data = rfile.read(n)
    if data is None:
        data = b""
    if data and len(data) < n:
        raise MuxProtocolError(
            f"torn frame: wanted {n} bytes, connection yielded {len(data)}")
    return data


def _read_frame(rfile, max_frame: int
                ) -> Optional[Tuple[int, int, int, bytes]]:
    """One frame off the wire → (type, flags, stream_id, payload), or None
    on clean EOF between frames."""
    hdr = _read_exact(rfile, _HDR.size)
    if not hdr:
        return None
    length, ftype, flags, sid = _HDR.unpack(hdr)
    if length > max_frame:
        raise MuxProtocolError(
            f"frame payload of {length} bytes exceeds the "
            f"{max_frame}-byte frame cap")
    payload = rfile.read(length) if length else b""
    if len(payload or b"") < length:
        raise MuxProtocolError(
            f"torn frame: header promised {length} payload bytes, "
            f"got {len(payload or b'')}")
    return ftype, flags, sid, payload


class _FlowWindow:
    """Per-stream send credit: ``take`` blocks until the peer grants more
    via WINDOW_UPDATE (or the stream/connection dies)."""

    def __init__(self, n: int):
        self.cv = threading.Condition()
        self.n = int(n)
        self.dead: Optional[BaseException] = None

    def grant(self, k: int) -> None:
        with self.cv:
            self.n += int(k)
            self.cv.notify_all()

    def kill(self, exc: BaseException) -> None:
        with self.cv:
            if self.dead is None:
                self.dead = exc
            self.cv.notify_all()

    def take(self, want: int, deadline: float) -> int:
        with self.cv:
            while self.n <= 0:
                if self.dead is not None:
                    raise self.dead
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        "flow-control window starved (peer stopped "
                        "granting credit)")
                self.cv.wait(left)
            k = min(int(want), self.n)
            self.n -= k
            return k


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class _ClientStream:
    __slots__ = ("win", "done", "chunks", "status", "error")

    def __init__(self, window: int):
        self.win = _FlowWindow(window)
        self.done = threading.Event()
        self.chunks: List[bytes] = []
        self.status: Optional[int] = None
        self.error: Optional[BaseException] = None

    def finish(self, error: Optional[BaseException] = None) -> None:
        if error is not None:
            if self.error is None:
                self.error = error
            self.win.kill(error)
        else:
            # unblock a sender mid-body: the response is already here
            # (early reject) — it stops sending and reads it
            self.win.grant(1 << 40)
        self.done.set()


class _ClientConn:
    """One connection generation: socket, reader thread, live streams."""

    def __init__(self, sock, rfile):
        self.sock = sock
        self.rfile = rfile
        self.wlock = threading.Lock()
        self.slock = threading.Lock()
        self.streams: Dict[int, _ClientStream] = {}
        self.next_id = 1                 # guarded by wlock (see open_stream)
        self.ping_seq = 0
        self.pings: Dict[bytes, list] = {}
        self.goaway_last: Optional[int] = None
        self.dead = False

    def write_frame(self, ftype: int, flags: int, sid: int,
                    payload: bytes = b"") -> None:
        buf = _HDR.pack(len(payload), ftype, flags, sid) + payload
        with self.wlock:
            self.sock.sendall(buf)

    def open_stream(self, st: "_ClientStream", payload: bytes,
                    flags: int, first_data: Optional[bytes] = None) -> int:
        """Allocate a stream id AND write its HEADERS frame atomically —
        id order must equal wire order (the server rejects out-of-order
        ids), so concurrent callers cannot interleave between the two.
        ``first_data`` piggybacks a small complete body as a DATA frame in
        the same write (one syscall per request for the common case)."""
        with self.wlock:
            sid = self.next_id
            self.next_id += 2
            with self.slock:
                self.streams[sid] = st
            buf = _HDR.pack(len(payload), T_HEADERS, flags, sid) + payload
            if first_data is not None:
                buf += _HDR.pack(len(first_data), T_DATA, F_END_STREAM,
                                 sid) + first_data
            try:
                self.sock.sendall(buf)
            except BaseException:
                with self.slock:
                    self.streams.pop(sid, None)
                raise
        return sid


class MuxTransport:
    """Client side of the mux transport — same ``request``/``close``
    surface as :class:`~repro_torch.fl.service.HttpTransport`, so
    :class:`~repro_torch.fl.service.RemoteCoordinator` (and anything else built
    on the Transport protocol) runs over it unchanged.

    One persistent connection carries every concurrent caller: each
    ``request`` opens a fresh stream, so N threads interleave on one socket
    (one TCP + TLS handshake total, not one per client). ``mux://host:port``
    is plaintext, ``muxs://host:port`` is TLS (pass ``ssl_context`` or
    ``cafile``; self-signed server certs verify against their own PEM).
    ``auth_token`` rides in every request's HEADERS frame and is enforced
    by the service before routing.
    """

    def __init__(self, url: str, *, auth_token: Optional[str] = None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 cafile: Optional[str] = None, timeout: float = 60.0,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 initial_window: int = INITIAL_WINDOW,
                 chunk_bytes: int = DATA_CHUNK):
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("mux", "muxs"):
            raise ValueError(
                f"MuxTransport speaks mux:// or muxs:// only, got {url!r}")
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 8791
        self._tls = parts.scheme == "muxs"
        if self._tls and ssl_context is None:
            ssl_context = client_ssl_context(cafile)
        self._ssl = ssl_context
        self.auth_token = auth_token
        self._timeout = float(timeout)
        self._max_frame = int(max_frame_bytes)
        self._window = int(initial_window)
        self._chunk = int(chunk_bytes)
        self._lock = threading.RLock()
        self._conn: Optional[_ClientConn] = None
        self._reader: Optional[threading.Thread] = None
        self._closed = False
        self.reconnects = 0                 # observability (tests/bench)

    # -- connection lifecycle -----------------------------------------------

    def _connect(self) -> _ClientConn:
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._timeout)
        try:
            # frames are written back-to-back (HEADERS, then DATA) — Nagle
            # plus delayed ACK turns that into ~40ms stalls per request
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._tls:
                sock = self._ssl.wrap_socket(
                    sock, server_hostname=self._host)
                sock.sendall(PREFACE)
                rfile = sock.makefile("rb")
                self._drain_post_handshake(sock, rfile)
            else:
                sock.sendall(PREFACE)
                rfile = sock.makefile("rb")
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        conn = _ClientConn(sock, rfile)
        t = threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True, name="afl-mux-client-reader")
        t.start()
        self._reader = t
        return conn

    def _drain_post_handshake(self, sock, rfile) -> None:
        """One PING round trip on a fresh TLS connection, before the reader
        thread starts. A TLS 1.3 server sends its session tickets after the
        handshake; an OpenSSL connection is not safe for use from two
        threads at once, and the reader thread's SSL_read taking a ticket
        while another thread's SSL_write runs can lose that write (a ping
        or request the server never sees) or crash the process. The
        tickets precede the ACK on the wire, so reading the ACK here takes
        them in this thread alone."""
        token = b"tlsready"
        sock.sendall(_HDR.pack(len(token), T_PING, 0, 0) + token)
        fr = _read_frame(rfile, self._max_frame)
        if fr is None:
            raise ConnectionError("mux server closed the connection")
        ftype, flags, _, payload = fr
        if ftype == T_GOAWAY:
            raise E.Unavailable(
                "mux server going away: "
                + payload[4:].decode("utf-8", "replace"))
        if ftype != T_PING or not flags & F_ACK or payload != token:
            raise MuxProtocolError(
                f"expected the PING ACK, got frame type {ftype}")

    def _ensure_conn(self) -> Tuple[_ClientConn, bool]:
        """(conn, reused) — reused=False when this call established it."""
        with self._lock:
            if self._closed:
                raise ConnectionError("MuxTransport is closed")
            conn = self._conn
            if conn is not None and not conn.dead \
                    and conn.goaway_last is None:
                return conn, True
            if conn is not None:
                self.reconnects += 1
            self._conn = conn = self._connect()
            return conn, False

    def _kill_conn(self, conn: _ClientConn,
                   error: Optional[BaseException] = None) -> None:
        conn.dead = True
        try:
            # shutdown, not just close: the reader's makefile handle keeps
            # the fd alive, so close alone would neither send a FIN nor
            # unblock a read parked on this socket
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        with conn.slock:
            streams = list(conn.streams.values())
            conn.streams.clear()
            pings = list(conn.pings.values())
            conn.pings.clear()
        for st in streams:
            if not st.done.is_set():
                st.finish(ConnectionError(
                    f"mux connection lost mid-request: {error}"
                    if error else "mux connection lost mid-request"))
        for slot in pings:
            slot[1].set()

    # -- the reader thread --------------------------------------------------

    def _read_loop(self, conn: _ClientConn) -> None:
        error: Optional[BaseException] = None
        try:
            while True:
                fr = _read_frame(conn.rfile, self._max_frame)
                if fr is None:
                    break
                ftype, flags, sid, payload = fr
                if ftype == T_RESPONSE:
                    with conn.slock:
                        st = conn.streams.get(sid)
                    if st is not None:
                        st.status = int(json.loads(payload or b"{}")
                                        .get("status", 200))
                        if flags & F_END_STREAM:
                            self._finish_stream(conn, sid, st)
                elif ftype == T_DATA:
                    with conn.slock:
                        st = conn.streams.get(sid)
                    if st is not None:
                        st.chunks.append(payload)
                        if payload:
                            try:
                                conn.write_frame(T_WINDOW, 0, sid,
                                                 _U32.pack(len(payload)))
                            except OSError:
                                pass
                        if flags & F_END_STREAM:
                            self._finish_stream(conn, sid, st)
                elif ftype == T_WINDOW:
                    with conn.slock:
                        st = conn.streams.get(sid)
                    if st is not None:
                        st.win.grant(_U32.unpack(payload[:4])[0])
                elif ftype == T_PING:
                    if flags & F_ACK:
                        with conn.slock:
                            slot = conn.pings.pop(payload, None)
                        if slot is not None:
                            slot[0] = time.perf_counter()
                            slot[1].set()
                    else:
                        conn.write_frame(T_PING, F_ACK, 0, payload)
                elif ftype == T_GOAWAY:
                    last = _U32.unpack(payload[:4])[0]
                    msg = payload[4:].decode("utf-8", "replace")
                    conn.goaway_last = last
                    with conn.slock:
                        doomed = [(s, st)
                                  for s, st in conn.streams.items()
                                  if s > last]
                        for s, _ in doomed:
                            conn.streams.pop(s)
                    for s, st in doomed:
                        st.finish(E.Unavailable(
                            f"server going away before stream {s} was "
                            f"processed ({msg or 'shutdown'}) — safe to "
                            "retry against a live endpoint"))
                else:
                    raise MuxProtocolError(f"unknown frame type {ftype}")
        except Exception as exc:                          # noqa: BLE001
            error = exc
        finally:
            self._kill_conn(conn, error)

    def _finish_stream(self, conn: _ClientConn, sid: int,
                       st: _ClientStream) -> None:
        with conn.slock:
            conn.streams.pop(sid, None)
        st.finish()

    # -- requests -----------------------------------------------------------

    def request(self, route: str, body: bytes = b"",
                federation: str = "default") -> bytes:
        body = bytes(body)
        try:
            return self._request_once(route, body, federation)
        except _StaleConn:
            # HEADERS never made it whole onto a stale connection — the
            # server cannot have routed it (a torn first frame is a
            # connection error before dispatch), so one retry is safe
            # for every route, submits included.
            try:
                return self._request_once(route, body, federation)
            except _StaleConn as exc:
                raise ConnectionError(str(exc)) from exc.cause

    def _request_once(self, route: str, body: bytes,
                      federation: str) -> bytes:
        conn, reused = self._ensure_conn()
        st = _ClientStream(self._window)
        header = {"route": route, "federation": federation}
        if self.auth_token is not None:
            header["token"] = self.auth_token
        # a body that fits one DATA frame rides in the same write as
        # HEADERS — and the combined write failing still means nothing of
        # the request was routed (torn frames are connection-fatal before
        # dispatch), so the stale-retry rule below stays sound
        inline = body if 0 < len(body) <= min(self._chunk,
                                              self._window) else None
        flags = 0 if body else F_END_STREAM
        try:
            sid = conn.open_stream(st, json.dumps(header).encode("utf-8"),
                                   flags, first_data=inline)
        except OSError as exc:
            self._kill_conn(conn, exc)
            if reused:
                raise _StaleConn(exc) from exc
            raise ConnectionError(f"mux send failed: {exc}") from exc
        if inline is not None:
            body = b""                      # fully sent with the HEADERS
        # From here on the request is SENT: any failure surfaces — a
        # replayed submit is never an option past this line.
        deadline = time.monotonic() + self._timeout
        off = 0
        while off < len(body):
            if st.done.is_set():
                break                       # early response (e.g. reject)
            n = st.win.take(min(self._chunk, len(body) - off), deadline)
            chunk = body[off:off + n]
            off += n
            try:
                conn.write_frame(
                    T_DATA, F_END_STREAM if off == len(body) else 0,
                    sid, chunk)
            except OSError as exc:
                self._kill_conn(conn, exc)
                raise ConnectionError(
                    f"mux send failed mid-request: {exc}") from exc
        if not st.done.wait(max(0.0, deadline - time.monotonic())):
            with conn.slock:
                conn.streams.pop(sid, None)
            raise TimeoutError(
                f"mux request {route!r} timed out after {self._timeout}s")
        if st.error is not None:
            raise st.error
        return b"".join(st.chunks)

    def ping(self, timeout: Optional[float] = None) -> float:
        """Round-trip a PING frame → latency in seconds. Touches no
        federation (no auth needed) — the standby liveness probe."""
        conn, _ = self._ensure_conn()
        with conn.slock:
            conn.ping_seq += 1
            token = struct.pack("<Q", conn.ping_seq)
            slot = [None, threading.Event()]
            conn.pings[token] = slot
        t0 = time.perf_counter()
        try:
            conn.write_frame(T_PING, 0, 0, token)
        except OSError as exc:
            self._kill_conn(conn, exc)
            raise ConnectionError(f"mux ping failed: {exc}") from exc
        if not slot[1].wait(timeout if timeout is not None
                            else self._timeout):
            raise TimeoutError("mux ping timed out")
        if slot[0] is None:
            raise ConnectionError("mux connection lost during ping")
        return slot[0] - t0

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None and not conn.dead:
            try:
                conn.write_frame(T_GOAWAY, 0, 0,
                                 _U32.pack(0) + b"client closing")
            except OSError:
                pass
            self._kill_conn(conn)
        if self._reader is not None:
            self._reader.join(timeout=2)
            self._reader = None


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _ServerStream:
    __slots__ = ("header", "body", "out", "poisoned", "responded")

    def __init__(self, header: dict, window: int):
        self.header = header
        self.body = bytearray()
        self.out = _FlowWindow(window)
        self.poisoned = False
        self.responded = False


class _ServerConn:
    def __init__(self, sock, rfile, addr):
        self.sock = sock
        self.rfile = rfile
        self.addr = addr
        self.wlock = threading.Lock()
        self.lock = threading.Lock()
        self.drain_cv = threading.Condition(self.lock)
        self.streams: Dict[int, _ServerStream] = {}
        self.inflight = 0
        self.last_sid = 0
        self.goaway_sent = False
        self.dead = False

    def write_frame(self, ftype: int, flags: int, sid: int,
                    payload: bytes = b"") -> None:
        buf = _HDR.pack(len(payload), ftype, flags, sid) + payload
        with self.wlock:
            self.sock.sendall(buf)

    def begin_goaway(self, message: str) -> None:
        with self.lock:
            if self.goaway_sent:
                return
            self.goaway_sent = True
            last = self.last_sid
        try:
            self.write_frame(T_GOAWAY, 0, 0,
                             _U32.pack(last) + message.encode("utf-8"))
        except OSError:
            pass

    def wait_drain(self, deadline: float) -> bool:
        with self.lock:
            while self.inflight or self.streams:
                left = deadline - time.monotonic()
                if left <= 0 or self.dead:
                    return not (self.inflight or self.streams)
                self.drain_cv.wait(left)
        return True

    def close(self) -> None:
        self.dead = True
        try:
            # see MuxTransport._kill_conn: shutdown so the FIN actually
            # goes out despite rfile's reference to the fd
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        with self.lock:
            streams = list(self.streams.values())
            self.streams.clear()
            self.drain_cv.notify_all()
        for st in streams:
            st.out.kill(ConnectionError("mux connection closed"))


class MuxFederationServer:
    """A threaded mux server hosting one :class:`FederationService` —
    thread-per-connection reader, thread-per-stream dispatch, so many
    uploaders interleave on each socket and across sockets. Optional TLS
    (``ssl_context`` from :func:`server_ssl_context`; client-cert auth when
    the context demands it) and graceful GOAWAY drain on ``close``.
    Context-manager friendly, same shape as ``HttpFederationServer``::

        with serve_mux(FederationService(server, auth_token=tok),
                       ssl_context=ctx) as srv:
            coord = RemoteCoordinator(srv.url, auth_token=tok, cafile=cert)
    """

    def __init__(self, service: FederationService, host: str = "127.0.0.1",
                 port: int = 0, *,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 initial_window: int = INITIAL_WINDOW,
                 chunk_bytes: int = DATA_CHUNK):
        self.service = service
        self._ssl = ssl_context
        self._max_frame = int(max_frame_bytes)
        self._window = int(initial_window)
        self._chunk = int(chunk_bytes)
        self._lsock = socket.create_server((host, port))
        self.host, self.port = self._lsock.getsockname()[:2]
        self.url = (f"{'muxs' if ssl_context is not None else 'mux'}"
                    f"://{self.host}:{self.port}")
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        self.errors: List[Tuple[str, str]] = []   # (where, message)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MuxFederationServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name="afl-mux-server")
            self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, addr = self._lsock.accept()
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(sock, addr),
                             daemon=True,
                             name="afl-mux-conn").start()

    def close(self, *, drain: bool = True, timeout: float = 10.0,
              close_service: bool = False) -> None:
        """Stop accepting, GOAWAY every connection, and (with ``drain``)
        wait for in-flight streams to finish before closing sockets —
        a sent submit is either fully answered or provably unprocessed."""
        self._closing = True
        try:
            # shutdown wakes the accept loop's blocked accept(); close alone
            # leaves it parked until the join below times out
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            conn.begin_goaway("server shutdown")
        if drain:
            deadline = time.monotonic() + timeout
            for conn in conns:
                conn.wait_drain(deadline)
        for conn in conns:
            conn.close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if close_service:
            self.service.close()

    def __enter__(self) -> "MuxFederationServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- per-connection machinery -------------------------------------------

    def _serve_conn(self, raw, addr) -> None:
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        raw.settimeout(15.0)               # bound the handshake + preface
        if self._ssl is not None:
            try:
                sock = self._ssl.wrap_socket(raw, server_side=True)
            except (ssl.SSLError, OSError) as exc:
                # a failed handshake (bad client cert, protocol mismatch)
                # drops that connection only — the server keeps serving
                self.errors.append(("tls", str(exc)))
                raw.close()
                return
        else:
            sock = raw
        conn = _ServerConn(sock, sock.makefile("rb"), addr)
        try:
            preface = conn.rfile.read(len(PREFACE))
        except OSError:
            conn.close()
            return
        if preface != PREFACE:
            try:
                conn.write_frame(T_GOAWAY, 0, 0, _U32.pack(0) +
                                 b"bad connection preface")
            except OSError:
                pass
            conn.close()
            return
        sock.settimeout(None)
        with self._conns_lock:
            self._conns.add(conn)
        try:
            self._frame_loop(conn)
        except MuxProtocolError as exc:
            conn.begin_goaway(str(exc))
        except OSError:
            pass
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def _frame_loop(self, conn: _ServerConn) -> None:
        body_cap = 8 * self.service.max_report_bytes
        while True:
            fr = _read_frame(conn.rfile, self._max_frame)
            if fr is None:
                return
            ftype, flags, sid, payload = fr
            if ftype == T_HEADERS:
                with conn.lock:
                    if conn.goaway_sent:
                        # promised: streams past last_sid never processed
                        continue
                    if sid % 2 == 0 or sid <= conn.last_sid:
                        raise MuxProtocolError(
                            f"stream id {sid} is not odd and increasing")
                    conn.last_sid = sid
                try:
                    header = json.loads(payload.decode("utf-8"))
                    if not isinstance(header, dict):
                        raise ValueError("HEADERS payload is not an object")
                except (ValueError, UnicodeDecodeError) as exc:
                    raise MuxProtocolError(
                        f"corrupt HEADERS on stream {sid}: {exc}") from None
                st = _ServerStream(header, self._window)
                with conn.lock:
                    conn.streams[sid] = st
                if flags & F_END_STREAM:
                    self._finish_request(conn, sid, st)
            elif ftype == T_DATA:
                with conn.lock:
                    st = conn.streams.get(sid)
                if st is None:
                    continue           # post-GOAWAY residue / aborted stream
                if not st.poisoned:
                    st.body.extend(payload)
                    if len(st.body) > body_cap:
                        st.poisoned = True
                        self._respond(conn, sid, st,
                                      *FederationService._error(
                                          E.OversizedReport(
                                              f"mux request body exceeds "
                                              f"{body_cap} bytes")))
                if payload:
                    try:
                        conn.write_frame(T_WINDOW, 0, sid,
                                         _U32.pack(len(payload)))
                    except OSError:
                        return
                if flags & F_END_STREAM:
                    self._finish_request(conn, sid, st)
            elif ftype == T_WINDOW:
                with conn.lock:
                    st = conn.streams.get(sid)
                if st is not None:
                    st.out.grant(_U32.unpack(payload[:4])[0])
            elif ftype == T_PING:
                if not flags & F_ACK:
                    conn.write_frame(T_PING, F_ACK, 0, payload)
            elif ftype == T_GOAWAY:
                # client is closing; serve what's in flight, read to EOF
                continue
            else:
                raise MuxProtocolError(f"unknown frame type {ftype}")

    def _finish_request(self, conn: _ServerConn, sid: int,
                        st: _ServerStream) -> None:
        if st.poisoned:
            with conn.lock:
                conn.streams.pop(sid, None)
                conn.drain_cv.notify_all()
            return
        with conn.lock:
            conn.inflight += 1
        threading.Thread(target=self._dispatch, args=(conn, sid, st),
                         daemon=True, name="afl-mux-stream").start()

    def _dispatch(self, conn: _ServerConn, sid: int,
                  st: _ServerStream) -> None:
        try:
            header = st.header
            data, status = self.service.handle(
                str(header.get("route", "")), bytes(st.body),
                str(header.get("federation", "default")),
                token=header.get("token"))
            self._respond(conn, sid, st, data, status)
        except (OSError, ConnectionError):
            pass                            # peer went away mid-response
        except Exception as exc:            # noqa: BLE001
            self.errors.append(("dispatch", f"{type(exc).__name__}: {exc}"))
        finally:
            with conn.lock:
                conn.streams.pop(sid, None)
                conn.inflight -= 1
                conn.drain_cv.notify_all()

    def _respond(self, conn: _ServerConn, sid: int, st: _ServerStream,
                 data: bytes, status: int) -> None:
        if st.responded:
            return
        st.responded = True
        head = json.dumps({"status": int(status)}).encode("utf-8")
        if not data:
            conn.write_frame(T_RESPONSE, F_END_STREAM, sid, head)
            return
        conn.write_frame(T_RESPONSE, 0, sid, head)
        deadline = time.monotonic() + 60.0
        off = 0
        while off < len(data):
            n = st.out.take(min(self._chunk, len(data) - off), deadline)
            chunk = data[off:off + n]
            off += n
            conn.write_frame(
                T_DATA, F_END_STREAM if off == len(data) else 0, sid, chunk)


def serve_mux(service: FederationService, host: str = "127.0.0.1",
              port: int = 0, *,
              ssl_context: Optional[ssl.SSLContext] = None,
              **kw) -> MuxFederationServer:
    """Serve a federation over the mux protocol; returns the started server
    (``.url`` is ``mux://`` or ``muxs://`` with the ephemeral port)."""
    return MuxFederationServer(service, host, port,
                               ssl_context=ssl_context, **kw).start()


def mux_ping(url: str, *, timeout: float = 5.0,
             ssl_context: Optional[ssl.SSLContext] = None,
             cafile: Optional[str] = None) -> float:
    """One-shot liveness probe: connect, PING, close → latency seconds.
    Raises on any failure — callers treat an exception as 'not alive'."""
    tr = MuxTransport(url, ssl_context=ssl_context, cafile=cafile,
                      timeout=timeout)
    try:
        return tr.ping(timeout)
    finally:
        tr.close()


def probe_alive(url: str, *, timeout: float = 5.0,
                cafile: Optional[str] = None,
                auth_token: Optional[str] = None) -> bool:
    """Scheme-dispatching liveness probe for standby watchers: ``mux(s)://``
    rides a PING frame (no federation touched, no auth needed),
    ``http(s)://`` does a describe round-trip. True iff the endpoint
    answered."""
    try:
        if urllib.parse.urlsplit(url).scheme in ("mux", "muxs"):
            mux_ping(url, timeout=timeout, cafile=cafile)
        else:
            from repro_torch.fl.service import RemoteCoordinator

            RemoteCoordinator(url, auth_token=auth_token,
                              cafile=cafile).close()
        return True
    except Exception:                                     # noqa: BLE001
        return False


# ---------------------------------------------------------------------------
# TLS helpers
# ---------------------------------------------------------------------------


def server_ssl_context(certfile: str, keyfile: str, *,
                       client_ca: Optional[str] = None) -> ssl.SSLContext:
    """Server-side TLS context from a cert/key PEM pair. With
    ``client_ca`` the server *requires* client certificates signed by (or
    identical to) that CA — mutual TLS."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    # no TLS 1.3 session tickets: no client resumes a session, and a ticket
    # arriving while a client's reader thread and a writer share the
    # connection is what MuxTransport._drain_post_handshake guards against
    # — a client without that guard can lose a write to it
    ctx.num_tickets = 0
    if client_ca is not None:
        ctx.load_verify_locations(client_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(cafile: Optional[str] = None, *,
                       certfile: Optional[str] = None,
                       keyfile: Optional[str] = None,
                       insecure: bool = False) -> ssl.SSLContext:
    """Client-side TLS context. ``cafile`` pins the server cert (pass the
    server's own PEM for self-signed deployments); ``certfile``/``keyfile``
    present a client certificate for mutual TLS; ``insecure`` disables
    verification (test rigs only)."""
    ctx = ssl.create_default_context(cafile=cafile)
    if certfile is not None:
        ctx.load_cert_chain(certfile, keyfile)
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def generate_self_signed_cert(directory, *, common_name: str = "127.0.0.1",
                              days: int = 2) -> Tuple[str, str]:
    """(cert.pem, key.pem) under ``directory`` via the ``openssl`` CLI —
    the no-extra-deps path tests, benches, and the runbook share. The cert
    carries a SAN for ``common_name`` as both DNS name and IP, so default
    hostname checking passes against loopback."""
    import pathlib

    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    san = f"subjectAltName=DNS:{common_name},IP:{common_name}" \
        if _is_ip(common_name) else f"subjectAltName=DNS:{common_name}"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-sha256",
         "-keyout", key, "-out", cert, "-days", str(days), "-nodes",
         "-subj", f"/CN={common_name}", "-addext", san],
        check=True, capture_output=True)
    return cert, key


def _is_ip(name: str) -> bool:
    try:
        socket.inet_aton(name)
        return True
    except OSError:
        return False
