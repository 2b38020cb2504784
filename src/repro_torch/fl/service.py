"""FederationService: the transport-agnostic AFL serving surface.

AFL's single-round AA law reduces a whole federation to "clients POST one
report, then anyone may ask for the solved head" — so the serving API is
small enough to pin down completely. This module does exactly that, in three
layers that compose but never leak into each other:

  * :class:`FederationService` — wraps ANY
    :class:`~repro_torch.fl.api.Coordinator` (sync
    :class:`~repro_torch.fl.api.AFLServer`, event-loop
    :class:`~repro_torch.fl.async_server.AsyncAFLServer`, mesh-sharded
    :class:`~repro_torch.fl.api.ShardedCoordinator`) behind a routed
    bytes-in / bytes-out API: ``describe``, ``submit``, ``submit_stream`` (framed
    multi-report uploads with backpressure derived from the async queue's
    ``pending``), ``solve`` / ``solve_multi_gamma`` / ``sweep`` (the γ
    grid), ``weights`` (versioned solved-head download with an ETag-style
    staleness token), ``state`` (checkpoint), and ``personalized_solve``
    (client-specific target γ and/or a local-stats mixture). Failures are
    the typed taxonomy of :mod:`repro_torch.fl.errors`, carried on the wire as
    stable codes.
  * Transports — :class:`InProcTransport` (same bytes, same envelope, no
    socket: the zero-copy default for tests) and :class:`HttpTransport` (a
    stdlib ``http.server`` loopback server via :func:`serve_http`, plus the
    ``http.client`` client side). Both move opaque byte envelopes; neither
    knows what a Gram matrix is.
  * :class:`RemoteCoordinator` — the client: speaks the service over bytes
    yet satisfies the :class:`~repro_torch.fl.api.Coordinator` protocol, so
    ``run_afl``, ``launch/train.py`` and the examples can point at a URL
    instead of an in-process object with zero call-site changes. It passes
    the same conformance suite as the local coordinators
    (``tests/test_torch_conformance.py``), which makes
    wire-equivalence — bit-for-bit at f64 — a permanent invariant.

Envelope format (shared by requests and responses)::

    b"AFLS" | u32 header_len | header JSON | array payload | blob

The header carries an array manifest (name/shape/dtype), the blob length,
and a CRC-32 of everything after the header, mirroring the
:class:`~repro_torch.fl.api.ClientReport` wire rules: a flipped or truncated byte
is rejected, never silently folded into a federation.
"""

from __future__ import annotations

import asyncio
import hmac
import http.client
import http.server
import inspect
import json
import ssl
import struct
import threading
import urllib.parse
import zlib
from collections import OrderedDict
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.core.engine import AnalyticEngine, SuffStats
from repro_torch.fl import errors as E
from repro_torch.fl.api import (ClientReport, GammaSweep, VersionedWeights,
                                _restore_stats)
from repro_torch.fl.replication import ReportLedger, WarmStandby

__all__ = [
    "pack_message",
    "unpack_message",
    "frame_reports",
    "FederationService",
    "InProcTransport",
    "HttpTransport",
    "HttpFederationServer",
    "serve_http",
    "RemoteCoordinator",
]

# ---------------------------------------------------------------------------
# The byte envelope
# ---------------------------------------------------------------------------

_MAGIC = b"AFLS"
_ARRAY_DTYPES = {"float64": np.float64, "float32": np.float32,
                 "int64": np.int64}
_HOST_ENGINE = AnalyticEngine("numpy_f64")


def pack_message(header: Dict[str, Any],
                 arrays: Sequence[Tuple[str, np.ndarray]] = (),
                 blob: bytes = b"") -> bytes:
    """Serialize one service message: JSON header + named arrays + an
    optional opaque blob (e.g. a nested ClientReport payload)."""
    manifest, parts = [], []
    for name, arr in arrays:
        arr = np.asarray(arr)
        if not arr.flags.c_contiguous:
            # (not ascontiguousarray — that would promote 0-d scalars to 1-d)
            arr = np.ascontiguousarray(arr)
        if arr.dtype.name not in _ARRAY_DTYPES:
            raise ValueError(f"unsupported envelope dtype {arr.dtype.name!r} "
                             f"for array {name!r}")
        manifest.append({"name": str(name), "shape": list(arr.shape),
                         "dtype": arr.dtype.name})
        parts.append(arr.tobytes())
    payload = b"".join(parts) + bytes(blob)
    header = dict(header)
    header["arrays"] = manifest
    header["blob_len"] = len(blob)
    header["crc32"] = zlib.crc32(payload)
    hb = json.dumps(header, sort_keys=True).encode("utf-8")
    return _MAGIC + struct.pack("<I", len(hb)) + hb + payload


def unpack_message(data: bytes) -> Tuple[dict, Dict[str, np.ndarray], bytes]:
    """Parse + validate a service message → (header, {name: array}, blob).

    Raises :class:`~repro_torch.fl.errors.BadRequest` for anything that is not a
    well-formed, checksum-clean envelope.
    """
    data = bytes(data)
    if len(data) < len(_MAGIC) + 4 or data[: len(_MAGIC)] != _MAGIC:
        raise E.BadRequest("not a federation service message (bad magic)")
    (hlen,) = struct.unpack("<I", data[len(_MAGIC): len(_MAGIC) + 4])
    body = len(_MAGIC) + 4
    if len(data) < body + hlen:
        raise E.BadRequest("truncated message header")
    try:
        header = json.loads(data[body: body + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise E.BadRequest(f"corrupt message header: {exc}") from None
    payload = data[body + hlen:]
    try:
        manifest = header["arrays"]
        blob_len = int(header["blob_len"])
        crc = int(header["crc32"])
        specs = [(str(a["name"]), tuple(int(s) for s in a["shape"]),
                  _ARRAY_DTYPES[a["dtype"]]) for a in manifest]
    except (KeyError, TypeError, ValueError) as exc:
        raise E.BadRequest(f"malformed message header: {exc}") from None
    if blob_len < 0 or any(s < 0 for _, shape, _ in specs for s in shape):
        raise E.BadRequest("malformed message header: negative sizes")
    sizes = [int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
             for _, shape, dt in specs]
    if len(payload) != sum(sizes) + blob_len:
        raise E.BadRequest(
            f"payload length {len(payload)} does not match header manifest")
    if zlib.crc32(payload) != crc:
        raise E.BadRequest("message payload failed its CRC-32 check")
    arrays, off = {}, 0
    for (name, shape, dt), nbytes in zip(specs, sizes):
        count = int(np.prod(shape, dtype=np.int64))
        # copy: frombuffer views are read-only and would pin the whole
        # response buffer — callers must get ordinary writable arrays,
        # exactly like an in-process coordinator returns
        arrays[name] = np.frombuffer(
            payload, dt, count, offset=off).reshape(shape).copy()
        off += nbytes
    return header, arrays, payload[off:]


def frame_reports(payloads: Iterable[bytes]) -> bytes:
    """Frame multiple report payloads into one ``submit_stream`` body:
    ``u32 count | (u32 len | payload)*``."""
    payloads = [bytes(p) for p in payloads]
    return struct.pack("<I", len(payloads)) + b"".join(
        struct.pack("<I", len(p)) + p for p in payloads)


def _unframe_reports(body: bytes) -> List[bytes]:
    body = bytes(body)
    if len(body) < 4:
        raise E.BadRequest("truncated stream body")
    (count,) = struct.unpack("<I", body[:4])
    frames, off = [], 4
    for _ in range(count):
        if len(body) < off + 4:
            raise E.BadRequest("truncated stream frame header")
        (n,) = struct.unpack("<I", body[off: off + 4])
        off += 4
        if len(body) < off + n:
            raise E.BadRequest("truncated stream frame")
        frames.append(body[off: off + n])
        off += n
    if off != len(body):
        raise E.BadRequest("trailing bytes after the last stream frame")
    return frames


def _decode_response(data: bytes) -> Tuple[dict, Dict[str, np.ndarray], bytes]:
    """Client-side decode: re-raise the typed error an error response
    carried, otherwise return (header, arrays, blob)."""
    header, arrays, blob = unpack_message(data)
    if not header.get("ok", False):
        raise E.from_code(header.get("error", "internal"),
                          header.get("message", "service error"))
    return header, arrays, blob


# ---------------------------------------------------------------------------
# One hosted federation: a coordinator + its concurrency discipline
# ---------------------------------------------------------------------------


class _AppliedMap:
    """Bounded idempotent-ingest map: client id → CRC-32 of the exact
    payload the service accepted.

    The unbounded dict grew one entry per client forever. With a
    :class:`~repro_torch.fl.replication.ReportLedger` attached the map is a pure
    cache — an evicted entry is recoverable from disk
    (``ledger.find_crc``), so eviction never breaks the ``duplicate: true``
    replay answer. Without a ledger the LRU *is* the replay window: a
    retry arriving after ``maxsize`` newer clients degrades to the
    coordinator's ``duplicate_client`` 409 — the documented floor for
    ledger-less services. ``maxsize=None`` keeps the old unbounded
    behavior."""

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = None if maxsize is None else max(1, int(maxsize))
        self._d: "OrderedDict[int, int]" = OrderedDict()

    def get(self, client_id: int) -> Optional[int]:
        crc = self._d.get(client_id)
        if crc is not None:
            self._d.move_to_end(client_id)
        return crc

    def set(self, client_id: int, crc: int) -> None:
        self._d[client_id] = crc
        self._d.move_to_end(client_id)
        if self.maxsize is not None:
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


class _Flight:
    """One in-flight coalesced read: the leader computes, followers wait on
    the event and share the leader's encoded response (or its exception)."""

    __slots__ = ("token", "event", "result", "exc")

    def __init__(self, token: tuple):
        self.token = token
        self.event = threading.Event()
        self.result: Optional[bytes] = None
        self.exc: Optional[BaseException] = None


class _Federation:
    """Adapter making any coordinator callable from transport threads.

    Sync coordinators are serialized under one lock; an async coordinator
    gets a dedicated daemon event loop (started lazily, its worker task
    brought up via ``start()``) and every call crosses into it through
    ``run_coroutine_threadsafe`` — so exceptions, return values, and the
    coordinator's own internal locking behave exactly as in-process.
    """

    def __init__(self, coordinator, *,
                 applied_cache_size: Optional[int] = None,
                 ledger: Optional[ReportLedger] = None,
                 auth_token: Optional[str] = None):
        self.coordinator = coordinator
        # bearer token gating every route of this federation (None = open).
        # Checked before dispatch, so a bad token never touches state.
        self.auth_token = None if auth_token is None else str(auth_token)
        self.is_async = inspect.iscoroutinefunction(
            getattr(coordinator, "submit", None))
        self._lock = threading.RLock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        # idempotent-ingest map: client id → CRC-32 of the exact report
        # payload the service accepted. A transport retry that re-delivers
        # the identical bytes answers success instead of duplicate_client.
        # LRU-bounded; with a ledger attached, evicted entries are
        # recovered from disk, so the bound costs nothing but a scan.
        self.applied = _AppliedMap(applied_cache_size)
        # durable submit ledger: every accepted submit/stream frame is
        # appended (and fsynced before the ack), so a warm standby tailing
        # the directory loses zero reports on failover
        self.ledger = ledger
        # a read replica never ingests: mutating routes answer the typed
        # read_only 403 before dispatch
        self.read_only = bool(getattr(coordinator, "read_only", False))
        # a hosted-but-not-yet-promoted warm standby (host_standby)
        self.standby: Optional[WarmStandby] = None
        self._adopt_ledger = False
        # failover latch: while True the federation answers 503 unavailable
        # (retryable) on every route — set when the coordinator dies,
        # cleared by FederationService.restore_federation or the promote
        # route (which flips a hosted standby live)
        self.suspended = False
        # single-flight read coalescing: concurrent identical read requests
        # (same route + body) at the same epoch share ONE computation and
        # ONE encoded response. Entries are valid only while read_token()
        # is unchanged — any epoch bump (submit, grow/shrink, promote; a
        # restore replaces the _Federation wholesale) changes the token, so
        # a stale head can never be served. coalesced_hits counts requests
        # answered without touching the coordinator.
        self.coalesce_lock = threading.Lock()
        self.read_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.inflight: Dict[tuple, "_Flight"] = {}
        self.coalesced_hits = 0

    def read_token(self) -> tuple:
        """Identity-plus-epoch fingerprint of everything a read-route
        response can depend on: the coordinator instance, its ETag salt
        (promotion mints a new one), the submission epoch, and the mesh
        epoch (grow/shrink bumps it without necessarily bumping version).
        Plain attribute reads — safe from transport threads."""
        c = self.coordinator
        salt = getattr(c, "_etag_salt", None)
        if salt is None:       # async wrapper / read replica: salt lives on
            inner = getattr(c, "server", None) or getattr(c, "_coord", None)
            salt = getattr(inner, "_etag_salt", None)
        return (id(c), salt, int(getattr(c, "version", -1)),
                int(getattr(c, "mesh_epoch", -1)))

    def start(self) -> "_Federation":
        if self.is_async and self._loop is None:
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever, daemon=True,
                name="afl-federation-loop")
            self._thread.start()
            start = getattr(self.coordinator, "start", None)
            if start is not None:
                self._run(start())
        return self

    def _run(self, awaitable):
        return asyncio.run_coroutine_threadsafe(
            awaitable, self._loop).result()

    def call(self, name: str, *args, **kwargs):
        """Invoke a coordinator method, awaiting it when it is a coroutine."""
        method = getattr(self.coordinator, name)
        if self.is_async:
            out = method(*args, **kwargs)
            return self._run(out) if inspect.isawaitable(out) else out
        with self._lock:
            return method(*args, **kwargs)

    @property
    def pending(self) -> int:
        """Unapplied queued reports (0 for coordinators without a queue)."""
        return int(getattr(self.coordinator, "pending", 0))

    def close(self) -> None:
        if self.standby is not None:
            self.standby.stop()
            self.standby = None
        if self.ledger is not None:
            self.ledger.close()
            self.ledger = None
        if self._loop is not None:
            try:
                close = getattr(self.coordinator, "close", None)
                if close is not None:
                    self._run(close())
            finally:
                self._loop.call_soon_threadsafe(self._loop.stop)
                self._thread.join(timeout=5)
                self._loop.close()
                self._loop = None
                self._thread = None


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class FederationService:
    """Routes byte envelopes to hosted coordinators (any kind, any count).

    >>> service = FederationService(AFLServer(dim=d, num_classes=c))
    >>> coord = RemoteCoordinator(service)            # in-proc transport
    >>> with serve_http(service) as srv:              # ...or over HTTP
    ...     coord = RemoteCoordinator(srv.url)

    ``handle(route, body, federation)`` is the single wire entrypoint both
    transports call; it never raises — every failure becomes an error
    envelope carrying a stable taxonomy code plus the HTTP status the
    transport should surface. ``max_report_bytes`` bounds any single report
    payload (checked before parsing); ``max_pending`` is the ingest
    high-watermark for queue-backed coordinators — once ``pending`` reaches
    it, submissions answer ``backpressure`` (HTTP 429, retryable) and the
    coordinator state stays untouched.
    """

    def __init__(self, coordinator=None, *, federation_id: str = "default",
                 max_report_bytes: int = 64 << 20,
                 max_pending: Optional[int] = None,
                 ledger_dir=None, applied_cache_size: int = 65536,
                 auth_token: Optional[str] = None):
        self.max_report_bytes = int(max_report_bytes)
        self.max_pending = None if max_pending is None else int(max_pending)
        self.applied_cache_size = (None if applied_cache_size is None
                                   else int(applied_cache_size))
        self._feds: Dict[str, _Federation] = {}
        if coordinator is not None:
            self.add_federation(
                federation_id, coordinator,
                ledger=(None if ledger_dir is None
                        else ReportLedger(ledger_dir)),
                auth_token=auth_token)

    # -- lifecycle / registry -----------------------------------------------

    def add_federation(self, federation_id: str, coordinator, *,
                       ledger: Optional[ReportLedger] = None,
                       auth_token: Optional[str] = None
                       ) -> "FederationService":
        """Host another coordinator under ``federation_id`` (async kinds get
        their worker loop brought up here). With a ``ledger``, every
        accepted submit/stream frame is appended and fsynced before the
        ack — the durable half of zero-loss failover. With ``auth_token``,
        every request must carry that bearer token or it answers the typed
        ``unauthorized`` 401 before touching any state."""
        self._feds[str(federation_id)] = _Federation(
            coordinator, applied_cache_size=self.applied_cache_size,
            ledger=ledger, auth_token=auth_token).start()
        return self

    def set_auth_token(self, token: Optional[str],
                       federation_id: str = "default") -> None:
        """Install (or clear, with ``None``) the bearer token gating a
        hosted federation — rotation without a restart."""
        self._fed(federation_id).auth_token = (
            None if token is None else str(token))

    def ledger(self, federation_id: str = "default"
               ) -> Optional[ReportLedger]:
        """The federation's live submit ledger (None when not configured) —
        e.g. to hand the in-process snapshot daemon for tick compaction."""
        return self._fed(federation_id).ledger

    def host_standby(self, federation_id: str, standby: WarmStandby,
                     *, adopt_ledger: bool = True,
                     auth_token: Optional[str] = None
                     ) -> "FederationService":
        """Host a warm standby: the federation answers retryable 503s while
        the standby tails the primary's ledger in the background; the
        ``promote`` route (or :meth:`promote_federation`) flips it live.
        With ``adopt_ledger`` the promoted primary keeps appending to the
        same ledger directory, so the failover chain can repeat."""
        fed = _Federation(standby.coordinator,
                          applied_cache_size=self.applied_cache_size,
                          auth_token=auth_token)
        fed.standby = standby.start()
        fed.suspended = True
        self._feds[str(federation_id)] = fed
        fed._adopt_ledger = bool(adopt_ledger)
        return self

    def promote_federation(self, federation_id: str = "default"):
        """Standby → primary: drain the ledger tail, refresh the ETag salt
        (tokens the dead primary minted never revalidate here), clear the
        suspended latch, and resume serving — with continued ledger appends
        when the standby was hosted with ``adopt_ledger``. Returns the
        promoted coordinator."""
        fed = self._fed(federation_id)
        if fed.standby is None:
            raise E.BadRequest(
                f"federation {federation_id!r} has no warm standby to "
                "promote (host one via host_standby)")
        standby = fed.standby
        fed.standby = None
        coordinator = standby.promote()
        if fed._adopt_ledger and fed.ledger is None:
            fed.ledger = ReportLedger(standby.ledger_dir)
        fed.suspended = False
        fed.start()                        # async kinds: bring the loop up
        return coordinator

    def suspend_federation(self, federation_id: str = "default"):
        """Take a federation out of service — the failover latch. Every
        subsequent request answers the retryable ``unavailable`` 503 until
        :meth:`restore_federation` installs a replacement coordinator.
        Returns the (possibly dead) coordinator for post-mortems."""
        fed = self._fed(federation_id)
        fed.suspended = True
        return fed.coordinator

    def restore_federation(self, federation_id: str,
                           coordinator) -> "FederationService":
        """Install a replacement coordinator (e.g. cold-started from the
        snapshot daemon's latest snapshot, or a promoted warm standby) and
        resume serving. The idempotent-ingest map AND the submit ledger
        carry over, so a client retrying a submit that straddled the
        outage still gets its idempotent answer."""
        old = self._fed(federation_id)
        applied, ledger = old.applied, old.ledger
        old.ledger = None                  # keep it open across the swap
        old.close()
        fed = _Federation(coordinator,
                          applied_cache_size=self.applied_cache_size,
                          ledger=ledger,
                          auth_token=old.auth_token).start()
        fed.applied = applied
        self._feds[str(federation_id)] = fed
        return self

    def coordinator(self, federation_id: str = "default"):
        """The backing coordinator object (in-proc introspection/tests)."""
        return self._fed(federation_id).coordinator

    def federation_ids(self) -> List[str]:
        return sorted(self._feds)

    def close(self) -> None:
        for fed in self._feds.values():
            fed.close()

    def __enter__(self) -> "FederationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _fed(self, federation_id: str) -> _Federation:
        fed = self._feds.get(str(federation_id))
        if fed is None:
            raise E.UnknownFederation(
                f"no federation {federation_id!r} "
                f"(hosting: {self.federation_ids()})")
        return fed

    # -- the wire entrypoint -------------------------------------------------

    def handle(self, route: str, body: bytes = b"",
               federation: str = "default", *,
               token: Optional[str] = None) -> Tuple[bytes, int]:
        """Dispatch one request → (response envelope, HTTP status)."""
        try:
            handler = self._ROUTES.get(route)
            if handler is None:
                raise E.BadRequest(
                    f"unknown route {route!r} (one of {sorted(self._ROUTES)})")
            fed = self._fed(federation)
            # auth precedes EVERYTHING else (promote included): a bad
            # bearer token answers 401 with coordinator state untouched
            if fed.auth_token is not None and (
                    token is None
                    or not hmac.compare_digest(str(token), fed.auth_token)):
                raise E.Unauthorized(
                    f"federation {federation!r} requires a valid bearer "
                    "token")
            # promote is the one route that must work DURING the outage —
            # it is how a hosted standby ends it
            if fed.suspended and route != "promote":
                raise E.Unavailable(
                    f"federation {federation!r} is failing over — retry "
                    "after the replacement coordinator is installed")
            if fed.read_only and route in self._MUTATING_ROUTES:
                raise E.ReadOnlyFederation(
                    f"{route!r} on read-only federation {federation!r} — "
                    "replicas never ingest; send writes to the primary")
            if route in self._COALESCED_ROUTES:
                return self._coalesced(fed, route, handler, bytes(body)), 200
            return handler(self, fed, bytes(body)), 200
        except E.ServiceError as exc:
            return self._error(exc)
        except ValueError as exc:
            return self._error(E.BadRequest(str(exc)))
        except Exception as exc:                      # noqa: BLE001
            # never leak a stack trace onto the wire; "internal" decodes to
            # the bare ServiceError on the client
            err = E.ServiceError(f"{type(exc).__name__}: {exc}")
            return self._error(err)

    @staticmethod
    def _error(exc: E.ServiceError) -> Tuple[bytes, int]:
        return (pack_message({"ok": False, "error": exc.code,
                              "message": str(exc),
                              "retryable": exc.retryable}),
                exc.http_status)

    @staticmethod
    def _ok(header: Dict[str, Any],
            arrays: Sequence[Tuple[str, np.ndarray]] = (),
            blob: bytes = b"") -> bytes:
        return pack_message({"ok": True, **header}, arrays, blob=blob)

    # -- single-flight read coalescing ----------------------------------------

    _COALESCE_CACHE_MAX = 64

    def _coalesced(self, fed: _Federation, route: str, handler,
                   body: bytes) -> bytes:
        """Single-flight dispatch for read routes: identical concurrent
        requests (same route + request bytes — which carry the γ / grid /
        if_etag) at the same :meth:`_Federation.read_token` share ONE
        underlying computation and ONE encoded response; repeats within the
        same epoch answer from the per-federation response cache. The token
        captures instance + salt + version + mesh epoch, so every epoch
        bump invalidates implicitly — a stale head can never be served, and
        N pollers between arrivals cost one solve. Works identically over
        in-proc, HTTP, and mux: coalescing sits under ``handle``, above the
        transports. Errors propagate to every waiter and are never cached.
        """
        key = (route, body)
        token = fed.read_token()
        with fed.coalesce_lock:
            entry = fed.read_cache.get(key)
            if entry is not None:
                if entry[0] == token:
                    fed.read_cache.move_to_end(key)
                    fed.coalesced_hits += 1
                    return entry[1]
                del fed.read_cache[key]    # stale epoch — drop eagerly
            flight = fed.inflight.get(key)
            if flight is not None and flight.token == token:
                leader = None
            else:
                leader = flight = _Flight(token)
                fed.inflight[key] = flight
        if leader is None:
            # follower: wait for the leader's response (the leader's
            # ``finally`` always signals, even on error). If an epoch
            # bumped mid-flight the answer is still linearizable — it is
            # what a direct dispatch would have returned moments earlier.
            flight.event.wait()
            if flight.exc is not None:
                raise flight.exc
            with fed.coalesce_lock:
                fed.coalesced_hits += 1
            return flight.result
        try:
            resp = handler(self, fed, body)
        except BaseException as exc:
            flight.exc = exc
            raise
        else:
            flight.result = resp
            return resp
        finally:
            with fed.coalesce_lock:
                if fed.inflight.get(key) is flight:
                    del fed.inflight[key]
                # cache only when no arrival landed during the compute —
                # otherwise the NEXT request recomputes under its own token
                if flight.exc is None and fed.read_token() == flight.token:
                    fed.read_cache[key] = (flight.token, flight.result)
                    while len(fed.read_cache) > self._COALESCE_CACHE_MAX:
                        fed.read_cache.popitem(last=False)
            flight.event.set()

    # -- shared ingest helpers ----------------------------------------------

    def _parse_report(self, payload: bytes) -> ClientReport:
        if len(payload) > self.max_report_bytes:
            raise E.OversizedReport(
                f"report payload is {len(payload)} bytes "
                f"(limit {self.max_report_bytes})")
        try:
            return ClientReport.from_bytes(payload)
        except E.ServiceError:
            raise
        except ValueError as exc:
            raise E.CorruptReport(str(exc)) from None

    def _check_backpressure(self, fed: _Federation) -> None:
        if self.max_pending is not None and fed.pending >= self.max_pending:
            raise E.Backpressure(
                f"{fed.pending} reports pending ≥ "
                f"max_pending={self.max_pending}")

    def _replayed(self, fed: _Federation, report: ClientReport,
                  payload: bytes) -> Optional[int]:
        """The idempotency check: the CRC of this exact payload if the
        service already accepted it for this client id (a transport retry
        whose first attempt landed — answer success, apply nothing), else
        ``None``. A *different* payload under a known id falls through to
        the coordinator's duplicate_client rejection."""
        crc = zlib.crc32(payload)
        return crc if fed.applied.get(report.client_id) == crc else None

    @staticmethod
    def _client_known(fed: _Federation, client_id: int) -> bool:
        """Whether the coordinator has already folded this client — the
        cheap gate in front of a ledger disk scan (a brand-new client must
        never pay one)."""
        c = fed.coordinator
        seen = getattr(getattr(c, "server", c), "_seen", None)
        return seen is not None and int(client_id) in seen

    def _ledger_replayed(self, fed: _Federation, report: ClientReport,
                         payload: bytes) -> bool:
        """Disk half of the idempotency check, consulted only after the
        in-memory map missed (LRU eviction, or a service restarted /
        promoted onto the same ledger): ``True`` iff the ledger's newest
        record for this client is byte-identical to ``payload``. A hit is
        re-cached into the map."""
        if fed.ledger is None:
            return False
        crc = zlib.crc32(payload)
        if fed.ledger.find_crc(report.client_id) != crc:
            return False
        fed.applied.set(report.client_id, crc)
        return True

    @staticmethod
    def _request_header(body: bytes) -> Tuple[dict, Dict[str, np.ndarray],
                                              bytes]:
        if not body:
            return {}, {}, b""
        return unpack_message(body)

    # -- routes ---------------------------------------------------------------

    def _r_describe(self, fed: _Federation, body: bytes) -> bytes:
        c = fed.coordinator
        # ledger position is read BEFORE pending: a compactor may treat
        # ledger_seq as fully-applied only when the same describe reports
        # pending == 0 — with this ordering, any record appended after the
        # seq read either shows up as pending or carries a higher seq, so
        # compacting to ledger_seq can never drop an unapplied report
        ledger_seq = (None if fed.ledger is None
                      else int(fed.ledger.last_seq))
        info = {
            "kind": type(c).__name__,
            "dim": int(c.dim),
            "num_classes": int(c.num_classes),
            "gamma": float(c.gamma),
            "num_clients": int(c.num_clients),
            "version": int(c.version),
            "pending": fed.pending,
            "max_report_bytes": self.max_report_bytes,
            "auth_required": fed.auth_token is not None,
        }
        shards = getattr(c, "num_shards", None)
        if shards is not None:
            info["num_shards"] = int(shards)
            info["mesh_epoch"] = int(getattr(c, "mesh_epoch", 0))
        info["read_only"] = fed.read_only
        if fed.read_only:
            info["replica_lag"] = int(getattr(c, "lag", 0))
            info["mesh_epoch"] = int(getattr(c, "mesh_epoch", 0))
        if ledger_seq is not None:
            info["ledger_seq"] = ledger_seq
        # read-path observability: requests answered without recomputing
        info["coalesced_hits"] = int(fed.coalesced_hits)
        # ingest observability for batching coordinators (AsyncAFLServer):
        # live queue depth plus the fold counters a capacity planner needs
        # to size batch_max against arrival rate
        if getattr(c, "batches_folded", None) is not None:
            info["ingest"] = {
                "queue_depth": fed.pending,
                "batch_max": int(getattr(c, "batch_max", 1)),
                "last_batch": int(getattr(c, "last_batch", 0)),
                "batches_folded": int(c.batches_folded),
                "rejected_dropped": int(getattr(c, "rejected_dropped", 0)),
            }
        return self._ok(info)

    def _r_grow(self, fed: _Federation, body: bytes) -> bytes:
        return self._resize_route(fed, body, "grow")

    def _r_shrink(self, fed: _Federation, body: bytes) -> bytes:
        return self._resize_route(fed, body, "shrink")

    def _resize_route(self, fed: _Federation, body: bytes,
                      verb: str) -> bytes:
        """``grow``/``shrink`` the hosted mesh by ``n`` shards (header key
        ``n``, default 1). Only elastic coordinators support it; racing
        requests surface the coordinator's retryable backpressure."""
        header, _, _ = self._request_header(body)
        n = int(header.get("n", 1))
        c = fed.coordinator
        if getattr(c, verb, None) is None:
            raise E.BadRequest(
                f"{type(c).__name__} is not elastic — no {verb}()")
        epoch = fed.call(verb, n)
        return self._ok({"mesh_epoch": int(epoch),
                         "num_shards": int(c.num_shards),
                         "version": int(c.version)})

    def _duplicate_ok(self, fed: _Federation) -> bytes:
        c = fed.coordinator
        return self._ok({"folded": True, "duplicate": True,
                         "num_clients": int(c.num_clients),
                         "version": int(c.version)})

    def _r_submit(self, fed: _Federation, body: bytes) -> bytes:
        """Body = one raw :class:`ClientReport` payload → fold outcome.
        Idempotent: re-delivery of the identical payload (client id + CRC)
        answers success without touching the aggregate, so a transport may
        safely replay a submit whose response was lost — even across an
        LRU-evicted map entry or a promotion, via the ledger fallback.
        Accepted folds are appended to the ledger and fsynced BEFORE the
        ack: anything a client saw acknowledged survives to the standby."""
        report = self._parse_report(body)
        if self._replayed(fed, report, body) is not None:
            return self._duplicate_ok(fed)
        self._check_backpressure(fed)
        try:
            folded = fed.call("submit", report)
        except E.DuplicateClient:
            # the map missed (evicted / fresh promotion) but the
            # coordinator knows the client — identical bytes on disk mean
            # this is a replay, not a conflict
            if self._ledger_replayed(fed, report, body):
                return self._duplicate_ok(fed)
            raise
        fed.applied.set(report.client_id, zlib.crc32(body))
        if fed.ledger is not None:
            fed.ledger.append(body, report.client_id)
            fed.ledger.sync()              # durable before the ack
        c = fed.coordinator
        return self._ok({"folded": bool(folded), "duplicate": False,
                         "num_clients": int(c.num_clients),
                         "version": int(c.version)})

    def _r_submit_stream(self, fed: _Federation, body: bytes) -> bytes:
        """Framed multi-report upload; each frame is accepted/rejected
        independently, so one corrupt report in a batch cannot poison the
        rest. Queue-backed coordinators ingest fire-and-forget: every
        admissible frame in the stream crosses into the coordinator loop in
        ONE ``enqueue_many`` call (the transport answer is *queued*, not
        *folded*) — so a 64-frame stream costs one loop wakeup, not 64.
        Backpressure — the service watermark (projected over the frames
        already admitted from this stream) or the coordinator's own —
        rejects a frame without touching state."""
        frames = _unframe_reports(body)
        if fed.is_async:
            return self._stream_async(fed, frames)
        results: List[Dict[str, Any]] = []
        accepted = appended = 0
        for frame in frames:
            try:
                report = self._parse_report(frame)
                if self._replayed(fed, report, frame) is not None:
                    results.append({"ok": True, "duplicate": True})
                    accepted += 1
                    continue
                try:
                    folded = fed.call("submit", report)
                except E.DuplicateClient:
                    if self._ledger_replayed(fed, report, frame):
                        results.append({"ok": True, "duplicate": True})
                        accepted += 1
                        continue
                    raise
                results.append({"ok": True, "queued": False,
                                "folded": bool(folded)})
                fed.applied.set(report.client_id, zlib.crc32(frame))
                if fed.ledger is not None:
                    fed.ledger.append(frame, report.client_id)
                    appended += 1
                accepted += 1
            except E.ServiceError as exc:
                results.append({"ok": False, "error": exc.code,
                                "message": str(exc),
                                "retryable": exc.retryable})
            except ValueError as exc:
                results.append({"ok": False, "error": E.BadRequest.code,
                                "message": str(exc), "retryable": False})
        if appended:
            fed.ledger.sync()              # ONE fsync per stream batch
        return self._ok({"results": results, "accepted": accepted,
                         "pending": fed.pending,
                         "version": int(fed.coordinator.version)})

    def _stream_async(self, fed: _Federation,
                      frames: Sequence[bytes]) -> bytes:
        """Queue-backed half of ``submit_stream``: admit every valid frame
        first (parse, replay/idempotency, projected watermark), then hand
        the whole admissible batch to the coordinator in one
        ``enqueue_many`` crossing. Bookkeeping (idempotency map + ledger)
        happens only for frames the coordinator actually admitted — its own
        watermark may shave the tail, which answers retryable backpressure
        exactly as a per-frame enqueue would have."""
        results: List[Optional[Dict[str, Any]]] = []
        # provisionally admitted frames: (result slot, report, frame, crc)
        slots: List[Tuple[int, ClientReport, bytes, int]] = []
        # intra-stream duplicates ride on their original's admission:
        # result slot → index into ``slots`` they duplicate
        dup_of: List[Tuple[int, int]] = []
        batch_seen: Dict[int, Tuple[int, int]] = {}   # client → (crc, slot#)
        accepted = appended = 0
        for frame in frames:
            try:
                report = self._parse_report(frame)
                if self._replayed(fed, report, frame) is not None:
                    results.append({"ok": True, "duplicate": True})
                    accepted += 1
                    continue
                crc = zlib.crc32(frame)
                prior = batch_seen.get(report.client_id)
                if prior is not None and prior[0] == crc:
                    # identical bytes earlier in this very stream — final
                    # answer depends on whether that frame is admitted
                    dup_of.append((len(results), prior[1]))
                    results.append(None)
                    continue
                if self.max_pending is not None and (
                        fed.pending + len(slots) >= self.max_pending):
                    raise E.Backpressure(
                        f"{fed.pending + len(slots)} reports pending ≥ "
                        f"max_pending={self.max_pending}")
                # fire-and-forget: the fold outcome is unknown at ack time,
                # so the idempotency answer for an evicted map entry must
                # come from disk BEFORE re-enqueueing
                if (self._client_known(fed, report.client_id)
                        and self._ledger_replayed(fed, report, frame)):
                    results.append({"ok": True, "duplicate": True})
                    accepted += 1
                    continue
                batch_seen[report.client_id] = (crc, len(slots))
                slots.append((len(results), report, frame, crc))
                results.append(None)
            except E.ServiceError as exc:
                results.append({"ok": False, "error": exc.code,
                                "message": str(exc),
                                "retryable": exc.retryable})
            except ValueError as exc:
                results.append({"ok": False, "error": E.BadRequest.code,
                                "message": str(exc), "retryable": False})
        admitted = 0
        if slots:
            reports = [s[1] for s in slots]
            if getattr(fed.coordinator, "enqueue_many", None) is not None:
                admitted = int(fed.call("enqueue_many", reports))
            else:
                try:
                    for report in reports:
                        fed.call("enqueue", report)
                        admitted += 1
                except E.ServiceError:
                    pass                   # tail answers backpressure below
        shaved = {"ok": False, "error": E.Backpressure.code,
                  "message": "coordinator queue full — retry",
                  "retryable": True}
        for n, (idx, report, frame, crc) in enumerate(slots):
            if n < admitted:
                results[idx] = {"ok": True, "queued": True}
                fed.applied.set(report.client_id, crc)
                if fed.ledger is not None:
                    # queued frames are appended the moment they are
                    # admitted — a crash before the worker applies them
                    # still drains them into the standby (zero loss for
                    # fire-and-forget ingest)
                    fed.ledger.append(frame, report.client_id)
                    appended += 1
                accepted += 1
            else:
                results[idx] = dict(shaved)
        for idx, slot in dup_of:
            if slot < admitted:
                results[idx] = {"ok": True, "duplicate": True}
                accepted += 1
            else:
                results[idx] = dict(shaved)
        if appended:
            fed.ledger.sync()              # ONE fsync per stream batch
        return self._ok({"results": results, "accepted": accepted,
                         "pending": fed.pending,
                         "version": int(fed.coordinator.version)})

    def _r_solve(self, fed: _Federation, body: bytes) -> bytes:
        header, _, _ = self._request_header(body)
        tg = float(header.get("target_gamma", 0.0))
        w = fed.call("solve", tg)
        return self._ok(
            {"target_gamma": tg, "version": int(fed.coordinator.version)},
            [("weight", np.asarray(w, np.float64))])

    def _r_solve_multi_gamma(self, fed: _Federation, body: bytes) -> bytes:
        header, _, _ = self._request_header(body)
        gammas = [float(g) for g in header.get("gammas", ())]
        if not gammas:
            raise E.BadRequest("solve_multi_gamma requires a non-empty "
                               "'gammas' list")
        ws = fed.call("solve_multi_gamma", gammas)
        stacked = np.stack([np.asarray(w, np.float64) for w in ws])
        return self._ok(
            {"gammas": gammas, "version": int(fed.coordinator.version)},
            [("weights", stacked)])

    def _r_sweep(self, fed: _Federation, body: bytes) -> bytes:
        header, arrays, _ = self._request_header(body)
        gammas = [float(g) for g in header.get("gammas", ())]
        if not gammas or "x" not in arrays or "y" not in arrays:
            raise E.BadRequest("sweep requires 'gammas' plus holdout arrays "
                               "'x' and 'y'")
        sweep: GammaSweep = fed.call("sweep", gammas,
                                     (arrays["x"], arrays["y"]))
        best = sweep.gammas.index(sweep.best_gamma)
        return self._ok(
            {"gammas": list(sweep.gammas),
             "accuracies": list(sweep.accuracies),
             "best_gamma": float(sweep.best_gamma),
             "best_index": int(best),
             "version": int(fed.coordinator.version)},
            [("weights", np.stack([np.asarray(w, np.float64)
                                   for w in sweep.weights]))])

    def _r_weights(self, fed: _Federation, body: bytes) -> bytes:
        header, _, _ = self._request_header(body)
        tg = float(header.get("target_gamma", 0.0))
        if_etag = header.get("if_etag")
        vw: VersionedWeights = fed.call(
            "weights", tg,
            if_etag=None if if_etag is None else str(if_etag))
        meta = {"version": int(vw.version), "target_gamma": tg,
                "etag": vw.etag, "not_modified": vw.not_modified}
        if vw.not_modified:
            return self._ok(meta)
        return self._ok(meta, [("weight", np.asarray(vw.weight, np.float64))])

    def _r_state(self, fed: _Federation, body: bytes) -> bytes:
        state = fed.call("state")
        arrays = [(k, np.asarray(v)) for k, v in state.items()]
        return self._ok({"kind": type(fed.coordinator).__name__,
                         "version": int(fed.coordinator.version)}, arrays)

    def _r_personalized_solve(self, fed: _Federation, body: bytes) -> bytes:
        """Per-client head from the shared aggregate (personalization):
        a client-specific target γ, optionally mixed
        with the client's OWN local statistics — solve
        ``(C_agg + β·C_k + γ_c·I) W = Q_agg + β·Q_k`` with the client's
        report riding in the envelope blob. β > 0 tilts the shared head
        toward the client's local distribution; β = 0 (no report) is the
        pure per-γ personalization. The federation aggregate is read, never
        written, so personalization can not corrupt the shared state.
        """
        header, _, blob = self._request_header(body)
        tg = float(header.get("target_gamma", 0.0))
        c = fed.coordinator
        if c.num_clients == 0:
            raise E.EmptyFederation("no clients aggregated")
        if not blob:
            w = fed.call("solve", tg)
            return self._ok({"target_gamma": tg, "mix_weight": 0.0,
                             "version": int(c.version)},
                            [("weight", np.asarray(w, np.float64))])
        report = self._parse_report(blob)
        beta = float(header.get("mix_weight", 1.0))
        state = fed.call("state")
        dim = int(state["gram"].shape[0])
        stats, _seen = _restore_stats(state, float(state["gamma"]), dim)
        raw_k = (np.asarray(report.gram, np.float64)
                 - report.gamma * np.eye(dim))
        mixed = SuffStats(
            gram=stats.gram + beta * raw_k,
            moment=stats.moment + beta * np.asarray(report.moment,
                                                    np.float64),
            count=stats.count + beta * report.count,
            clients=stats.clients,
        )
        w = _HOST_ENGINE.solve(mixed, target_gamma=tg)
        return self._ok({"target_gamma": tg, "mix_weight": beta,
                         "version": int(c.version)},
                        [("weight", np.asarray(w, np.float64))])

    def _r_promote(self, fed: _Federation, body: bytes) -> bytes:
        """Flip a hosted warm standby live (see :meth:`promote_federation`).
        The one route the suspended latch does not gate."""
        # self-route through the public method: _fed lookup already done,
        # but promote_federation re-resolves by id — find ours
        fid = next(k for k, v in self._feds.items() if v is fed)
        coordinator = self.promote_federation(fid)
        return self._ok({"promoted": True,
                         "kind": type(coordinator).__name__,
                         "num_clients": int(coordinator.num_clients),
                         "version": int(coordinator.version)})

    _ROUTES = {
        "describe": _r_describe,
        "submit": _r_submit,
        "submit_stream": _r_submit_stream,
        "solve": _r_solve,
        "solve_multi_gamma": _r_solve_multi_gamma,
        "sweep": _r_sweep,
        "weights": _r_weights,
        "state": _r_state,
        "personalized_solve": _r_personalized_solve,
        "grow": _r_grow,
        "shrink": _r_shrink,
        "promote": _r_promote,
    }

    # routes that change federation state — rejected up front on a
    # read-only (replica) federation
    _MUTATING_ROUTES = frozenset(
        {"submit", "submit_stream", "grow", "shrink"})

    # pure read routes whose responses depend only on (request bytes, head
    # epoch) — safe to single-flight and cache per read_token. ``state`` and
    # ``describe`` are deliberately excluded: state is a snapshot/backup path
    # (cheap, rarely concurrent-identical) and describe reports live queue
    # depth that must not be frozen within an epoch.
    _COALESCED_ROUTES = frozenset(
        {"solve", "solve_multi_gamma", "sweep", "weights"})


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class InProcTransport:
    """Zero-copy loopback: the same byte envelopes, no socket. The default
    for tests — what crosses this transport is exactly what would cross
    HTTP, so in-proc coverage IS wire coverage."""

    def __init__(self, service: FederationService, *,
                 auth_token: Optional[str] = None):
        self._service = service
        self.auth_token = auth_token

    def request(self, route: str, body: bytes = b"",
                federation: str = "default") -> bytes:
        data, _status = self._service.handle(route, body, federation,
                                             token=self.auth_token)
        return data

    def close(self) -> None:
        pass


class HttpTransport:
    """Client side of the HTTP transport (stdlib ``http.client``).

    Connections are **kept alive and reused** (HTTP/1.1 persistent
    connections, one pooled connection per calling thread, so the transport
    stays trivially thread-safe without locking the socket; connections
    owned by dead threads are swept on the next pool access, so thread
    churn cannot leak sockets). At loopback latencies reuse is minor; over
    a WAN it removes a TCP (and eventually TLS) handshake round-trip from
    every submit/poll. A pooled connection the
    server has since closed (idle timeout, restart) is detected on its next
    use and replaced with ONE transparent retry on a fresh connection —
    with replay discipline: a failure while *sending* or while *reading
    the response* retries on the fresh socket — replaying a ``submit``
    whose first attempt actually landed is safe because the service's
    ingest is idempotent (a re-delivered identical payload, keyed on
    client id + report CRC, answers success without double-applying,
    instead of surfacing a spurious ``duplicate_client`` 409). A *timeout*
    is never retried (the request may still be executing), and a failure
    on a *fresh* connection propagates — that is a real transport error.
    ``keep_alive=False`` restores the one-shot connection-per-request
    behavior.
    """

    def __init__(self, url: str, *, timeout: float = 60.0,
                 keep_alive: bool = True,
                 auth_token: Optional[str] = None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 cafile: Optional[str] = None):
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(
                f"HttpTransport speaks http:// or https:// only, got {url!r}")
        self._tls = parts.scheme == "https"
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or (443 if self._tls else 80)
        self._prefix = parts.path.rstrip("/")
        self._timeout = float(timeout)
        self.keep_alive = bool(keep_alive)
        self.auth_token = auth_token
        self._ssl = (ssl_context if ssl_context is not None
                     else (ssl.create_default_context(cafile=cafile)
                           if self._tls else None))
        self._local = threading.local()
        self._pool: Dict[threading.Thread, http.client.HTTPConnection] = {}
        self._pool_lock = threading.Lock()

    def _connect(self) -> http.client.HTTPConnection:
        if self._tls:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self._timeout,
                context=self._ssl)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._timeout)

    def _pooled(self) -> Tuple[http.client.HTTPConnection, bool]:
        """This thread's live connection (reused=True), or a fresh one that
        joins the pool. Joining also sweeps connections whose owning thread
        has exited — their thread-local slot is gone, so without the sweep
        the sockets would stay open until close()."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            return conn, True
        conn = self._connect()
        self._local.conn = conn
        with self._pool_lock:
            for t in [t for t in self._pool if not t.is_alive()]:
                self._pool.pop(t).close()
            self._pool[threading.current_thread()] = conn
        return conn, False

    def _discard(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            return
        self._local.conn = None
        with self._pool_lock:
            me = threading.current_thread()
            if self._pool.get(me) is conn:
                self._pool.pop(me)
        conn.close()

    def _path(self, route: str, federation: str) -> str:
        return (f"{self._prefix}/v1/"
                f"{urllib.parse.quote(federation, safe='')}/{route}")

    def request(self, route: str, body: bytes = b"",
                federation: str = "default") -> bytes:
        path = self._path(route, federation)
        headers = {"Content-Type": "application/octet-stream"}
        if self.auth_token is not None:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        if not self.keep_alive:
            conn = self._connect()
            try:
                conn.request("POST", path, body=body, headers=headers)
                return conn.getresponse().read()
            finally:
                conn.close()
        while True:
            conn, reused = self._pooled()
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.will_close:
                    self._discard()            # server opted out of reuse
                return data
            except (http.client.HTTPException, ConnectionError,
                    OSError) as exc:
                self._discard()
                if not reused or isinstance(exc, TimeoutError):
                    # fresh socket: a real failure. Timeout: the request
                    # may still be executing — replaying races it, so
                    # surface the error instead.
                    raise
                # stale kept-alive socket — retry once on a fresh one.
                # Safe even for submit: the service's idempotent ingest
                # (client id + CRC) makes a replayed landed request a no-op.

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = dict(self._pool), {}
        for conn in pool.values():
            conn.close()
        self._local = threading.local()


class _HttpHandler(http.server.BaseHTTPRequestHandler):
    service: FederationService = None  # type: ignore[assignment]
    server_version = "AFLFederationService/1"
    protocol_version = "HTTP/1.1"
    # headers and body go out in separate writes; without TCP_NODELAY the
    # Nagle + delayed-ACK interaction costs ~40ms per response on loopback
    disable_nagle_algorithm = True

    def _respond(self, data: bytes, status: int) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _bearer(self) -> Optional[str]:
        auth = self.headers.get("Authorization") or ""
        return auth[7:] if auth.startswith("Bearer ") else None

    def _route(self, body: bytes) -> Tuple[bytes, int]:
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if len(parts) != 3 or parts[0] != "v1":
            return FederationService._error(E.BadRequest(
                f"path {self.path!r} is not /v1/<federation>/<route>"))
        return self.service.handle(parts[2], body,
                                   urllib.parse.unquote(parts[1]),
                                   token=self._bearer())

    def do_POST(self) -> None:  # noqa: N802 (stdlib handler naming)
        length = int(self.headers.get("Content-Length") or 0)
        # refuse to even read a body past the request cap — backstop against
        # memory-ballooning uploads (8× single-report cap: stream batches)
        if length > 8 * self.service.max_report_bytes:
            self._respond(*FederationService._error(E.OversizedReport(
                f"request body is {length} bytes")))
            return
        body = self.rfile.read(length) if length else b""
        self._respond(*self._route(body))

    def do_GET(self) -> None:  # noqa: N802
        """GET works for the body-less reads (describe / weights / state) —
        curl-friendly introspection of a live federation."""
        self._respond(*self._route(b""))

    def log_message(self, *args) -> None:  # silence per-request stderr spam
        pass


class HttpFederationServer:
    """A threaded stdlib HTTP server hosting one :class:`FederationService`
    on loopback (or any interface). Context-manager friendly::

        with serve_http(FederationService(server)) as srv:
            coord = RemoteCoordinator(srv.url)
    """

    def __init__(self, service: FederationService, host: str = "127.0.0.1",
                 port: int = 0, *,
                 ssl_context: Optional[ssl.SSLContext] = None):
        handler = type("BoundHandler", (_HttpHandler,), {"service": service})
        self.service = service
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True)
        self.url = (f"{'https' if ssl_context is not None else 'http'}"
                    f"://{self.host}:{self.port}")
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpFederationServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="afl-http-server")
            self._thread.start()
        return self

    def close(self, *, close_service: bool = False) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread = None
        if close_service:
            self.service.close()

    def __enter__(self) -> "HttpFederationServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(service: FederationService, host: str = "127.0.0.1",
               port: int = 0, *,
               ssl_context: Optional[ssl.SSLContext] = None
               ) -> HttpFederationServer:
    """Serve a federation over loopback HTTP (HTTPS with ``ssl_context``);
    returns the started server (``.url`` carries the ephemeral port when
    ``port=0``)."""
    return HttpFederationServer(service, host, port,
                                ssl_context=ssl_context).start()


def _transport_for_url(url: str, *, auth_token: Optional[str] = None,
                       ssl_context: Optional[ssl.SSLContext] = None,
                       cafile: Optional[str] = None):
    """URL scheme → transport: http/https → :class:`HttpTransport`,
    mux/muxs → :class:`~repro_torch.fl.mux.MuxTransport` (imported lazily —
    mux builds on this module, not the other way around)."""
    scheme = urllib.parse.urlsplit(url).scheme
    if scheme in ("mux", "muxs"):
        from repro_torch.fl.mux import MuxTransport

        return MuxTransport(url, auth_token=auth_token,
                            ssl_context=ssl_context, cafile=cafile)
    return HttpTransport(url, auth_token=auth_token,
                         ssl_context=ssl_context, cafile=cafile)


# ---------------------------------------------------------------------------
# The remote client
# ---------------------------------------------------------------------------


def promote_remote(transport: Union[str, FederationService, "InProcTransport",
                                    "HttpTransport"],
                   federation: str = "default", *,
                   auth_token: Optional[str] = None,
                   ssl_context: Optional[ssl.SSLContext] = None,
                   cafile: Optional[str] = None) -> dict:
    """Send the ``promote`` route to a standby service — the one request a
    suspended federation answers, so it cannot go through
    :class:`RemoteCoordinator` (whose constructor ``describe`` would 503
    during the outage). Returns the promote response header; a
    :class:`RemoteCoordinator` can be constructed normally afterwards."""
    own = False
    if isinstance(transport, str):
        transport, own = _transport_for_url(
            transport, auth_token=auth_token, ssl_context=ssl_context,
            cafile=cafile), True
    elif isinstance(transport, FederationService):
        transport = InProcTransport(transport, auth_token=auth_token)
    try:
        header, _, _ = _decode_response(
            transport.request("promote", b"", federation))
        return header
    finally:
        if own:
            transport.close()


class RemoteCoordinator:
    """A :class:`~repro_torch.fl.api.Coordinator` whose backing state lives behind
    a transport.

    Construction accepts a URL string (``http(s)://`` →
    :class:`HttpTransport`, ``mux(s)://`` →
    :class:`~repro_torch.fl.mux.MuxTransport`), a :class:`FederationService`
    (→ :class:`InProcTransport`), or any object with the transport
    ``request`` method. ``describe`` pins dim/classes/γ
    at construction; everything else is a wire round-trip, and every error
    re-raises as the same typed taxonomy exception an in-process coordinator
    would have thrown — which is why this class passes the local
    coordinators' conformance suite verbatim.

    The one deliberate divergence: ``sweep`` ships the holdout to the
    service and scores there (one round-trip for the whole γ grid) instead
    of downloading every candidate head.
    """

    def __init__(self,
                 transport: Union[str, FederationService, "InProcTransport",
                                  "HttpTransport"],
                 *, federation: str = "default",
                 auth_token: Optional[str] = None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 cafile: Optional[str] = None):
        if isinstance(transport, str):
            transport = _transport_for_url(
                transport, auth_token=auth_token, ssl_context=ssl_context,
                cafile=cafile)
        elif isinstance(transport, FederationService):
            transport = InProcTransport(transport, auth_token=auth_token)
        self._transport = transport
        self.federation = str(federation)
        info = self.describe()
        self.dim = int(info["dim"])
        self.num_classes = int(info["num_classes"])
        self.gamma = float(info["gamma"])
        self.kind = str(info.get("kind", "unknown"))

    # -- plumbing -----------------------------------------------------------

    def _request(self, route: str, header: Optional[dict] = None,
                 arrays: Sequence[Tuple[str, np.ndarray]] = (),
                 blob: bytes = b"", raw: Optional[bytes] = None):
        if raw is not None:
            body = bytes(raw)
        elif header is None and not arrays and not blob:
            body = b""
        else:
            body = pack_message(header or {}, arrays, blob=blob)
        return _decode_response(
            self._transport.request(route, body, self.federation))

    def close(self) -> None:
        self._transport.close()

    def __enter__(self) -> "RemoteCoordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- protocol surface ---------------------------------------------------

    def describe(self) -> dict:
        header, _, _ = self._request("describe")
        return header

    @property
    def num_clients(self) -> int:
        return int(self.describe()["num_clients"])

    @property
    def version(self) -> int:
        return int(self.describe()["version"])

    @property
    def pending(self) -> int:
        return int(self.describe()["pending"])

    @property
    def num_shards(self) -> Optional[int]:
        """Shard count of an elastic remote, ``None`` for fixed kinds."""
        shards = self.describe().get("num_shards")
        return None if shards is None else int(shards)

    @property
    def mesh_epoch(self) -> int:
        return int(self.describe().get("mesh_epoch", 0))

    def grow(self, n: int = 1) -> int:
        """Admit ``n`` shards on the remote mesh → new mesh epoch."""
        header, _, _ = self._request("grow", {"n": int(n)})
        return int(header["mesh_epoch"])

    def shrink(self, n: int = 1) -> int:
        """Retire ``n`` shards on the remote mesh → new mesh epoch."""
        header, _, _ = self._request("shrink", {"n": int(n)})
        return int(header["mesh_epoch"])

    def submit(self, report: ClientReport) -> bool:
        return self.submit_bytes(report.to_bytes())

    def submit_bytes(self, payload: bytes) -> bool:
        """Submit an already-serialized report (skips the re-encode when the
        caller holds wire bytes — e.g. relaying a client upload)."""
        header, _, _ = self._request("submit", raw=payload)
        return bool(header["folded"])

    def submit_many(self, reports: Iterable[ClientReport]) -> None:
        """Sync semantics (stop at first rejection), matching
        :meth:`repro_torch.fl.api.AFLServer.submit_many`; for fire-and-forget
        batching use :meth:`submit_stream`."""
        for report in reports:
            self.submit(report)

    def submit_stream(self, payloads: Iterable[bytes]) -> dict:
        """Upload many serialized reports in ONE framed request; returns the
        per-frame outcome dict (``results`` / ``accepted`` / ``pending`` /
        ``version``). Queue-backed federations ingest asynchronously —
        ``pending`` is the live backpressure signal."""
        header, _, _ = self._request("submit_stream",
                                     raw=frame_reports(payloads))
        return header

    def solve(self, target_gamma: float = 0.0) -> np.ndarray:
        _, arrays, _ = self._request(
            "solve", {"target_gamma": float(target_gamma)})
        return arrays["weight"]

    def solve_multi_gamma(self, gammas: Sequence[float]) -> List[np.ndarray]:
        _, arrays, _ = self._request(
            "solve_multi_gamma", {"gammas": [float(g) for g in gammas]})
        return list(arrays["weights"])

    def sweep(self, gammas: Sequence[float], holdout) -> GammaSweep:
        x, y = holdout
        ya = np.asarray(y)
        ya = (ya.astype(np.int64) if ya.dtype.kind in "iub"
              else ya.astype(np.float64))
        header, arrays, _ = self._request(
            "sweep", {"gammas": [float(g) for g in gammas]},
            [("x", np.asarray(x, np.float64)), ("y", ya)])
        weights = list(arrays["weights"])
        best = int(header["best_index"])
        return GammaSweep(tuple(float(g) for g in header["gammas"]), weights,
                          tuple(float(a) for a in header["accuracies"]),
                          float(header["best_gamma"]), weights[best])

    def weights(self, target_gamma: float = 0.0, *,
                if_etag: Optional[str] = None) -> VersionedWeights:
        req = {"target_gamma": float(target_gamma)}
        if if_etag is not None:
            req["if_etag"] = str(if_etag)
        header, arrays, _ = self._request("weights", req)
        return VersionedWeights(int(header["version"]),
                                float(header["target_gamma"]),
                                arrays.get("weight"),
                                str(header.get("etag", "")))

    def personalized_solve(self, target_gamma: float = 0.0, *,
                           report: Union[ClientReport, bytes, None] = None,
                           mix_weight: Optional[float] = None) -> np.ndarray:
        """Per-client head: client-specific target γ, optionally mixed with
        the client's own local statistics (``report`` + ``mix_weight`` β)."""
        req: Dict[str, Any] = {"target_gamma": float(target_gamma)}
        if mix_weight is not None:
            req["mix_weight"] = float(mix_weight)
        blob = b""
        if report is not None:
            blob = (bytes(report) if isinstance(report, (bytes, bytearray))
                    else report.to_bytes())
        _, arrays, _ = self._request("personalized_solve", req, blob=blob)
        return arrays["weight"]

    def state(self) -> Dict[str, np.ndarray]:
        """Download the federation checkpoint (the one shared coordinator
        state schema — restorable into any local coordinator kind)."""
        _, arrays, _ = self._request("state")
        return arrays
