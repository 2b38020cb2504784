"""Replication: the durable submit ledger, warm standby, and read replicas.

AFL's absolute-aggregation law makes the server's entire state an additive
sum of client SuffStats — so an append-only log of the *accepted report
payloads* is a complete replication log. Replaying it through any
coordinator's ``submit`` (which re-runs the exact validation the primary
ran: duplicate-client guard, γ mismatch, CRC) reproduces the aggregate
exactly, on any box, at any shard count. That one observation yields the
whole multi-box story in three small pieces:

  * :class:`ReportLedger` — a durable, CRC-framed, append-only segment log
    the :class:`~repro_torch.fl.service.FederationService` writes on every
    accepted ``submit`` / ``submit_stream`` frame. Batched fsync (one
    ``sync()`` per stream batch, not per record), sealed-segment rotation,
    crash-truncated-tail recovery on open, and compaction down to a
    snapshot reference plus the suffix of records the snapshot missed.
  * :class:`LedgerTailer` + :class:`WarmStandby` — a follower that
    cold-starts from the latest :class:`~repro_torch.checkpoint.SnapshotDaemon`
    snapshot and tails the ledger. Because replay goes through ``submit``,
    records the snapshot already covers skip on the coordinator's own
    duplicate-client guard *before any mutation* — so ``promote()`` yields
    a coordinator bit-for-bit (f64) equal to the never-crashed oracle:
    snapshot state is bitwise the oracle's prefix (the ``gram_diag_raw``
    checkpoint rider), and the replayed suffix folds in the primary's
    accept order. Zero reports lost.
  * :class:`WeightsReplica` — a read-only coordinator that follows the
    primary's epoch through the same ledger and serves ``weights`` /
    ``solve`` / ``personalized_solve`` / ``sweep`` from its *own* cached
    factor. Its ETag salt is its own (every coordinator instance mints a
    fresh one), so a token minted by the primary never revalidates on a
    replica and vice versa; while catching up past ``max_lag`` it answers
    the typed retryable ``unavailable`` instead of serving stale heads.

Ledger layout (one directory)::

    ledger-{start_seq:012d}.seg       segment: 8-byte magic, then records
    ledger-checkpoint.json            compaction floor: snapshot ref + base_seq

Record framing (little-endian)::

    u32 body_len | u32 crc32(body) | body
    body = u32 meta_len | meta JSON ({"seq": .., "cid": ..}) | report payload

A torn tail (crash mid-append) fails the CRC of its last record; open-time
recovery truncates the file back to the last clean record, and a tailer
reading a live segment simply stops at the tear and retries next poll.
"""

from __future__ import annotations

import inspect
import json
import os
import pathlib
import struct
import threading
import zlib
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Type)

import numpy as np

from repro_torch.fl import errors as E
from repro_torch.fl.api import AFLServer, ClientReport, GammaSweep, VersionedWeights

__all__ = [
    "ReportLedger",
    "LedgerTailer",
    "WarmStandby",
    "WeightsReplica",
    "compact_ledger_dir",
    "last_seq_on_disk",
    "watch_primary",
]

_SEG_MAGIC = b"AFLGSG1\n"               # 8 bytes, versioned
_SEG_GLOB = "ledger-*.seg"
_CKPT_NAME = "ledger-checkpoint.json"
_REC_HDR = struct.Struct("<II")         # body_len, crc32(body)
_U32 = struct.Struct("<I")


def _seg_start(path: pathlib.Path) -> int:
    """First sequence number a segment file may contain (from its name)."""
    return int(path.name[len("ledger-"):-len(".seg")])


def _seg_name(start_seq: int) -> str:
    return f"ledger-{start_seq:012d}.seg"


def _list_segments(directory: pathlib.Path) -> List[pathlib.Path]:
    return sorted(directory.glob(_SEG_GLOB), key=_seg_start)


def _parse_records(buf: bytes, base_off: int):
    """Yield ``(end_offset, seq, client_id, payload)`` for every complete,
    CRC-clean record in ``buf`` (whose first byte sits at file offset
    ``base_off``); stop at the first incomplete or corrupt record — a live
    tail and a torn tail look the same to a reader, and both mean "no more
    records *yet*"."""
    off = 0
    n = len(buf)
    while off + _REC_HDR.size <= n:
        body_len, crc = _REC_HDR.unpack_from(buf, off)
        end = off + _REC_HDR.size + body_len
        if body_len < _U32.size or end > n:
            return                          # incomplete (torn or still being written)
        body = buf[off + _REC_HDR.size: end]
        if zlib.crc32(body) != crc:
            return                          # torn mid-record
        (meta_len,) = _U32.unpack_from(body, 0)
        if _U32.size + meta_len > len(body):
            return
        try:
            meta = json.loads(body[_U32.size: _U32.size + meta_len])
            seq, cid = int(meta["seq"]), int(meta["cid"])
        except (ValueError, KeyError, TypeError):
            return
        payload = body[_U32.size + meta_len:]
        off = end
        yield base_off + off, seq, cid, payload


class ReportLedger:
    """Durable append-only log of accepted report payloads.

    One writer (the serving process) appends; any number of tailers read.
    Appends buffer in the OS; durability is explicit — the service calls
    :meth:`sync` once per acknowledged request (one fsync per stream
    *batch*, not per record), and a safety valve fsyncs automatically every
    ``fsync_batch`` appends. ``segment_bytes`` caps a segment before
    rotation seals it; sealed segments are immutable and therefore safe to
    delete under :meth:`compact` once a snapshot covers them.

    Open-time recovery: the final (active) segment is scanned and
    physically truncated back to its last CRC-clean record, so a crash
    mid-append can never leave a half-record in front of future appends.
    """

    def __init__(self, directory, *, segment_bytes: int = 8 << 20,
                 fsync_batch: int = 64):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync_batch = max(1, int(fsync_batch))
        self._lock = threading.RLock()
        self._fh = None
        self._unsynced = 0
        self._last_seq = 0
        self._durable_seq = 0
        self._recover()

    # -- open / recovery -----------------------------------------------------

    def _recover(self) -> None:
        segs = _list_segments(self.directory)
        last_seq = self.base_seq
        for i, path in enumerate(segs):
            data = path.read_bytes()
            good_end = len(_SEG_MAGIC)
            if data[:len(_SEG_MAGIC)] != _SEG_MAGIC:
                good_end = 0                # torn header write
            else:
                for end, seq, _cid, _p in _parse_records(
                        data[len(_SEG_MAGIC):], len(_SEG_MAGIC)):
                    good_end, last_seq = end, seq
            if i == len(segs) - 1 and good_end < len(data):
                # active segment: truncate the torn tail away
                with path.open("r+b") as f:
                    f.truncate(good_end)
                if good_end == 0:           # header itself was torn
                    path.write_bytes(_SEG_MAGIC)
        self._last_seq = self._durable_seq = last_seq
        if segs:
            self._fh = segs[-1].open("ab")
        else:
            self._open_segment(1)

    def _open_segment(self, start_seq: int) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        path = self.directory / _seg_name(start_seq)
        self._fh = path.open("ab")
        if self._fh.tell() == 0:
            self._fh.write(_SEG_MAGIC)
            self._fh.flush()

    # -- append side ---------------------------------------------------------

    @property
    def last_seq(self) -> int:
        """Sequence number of the newest appended record (0 when empty)."""
        return self._last_seq

    @property
    def durable_seq(self) -> int:
        """Newest sequence number known to have reached stable storage."""
        return self._durable_seq

    def append(self, payload: bytes, client_id: int) -> int:
        """Append one accepted report payload; returns its sequence number.
        Buffered — call :meth:`sync` before acknowledging the client."""
        payload = bytes(payload)
        with self._lock:
            if self._fh.tell() >= self.segment_bytes:
                self.rotate()
            seq = self._last_seq + 1
            meta = json.dumps({"seq": seq, "cid": int(client_id)},
                              separators=(",", ":")).encode()
            body = _U32.pack(len(meta)) + meta + payload
            self._fh.write(_REC_HDR.pack(len(body), zlib.crc32(body)) + body)
            self._last_seq = seq
            self._unsynced += 1
            if self._unsynced >= self.fsync_batch:
                self.sync()
            return seq

    def sync(self) -> int:
        """Flush and fsync everything appended so far; returns the durable
        sequence number. The service calls this once per acknowledged
        request — the fsync-batching win for streamed uploads."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            self._durable_seq = self._last_seq
            self._unsynced = 0
            return self._durable_seq

    def rotate(self) -> None:
        """Seal the active segment and start a fresh one. Sealed segments
        never change again — the compaction-safety invariant."""
        with self._lock:
            self._open_segment(self._last_seq + 1)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self.sync()
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "ReportLedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read side -----------------------------------------------------------

    def records(self, after_seq: int = 0
                ) -> Iterator[Tuple[int, int, bytes]]:
        """Yield ``(seq, client_id, payload)`` for every record with
        ``seq > after_seq``, oldest first, reading straight from disk (a
        fresh view — safe from any process)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        for path in _list_segments(self.directory):
            data = path.read_bytes()
            if data[:len(_SEG_MAGIC)] != _SEG_MAGIC:
                continue
            for _end, seq, cid, payload in _parse_records(
                    data[len(_SEG_MAGIC):], len(_SEG_MAGIC)):
                if seq > after_seq:
                    yield seq, cid, payload

    def find_crc(self, client_id: int) -> Optional[int]:
        """CRC-32 of the *newest* payload this ledger holds for a client, or
        ``None``. The disk half of the idempotent-ingest discipline: the
        in-memory ``applied`` map is an LRU over this — an evicted entry is
        recovered here (newest-segment-first scan), so bounding the map
        never breaks ``duplicate: true`` replay answers."""
        cid = int(client_id)
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        for path in reversed(_list_segments(self.directory)):
            data = path.read_bytes()
            if data[:len(_SEG_MAGIC)] != _SEG_MAGIC:
                continue
            hit = None
            for _end, _seq, rec_cid, payload in _parse_records(
                    data[len(_SEG_MAGIC):], len(_SEG_MAGIC)):
                if rec_cid == cid:
                    hit = zlib.crc32(payload)   # later record wins
            if hit is not None:
                return hit
        return None

    # -- compaction ----------------------------------------------------------

    @property
    def _ckpt_path(self) -> pathlib.Path:
        return self.directory / _CKPT_NAME

    def _read_ckpt(self) -> Dict[str, Any]:
        try:
            return json.loads(self._ckpt_path.read_text())
        except (OSError, ValueError):
            return {}

    @property
    def base_seq(self) -> int:
        """Compaction floor: every record with ``seq ≤ base_seq`` is covered
        by :attr:`snapshot_ref` and may no longer exist on disk."""
        return int(self._read_ckpt().get("base_seq", 0))

    @property
    def snapshot_ref(self) -> Optional[str]:
        """Checkpoint directory that covers everything up to
        :attr:`base_seq` (a follower cold-starts there, then tails)."""
        ref = self._read_ckpt().get("snapshot")
        return None if ref is None else str(ref)

    def compact(self, snapshot_ref, base_seq: int) -> List[pathlib.Path]:
        """Drop sealed segments every record of which is ≤ ``base_seq``
        (i.e. covered by the snapshot at ``snapshot_ref``), and persist the
        (snapshot, base_seq) floor. The active segment is never deleted.
        Returns the deleted segment paths."""
        base_seq = int(base_seq)
        with self._lock:
            self.sync()
            segs = _list_segments(self.directory)
            deleted = []
            # a sealed segment's records all precede the next segment's start
            for path, nxt in zip(segs[:-1], segs[1:]):
                if _seg_start(nxt) - 1 <= base_seq:
                    path.unlink()
                    deleted.append(path)
            tmp = self._ckpt_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(
                {"snapshot": None if snapshot_ref is None
                 else str(snapshot_ref),
                 "base_seq": max(base_seq, self.base_seq)}))
            os.replace(tmp, self._ckpt_path)
            return deleted


def last_seq_on_disk(directory) -> int:
    """Newest sequence number any reader can currently see under
    ``directory`` (scans the final segment only — the lag probe)."""
    directory = pathlib.Path(directory)
    segs = _list_segments(directory)
    for path in reversed(segs):
        data = path.read_bytes()
        if data[:len(_SEG_MAGIC)] != _SEG_MAGIC:
            continue
        last = 0
        for _end, seq, _cid, _p in _parse_records(
                data[len(_SEG_MAGIC):], len(_SEG_MAGIC)):
            last = seq
        if last:
            return last
        # empty (freshly rotated) segment — fall back one
    try:
        ckpt = json.loads((directory / _CKPT_NAME).read_text())
        return int(ckpt.get("base_seq", 0))
    except (OSError, ValueError):
        return 0


def compact_ledger_dir(directory, snapshot_ref,
                       base_seq: int) -> List[pathlib.Path]:
    """Out-of-process compaction: the same sealed-segment drop + checkpoint
    floor as :meth:`ReportLedger.compact`, but safe to run against a
    directory whose writer lives in ANOTHER process. Opening a second
    :class:`ReportLedger` would be wrong here — its open-time recovery
    physically truncates what it takes for a torn tail, racing the live
    writer's active segment. This helper only ever deletes *sealed*
    segments fully covered by ``base_seq`` and atomically rewrites the
    checkpoint file; the active (last) segment is never touched. The
    caller owns the safety of ``base_seq`` (e.g. a ``describe`` that
    reported the seq with ``pending == 0``). Returns deleted paths."""
    directory = pathlib.Path(directory)
    base_seq = int(base_seq)
    segs = _list_segments(directory)
    deleted = []
    for path, nxt in zip(segs[:-1], segs[1:]):
        if _seg_start(nxt) - 1 <= base_seq:
            try:
                path.unlink()
            except OSError:
                continue               # already gone (concurrent compactor)
            deleted.append(path)
    ckpt_path = directory / _CKPT_NAME
    try:
        prior = int(json.loads(ckpt_path.read_text()).get("base_seq", 0))
    except (OSError, ValueError):
        prior = 0
    tmp = ckpt_path.with_suffix(".tmp")
    tmp.write_text(json.dumps(
        {"snapshot": None if snapshot_ref is None else str(snapshot_ref),
         "base_seq": max(base_seq, prior)}))
    os.replace(tmp, ckpt_path)
    return deleted


class LedgerTailer:
    """Incremental read cursor over a :class:`ReportLedger` directory.

    Read-only and crash-tolerant: it never truncates — a torn or
    still-being-written record simply ends the poll (the writer's own
    open-time recovery, or the next append, resolves it). Each
    :meth:`poll` reads only bytes past the cursor, advancing across sealed
    segments on clean end-of-segment. ``position`` is the last sequence
    number delivered."""

    def __init__(self, directory, *, after_seq: int = 0):
        self.directory = pathlib.Path(directory)
        self.position = int(after_seq)
        self._seg: Optional[pathlib.Path] = None
        self._off = 0
        # True when the last poll() consumed every readable byte (parked at
        # the live tip); False when it parked at a torn/half-written record.
        # Snapshot of that instant — a later append makes it stale until
        # the next poll, so it is a fast-path hint, not a lag oracle.
        self.at_tip = False

    def _pick_segment(self) -> Optional[pathlib.Path]:
        """Newest segment that may contain ``position + 1`` (compacted-away
        prefixes fall forward to the oldest surviving segment)."""
        segs = _list_segments(self.directory)
        if not segs:
            return None
        pick = segs[0]
        for p in segs:
            if _seg_start(p) <= self.position + 1:
                pick = p
        return pick

    def poll(self) -> List[Tuple[int, int, bytes]]:
        """All records appended (and readable) since the last poll, as
        ``(seq, client_id, payload)`` tuples, oldest first."""
        out: List[Tuple[int, int, bytes]] = []
        while True:
            if self._seg is None:
                self._seg = self._pick_segment()
                if self._seg is None:
                    self.at_tip = True      # nothing on disk at all
                    return out
                self._off = len(_SEG_MAGIC)
            try:
                with self._seg.open("rb") as f:
                    f.seek(self._off)
                    buf = f.read()
            except OSError:
                self._seg = None            # compacted away — re-pick
                continue
            clean_end = self._off
            for end, seq, cid, payload in _parse_records(buf, self._off):
                clean_end = end
                if seq > self.position:
                    out.append((seq, cid, payload))
                    self.position = seq
            consumed_all = clean_end - self._off == len(buf)
            self._off = clean_end
            if not consumed_all:
                self.at_tip = False
                return out                  # live/torn tail — retry later
            # clean end-of-segment: advance iff a later segment exists
            nxt = [p for p in _list_segments(self.directory)
                   if _seg_start(p) > _seg_start(self._seg)]
            if not nxt:
                self.at_tip = True
                return out
            self._seg = nxt[0]
            self._off = len(_SEG_MAGIC)

    def lag(self) -> int:
        """Records appended but not yet delivered to this tailer."""
        return max(0, last_seq_on_disk(self.directory) - self.position)


# ---------------------------------------------------------------------------
# Warm standby
# ---------------------------------------------------------------------------


def _latest_snapshot(snapshot_dir) -> Optional[pathlib.Path]:
    d = pathlib.Path(snapshot_dir)
    if not d.is_dir():
        return None
    snaps = sorted(p for p in d.glob("snap-*")
                   if (p / "manifest.json").exists())
    return snaps[-1] if snaps else None


class WarmStandby:
    """A follower coordinator: snapshot cold-start + ledger tail + promote.

    Cold-start precedence: an explicitly passed ``coordinator`` > the
    newest snapshot under ``snapshot_dir`` > the ledger's own compaction
    ``snapshot_ref`` > an empty ``cls(**ctor_kw)``. From there the standby
    replays every ledger record through ``coordinator.submit`` — records
    the snapshot already covers are skipped by the coordinator's own
    duplicate-client guard *before any state moves*, which is what makes
    replay-from-anywhere exact: the result is bitwise the primary's fold
    sequence, not an approximation of it.

    ``start()`` tails in a background thread; :meth:`promote` stops the
    tail, drains the remaining suffix, refreshes the coordinator's ETag
    salt (tokens minted by the dead primary must never revalidate here)
    and returns the coordinator — ready for
    ``FederationService.restore_federation`` or, when the standby was
    hosted via ``FederationService.host_standby``, the wire ``promote``
    route.
    """

    def __init__(self, ledger_dir, *, snapshot_dir=None, coordinator=None,
                 cls: Type = AFLServer, ctor_kw: Optional[dict] = None,
                 from_state_kw: Optional[dict] = None,
                 poll_interval: float = 0.05):
        self.ledger_dir = pathlib.Path(ledger_dir)
        self.snapshot_dir = (None if snapshot_dir is None
                             else pathlib.Path(snapshot_dir))
        self.poll_interval = float(poll_interval)
        self.applied = 0                    # records folded from the ledger
        self.skipped = 0                    # duplicates / rejected replays
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._apply_lock = threading.RLock()
        self.coordinator = coordinator if coordinator is not None else \
            self._cold_start(cls, dict(ctor_kw or {}),
                             dict(from_state_kw or {}))
        # replay from the beginning of whatever the ledger still holds:
        # the seen-set guard makes the overlap with the snapshot a no-op
        self._tailer = LedgerTailer(self.ledger_dir)

    def _cold_start(self, cls, ctor_kw, from_state_kw):
        import repro_torch.checkpoint as ckpt

        snap = (None if self.snapshot_dir is None
                else _latest_snapshot(self.snapshot_dir))
        if snap is None:
            # the ledger's own compaction floor names the snapshot that
            # covers the deleted prefix
            ref = self._ledger_ckpt().get("snapshot")
            if ref and pathlib.Path(ref).is_dir():
                snap = pathlib.Path(ref)
        if snap is not None:
            return ckpt.load_server(snap, cls, **from_state_kw)
        if not ctor_kw:
            raise E.BadRequest(
                "warm standby has no snapshot to cold-start from and no "
                "ctor_kw (dim/num_classes/...) to start empty")
        return cls(**ctor_kw)

    def _ledger_ckpt(self) -> Dict[str, Any]:
        try:
            return json.loads((self.ledger_dir / _CKPT_NAME).read_text())
        except (OSError, ValueError):
            return {}

    # -- replay --------------------------------------------------------------

    def _apply(self, payload: bytes) -> bool:
        """Fold one ledger record; duplicates and invalid replays skip —
        the same outcome the primary's worker produced for them. An async
        coordinator folds through its wrapped sync server (same state, no
        event loop needed on the replay path)."""
        try:
            report = ClientReport.from_bytes(payload)
            target = self.coordinator
            if inspect.iscoroutinefunction(getattr(target, "submit", None)):
                target = target.server
            target.submit(report)
            return True
        except (E.DuplicateClient, E.GammaMismatch, ValueError):
            return False

    def catch_up(self) -> int:
        """Drain everything currently readable from the ledger; returns the
        number of records newly folded."""
        folded = 0
        with self._apply_lock:
            while True:
                batch = self._tailer.poll()
                if not batch:
                    return folded
                for _seq, _cid, payload in batch:
                    if self._apply(payload):
                        folded += 1
                        self.applied += 1
                    else:
                        self.skipped += 1

    @property
    def position(self) -> int:
        """Ledger sequence number of the last record examined."""
        return self._tailer.position

    def lag(self) -> int:
        """Records durable in the ledger but not yet replayed here."""
        return self._tailer.lag()

    # -- the background tail -------------------------------------------------

    def start(self) -> "WarmStandby":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="afl-standby-tail")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 20 * self.poll_interval))
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.catch_up()
            except Exception:               # noqa: BLE001 — keep tailing
                pass
            self._stop.wait(self.poll_interval)

    def promote(self):
        """Standby → primary: stop tailing, drain the remaining ledger
        suffix, invalidate every token the old primary minted (fresh ETag
        salt), and hand the coordinator over. Bit-for-bit (f64) the
        never-crashed oracle: snapshot prefix bitwise (``gram_diag_raw``
        rider) + suffix folded in the primary's accept order."""
        self.stop()
        self.catch_up()
        refresh = getattr(self.coordinator, "new_etag_salt", None)
        if refresh is not None:
            refresh()
        return self.coordinator

    def __enter__(self) -> "WarmStandby":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Read replica
# ---------------------------------------------------------------------------


class WeightsReplica:
    """Read-only coordinator following the primary's epoch via the ledger.

    Satisfies the read half of the :class:`~repro_torch.fl.api.Coordinator`
    protocol from its *own* cached factor — the solve-once /
    download-millions path never touches the primary's ingest lock. The
    mutating half (``submit`` / ``grow`` / ``shrink``) raises the typed
    ``read_only`` error, and a :class:`~repro_torch.fl.service.FederationService`
    hosting a replica rejects the mutating routes before dispatch
    (``read_only = True`` is the autodetect hook).

    Staleness contract: with ``auto_refresh`` (default) every read first
    drains the ledger tail; if the replica still trails the primary by more
    than ``max_lag`` records (a torn tail it cannot read past, or
    ``auto_refresh=False`` between manual :meth:`refresh` calls) the read
    raises the retryable typed ``unavailable`` rather than serving a stale
    head. ETag semantics are instance-scoped exactly like every other
    coordinator: the replica's tokens are minted under its own salt, so a
    token from the primary never revalidates here and vice versa — a
    client switching endpoints re-downloads once, then caches against the
    replica."""

    read_only = True

    def __init__(self, ledger_dir, *, snapshot_dir=None,
                 cls: Type = AFLServer, ctor_kw: Optional[dict] = None,
                 from_state_kw: Optional[dict] = None, max_lag: int = 0,
                 auto_refresh: bool = True):
        self._standby = WarmStandby(ledger_dir, snapshot_dir=snapshot_dir,
                                    cls=cls, ctor_kw=ctor_kw,
                                    from_state_kw=from_state_kw)
        self.max_lag = int(max_lag)
        self.auto_refresh = bool(auto_refresh)
        self._standby.catch_up()

    # -- follow the primary --------------------------------------------------

    @property
    def _coord(self):
        return self._standby.coordinator

    def refresh(self) -> int:
        """Drain the ledger tail into the local aggregate; returns newly
        folded records."""
        return self._standby.catch_up()

    @property
    def position(self) -> int:
        return self._standby.position

    @property
    def lag(self) -> int:
        """Records the primary has durably accepted that this replica has
        not folded yet."""
        return self._standby.lag()

    def _ready(self) -> None:
        if self.auto_refresh:
            self._standby.catch_up()
            if self._standby._tailer.at_tip:
                return                      # drained to the live tip: lag 0
                                            # without the disk lag() scan
        lag = self.lag
        if lag > self.max_lag:
            raise E.Unavailable(
                f"read replica is {lag} records behind the primary "
                f"(max_lag={self.max_lag}) — catching up, retry")

    # -- metadata (never gated: a lagging replica still describes itself) ----

    @property
    def dim(self) -> int:
        return self._coord.dim

    @property
    def num_classes(self) -> int:
        return self._coord.num_classes

    @property
    def gamma(self) -> float:
        return self._coord.gamma

    @property
    def num_clients(self) -> int:
        return self._coord.num_clients

    @property
    def version(self) -> int:
        return self._coord.version

    @property
    def mesh_epoch(self) -> int:
        return int(getattr(self._coord, "mesh_epoch", 0))

    @property
    def pending(self) -> int:
        """For a replica, "pending" is its replication lag."""
        return self.lag

    # -- the read surface ----------------------------------------------------

    def solve(self, target_gamma: float = 0.0) -> np.ndarray:
        self._ready()
        return self._coord.solve(target_gamma)

    def solve_multi_gamma(self, gammas: Sequence[float]) -> list:
        self._ready()
        return self._coord.solve_multi_gamma(gammas)

    def sweep(self, gammas: Sequence[float], holdout) -> GammaSweep:
        self._ready()
        return self._coord.sweep(gammas, holdout)

    def weights(self, target_gamma: float = 0.0, *,
                if_etag: Optional[str] = None) -> VersionedWeights:
        self._ready()
        return self._coord.weights(target_gamma, if_etag=if_etag)

    def state(self) -> Dict[str, np.ndarray]:
        self._ready()
        return self._coord.state()

    def new_etag_salt(self) -> str:
        return self._coord.new_etag_salt()

    # -- the rejected mutating surface ---------------------------------------

    def _read_only(self, verb: str):
        raise E.ReadOnlyFederation(
            f"{verb} on a weights read replica — replicas follow the "
            "primary's ledger and never ingest; send writes to the primary")

    def submit(self, report) -> bool:
        self._read_only("submit")

    def submit_many(self, reports) -> None:
        self._read_only("submit")

    def grow(self, n: int = 1) -> int:
        self._read_only("grow")

    def shrink(self, n: int = 1) -> int:
        self._read_only("shrink")

    def close(self) -> None:
        self._standby.stop()


# ---------------------------------------------------------------------------
# The promotion watch loop (standbyd / serve --standby-of)
# ---------------------------------------------------------------------------


def watch_primary(standby: WarmStandby, is_alive: Callable[[], bool], *,
                  grace: int = 3, interval: float = 1.0,
                  stop: Optional[threading.Event] = None,
                  on_promote: Optional[Callable[[Any], None]] = None):
    """Tail the ledger while the primary answers; after ``grace``
    consecutive liveness failures, :meth:`WarmStandby.promote` and return
    the promoted coordinator (``on_promote`` then fires with it, e.g. to
    flip a hosting service's suspended latch — a second ``promote`` through
    the service is a harmless no-op). Returns ``None`` if ``stop`` was set
    before promotion was warranted."""
    stop = stop or threading.Event()
    standby.start()
    failures = 0
    while not stop.is_set():
        try:
            alive = bool(is_alive())
        except Exception:                   # noqa: BLE001 — a probe error IS a failure
            alive = False
        failures = 0 if alive else failures + 1
        if failures >= max(1, int(grace)):
            coordinator = standby.promote()
            if on_promote is not None:
                on_promote(coordinator)
            return coordinator
        stop.wait(float(interval))
    standby.stop()
    return None
