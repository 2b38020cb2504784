"""The snapshot daemon: checkpoint-over-wire pulls for failover.

AFL's one-state-schema property (every coordinator kind writes and restores
the same ``state()`` dict) means a *single* periodic puller gives any
federation durable failover: snapshot the live service over the wire, and a
replacement coordinator — of ANY kind, on ANY shard count — cold-starts from
the latest snapshot with zero aggregation loss for everything the snapshot
saw. The AA law does the rest: clients that reported after the snapshot
simply resubmit (the service's idempotent ingest and duplicate-client guard
make that safe), and the restored aggregate is exact, not approximate.

:class:`SnapshotDaemon` is deliberately dumb: pull ``state``, write a
versioned checkpoint directory, prune old ones, repeat — and *survive*
outages (a dead service is the exact moment the existing snapshots matter,
so a failed pull is recorded and retried, never fatal). The port of
``repro.checkpoint.snapshot``; ``launch/serve.py --snapshot-dir`` runs one
in-process beside a hosted federation, and ``tools/torch_snapshotd.py`` is
its out-of-process CLI. ``restore(ShardedCoordinator, num_shards=8)``
reshards on the way back.

Snapshot naming: ``snap-{version:012d}-{epoch:06d}`` where version is the
federation's submission version (client count) at pull time and epoch is the
coordinator's ``mesh_epoch`` — monotone under ingest AND resharding, so
lexicographic order IS recency order and ``latest()`` is a directory
listing. Client count alone is not an identity: a grow/shrink or a γ change
mutates the state without admitting a client, so idempotence is decided by a
digest of the pulled state, not by the name — same name + different digest
means the snapshot on disk is stale and gets overwritten in place.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np

import repro_torch.checkpoint as ckpt

__all__ = ["SnapshotDaemon", "state_digest"]


def state_digest(state: dict) -> str:
    """CRC-32 over the state's arrays and scalars in sorted-key order — a
    cheap, deterministic identity for "did the aggregate actually change".
    Two pulls with equal digests are byte-identical snapshots."""
    crc = 0
    for key in sorted(state):
        crc = zlib.crc32(key.encode(), crc)
        val = state[key]
        if hasattr(val, "shape") and hasattr(val, "dtype"):   # a host array
            crc = zlib.crc32(np.ascontiguousarray(val).tobytes(), crc)
        else:
            crc = zlib.crc32(
                json.dumps(val, sort_keys=True, default=str).encode(), crc)
    return f"{crc:08x}"


class SnapshotDaemon:
    """Periodically snapshot a live federation to versioned checkpoints.

    ``source`` may be a service URL string, a
    :class:`~repro_torch.fl.service.FederationService`, any transport object, or
    a local coordinator — anything a
    :class:`~repro_torch.fl.service.RemoteCoordinator` can speak to, or anything
    with a ``state()`` method. The connection is made lazily per pull, so
    the daemon can be constructed (and keeps running) while the service is
    down.

    >>> d = SnapshotDaemon(srv.url, directory=tmp, interval=0.5, keep=3)
    >>> d.start()                      # background thread
    >>> ...                            # coordinator dies
    >>> coord = d.restore(AsyncAFLServer)
    >>> d.stop()
    """

    def __init__(self, source: Any, *, directory, interval: float = 30.0,
                 keep: int = 5, federation: str = "default",
                 ledger: Any = None, auth_token: Optional[str] = None):
        self.source = source
        self.directory = pathlib.Path(directory)
        self.interval = float(interval)
        self.keep = int(keep)
        self.federation = str(federation)
        # ledger-aware compaction: a ReportLedger object (same process as
        # the writer) or a ledger directory path (out-of-process — uses the
        # non-truncating compact_ledger_dir). Each successful snapshot tick
        # compacts the ledger to the highest sequence number the snapshot
        # provably covers — only when the pull observed pending == 0, so an
        # async coordinator's queued-but-unapplied records always survive.
        self.ledger = ledger
        self.auth_token = auth_token
        self.errors: List[Tuple[float, str]] = []   # (monotonic time, msg)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one pull -----------------------------------------------------------

    def _local_floor(self) -> int:
        """Compaction floor for a bare-coordinator source: ledger position
        read BEFORE pending (the same ordering contract as the service's
        describe route) — any record appended after the seq read either
        shows as pending (floor 0, skip) or carries a higher seq."""
        if self.ledger is None:
            return 0
        if hasattr(self.ledger, "last_seq"):
            seq = int(self.ledger.last_seq)
        else:
            from repro_torch.fl.replication import last_seq_on_disk

            seq = int(last_seq_on_disk(self.ledger))
        pending = int(getattr(self.source, "pending", 0) or 0)
        return seq if pending == 0 else 0

    def _pull_state(self):
        if hasattr(self.source, "state") and not hasattr(
                self.source, "handle"):
            floor = self._local_floor()
            return (self.source.state(), type(self.source).__name__,
                    int(getattr(self.source, "mesh_epoch", 0)), floor)
        from repro_torch.fl.service import RemoteCoordinator

        # per-pull client: a stale connection to a restarted service must
        # never wedge the daemon
        remote = RemoteCoordinator(self.source, federation=self.federation,
                                   auth_token=self.auth_token)
        try:
            info = remote.describe()
            floor = 0
            if self.ledger is not None and int(info.get("pending", 0)) == 0:
                # describe reads ledger_seq before pending, so with
                # pending == 0 everything ≤ ledger_seq is applied — and
                # the state pulled below can only cover MORE than that
                floor = int(info.get("ledger_seq", 0))
            return remote.state(), remote.kind, remote.mesh_epoch, floor
        finally:
            remote.close()

    def snapshot_once(self) -> Optional[pathlib.Path]:
        """Pull and persist one snapshot; returns its directory, or ``None``
        when this exact state is already on disk (an idempotent no-op).
        Idempotence is by state digest, not name: a resharding or γ change
        that kept the client count rewrites the stale snapshot in place.
        Either way the tick ends by compacting the attached ledger (when
        one is configured) to what the on-disk snapshot now covers."""
        state, kind, epoch, floor = self._pull_state()
        version = int(len(state["seen"]))
        digest = state_digest(state)
        path = self.directory / f"snap-{version:012d}-{epoch:06d}"
        manifest = path / "manifest.json"
        if manifest.exists():
            meta = json.loads(manifest.read_text()).get("metadata", {})
            if meta.get("digest") == digest:
                self._compact(path, floor)
                return None
            for f in sorted(path.iterdir(), reverse=True):    # stale: redo
                f.unlink()
            path.rmdir()
        ckpt.save(path, dict(state),
                  metadata={"federation": self.federation,
                            "source_kind": kind, "version": version,
                            "mesh_epoch": epoch, "digest": digest})
        self.prune()
        self._compact(path, floor)
        return path

    def _compact(self, snapshot_path: pathlib.Path, base_seq: int) -> None:
        """Tick compaction: drop ledger segments the snapshot covers. A
        failure here never fails the snapshot — compaction is advisory."""
        if self.ledger is None or base_seq <= 0:
            return
        try:
            if hasattr(self.ledger, "compact"):
                self.ledger.compact(snapshot_path, base_seq)
            else:
                from repro_torch.fl.replication import compact_ledger_dir

                compact_ledger_dir(self.ledger, snapshot_path, base_seq)
        except Exception as exc:                       # noqa: BLE001
            self.errors.append((time.monotonic(),
                                f"compact: {type(exc).__name__}: {exc}"))

    def prune(self) -> None:
        """Drop all but the newest ``keep`` snapshots."""
        for path in self.snapshots()[:-self.keep] if self.keep > 0 else []:
            for f in sorted(path.iterdir(), reverse=True):
                f.unlink()
            path.rmdir()

    # -- the archive --------------------------------------------------------

    def snapshots(self) -> List[pathlib.Path]:
        """Complete snapshot directories, oldest → newest."""
        if not self.directory.is_dir():
            return []
        return sorted(p for p in self.directory.glob("snap-*")
                      if (p / "manifest.json").exists())

    def latest(self) -> Optional[pathlib.Path]:
        snaps = self.snapshots()
        return snaps[-1] if snaps else None

    @property
    def latest_version(self) -> Optional[int]:
        """Client count of the newest snapshot (the ``-{epoch}`` suffix is
        tie-break, not version — ``wait_for_version`` waits on ingest)."""
        latest = self.latest()
        return None if latest is None else int(latest.name.split("-")[1])

    def restore(self, cls=None, **kwargs):
        """Cold-start a replacement coordinator from the latest snapshot —
        any kind, any shard count (``cls``/kwargs go to ``from_state``)."""
        latest = self.latest()
        if latest is None:
            raise FileNotFoundError(
                f"no snapshots under {self.directory} — nothing to restore")
        return ckpt.load_server(latest, cls, **kwargs)

    # -- the daemon loop ----------------------------------------------------

    def start(self) -> "SnapshotDaemon":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="afl-snapshotd")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 2 * self.interval))
            self._thread = None

    def wait_for_version(self, version: int,
                         timeout: float = 30.0) -> bool:
        """Block until a snapshot at ≥ ``version`` exists (the drill's
        deterministic cut point), or the timeout expires."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            v = self.latest_version
            if v is not None and v >= int(version):
                return True
            time.sleep(min(0.02, max(self.interval / 4, 0.002)))
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.snapshot_once()
            except Exception as exc:                   # noqa: BLE001
                # an unreachable service is the daemon's reason to exist:
                # record, keep the existing snapshots, try again next tick
                self.errors.append((time.monotonic(),
                                    f"{type(exc).__name__}: {exc}"))
            self._stop.wait(self.interval)

    def __enter__(self) -> "SnapshotDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
