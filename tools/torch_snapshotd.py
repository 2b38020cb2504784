#!/usr/bin/env python
"""Standalone snapshot daemon for a live AFL federation (the port's).

Runs OUTSIDE the serving process (its whole point: it must survive a
coordinator crash), periodically pulling checkpoint-over-wire ``state`` from
a :class:`~repro_torch.fl.service.FederationService` (or the reference's:
the wire and the checkpoint formats are the same) and writing versioned
checkpoint directories a replacement coordinator can cold-start from — any
kind, any shard count:

  PYTHONPATH=src python tools/torch_snapshotd.py --url http://127.0.0.1:8790 \\
      --dir /var/afl/snapshots --interval 30 --keep 5

  # failover: bring up a replacement from the latest snapshot
  PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
      --coordinator sharded --shards 8 \\
      --restore-from /var/afl/snapshots/snap-000000000042-000000

``--once`` takes a single snapshot and exits (cron-style operation). A pull
that fails (service down — exactly when the existing snapshots matter) is
logged and retried on the next tick, never fatal. The daemon needs no card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import SnapshotDaemon  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--url", required=True,
                    help="federation service URL, e.g. http://127.0.0.1:8790")
    ap.add_argument("--dir", required=True,
                    help="snapshot directory (created if missing)")
    ap.add_argument("--interval", type=float, default=30.0,
                    help="seconds between pulls")
    ap.add_argument("--keep", type=int, default=5,
                    help="snapshots retained (older ones pruned)")
    ap.add_argument("--federation", default="default",
                    help="federation id to snapshot")
    ap.add_argument("--once", action="store_true",
                    help="take one snapshot and exit")
    ap.add_argument("--ledger-dir", default=None,
                    help="the primary's submit-ledger directory: each "
                         "successful tick compacts it to what the snapshot "
                         "covers (out-of-process safe — only sealed "
                         "segments are dropped, never the active one)")
    ap.add_argument("--auth-token", default=None,
                    help="bearer token for an auth-gated federation")
    args = ap.parse_args(argv)

    daemon = SnapshotDaemon(args.url, directory=args.dir,
                            interval=args.interval, keep=args.keep,
                            federation=args.federation,
                            ledger=args.ledger_dir,
                            auth_token=args.auth_token)
    if args.once:
        path = daemon.snapshot_once()
        print(f"snapshot: {path if path else 'already current'}", flush=True)
        return 0
    print(f"snapshotd: {args.url} → {args.dir} every {args.interval:g}s "
          f"(keep {args.keep}); ctrl-c to stop", flush=True)
    daemon.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    if daemon.errors:
        print(f"{len(daemon.errors)} failed pulls; last: "
              f"{daemon.errors[-1][1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
