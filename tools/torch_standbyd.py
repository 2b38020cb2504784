#!/usr/bin/env python
"""Warm-standby daemon (the port's): tail the submit ledger, promote on
primary death.

Runs OUTSIDE the primary's process (like ``torch_snapshotd.py``, its whole
point is surviving the primary). Cold-starts a coordinator from the newest
snapshot under ``--snapshot-dir`` (or from scratch via ``--dim/--classes``),
then tails the primary's :class:`~repro_torch.fl.replication.ReportLedger`
under ``--ledger-dir`` (the reference's ledger format, byte for byte) so
every acked submit — including ones the snapshot never saw — is already
folded the moment promotion is needed. While the primary answers liveness
probes (``--watch-url``) the standby serves retryable 503s; after
``--grace`` consecutive failures it promotes and starts serving writes
itself, appending to the SAME ledger so the failover chain can repeat:

  PYTHONPATH=src python tools/torch_standbyd.py \\
      --ledger-dir /var/afl/ledger --snapshot-dir /var/afl/snapshots \\
      --watch-url http://127.0.0.1:8790 --grace 3 --port 8791

``--coordinator sharded`` restores as a ``ShardedCoordinator`` of
``--shards`` shards (``--tiled`` for the row-tiled Gram) on ``--device``
(every visible card by default; ``cpu`` for the CPU). ``--once`` replays
ledger + snapshot, prints the recovered position, and exits without
serving (an offline restore check). Promotion is bit-for-bit: the AA law
makes the ledger an order-insensitive sum, so snapshot prefix + ledger
suffix equals the never-crashed aggregate exactly (f64).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.fl import (AFLServer, AsyncAFLServer,  # noqa: E402
                            ShardedCoordinator, WarmStandby, watch_primary)
from repro_torch.fl.mux import probe_alive  # noqa: E402
from repro_torch.fl.service import FederationService, serve_http  # noqa: E402

_KINDS = {"sync": AFLServer, "async": AsyncAFLServer,
          "sharded": ShardedCoordinator}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ledger-dir", required=True,
                    help="the primary's submit ledger directory")
    ap.add_argument("--snapshot-dir", default=None,
                    help="snapshot directory to cold-start from")
    ap.add_argument("--watch-url", default=None,
                    help="primary URL to probe (http(s):// describes, "
                         "mux(s):// rides a PING frame); omit with --once")
    ap.add_argument("--watch-cafile", default=None,
                    help="CA PEM for probing a TLS primary (muxs/https)")
    ap.add_argument("--watch-token", default=None,
                    help="bearer token for http(s) probes of an "
                         "auth-gated primary (mux PING needs none)")
    ap.add_argument("--grace", type=int, default=3,
                    help="consecutive failed probes before promotion")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between liveness probes")
    ap.add_argument("--coordinator", default="sync", choices=sorted(_KINDS),
                    help="coordinator kind to restore as (any kind can "
                         "replay any ledger)")
    ap.add_argument("--shards", type=int, default=None,
                    help="sharded kind: shard count (default: one a device)")
    ap.add_argument("--tiled", action="store_true",
                    help="sharded kind: row-tiled global Gram")
    ap.add_argument("--device", default=None,
                    help="sharded kind: where its shards solve (default: "
                         "every visible card; 'cpu' for the CPU)")
    ap.add_argument("--dim", type=int, default=None,
                    help="bootstrap dim when no snapshot exists yet")
    ap.add_argument("--classes", type=int, default=None)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8791)
    ap.add_argument("--once", action="store_true",
                    help="replay snapshot + ledger, report, exit")
    args = ap.parse_args(argv)

    kind_kw = {}
    if args.coordinator == "sharded":
        kind_kw = dict(num_shards=args.shards, tiled_gram=args.tiled,
                       device=args.device)
    ctor_kw = None
    if args.dim is not None and args.classes is not None:
        ctor_kw = dict(dim=args.dim, num_classes=args.classes,
                       gamma=args.gamma, **kind_kw)
    standby = WarmStandby(args.ledger_dir, snapshot_dir=args.snapshot_dir,
                          cls=_KINDS[args.coordinator], ctor_kw=ctor_kw,
                          from_state_kw=kind_kw)

    if args.once:
        folded = standby.catch_up()
        c = standby.coordinator
        print(f"replayed to seq {standby.position} "
              f"(+{folded} applied, {standby.skipped} already in snapshot): "
              f"{type(c).__name__} with {c.num_clients} clients "
              f"at version {c.version}"
              + (f" on {c.num_shards} shards" if args.coordinator == "sharded" else ""),
              flush=True)
        return 0
    if not args.watch_url:
        ap.error("--watch-url is required unless --once")

    service = FederationService()
    service.host_standby("default", standby)
    with service, serve_http(service, args.host, args.port) as srv:
        print(f"standbyd: tailing {args.ledger_dir}, watching "
              f"{args.watch_url} (grace {args.grace}); standby at {srv.url} "
              "answers 503 until promoted; ctrl-c to stop", flush=True)

        def _alive() -> bool:
            return probe_alive(args.watch_url, cafile=args.watch_cafile,
                               auth_token=args.watch_token)

        stop = threading.Event()
        try:
            coordinator = watch_primary(
                standby, _alive, grace=args.grace, interval=args.interval,
                stop=stop,
                on_promote=lambda c: service.promote_federation())
        except KeyboardInterrupt:
            stop.set()
            return 0
        if coordinator is not None:
            print(f"PROMOTED: {type(coordinator).__name__} with "
                  f"{coordinator.num_clients} clients now serving writes "
                  f"at {srv.url} (zero reports lost)", flush=True)
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                print("shutting down")
    return 0


if __name__ == "__main__":
    sys.exit(main())
