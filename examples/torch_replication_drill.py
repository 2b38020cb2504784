"""Replication drill on the PyTorch port: kill the primary mid-stream, lose
nothing, read on.

The port of ``examples/replication_drill.py``.
The multi-box day-in-the-life for the replication rung. The primary writes
every accepted submit to a durable CRC-framed ledger; a warm standby tails
that ledger; a read replica follows the same ledger for the
solve-once/download-millions path:

  t0  a primary serves with ``--ledger-dir`` semantics (every accepted
      submit fsynced to the ledger before the ack); a snapshot daemon
      ticks; the first wave of clients reports
  t1  a second wave arrives as ONE framed ``submit_stream`` batch — acked
      the moment the frames are admitted and ledgered, NOT when folded
  t2  the primary dies mid-stream (simulated: federation suspended) with
      that batch barely acked; clients see typed retryable ``unavailable``
  t3  a warm standby cold-starts from the newest snapshot, tails the
      ledger suffix, and promotes: bit-for-bit (f64, ``assert_array_equal``)
      equal to a never-crashed oracle — ZERO reports lost, including the
      mid-stream batch; a straggler retry answers ``duplicate: true``
  t4  a weights read replica follows the same ledger: ETags are
      instance-scoped (a primary token never revalidates on the replica,
      and vice versa), reads never touch ingest, writes answer the typed
      ``read_only`` 403

  PYTHONPATH=src python examples/torch_replication_drill.py
"""

import tempfile

import numpy as np

from repro_torch.fl import (AFLServer, FederationService, RemoteCoordinator,
                      WarmStandby, WeightsReplica, make_report, serve_http)
from repro_torch.fl import errors as E
from repro_torch.checkpoint import SnapshotDaemon

DIM, C, GAMMA, K = 64, 10, 1.0, 16

rng = np.random.default_rng(0)
x = rng.standard_normal((K * 32, DIM))
y = np.eye(C)[rng.integers(0, C, K * 32)]
reports = [make_report(k, x[k * 32:(k + 1) * 32], y[k * 32:(k + 1) * 32],
                       GAMMA) for k in range(K)]

oracle = AFLServer(DIM, C, gamma=GAMMA)
oracle.submit_many(reports)
oracle_w = np.asarray(oracle.solve(0.25), np.float64)

with tempfile.TemporaryDirectory() as tmp:
    ledger_dir, snap_dir = f"{tmp}/ledger", f"{tmp}/snapshots"

    # ---- t0: primary with a durable submit ledger; first wave; snapshot
    service = FederationService(AFLServer(DIM, C, gamma=GAMMA),
                                ledger_dir=ledger_dir)
    with service, serve_http(service) as http:
        rc = RemoteCoordinator(http.url)
        rc.submit_many(reports[: K // 2])
        daemon = SnapshotDaemon(http.url, directory=snap_dir, interval=3600)
        daemon.snapshot_once()
        print(f"t0  {rc.num_clients} clients in, ledger at seq "
              f"{rc.describe()['ledger_seq']}; snapshot "
              f"v{daemon.latest_version}")

        # ---- t1: a framed stream batch — acked on admission + ledger write
        batch = [r.to_bytes() for r in reports[K // 2: 3 * K // 4]]
        out = rc.submit_stream(batch)
        assert out["accepted"] == len(batch)
        print(f"t1  stream batch of {out['accepted']} acked, ledger at seq "
              f"{rc.describe()['ledger_seq']}")

        # ---- t2: the primary dies; the last wave bounces off the outage
        service.suspend_federation()
        outage = 0
        for rep in reports[3 * K // 4:]:
            try:
                rc.submit(rep)
            except E.Unavailable as exc:
                assert exc.retryable
                outage += 1
        print(f"t2  primary down: {outage} submits got retryable "
              f"'{E.Unavailable.code}' — reports kept client-side")

        # ---- t3: warm standby = snapshot prefix + ledger suffix → promote
        standby = WarmStandby(ledger_dir, snapshot_dir=snap_dir)
        promoted = standby.promote()
        assert promoted.num_clients == 3 * K // 4      # zero loss
        service.restore_federation("default", promoted)
        rc.submit_many(reports[3 * K // 4:])           # stragglers drain
        dup = rc.submit_stream(batch)                  # mid-stream retry
        assert all(r.get("duplicate") for r in dup["results"])
        w = np.asarray(rc.solve(0.25), np.float64)
        np.testing.assert_array_equal(w, oracle_w)     # bit-for-bit, f64
        print(f"t3  standby promoted from snapshot v{daemon.latest_version}"
              f" + {standby.applied} ledger records "
              f"({standby.skipped} already in snapshot); "
              f"{rc.num_clients} clients; max|ΔW| vs oracle = 0.0 "
              "(assert_array_equal) — zero reports lost")

        # ---- t4: a read replica follows the ledger; ETags never cross
        replica = WeightsReplica(ledger_dir, snapshot_dir=snap_dir)
        rep_svc = FederationService(replica)
        with rep_svc, serve_http(rep_svc) as rep_http:
            rrc = RemoteCoordinator(rep_http.url)
            info = rrc.describe()
            assert info["read_only"] and info["replica_lag"] == 0
            vw_p = rc.weights(0.25)
            vw_r = rrc.weights(0.25)
            assert vw_p.etag != vw_r.etag
            assert not rrc.weights(0.25, if_etag=vw_p.etag).not_modified
            assert rrc.weights(0.25, if_etag=vw_r.etag).not_modified
            np.testing.assert_array_equal(
                np.asarray(vw_r.weight, np.float64), w)
            try:
                rrc.submit(reports[0])
                raise AssertionError("replica accepted a write")
            except E.ReadOnlyFederation:
                pass
            print(f"t4  replica serving at lag {rrc.describe()['replica_lag']}"
                  ": primary ETag re-downloads once, replica ETag caches, "
                  f"writes answer '{E.ReadOnlyFederation.code}'")
            rrc.close()
        rc.close()

print("drill OK — the ledger is the federation; boxes are cattle")
