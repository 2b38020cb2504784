"""Elastic federation drill on the PyTorch port: grow the mesh, lose the
coordinator, recover.

The port of ``examples/failover_drill.py``.
An operator's day-in-the-life for the elastic rung — every federation byte
crosses a loopback socket, and the coordinator that finishes the round is
NOT the one that started it:

  t0  a sharded coordinator serves; half the clients report; a
      :class:`repro_torch.checkpoint.SnapshotDaemon` ticks in the background,
      writing versioned checkpoint-over-wire snapshots
  t1  load ramps: the operator grows the mesh over the wire (grow route);
      in-flight submits racing the resize see a RETRYABLE backpressure
      envelope, never corruption — the AA law makes the migration exact
  t2  the coordinator dies mid-round (simulated: federation suspended);
      clients see typed, retryable ``unavailable`` errors and keep their
      reports
  t3  a replacement cold-starts from the daemon's latest snapshot — on a
      DIFFERENT shard count than the fallen coordinator ever had — and the
      stragglers drain into it, duplicate retries answered idempotently
  t4  the finished head equals a never-crashed single server's oracle

The sharded coordinator's shards (threads, its solves through the panel
kernels) run on the card unless ``--device`` names another device.

  PYTHONPATH=src python examples/torch_failover_drill.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.fl import (AFLServer, FederationService, RemoteCoordinator,
                      ShardedCoordinator, make_report, serve_http)
from repro_torch.fl import errors as E
from repro_torch.checkpoint import SnapshotDaemon

DIM, C, GAMMA, K = 64, 10, 1.0, 16

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the shards (default: cuda; 'cpu' runs on the CPU)")
DEVICE = ap.parse_args().device

rng = np.random.default_rng(0)
x = rng.standard_normal((K * 32, DIM))
y = np.eye(C)[rng.integers(0, C, K * 32)]
reports = [make_report(k, x[k * 32:(k + 1) * 32], y[k * 32:(k + 1) * 32],
                       GAMMA) for k in range(K)]

oracle = AFLServer(DIM, C, gamma=GAMMA)
oracle.submit_many(reports)

with tempfile.TemporaryDirectory() as snapdir:
    # ---- t0: serve sharded, first half reports, daemon snapshots
    service = FederationService(ShardedCoordinator(DIM, C, gamma=GAMMA,
                                                   num_shards=2, device=DEVICE))
    with service, serve_http(service) as http:
        rc = RemoteCoordinator(http.url)
        rc.submit_many(reports[: K // 2])
        daemon = SnapshotDaemon(http.url, directory=snapdir, interval=3600)
        daemon.snapshot_once()
        print(f"t0  {rc.num_clients} clients in; snapshot "
              f"v{daemon.latest_version} at {daemon.latest()}")

        # ---- t1: live grow over the wire
        epoch = rc.grow(2)                      # 2 → 4 shards
        print(f"t1  mesh grown: {rc.num_shards} shards (epoch {epoch})")
        daemon.snapshot_once()                  # same version → no-op
        mid = reports[K // 2: 3 * K // 4]
        rc.submit_many(mid)
        daemon.snapshot_once()                  # new version → new snap
        print(f"t1  {rc.num_clients} clients in; snapshot "
              f"v{daemon.latest_version}")

        # ---- t2: the coordinator dies; clients see typed retryable errors
        fallen = service.suspend_federation()
        outage = 0
        for rep in reports[3 * K // 4:]:
            try:
                rc.submit(rep)
            except E.ServiceError as exc:
                assert isinstance(exc, E.Unavailable) and exc.retryable
                outage += 1
        print(f"t2  coordinator down: {outage} submits got retryable "
              f"'{E.Unavailable.code}' — reports kept client-side")

        # ---- t3: cold-start a replacement from the snapshot, resharded
        replacement = daemon.restore(cls=ShardedCoordinator, num_shards=3,
                                     device=DEVICE)
        service.restore_federation("default", replacement)
        rc.submit_many(reports[K // 2:])        # stragglers + dup retries
        print(f"t3  replacement up on {rc.num_shards} shards; "
              f"{rc.num_clients} clients after straggler drain "
              "(duplicate retries answered idempotently)")

        # ---- t4: the round finishes exactly
        w = np.asarray(rc.solve(), np.float64)
        ref = np.asarray(oracle.solve(), np.float64)
        dw = np.abs(w - ref).max()
        print(f"t4  max|ΔW| vs never-crashed oracle: {dw:.2e}")
        assert dw < 1e-4, dw
        rc.close()
        del fallen

print("drill OK — the coordinator is cattle, the statistics are the pet")
