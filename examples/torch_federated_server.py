"""Operational AFL over the wire on the PyTorch port: a real client/server
pair on loopback HTTP.

The port of ``examples/federated_server.py``. A compressed "day in the
life" of a served federation — every byte below actually crosses a socket
through :class:`repro_torch.fl.service.FederationService` and comes back
through :class:`repro_torch.fl.service.RemoteCoordinator`:

  t0  service up; 60 % of clients POST their report (the rest straggle);
      the solved head is downloaded versioned (ETag-style staleness token —
      the second download is a cheap not-modified)
  t1  an operator snapshots the LIVE federation over the wire and restarts
      it behind a new port — remote state() == one checkpoint schema
  t2  stragglers report, out of order, pairwise-masked (the server never
      sees any individual client's statistics) — still the exact joint
      solution, and bit-for-bit the in-proc answer
  t3  a late trickle of micro-clients goes through submit_stream into an
      ASYNC coordinator: framed multi-report upload, fire-and-forget ingest,
      backpressure visible as `pending`
  t4  server-side γ cross-validation: the grid ships once, every candidate
      solved off ONE eigendecomposition
  t5  personalization: one client mixes its OWN local statistics into the
      shared aggregate for a per-client head (read-only — the shared state
      is untouched)

Host f64 throughout: no card. The checkpoint goes to a temporary directory.

  PYTHONPATH=src python examples/torch_federated_server.py
"""

import shutil
import tempfile
import time

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.core import analytic as al
from repro_torch.data import synthetic as D
from repro_torch.fl import (AFLServer, AsyncAFLServer, FederationService,
                            RemoteCoordinator, make_report, masked_reports,
                            serve_http)
from repro_torch.fl.afl import evaluate
from repro_torch.fl.partition import make_partition

K, GAMMA, N_MICRO, MICRO_ROWS = 30, 1.0, 12, 16

ds = D.gaussian_mixture(n=8000, dim=128, num_classes=40, separation=0.45)
train, test = D.train_test_split(ds, 0.25, seed=0)
y_onehot = np.eye(train.num_classes)[train.y]
DIM, C = train.x.shape[1], train.num_classes
# hold the tail back as t3's late-joining micro-clients; K regulars split
# the rest
n_late = N_MICRO * MICRO_ROWS
parts = make_partition(train.y[:-n_late], K, "niid1", alpha=0.05, seed=0)

reports = [make_report(i, train.x[idx], y_onehot[idx], GAMMA)
           for i, idx in enumerate(parts)]
on_time, stragglers = reports[: int(K * 0.6)], reports[int(K * 0.6):]
stragglers = masked_reports(stragglers, seed=42)

# the wire-equivalence referee: the same reports folded in-process
inproc = AFLServer(dim=DIM, num_classes=C, gamma=GAMMA)

# ---- t0: serve, submit from "another process", download versioned weights
service = FederationService(AFLServer(dim=DIM, num_classes=C, gamma=GAMMA))
http = serve_http(service)
client = RemoteCoordinator(http.url)          # knows ONLY the URL
for r in on_time:
    client.submit(r)                          # ClientReport bytes over HTTP
inproc.submit_many(on_time)
vw = client.weights()
acc1 = evaluate(vw.weight, test.x, test.y)
again = client.weights(if_etag=vw.etag)
print(f"t0: {client.num_clients}/{K} clients over {http.url} → acc "
      f"{acc1:.4f} (weights v{vw.version}; re-poll: "
      f"not_modified={again.not_modified})")

# ---- t1: snapshot the live federation over the wire, restart elsewhere
ckpt_dir = tempfile.mkdtemp(prefix="afl_fed_ckpt_")
ckpt.save_server(ckpt_dir, client, metadata={"phase": "t0"})
http.close()
service = FederationService(
    AFLServer.from_state(ckpt.restore(ckpt_dir)))
http = serve_http(service)
client = RemoteCoordinator(http.url)
print(f"t1: checkpoint → restart on {http.url} "
      f"({client.num_clients} clients restored)")
# the referee walks through the same checkpoint (restore re-derives the raw
# aggregate, rounding last ulps — both sides must round identically)
inproc = AFLServer.from_state(ckpt.restore(ckpt_dir))

# ---- t2: masked stragglers, shuffled, over the wire
rng = np.random.default_rng(7)
order = rng.permutation(len(stragglers))
client.submit_stream([stragglers[i].to_bytes() for i in order])
inproc.submit_many([stragglers[i] for i in order])   # same fold order
w_remote = client.solve()
dev_wire = np.abs(w_remote - inproc.solve()).max()
acc2 = evaluate(w_remote, test.x, test.y)
print(f"t2: all {client.num_clients}/{K} regulars in (masked, shuffled) → "
      f"acc {acc2:.4f}; max |ΔW| wire vs in-proc = {dev_wire:.2e}")
assert dev_wire == 0.0, "wire transport must be bit-for-bit at f64"

# ---- t3: late micro-clients stream into an ASYNC coordinator
http.close()
service = FederationService(
    AsyncAFLServer(DIM, C, gamma=GAMMA, update_rank_budget=MICRO_ROWS,
                   server=service.coordinator()))
http = serve_http(service)
client = RemoteCoordinator(http.url)
a, b = len(train.x) - n_late, len(train.x)
frames = [make_report(K + i, train.x[lo:lo + MICRO_ROWS],
                      y_onehot[lo:lo + MICRO_ROWS],
                      GAMMA).to_bytes()
          for i, lo in enumerate(range(a, b, MICRO_ROWS))]
out = client.submit_stream(frames)
print(f"t3: {out['accepted']}/{N_MICRO} micro-reports queued in one framed "
      f"request (pending at ack: {out['pending']})")
while client.pending:                     # fire-and-forget: wait for drain
    time.sleep(0.01)
w_all = client.solve()
acc3 = evaluate(w_all, test.x, test.y)
w_joint = al.ridge_solve(train.x, y_onehot, 0.0)
dev = np.abs(w_all - w_joint).max()
print(f"    all {client.num_clients}/{K + N_MICRO} in → acc {acc3:.4f}; "
      f"max |ΔW| vs centralized = {dev:.2e}")
assert dev < 1e-8

# ---- t4: γ cross-validation, server-side, one eigendecomposition
sweep = client.sweep([0.0, 1e-3, 0.1, 1.0, 10.0], (test.x, test.y))
print(f"t4: γ sweep {sweep.gammas} → acc "
      f"{tuple(round(a, 4) for a in sweep.accuracies)}; best "
      f"γ={sweep.best_gamma:g} ({sweep.best_accuracy:.4f})")

# ---- t5: a personalized head for one client (local-stats mixture)
mine = reports[0]
w_personal = client.personalized_solve(0.0, report=mine, mix_weight=5.0)
tilt = np.abs(w_personal - w_all).max()
print(f"t5: client {mine.client_id} personalized head (β=5 local mixture): "
      f"max |ΔW| vs shared = {tilt:.2e} (shared aggregate untouched: "
      f"{client.num_clients} clients)")

http.close()
service.close()
shutil.rmtree(ckpt_dir)
print("single-round, straggler-tolerant, secure, async, served over HTTP — "
      "and still exact.")
