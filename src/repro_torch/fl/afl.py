"""End-to-end AFL driver (Algorithm 1) over a client partition.

The port of ``repro.fl.afl``. Two feature paths:
  * feature-space datasets (x already embeddings): clients run local_stage
    directly — this is the configuration of every paper table.
  * token datasets + a frozen backbone: clients first embed their shard with
    the shared pre-trained backbone (``repro_torch.models``, on the card),
    then run local_stage.

The round itself is host f64, as in the reference: the clients are
``AFLClient`` on ``numpy_f64`` and the coordinator an ``AFLServer``, in
this process or behind a federation service. The
card enters through ``backbone_fn`` (and ``feature_map``, when it is given a
tensor); whatever they return is brought to the host with
:func:`~repro_torch.core.engine.to_numpy`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.config import FLConfig
from repro_torch.core import analytic as al
from repro_torch.core.engine import to_numpy
from repro_torch.data.synthetic import Dataset
from repro_torch.fl.api import AFLClient, AFLServer, evaluate_weight
from repro_torch.fl.partition import make_partition


@dataclasses.dataclass
class AFLResult:
    weight: np.ndarray
    accuracy: float
    train_seconds: float
    num_clients: int
    client_sizes: list


def embed_with_backbone(backbone_fn: Callable, x: np.ndarray,
                        batch: int = 256) -> np.ndarray:
    """Run the frozen backbone over token inputs in mini-batches → (N, d)
    host array (a tensor the backbone returns, on any device, is copied to
    the host in its own dtype)."""
    outs = []
    for i in range(0, len(x), batch):
        outs.append(to_numpy(backbone_fn(x[i : i + batch]), None))
    return np.concatenate(outs, 0)


def evaluate(weight: np.ndarray, x: np.ndarray, y: np.ndarray) -> float:
    return evaluate_weight(weight, x, y)


def run_afl(
    train: Dataset,
    test: Dataset,
    fl: FLConfig,
    *,
    backbone_fn: Optional[Callable] = None,
    feature_map: Optional[Callable] = None,
    pairwise: bool = False,
    coordinator=None,
) -> AFLResult:
    """Full AFL: partition → local stages (one epoch each) → single-round
    aggregation (+ RI restore) → evaluate.

    ``feature_map``: optional shared non-linear projection φ applied to the
    (backbone) features before the analytic head (paper §5 /
    ``core.features``) — the regression stays linear in φ-space, so every
    AFL invariance holds.

    ``coordinator``: where the reports go — any synchronous coordinator
    (an object with ``dim``, ``gamma``, ``submit`` and ``solve``; defaults
    to a fresh in-process :class:`~repro_torch.fl.api.AFLServer`), or a
    service URL (``http(s)://``, ``mux(s)://``), which becomes a
    :class:`~repro_torch.fl.service.RemoteCoordinator`.

    The production path (``use_ri=True``, ``pairwise=False``) drives the
    canonical API: one :class:`~repro_torch.fl.api.AFLClient` local stage
    per client, one report submitted to the coordinator, one solve. The
    paper-literal ``pairwise`` recursion and the no-RI ablation route
    through :mod:`repro_torch.core.analytic` (Table 3 / A.1).
    """
    t0 = time.perf_counter()
    x_tr, x_te = train.x, test.x
    if backbone_fn is not None:
        x_tr = embed_with_backbone(backbone_fn, x_tr)
        x_te = embed_with_backbone(backbone_fn, x_te)
    if feature_map is not None:
        x_tr = to_numpy(feature_map(x_tr), None)
        x_te = to_numpy(feature_map(x_te), None)
    y_tr = np.eye(train.num_classes, dtype=np.float64)[train.y]

    parts = make_partition(train.y, fl.num_clients, fl.partition,
                           alpha=fl.alpha, shards_per_client=fl.shards_per_client,
                           seed=fl.seed)
    if fl.use_ri and not pairwise:
        if isinstance(coordinator, str):
            from repro_torch.fl.service import RemoteCoordinator

            coordinator = RemoteCoordinator(coordinator)
        server = coordinator if coordinator is not None else AFLServer(
            x_tr.shape[1], train.num_classes, gamma=fl.gamma)
        if (server.dim, server.gamma) != (x_tr.shape[1], fl.gamma):
            raise ValueError(
                f"coordinator (dim={server.dim}, γ={server.gamma}) does not "
                f"match the run (dim={x_tr.shape[1]}, γ={fl.gamma})")
        for cid, idx in enumerate(parts):
            # empty clients still upload (γI Gram, 0 moment) — the AA law
            # and the RI restore handle them exactly.
            server.submit(AFLClient(cid, gamma=fl.gamma).local_stage(
                x_tr[idx].astype(np.float64), y_tr[idx]))
        weight = server.solve(target_gamma=0.0)
    else:
        # paper-literal ablation path: per-client (Ŵ_k^r, C_k^r) uploads,
        # AA-law recursion and/or the biased no-RI aggregate
        updates = [al.local_stage(x_tr[idx].astype(np.float64), y_tr[idx],
                                  fl.gamma) for idx in parts]
        weight = al.afl_aggregate(updates, use_ri=fl.use_ri, pairwise=pairwise)
    dt = time.perf_counter() - t0
    acc = evaluate(weight, x_te.astype(np.float64), test.y)
    return AFLResult(weight, acc, dt, fl.num_clients, [len(p) for p in parts])


def joint_ridge(train: Dataset, test: Dataset, gamma: float = 0.0,
                backbone_fn: Optional[Callable] = None):
    """Centralized joint-training reference (the equivalence target)."""
    x_tr, x_te = train.x, test.x
    if backbone_fn is not None:
        x_tr = embed_with_backbone(backbone_fn, x_tr)
        x_te = embed_with_backbone(backbone_fn, x_te)
    y = np.eye(train.num_classes, dtype=np.float64)[train.y]
    w = al.ridge_solve(x_tr.astype(np.float64), y, gamma)
    return w, evaluate(w, x_te.astype(np.float64), test.y)
