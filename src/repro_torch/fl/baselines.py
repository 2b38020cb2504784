"""Gradient-FL baselines the paper compares against (frozen backbone, linear
head): FedAvg, FedProx, and local-only training (paper Supp. E & F settings:
local epoch 1, batch 64, SGD lr 0.05, full participation).

These run on feature matrices (the shared frozen backbone's embeddings) —
exactly the paper's experimental configuration. Implemented with numpy-level
loops over clients and inner steps in plain numpy for determinism and speed
at these sizes.

A copy of ``repro.fl.baselines`` (numpy SGD, not autograd): the same data
and seed give the reference's weights.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.config import FLConfig
from repro_torch.data.synthetic import Dataset
from repro_torch.fl.afl import evaluate
from repro_torch.fl.partition import make_partition


@dataclasses.dataclass
class FLRunResult:
    accuracy: float          # best test acc over rounds (paper metric)
    curve: List[float]       # test acc per round
    train_seconds: float
    rounds: int


def _softmax(z):
    z = z - z.max(-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(-1, keepdims=True)


def _local_sgd(w, x, y_onehot, lr, batch, rng, mu=0.0, w_global=None):
    """One local epoch of SGD on softmax-CE; FedProx adds μ/2·||w−w_g||²."""
    n = len(x)
    if n == 0:
        return w
    perm = rng.permutation(n)
    for i in range(0, n, batch):
        idx = perm[i : i + batch]
        xb, yb = x[idx], y_onehot[idx]
        probs = _softmax(xb @ w)
        grad = xb.T @ (probs - yb) / len(idx)
        if mu and w_global is not None:
            grad = grad + mu * (w - w_global)
        w = w - lr * grad
    return w


def run_gradient_fl(
    train: Dataset,
    test: Dataset,
    fl: FLConfig,
    *,
    method: str = "fedavg",       # fedavg | fedprox
    rounds: int = 50,
    lr: float = 0.05,
    batch: int = 64,
    mu: float = 0.001,            # FedProx μ (paper's tuned value)
    eval_every: int = 1,
) -> FLRunResult:
    t0 = time.perf_counter()
    rng = np.random.default_rng(fl.seed)
    d, c = train.x.shape[1], train.num_classes
    y_onehot = np.eye(c)[train.y]
    parts = make_partition(train.y, fl.num_clients, fl.partition,
                           alpha=fl.alpha, shards_per_client=fl.shards_per_client,
                           seed=fl.seed)
    sizes = np.array([len(p) for p in parts], float)
    weights = sizes / sizes.sum()
    w_global = np.zeros((d, c))
    curve = []
    for r in range(rounds):
        locals_ = []
        for k, idx in enumerate(parts):
            wk = _local_sgd(
                w_global.copy(), train.x[idx], y_onehot[idx], lr, batch, rng,
                mu=(mu if method == "fedprox" else 0.0), w_global=w_global,
            )
            locals_.append(wk)
        w_global = sum(w * lw for w, lw in zip(locals_, weights))
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            curve.append(evaluate(w_global, test.x, test.y))
    return FLRunResult(max(curve), curve, time.perf_counter() - t0, rounds)


def run_local_only(train: Dataset, test: Dataset, fl: FLConfig,
                   epochs: int = 5, lr: float = 0.05, batch: int = 64):
    """Paper Supp. F: per-client training without aggregation.
    Returns (avg acc, max acc) across clients."""
    rng = np.random.default_rng(fl.seed)
    d, c = train.x.shape[1], train.num_classes
    y_onehot = np.eye(c)[train.y]
    parts = make_partition(train.y, fl.num_clients, fl.partition,
                           alpha=fl.alpha, shards_per_client=fl.shards_per_client,
                           seed=fl.seed)
    accs = []
    for idx in parts:
        if len(idx) == 0:
            accs.append(1.0 / c)
            continue
        w = np.zeros((d, c))
        for _ in range(epochs):
            w = _local_sgd(w, train.x[idx], y_onehot[idx], lr, batch, rng)
        accs.append(evaluate(w, test.x, test.y))
    return float(np.mean(accs)), float(np.max(accs))


def run_fedfisher_diag(train: Dataset, test: Dataset, fl: FLConfig,
                       epochs: int = 1, lr: float = 0.05, batch: int = 64,
                       eps: float = 1e-8) -> FLRunResult:
    """One-shot Fisher-weighted aggregation (FedFisher [11]-style, diagonal).

    Each client trains its head locally, estimates the diagonal empirical
    Fisher of its solution, and the server merges in ONE round:
        w = (Σ F_k + εI)^{-1} Σ F_k w_k   (elementwise).
    This is the single-round *gradient* competitor the paper compares against
    in Table A.3 — unlike AFL's AA law it is an approximation, so it retains
    heterogeneity sensitivity.
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(fl.seed)
    d, c = train.x.shape[1], train.num_classes
    y_onehot = np.eye(c)[train.y]
    parts = make_partition(train.y, fl.num_clients, fl.partition,
                           alpha=fl.alpha, shards_per_client=fl.shards_per_client,
                           seed=fl.seed)
    fisher_sum = np.zeros((d, c))
    fw_sum = np.zeros((d, c))
    for idx in parts:
        if len(idx) == 0:
            continue
        w = np.zeros((d, c))
        for _ in range(epochs):
            w = _local_sgd(w, train.x[idx], y_onehot[idx], lr, batch, rng)
        # diagonal empirical Fisher of the local softmax head:
        # F[d, c] = E[ x_d² · p_c(1-p_c) ]
        p = _softmax(train.x[idx] @ w)
        fisher = (train.x[idx] ** 2).T @ (p * (1 - p)) / len(idx)
        fisher_sum += fisher
        fw_sum += fisher * w
    w_global = fw_sum / (fisher_sum + eps)
    acc = evaluate(w_global, test.x, test.y)
    return FLRunResult(acc, [acc], time.perf_counter() - t0, 1)
