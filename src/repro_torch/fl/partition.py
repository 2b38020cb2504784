"""Client data partitioners: IID, NIID-1 (Dirichlet/LDA), NIID-2 (Sharding).

A copy of ``repro.fl.partition`` (pure numpy): the same seed gives the same
index arrays in both packages.

Paper §4.1: NIID-1 draws each client's class mixture from Dir(α) (smaller α →
more heterogeneous; the paper stresses α down to 0.005). NIID-2 sorts by
label, cuts into equal shards and deals s shards per client (smaller s → more
heterogeneous; down to s=2). All partitioners return a list of K index arrays
covering the dataset (possibly empty for extreme α — AFL tolerates empty
clients, their Gram contribution is γI which the RI process removes).
"""

from __future__ import annotations

import numpy as np


def iid(labels: np.ndarray, num_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(labels))
    return [np.sort(p) for p in np.array_split(perm, num_clients)]


def dirichlet(labels: np.ndarray, num_clients: int, alpha: float, seed: int = 0):
    """NIID-1 (LDA): for each class, split its samples across clients with
    proportions ~ Dir(α)."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in range(num_clients)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            out[k].append(part)
    return [np.sort(np.concatenate(p)) if p else np.array([], int) for p in out]


def sharding(labels: np.ndarray, num_clients: int, shards_per_client: int,
             seed: int = 0):
    """NIID-2: sort by label, cut into K*s equal shards, deal s per client."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    n_shards = num_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    assign = rng.permutation(n_shards)
    out = []
    for k in range(num_clients):
        mine = assign[k * shards_per_client : (k + 1) * shards_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in mine])))
    return out


def make_partition(labels, num_clients, scheme: str, *, alpha=0.1,
                   shards_per_client=4, seed=0):
    if scheme == "iid":
        return iid(labels, num_clients, seed)
    if scheme == "niid1":
        return dirichlet(labels, num_clients, alpha, seed)
    if scheme == "niid2":
        return sharding(labels, num_clients, shards_per_client, seed)
    raise ValueError(f"unknown partition scheme {scheme!r}")
