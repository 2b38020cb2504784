"""Quickstart on the PyTorch port: AFL through the canonical client/coordinator API.

The port of ``examples/quickstart.py``. Trains a federated linear probe
over frozen features with K=100 clients under an extreme non-IID split, in
ONE local epoch and ONE aggregation round — each client's upload crossing
the "network" as canonical wire bytes — and checks the result is
*identical* to training on the centralized dataset (the paper's
invariance-to-data-partitioning property). Host f64 throughout: no card.

  PYTHONPATH=src python examples/torch_quickstart.py
"""

import numpy as np

from repro_torch.data import synthetic as D
from repro_torch.fl import AFLClient, AFLServer, ClientReport
from repro_torch.fl.afl import evaluate, joint_ridge
from repro_torch.fl.partition import make_partition


def main() -> dict:
    # 1. A dataset of frozen-backbone features (stand-in for ResNet/CIFAR).
    ds = D.gaussian_mixture(n=10_000, dim=256, num_classes=50, separation=0.5)
    train, test = D.train_test_split(ds, test_frac=0.2)
    y_onehot = np.eye(train.num_classes)[train.y]

    # 2. The centralized reference: one ridge solve on all data (γ→0).
    w_joint, acc_joint = joint_ridge(train, test, gamma=0.0)
    print(f"joint (centralized) accuracy: {acc_joint:.4f}")

    # 3. AFL: 100 clients under a pathological non-IID split (Dirichlet
    #    α=0.01). Each client runs its one-epoch local stage and uploads ONE
    #    report — serialized to bytes, validated on ingest — to the
    #    coordinator.
    parts = make_partition(train.y, 100, "niid1", alpha=0.01, seed=0)
    server = AFLServer(dim=256, num_classes=50, gamma=1.0)
    for cid, idx in enumerate(parts):
        payload = AFLClient(cid, gamma=1.0).local_stage(
            train.x[idx], y_onehot[idx]).to_bytes()
        server.submit(ClientReport.from_bytes(payload))
    w_afl = server.solve()                    # single round, RI-restored
    acc = evaluate(w_afl, test.x, test.y)
    print(f"AFL accuracy (K={server.num_clients}, α=0.01): {acc:.4f}")

    # 4. The paper's claim: exact equivalence, not approximation.
    dev = np.abs(w_afl - w_joint).max()
    print(f"max |W_afl - W_joint| = {dev:.2e}")
    assert dev < 1e-6 and abs(acc - acc_joint) < 1e-12
    print("AFL == joint training, under any partition. QED.")
    return dict(joint_accuracy=acc_joint, afl_accuracy=acc, max_dw=float(dev))


if __name__ == "__main__":
    main()
