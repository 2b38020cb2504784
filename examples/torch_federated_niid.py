"""Federated non-IID sweep on the PyTorch port, with a real (reduced) backbone.

The port of ``examples/federated_niid.py``. End-to-end AFL over one of the
assigned architectures as the frozen feature extractor: tokens → backbone
forward (on the card: the flash kernel) → pooled embeddings → per-client
analytic local stages → single-round aggregation — then the same data run
through the gradient-FL baseline for contrast, across heterogeneity levels.

  PYTHONPATH=src python examples/torch_federated_niid.py [--arch qwen3_32b] [--device cpu]

The backbone runs on the card unless ``--device`` names another device;
the clients and the server run in host f64.
"""

import argparse

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic as D
from repro_torch.device import resolve_device
from repro_torch.fl import AFLClient, AFLServer, ClientReport, afl, baselines
from repro_torch.fl.partition import make_partition
from repro_torch.launch.train import embed
from repro_torch.models import transformer as T

SETTINGS = [("IID", dict(partition="iid")),
            ("NIID-1 a=0.1", dict(partition="niid1", alpha=0.1)),
            ("NIID-1 a=0.01", dict(partition="niid1", alpha=0.01)),
            ("NIID-2 s=2", dict(partition="niid2", shards_per_client=2))]


def afl_over_wire(train, test, fl: FLConfig) -> float:
    """The AFL column through the canonical API: one AFLClient local stage
    per client, each report crossing the wire as validated bytes."""
    y_onehot = np.eye(train.num_classes)[train.y]
    parts = make_partition(train.y, fl.num_clients, fl.partition, alpha=fl.alpha,
                           shards_per_client=fl.shards_per_client, seed=fl.seed)
    server = AFLServer(train.x.shape[1], train.num_classes, gamma=fl.gamma)
    for cid, idx in enumerate(parts):
        payload = AFLClient(cid, gamma=fl.gamma).local_stage(
            train.x[idx], y_onehot[idx]).to_bytes()
        server.submit(ClientReport.from_bytes(payload))
    return afl.evaluate(server.solve(), test.x, test.y)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_32b")
    ap.add_argument("--samples", type=int, default=3000)
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(vocab_size=512)
    params = T.init_params(cfg, seed=0, device=dev)

    print(f"backbone: {cfg.name} (reduced: {cfg.num_layers}L d={cfg.d_model}), device {dev}")
    raw = D.token_classification(n=args.samples, seq=32, vocab=cfg.vocab_size,
                                 num_classes=16, skew=2.0, seed=0)
    feats = np.concatenate(
        [embed(params, cfg, torch.from_numpy(raw.x[i:i + 256]).to(dev)).cpu().numpy()
         for i in range(0, len(raw), 256)])
    ds = D.Dataset(feats, raw.y, raw.num_classes)
    train, test = D.train_test_split(ds, 0.25, seed=0)

    print(f"{'setting':16s} {'FedAvg(30r)':>12s} {'AFL(1r)':>12s}")
    rows = {}
    for label, kw in SETTINGS:
        fl = FLConfig(num_clients=args.clients, **kw)
        fa = baselines.run_gradient_fl(train, test, fl, rounds=30)
        acc = afl_over_wire(train, test, fl)
        print(f"{label:16s} {fa.accuracy:12.4f} {acc:12.4f}")
        rows[label] = dict(fedavg=fa.accuracy, afl=acc)
    print("\nAFL column is constant by construction (AA law); FedAvg drifts "
          "with heterogeneity.")
    return dict(arch=cfg.name, layers=cfg.num_layers, batches=-(-len(raw) // 256),
                rows=rows)


if __name__ == "__main__":
    main()
