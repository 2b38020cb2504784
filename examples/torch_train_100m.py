"""End-to-end driver on the PyTorch port: pre-train a ~100M-param LM for a
few hundred steps, then AFL-probe it — the paper's full "pre-trained
backbone + analytic downstream" pipeline in one script.

The port of ``examples/train_100m.py``. Stage 1 pre-trains a ~100M dense
decoder (a scaled-down minicpm family member, WSD schedule) with the
generic gradient train step (``launch.steps.make_full_train_step``: SGD,
attention on the card through the flash kernel's forward) on synthetic
token streams. Stage 2 freezes it and runs AFL over 50 non-IID clients,
checking that the federated probe equals the centralized probe and beats
chance.

  PYTHONPATH=src python examples/torch_train_100m.py [--steps 200] [--device cpu]

It runs on the card unless ``--device`` names another device.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.config import FLConfig, ModelConfig
from repro_torch.data import synthetic as D
from repro_torch.device import resolve_device
from repro_torch.fl import afl
from repro_torch.launch import steps as ST
from repro_torch.launch.train import embed
from repro_torch.models import transformer as T
from repro_torch.optim import tree_leaves, wsd_schedule

# ~100M params: 12L, d=768, 12H, ffn 2048, vocab 32k (embed ≈ 2×24.6M).
CFG_100M = ModelConfig(
    name="dense-100m", arch_type="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32_000,
    num_classes=16, source="scaled minicpm family [arXiv:2404.06395]")


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def main(argv=None) -> dict:
    """Runs both stages with their asserts; returns what they measured."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    cfg = CFG_100M
    dev = resolve_device(args.device)
    params = T.init_params(cfg, seed=0, device=dev)
    print(f"model: {cfg.name}, {count_params(params)/1e6:.1f}M params, device {dev}")

    # ---- stage 1: LM pre-training (gradient, WSD schedule) ----
    step = ST.make_full_train_step(cfg)
    sched = wsd_schedule(0.1, warmup=max(args.steps // 10, 5), total=args.steps)
    t0, losses = time.time(), []
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(
            D.lm_stream(args.batch, args.seq, cfg.vocab_size, seed=i)).to(dev)}
        params, loss = step(params, batch, sched(i))
        losses.append(float(loss))
        if i % max(args.steps // 10, 1) == 0:
            print(f"  step {i:4d} loss {losses[-1]:.4f} lr {sched(i):.2e}")
    pretrain_s = time.time() - t0
    head_m = float(np.mean(losses[:5]))
    tail_m = float(np.mean(losses[-5:]))
    print(f"pre-training: loss {head_m:.3f} → {tail_m:.3f} "
          f"(smoothed; {pretrain_s:.0f}s)")
    assert tail_m < head_m, "LM loss should decrease"

    # ---- stage 2: freeze + AFL downstream probe ----
    # Note: with a synthetic 32k-vocab task the absolute probe accuracy is
    # modest — the claims checked are (i) the federated probe is *identical*
    # to the centralized probe and (ii) it beats chance.
    raw = D.token_classification(n=2500, seq=64, vocab=cfg.vocab_size,
                                 num_classes=16, skew=5.0, seed=1)
    feats = np.concatenate(
        [embed(params, cfg, torch.from_numpy(raw.x[i:i + 128]).to(dev)).cpu().numpy()
         for i in range(0, len(raw), 128)])
    ds = D.Dataset(feats, raw.y, raw.num_classes)
    train, test = D.train_test_split(ds, 0.25, seed=0)
    fl = FLConfig(num_clients=50, partition="niid1", alpha=0.05)
    res = afl.run_afl(train, test, fl)
    _, acc_joint = afl.joint_ridge(train, test, gamma=0.0)
    chance = 1.0 / raw.num_classes
    print(f"AFL probe: {res.accuracy:.4f} (centralized: {acc_joint:.4f}, "
          f"chance: {chance:.4f}) — K=50, α=0.05, single round")
    assert abs(res.accuracy - acc_joint) < 1e-9, "AA-law equivalence violated"
    assert res.accuracy > chance, "probe should beat chance"
    return dict(params=count_params(params), steps=args.steps, loss_head=head_m,
                loss_tail=tail_m, pretrain_s=pretrain_s, probe_accuracy=res.accuracy,
                joint_accuracy=acc_joint, chance=chance)


if __name__ == "__main__":
    main()
