"""Training launcher: AFL analytic training of a backbone+head, end to end.

The port of ``repro.launch.train``'s analytic mode on one device: frozen
backbone forward (any family whose input is tokens alone: dense, moe,
hybrid, xlstm; as in the reference, the enc-dec and VLM archs would need
their modality stubs, which the token-classification data lacks) → Gram
statistics folded batch by batch (on CUDA through
the hand-written Gram kernel with ``--kernel``) → one ``ClientReport`` →
an ``AFLServer`` solves in host f64 (in this process, or behind a
federation service at ``--server-url``) → linear head → accuracy. With
``--shards N`` (and ``--tiled``) a ``ShardedCoordinator`` aggregates
instead and solves over a mesh of N shards on the device, as the
reference's does over a multi-device jax mesh; the reference takes the
shard count from its mesh, the port from the flag (N shards share one
card). ``--mode gradient`` runs the gradient-FL baseline (head SGD on the
frozen backbone's embeddings) on the same data, and ``--mode lm`` the
full-backbone LM pre-training driver (next-token CE, SGD under a WSD
schedule), as the reference's do.

Usage (on the GPU; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --samples 256 --seq 16 --classes 8 --batch 64 --kernel
Against a federation (``python -m repro_torch.launch.serve --federation``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --classes 8 --server-url http://127.0.0.1:8790
Through the sharded coordinator (8 shards, row-tiled Gram):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --classes 8 --shards 8 --tiled
The gradient baseline and the LM driver:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --mode gradient --samples 256 --seq 16 --classes 8 --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --mode lm --steps 8 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import to_numpy
from repro_torch.data import synthetic as D
from repro_torch.device import resolve_device
from repro_torch.fl.api import (AFLClient, AFLServer, ClientReport,
                                ShardedCoordinator)
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import transformer as T
from repro_torch.optim import wsd_schedule


def _batches(ds: D.Dataset, batch: int):
    n = (len(ds) // batch) * batch
    for i in range(0, n, batch):
        yield ds.x[i:i + batch], ds.y[i:i + batch]


def embed(params, cfg, tokens) -> torch.Tensor:
    """Frozen-backbone embedding: tokens (B,S) → (B,D) f32."""
    with torch.no_grad():
        return T.pool(T.forward(params, cfg, {"tokens": tokens})).to(torch.float32)


def local_stage(params, cfg, train_ds, fl: FLConfig, batch: int, *,
                device, use_kernel: bool = False) -> ClientReport:
    """One client's epoch over ``train_ds``: every batch is embedded on
    ``device`` and folded into the client's statistics there."""
    client = AFLClient(0, gamma=fl.gamma, backend="torch", device=device,
                       use_kernel=use_kernel)
    for toks, labels in _batches(train_ds, batch):
        emb = embed(params, cfg, toks)
        y = F.one_hot(torch.as_tensor(labels, device=device),
                      cfg.num_classes).to(torch.float32)
        client.update(emb, y)
    return client.report()


def run_analytic(cfg, train_ds, test_ds, fl: FLConfig, batch: int,
                 use_kernel: bool = False, *, device=None, params=None,
                 coordinator=None, server_url: str = ""):
    """AFL on one device: one epoch of forwards, one aggregation.

    ``params`` defaults to ``T.init_params(cfg, seed=0)`` on ``device``; a
    caller may pass its own (e.g. the reference's, carried over by
    ``models.convert.params_from_jax``). The report goes to a
    :class:`~repro_torch.fl.service.RemoteCoordinator` when ``server_url``
    points at a live federation service (``launch/serve.py
    --federation``), else to ``coordinator`` (e.g. a
    :class:`~repro_torch.fl.api.ShardedCoordinator`), which defaults to a
    fresh ``AFLServer``; a caller that passes its own can solve the same
    aggregate again afterwards (e.g. at other γ). Returns (test accuracy,
    seconds from the first forward to the solved head).
    """
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=0, device=dev)
    remote = None
    if server_url:
        from repro_torch.fl.service import RemoteCoordinator

        remote = RemoteCoordinator(server_url)
        if remote.dim != cfg.d_model:
            remote.close()
            raise ValueError(f"remote federation dim={remote.dim} != model "
                             f"d_model={cfg.d_model}")
    try:
        t0 = time.perf_counter()
        report = local_stage(params, cfg, train_ds, fl, batch, device=dev,
                             use_kernel=use_kernel)
        coord = remote if remote is not None else coordinator
        if coord is None:
            coord = AFLServer(cfg.d_model, cfg.num_classes, gamma=fl.gamma)
        coord.submit(report)
        w = coord.solve(target_gamma=0.0)
        train_s = time.perf_counter() - t0
    finally:
        if remote is not None:
            remote.close()
    correct = total = 0
    for toks, labels in _batches(test_ds, batch):
        pred = np.argmax(to_numpy(embed(params, cfg, toks), None) @ w, -1)
        correct += int((pred == labels).sum())
        total += len(labels)
    return float(correct / max(total, 1)), train_s


def run_gradient(cfg, train_ds, test_ds, fl: FLConfig, batch: int, rounds: int,
                 lr: float = 0.05, *, device=None, params=None):
    """Head-only gradient FL baseline on the same frozen features: ``rounds``
    epochs of ``steps.head_sgd_step`` over the backbone's embeddings of each
    batch, from a zero head. ``params`` as :func:`run_analytic`'s. Returns
    (test accuracy, seconds of the rounds)."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=0, device=dev)
    head = torch.zeros((cfg.d_model, cfg.num_classes), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for _ in range(rounds):
        for toks, labels in _batches(train_ds, batch):
            emb = embed(params, cfg, toks)
            head = ST.head_sgd_step(head, emb, labels, lr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    w = to_numpy(head, None)
    correct = total = 0
    for toks, labels in _batches(test_ds, batch):
        pred = np.argmax(to_numpy(embed(params, cfg, toks), None) @ w, -1)
        correct += int((pred == labels).sum())
        total += len(labels)
    return float(correct / max(total, 1)), train_s


def run_lm(cfg, steps: int, batch: int, seq: int, base_lr: float = 3e-3, *,
           device=None, params=None):
    """Generic LM pre-training driver (WSD schedule, minicpm-style):
    ``steps`` of ``steps.make_full_train_step`` on ``sample_batch(cfg,
    batch, seq, seed=i)``, the params (``run_analytic``'s default, or the
    caller's, updated in place) trained from the first step. Returns the
    losses, as floats."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=0, device=dev)
    train_step = ST.make_full_train_step(cfg)
    sched = wsd_schedule(base_lr, warmup=max(steps // 10, 1), total=steps)
    losses = []
    for i in range(steps):
        b = sample_batch(cfg, batch, seq, seed=i, device=dev)
        params, loss = train_step(params, b, sched(i))
        losses.append(float(loss))
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="analytic",
                    choices=["analytic", "gradient", "lm"])
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5, help="gradient-FL rounds")
    ap.add_argument("--steps", type=int, default=50, help="lm steps")
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--kernel", action="store_true",
                    help="fold Gram batches with the CUDA kernel")
    ap.add_argument("--server-url", default="",
                    help="submit to a FederationService at this URL instead "
                         "of aggregating in-process (see launch/serve.py "
                         "--federation)")
    ap.add_argument("--shards", type=int, default=None,
                    help="aggregate in a ShardedCoordinator of this many "
                         "shards on --device (one thread a shard)")
    ap.add_argument("--tiled", action="store_true",
                    help="with --shards: row-tiled global Gram, factored "
                         "tile-parallel on the shards")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_classes=args.classes)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} reduced={args.reduced} device={dev}")

    if args.mode == "lm":
        losses = run_lm(cfg, args.steps, args.batch, args.seq, device=dev)
        print(f"lm: step0 loss={losses[0]:.4f} → step{len(losses)-1} "
              f"loss={losses[-1]:.4f}")
        return

    ds = D.token_classification(
        n=args.samples, seq=args.seq, vocab=cfg.vocab_size,
        num_classes=args.classes, seed=0)
    train_ds, test_ds = D.train_test_split(ds, 0.25, seed=0)
    fl = FLConfig(gamma=args.gamma)
    if args.mode == "gradient":
        acc, dt = run_gradient(cfg, train_ds, test_ds, fl, args.batch, args.rounds,
                               device=dev)
        print(f"gradient FL baseline: acc={acc:.4f} train_time={dt:.2f}s "
              f"({args.rounds} rounds)")
        return
    coordinator = None
    if args.shards is not None:
        coordinator = ShardedCoordinator(cfg.d_model, cfg.num_classes,
                                         gamma=fl.gamma, num_shards=args.shards,
                                         tiled_gram=args.tiled, device=dev)
    elif args.tiled:
        ap.error("--tiled needs --shards")
    acc, dt = run_analytic(cfg, train_ds, test_ds, fl, args.batch,
                           use_kernel=args.kernel, device=dev,
                           coordinator=coordinator, server_url=args.server_url)
    where = (f" via {args.server_url}" if args.server_url else
             f" over {args.shards} shards" + (" (tiled)" if args.tiled else "")
             if args.shards is not None else "")
    print(f"AFL analytic: acc={acc:.4f} train_time={dt:.2f}s (one epoch, "
          f"single aggregation{where})")


if __name__ == "__main__":
    main()
