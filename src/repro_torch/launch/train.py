"""Training launcher: AFL analytic training of a backbone+head, end to end.

The port of ``repro.launch.train``'s analytic mode on one device: frozen
backbone forward → Gram statistics folded batch by batch (on CUDA through
the hand-written Gram kernel with ``--kernel``) → one ``ClientReport`` →
an ``AFLServer`` solves in host f64 → linear head → accuracy.

Usage (on the GPU; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --samples 256 --seq 16 --classes 8 --batch 64 --kernel
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
from repro_torch.fl.api import AFLClient, AFLServer, ClientReport
from repro_torch.models import transformer as T

_NOT_PORTED = "{} is not ported to torch yet (see ROADMAP.md, Queue 1)"


def _batches(ds: D.Dataset, batch: int):
    n = (len(ds) // batch) * batch
    for i in range(0, n, batch):
        yield ds.x[i:i + batch], ds.y[i:i + batch]


def embed(params, cfg, tokens) -> torch.Tensor:
    """Frozen-backbone embedding: tokens (B,S) → (B,D) f32."""
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
                 coordinator=None):
    """AFL on one device: one epoch of forwards, one aggregation.

    ``params`` defaults to ``T.init_params(cfg, seed=0)`` on ``device``; a
    caller may pass its own (e.g. the reference's, carried over by
    ``models.convert.params_from_jax``). ``coordinator`` defaults to a
    fresh ``AFLServer``; a caller that passes its own can solve the same
    aggregate again afterwards (e.g. at other γ). Returns (test accuracy,
    seconds from the first forward to the solved head).
    """
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    report = local_stage(params, cfg, train_ds, fl, batch, device=dev,
                         use_kernel=use_kernel)
    coord = coordinator
    if coord is None:
        coord = AFLServer(cfg.d_model, cfg.num_classes, gamma=fl.gamma)
    coord.submit(report)
    w = coord.solve(target_gamma=0.0)
    train_s = time.perf_counter() - t0
    correct = total = 0
    for toks, labels in _batches(test_ds, batch):
        pred = np.argmax(to_numpy(embed(params, cfg, toks), None) @ w, -1)
        correct += int((pred == labels).sum())
        total += len(labels)
    return float(correct / max(total, 1)), train_s


def main() -> None:
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
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--kernel", action="store_true",
                    help="fold Gram batches with the CUDA kernel")
    ap.add_argument("--server-url", default="",
                    help="submit to a remote federation (not ported yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU)")
    args = ap.parse_args()
    if args.mode != "analytic":
        raise SystemExit(_NOT_PORTED.format(f"--mode {args.mode}"))
    if args.server_url:
        raise SystemExit(_NOT_PORTED.format("--server-url"))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_classes=args.classes)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} reduced={args.reduced} device={dev}")

    ds = D.token_classification(
        n=args.samples, seq=args.seq, vocab=cfg.vocab_size,
        num_classes=args.classes, seed=0)
    train_ds, test_ds = D.train_test_split(ds, 0.25, seed=0)
    fl = FLConfig(gamma=args.gamma)
    acc, dt = run_analytic(cfg, train_ds, test_ds, fl, args.batch,
                           use_kernel=args.kernel, device=dev)
    print(f"AFL analytic: acc={acc:.4f} train_time={dt:.2f}s (one epoch, "
          "single aggregation)")


if __name__ == "__main__":
    main()
