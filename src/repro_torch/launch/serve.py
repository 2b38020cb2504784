"""Serving launcher: batched prefill, then greedy decode against a KV cache.

The port of the LLM-serving mode of ``repro.launch.serve``: a batch of
prompts is prefilled in one forward pass that fills the per-layer KV cache,
then each decode step feeds the previous step's greedy token at the next
position. On the card every attention call is the hand-written flash
kernel (``kernels/csrc/flash_attention.cu``). Dense archs only; the other
families' caches wait (ROADMAP Queue 1, item 8), and so does the
federation-serving mode (``--federation``, Queue 1, item 7).

Usage (the card; ``--device cpu`` runs the plain versions on the CPU, and
``--reduced`` the smoke-test variant of the config; unlike the reference's
launcher, the default is the full config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \\
      --batch 4 --prompt-len 2048 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \\
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0, *, device=None,
          params=None, on_step: Optional[Callable[[int, torch.Tensor], None]] = None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (drawn from
    ``seed``), then decode greedily to ``gen`` new tokens each.

    ``params`` defaults to ``T.init_params(cfg, seed)`` on ``device``; a
    caller may pass its own (e.g. the reference's, carried over by
    ``models.convert.params_from_jax``). ``on_step(i, logits)``, if given,
    sees the vocab logits (B, V) that chose new token ``i`` (0: the
    prefill's). Returns (tokens (B, prompt_len + gen) int numpy, prefill
    seconds, decode seconds), each timed to a synchronised end.
    """
    dev = resolve_device(device)
    max_seq = prompt_len + gen
    if params is None:
        params = T.init_params(cfg, seed=seed, device=dev)
    prefill = ST.make_prefill_step(cfg, max_seq)
    decode = ST.make_serve_step(cfg)
    b = sample_batch(cfg, batch, prompt_len, seed=seed, with_labels=False, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, b)
    _sync(dev)
    t1 = time.perf_counter()

    toks = [logits.argmax(-1).to(torch.int32)]
    if on_step is not None:
        on_step(0, logits)
    for i in range(gen - 1):
        logits, cache = decode(params, cache, toks[-1], prompt_len + i)
        toks.append(logits.argmax(-1).to(torch.int32))
        if on_step is not None:
            on_step(i + 1, logits)
    _sync(dev)
    t2 = time.perf_counter()

    out = np.concatenate([b["tokens"].cpu().numpy(), torch.stack(toks, 1).cpu().numpy()], 1)
    return out, t1 - t0, t2 - t1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="LLM serving arch (dense family), e.g. gemma3_12b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test variant (default: full width)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU)")
    ap.add_argument("--federation", action="store_true",
                    help="serve an AFL federation instead (not ported yet)")
    args = ap.parse_args(argv)
    if args.federation:
        raise SystemExit("--federation is not ported yet (ROADMAP Queue 1 item 7)")
    if args.arch is None:
        ap.error("--arch is required")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out, prefill_s, decode_s = serve(cfg, args.batch, args.prompt_len, args.gen, device=dev)
    n_new = args.batch * (args.gen - 1)
    print(f"arch={cfg.name} reduced={args.reduced} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {prefill_s * 1e3:.1f}ms   decode: {decode_s * 1e3:.1f}ms "
          f"({n_new / max(decode_s, 1e-9):.1f} tok/s over {args.gen - 1} steps)")
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    print("first sequence tail:", out[0, -min(8, out.shape[1]):].tolist())


if __name__ == "__main__":
    main()
