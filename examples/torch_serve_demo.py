"""Serving demo on the PyTorch port: batched requests against three families.

The port of ``examples/serve_demo.py``. Prefills a batch of prompts and
decodes tokens against each family's cache (KV / SSM state / enc-dec
cross-attention memory), at reduced widths: the small analogue of the
dry run's decode_32k / long_500k shapes. On the card attention is the flash
kernel.

  PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

It runs on the card unless ``--device`` names another device.
"""

import argparse

from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import serve

REQUESTS = [
    ("gemma3_12b", "dense, 5:1 local:global sliding window"),
    ("zamba2_7b", "hybrid Mamba2 + shared attention"),
    ("seamless_m4t_medium", "enc-dec (audio frontend stubbed)"),
]
BATCH, PROMPT, GEN = 4, 24, 12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    out = {}
    for arch, note in REQUESTS:
        cfg = get_config(arch).reduced()
        toks, prefill_s, decode_s = serve(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                                          device=args.device)
        rate = BATCH * GEN / decode_s
        print(f"{arch:22s} [{note}]")
        print(f"  prefill {prefill_s*1e3:7.1f}ms  decode {decode_s*1e3:7.1f}ms "
              f"({rate:5.1f} tok/s)  sample: ...{toks[0, -6:].tolist()}")
        assert toks.shape == (BATCH, PROMPT + GEN)
        out[arch] = dict(prefill_s=prefill_s, decode_s=decode_s, tokens=toks)
    return out


if __name__ == "__main__":
    main()
