#!/usr/bin/env python3
"""``gram_update`` and each regime of ``flash_attention`` on one GPU, at
chip_smoke.py's main-path shapes, with what bounds them.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 tools/kernel_probe.py

Builds ``csrc/gram.cu`` and ``csrc/flash_attention.cu`` (printing each
kernel's registers and spills), then times ``gram_update`` at (64, 2304,
16) and (8192, 2304, 16) beside ``torch.mm`` and the time to zero G (the
write alone), and at N = 1 and 16 (the write with next to no FMAs);
and for ``flash_attention`` times the main path's five shapes beside
``scaled_dot_product_attention``: one JSON line each, with the card's name
and power limit first. Each kernel is checked against its plain version
before it is timed (chip_smoke.py's tolerances); times are chip_smoke.py's
(a sleep kernel holds the stream while the calls queue, median of trials).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as CS  # noqa: E402

def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_probe: needs an NVIDIA GPU")
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gram as G
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for built in build.load(G.SOURCE, FA.SOURCE):
        print(f"build: {built.path.name} in {built.seconds:.2f} s", flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    G.build()
    FA.build()

    for n, d, c, dtype in CS.GRAM_SHAPES[:2]:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        y = F.one_hot(torch.randint(0, c, (n,), generator=gen, device="cuda"), c).to(dtype)
        g_ref, q_ref = ref.gram_ref(x, y)
        rtol, atol = CS.GRAM_TOL[dtype]
        library_ms = CS.time_cuda(lambda: torch.mm(x.T, torch.cat([x, y], 1)))
        bound_ms = CS.gram_bound(n, d, c, dtype)[0]
        g_zero = torch.empty_like(g_ref)
        print(json.dumps(dict(kernel="write floor", shape=[d, d], what="zero_() of G",
                              ms=CS.time_cuda(lambda: g_zero.zero_()))), flush=True)
        g, q = G.gram_update(x, y)
        torch.cuda.synchronize()
        torch.testing.assert_close(g, g_ref, rtol=rtol, atol=atol)
        torch.testing.assert_close(q, q_ref, rtol=rtol, atol=atol)
        assert torch.equal(g, g.T)
        ms = CS.time_cuda(lambda: G.gram_update(x, y))
        print(json.dumps(dict(kernel="gram_update", shape=[n, d, c], ms=ms,
                              library_ms=library_ms, bound_ms=bound_ms)), flush=True)

    for n in (1, 16):                      # the G write with next to no FMAs
        x = torch.randn((n, 2304), device="cuda")
        y = torch.randn((n, 16), device="cuda")
        print(json.dumps(dict(kernel="gram_update", shape=[n, 2304, 16],
                              ms=CS.time_cuda(lambda: G.gram_update(x, y)))), flush=True)

    for what, shape, kw, dtype in CS.ATTN_SHAPES[:5]:
        b, hq, hkv, sq, skv, d = shape
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])
        _, err = CS.check_attention(FA, ref, q, k, v, kw, what)
        ms = CS.time_auto(lambda: FA.flash_attention(q, k, v, **kw))
        library_ms = CS.time_auto(CS._sdpa_library(ref, q, k, v, kw))
        regime, chunks, launches = CS.attention_plan(FA, shape, kw)
        print(json.dumps(dict(kernel="flash_attention", case=what, shape=list(shape),
                              regime=regime, chunks=chunks, cuda_launches=launches,
                              max_abs_err=err, ms=ms, library_ms=library_ms,
                              bound_ms=CS.attention_bound(ref, shape, kw, dtype)[0])),
              flush=True)


if __name__ == "__main__":
    main()
