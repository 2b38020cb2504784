#!/usr/bin/env python3
"""``gram_update`` and each regime of ``flash_attention`` on one GPU, at
chip_smoke.py's main-path shapes, with what bounds them.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 tools/kernel_probe.py [--flash | --bf16]

Builds ``csrc/gram.cu`` and ``csrc/flash_attention.cu`` (printing each
kernel's registers and spills), then times ``gram_update`` at (64, 2304,
16) and (8192, 2304, 16) beside ``torch.mm`` and the time to zero G (the
write alone), and at N = 1 and 16 (the write with next to no FMAs);
and for ``flash_attention`` times the main path's five shapes beside
``scaled_dot_product_attention``: one JSON line each, with the card's name
and power limit first. Each kernel is checked against its plain version
before it is timed (chip_smoke.py's tolerances); times are chip_smoke.py's
(a sleep kernel holds the stream while the calls queue, median of trials).
With ``--flash`` it builds and times ``flash_attention`` alone, at the
main path's five shapes and the backbone zoo's serve shapes, with no
library times: the form ``tools/flash_ab.sh`` compares across checkouts.
With ``--bf16`` it builds ``flash_attention`` alone and times its bf16
instance at every bf16 row of chip_smoke.py's attention phase, each beside
the same PyTorch call in bf16 (``scaled_dot_product_attention``, or the
compiled ``flex_attention`` for a softcap) and its bound.
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
    bf16 = "--bf16" in sys.argv[1:]
    flash_only = bf16 or "--flash" in sys.argv[1:]
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gram as G
    from repro_torch.kernels import ref
    from repro_torch.launch import mesh

    CS.PEAK_BYTES_S, CS.PEAK_FLOPS = mesh.HBM_BW, mesh.PEAK_FLOPS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for built in build.load(*([] if flash_only else [G.SOURCE]), FA.SOURCE):
        print(f"build: {built.path.name} in {built.seconds:.2f} s", flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    FA.build()
    if bf16:
        bad = [what for what, shape, kw, dtype in CS.ATTN_SHAPES
               if dtype == torch.bfloat16 and not bf16_row(FA, ref, what, shape, kw)]
        if bad:
            sys.exit(f"kernel_probe: bf16 rows past the bar: {bad}")
        return
    if flash_only:
        zoo = [i for i, row in enumerate(CS.ATTN_SHAPES) if row[0] == "granite prefill"][0]
        for what, shape, kw, dtype in CS.ATTN_SHAPES[:5] + CS.ATTN_SHAPES[zoo:]:
            flash_row(FA, ref, what, shape, kw, dtype, library=False)
        return
    G.build()

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
        flash_row(FA, ref, what, shape, kw, dtype)


def bf16_row(FA, ref, what, shape, kw) -> bool:
    """The bf16 instance at ``shape``: max |err| against the plain version in
    f32 and against its schedule's twin (``ref.mha_tile_bf16_ref`` or
    ``mha_split_bf16_ref``), each over the plain output's largest |value|,
    the regime's kernel time beside the library's; False past
    ``ATTN_BF16_REL``."""
    b, hq, hkv, sq, skv, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])
    kind = FA.regime(torch.bfloat16, hq // hkv * sq)
    out = FA.flash_attention(q, k, v, **kw)
    want = CS._attn_want(ref, q, k, v, kw)
    twin = ref.mha_bf16_schedule_ref(
        q, k, v, sms=torch.cuda.get_device_properties(0).multi_processor_count, **kw)
    torch.cuda.synchronize()
    top = float(want.abs().max()) or 1.0
    rel = float((out.float() - want).abs().max()) / top
    rel_twin = float((out.float() - twin.float()).abs().max()) / top
    twin_rel = float((twin.float() - want).abs().max()) / top
    ok = rel <= CS.ATTN_BF16_REL and bool(torch.isfinite(out).all())
    ms = CS.time_auto(lambda: FA.flash_attention(q, k, v, **kw))
    library_ms = CS.time_auto(CS._sdpa_library(ref, q, k, v, kw))
    print(json.dumps(dict(kernel="flash_attention", case=what, shape=list(shape), kw=kw,
                          regime=kind, rel=rel, rel_twin=rel_twin, twin_rel=twin_rel, ok=ok,
                          ms=ms, library_ms=library_ms,
                          bound_ms=CS.attention_bound(ref, shape, kw, torch.bfloat16)[0])),
          flush=True)
    return ok


def flash_row(FA, ref, what, shape, kw, dtype, library=True) -> None:
    b, hq, hkv, sq, skv, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])
    _, err = CS.check_attention(FA, ref, q, k, v, kw, what)
    ms = CS.time_auto(lambda: FA.flash_attention(q, k, v, **kw))
    library_ms = CS.time_auto(CS._sdpa_library(ref, q, k, v, kw)) if library else None
    regime, chunks, launches = CS.attention_plan(FA, shape, kw, dtype)
    print(json.dumps(dict(kernel="flash_attention", case=what, shape=list(shape), kw=kw,
                          regime=regime, chunks=chunks, cuda_launches=launches,
                          max_abs_err=err, ms=ms, library_ms=library_ms,
                          bound_ms=CS.attention_bound(ref, shape, kw, dtype)[0])),
          flush=True)


if __name__ == "__main__":
    main()
