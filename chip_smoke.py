#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX
package, and fails (non-zero exit, no result line) without a GPU or
without the repository around it. Phases, each fatal on failure:

  1. header: the card's name and power limit (nvidia-smi), the TF32
     switches (must be off), and the build of every kernel of the path;
  2. kernels: ``gram_update`` against its plain version on the card at
     four shapes, timed beside the plain version, one library call and
     the card's bound;
  3. small check: a reduced ``run_analytic`` on the card (kernel) against
     the same run on the CPU (plain versions), same weights;
  4. slice: ``run_analytic`` at the full width of minicpm_2b (all 40
     layers, random f32 weights from a seed), with the kernel's launches
     counted over exactly that run; then, at the same width, the kernel's
     fold of a real batch against the plain fold, the card's pooled
     embeddings against the CPU's, the same aggregate solved at γ > 0, and
     a no-layer control of how much signal the data hold.

It then prints the kernels' JSON line, and last the device line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# One card: every phase runs on device 0, and the last line counts it.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.bfloat16: 989e12}
# tests/test_kernels_gram.py's tolerances: (rtol, atol)
GRAM_TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (2e-2, 2e-1)}
# (N, d, C, dtype): the main path's per-batch shape first
GRAM_SHAPES = [
    (64, 2304, 16, torch.float32),
    (8192, 2304, 16, torch.float32),
    (1000, 200, 37, torch.float32),
    (2048, 384, 128, torch.bfloat16),
]
SLICE = dict(arch="minicpm_2b", samples=4096, seq=32, batch=64, classes=16)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, reps: int = 50, trials: int = 7) -> float:
    """Median device milliseconds per call of ``fn``.

    A sleep kernel holds the stream while the host queues ``reps`` calls
    between two CUDA events, so host overhead between launches does not
    count; warm-up first, median over ``trials``.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def gram_bound(n, d, c, dtype):
    """Least time for (XᵀX, XᵀY): bytes each read or written once, and the
    operations at the input type's peak. G is symmetric, so the function
    needs N·d·(d+1) flops for it (one triangle with its diagonal), plus
    2·N·d·C for Q."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = n * d * (d + 1) + 2 * n * d * c
    nbytes = 4 * (d * d + d * c) + itemsize * n * (d + c)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), by, flops, nbytes


def header(G):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])    # name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"torch.backends.cuda.matmul.allow_tf32={tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    if tf32:
        fail("TF32 matmuls are on; the f32 references need them off")
    build = G.build()
    log(f"build: {build.path.name} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def kernel_phase(G, ref):
    rows = []
    for i, (n, d, c, dtype) in enumerate(GRAM_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(i)
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
        y = F.one_hot(labels, c).to(dtype)
        g, q = G.gram_update(x, y)
        g_ref, q_ref = ref.gram_ref(x, y)
        torch.cuda.synchronize()
        rtol, atol = GRAM_TOL[dtype]
        torch.testing.assert_close(g, g_ref, rtol=rtol, atol=atol)
        torch.testing.assert_close(q, q_ref, rtol=rtol, atol=atol)
        if not torch.equal(g, g.T):
            fail(f"gram kernel G is not symmetric at {(n, d, c)}")
        err = max(float((g - g_ref).abs().max()), float((q - q_ref).abs().max()))
        ms = time_cuda(lambda: G.gram_update(x, y))
        plain_ms = time_cuda(lambda: ref.gram_ref(x, y))
        library_ms = time_cuda(lambda: torch.mm(x.T, torch.cat([x, y], 1)))
        bound_ms, bound_by, flops, nbytes = gram_bound(n, d, c, dtype)
        row = dict(n=n, d=d, c=c, dtype=str(dtype).removeprefix("torch."),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes)
        rows.append(row)
        log(f"gram_update N={n} d={d} C={c} {row['dtype']}: max|err|={err:.3e} "
            f"(rtol {rtol} atol {atol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.mm {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) = "
            f"{100 * bound_ms / ms:.1f}% of bound")
    return rows


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, device) for v in params]
    return params.to(device)


def small_check(get_config, D, T, train, FLConfig):
    """Reduced run on the card (kernel) against the CPU (plain versions)."""
    cfg = get_config(SLICE["arch"]).reduced(num_classes=8)
    ds = D.token_classification(n=256, seq=16, vocab=cfg.vocab_size,
                                num_classes=8, seed=0)
    tr, te = D.train_test_split(ds, 0.25, seed=0)
    fl = FLConfig(gamma=1.0)
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    p_gpu = _params_to(p_cpu, "cuda")
    rep_gpu = train.local_stage(p_gpu, cfg, tr, fl, 64, device="cuda", use_kernel=True)
    rep_cpu = train.local_stage(p_cpu, cfg, tr, fl, 64, device="cpu", use_kernel=True)
    for name in ("gram", "moment"):
        a, b = getattr(rep_gpu, name), getattr(rep_cpu, name)
        torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b),
                                   rtol=1e-4, atol=1e-4 * float(abs(b).max()))
    acc_gpu, _ = train.run_analytic(cfg, tr, te, fl, 64, use_kernel=True,
                                    device="cuda", params=p_gpu)
    acc_cpu, _ = train.run_analytic(cfg, tr, te, fl, 64, use_kernel=True,
                                    device="cpu", params=p_cpu)
    log(f"small check (reduced {cfg.name}, d={cfg.d_model}): report gram/moment "
        f"agree to rtol 1e-4; accuracy card {acc_gpu:.4f} vs CPU {acc_cpu:.4f}")
    if abs(acc_gpu - acc_cpu) * len(te) > 2:    # more than two test samples apart
        fail(f"reduced run accuracy {acc_gpu} on the card vs {acc_cpu} on the CPU")


def slice_phase(G, get_config, D, T, train, FLConfig, api):
    cfg = dataclasses.replace(get_config(SLICE["arch"]), num_classes=SLICE["classes"])
    t0 = time.perf_counter()
    ds = D.token_classification(n=SLICE["samples"], seq=SLICE["seq"],
                                vocab=cfg.vocab_size, num_classes=SLICE["classes"],
                                seed=0)
    tr, te = D.train_test_split(ds, 0.25, seed=0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"slice: {cfg.name} full width d={cfg.d_model} heads={cfg.num_heads} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.num_layers} (no cut); "
        f"{n_params / 1e9:.3f}B params {cfg.dtype} ({4 * n_params / 1e9:.2f} GB) "
        f"init {t_init:.2f} s; data {len(tr)} train / {len(te)} test x seq "
        f"{SLICE['seq']} made in {t_data:.2f} s")
    expected = len(tr) // SLICE["batch"]
    fl = FLConfig(gamma=1.0)
    server = api.AFLServer(cfg.d_model, cfg.num_classes, gamma=fl.gamma)
    torch.cuda.reset_peak_memory_stats()
    G.gram_update.launches = 0
    t0 = time.perf_counter()
    acc, train_s = train.run_analytic(cfg, tr, te, fl, SLICE["batch"],
                                      use_kernel=True, device="cuda", params=params,
                                      coordinator=server)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = G.gram_update.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"slice: run_analytic acc={acc:.4f} train_s={train_s:.3f} wall_s={wall:.3f} "
        f"gram_update launches={launches} (expected {expected}) peak_mem={peak:.2f} GB")
    if launches != expected:
        fail(f"gram_update launched {launches} times, expected {expected}")
    if not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
        fail(f"accuracy {acc} is not a fraction")
    slice_checks(cfg, params, tr, te, server, acc, train, fl, api)
    return launches


# γ = ρ·tr(G)/d: the same aggregate solved ridgeless and at three ridges
HEAD_RHOS = (0.0, 1e-4, 1e-2, 1.0)
# pooled embeddings of a few test rows, card (cuBLAS, TF32 off) against the
# host CPU on the same weights: f32 sums in another order over 40 layers
BACKBONE_ROWS = 4
BACKBONE_TOL = (1e-3, 1e-3)    # (rtol, atol)


def _head_accuracies(server, dim, x_test, y_test, api):
    scale = float(server.state()["gram_diag_raw"].sum()) / dim
    return [api.evaluate_weight(server.solve(target_gamma=rho * scale), x_test, y_test)
            for rho in HEAD_RHOS]


def _spread(emb):
    """Mean cosine between distinct rows, and the participation ratio
    (Σλ)²/Σλ² of the centred rows' spectrum: how far the pooled embeddings
    collapse onto a few directions."""
    e = emb.double()
    u = F.normalize(e, dim=1)
    n = len(u)
    cos = float(((u @ u.T).sum() - n) / (n * (n - 1)))
    c = e - e.mean(0)
    k = c @ c.T
    return cos, float(torch.trace(k) ** 2 / (k * k).sum())


def slice_checks(cfg, params, tr, te, server, acc, train, fl, api):
    """Full-width checks on the slice's own data, after its counted run:
    the Gram fold of real embeddings against the plain fold, the card's
    backbone against the CPU's, the same aggregate at γ > 0, and a
    no-layer control that says how much linear signal the data holds."""
    t0 = time.perf_counter()
    batch, c, d = SLICE["batch"], cfg.num_classes, cfg.d_model
    table = params["embed"]
    dev = table.device
    onehot = lambda y: F.one_hot(torch.as_tensor(y, device=dev), c).to(torch.float32)  # noqa: E731

    emb = train.embed(params, cfg, tr.x[:batch])
    reports = [api.AFLClient(0, gamma=fl.gamma, backend="torch", device=dev,
                             use_kernel=k).update(emb, onehot(tr.y[:batch])).report()
               for k in (True, False)]
    rtol, atol = GRAM_TOL[torch.float32]
    for name in ("gram", "moment", "root"):
        a, b = (torch.from_numpy(getattr(r, name)) for r in reports)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
    fold_err = float(np.abs(reports[0].gram - reports[1].gram).max())

    te_emb = torch.cat([train.embed(params, cfg, te.x[i:i + batch])
                        for i in range(0, len(te), batch)])
    host = _params_to(params, "cpu")
    emb_cpu = train.embed(host, cfg, te.x[:BACKBONE_ROWS])
    del host
    emb_card = te_emb[:BACKBONE_ROWS].cpu()
    bb_err = float((emb_card - emb_cpu).abs().max())
    log(f"slice check: full-width Gram fold of one real batch, kernel vs plain "
        f"max|err|={fold_err:.3e} (rtol {rtol} atol {atol}); pooled embeddings of "
        f"{BACKBONE_ROWS} test rows, card vs CPU max|err|={bb_err:.3e} "
        f"(max|emb|={float(emb_cpu.abs().max()):.3e}; rtol {BACKBONE_TOL[0]} "
        f"atol {BACKBONE_TOL[1]})")
    torch.testing.assert_close(emb_card, emb_cpu, rtol=BACKBONE_TOL[0],
                               atol=BACKBONE_TOL[1])

    x_te = te_emb.double().cpu().numpy()
    accs = _head_accuracies(server, d, x_te, te.y[:len(x_te)], api)
    cos, pr = _spread(te_emb)
    pooled0 = lambda toks: table[torch.as_tensor(toks, device=dev).long()].mean(1)  # noqa: E731
    control = api.AFLServer(d, c, gamma=fl.gamma)
    control.submit(api.AFLClient(1, gamma=fl.gamma, backend="torch", device=dev)
                   .update(pooled0(tr.x), onehot(tr.y)).report())
    te0 = pooled0(te.x)
    accs0 = _head_accuracies(control, d, te0.double().cpu().numpy(), te.y, api)
    cos0, pr0 = _spread(te0)
    fmt = lambda a: ", ".join(f"ρ={r:g}: {x:.4f}" for r, x in zip(HEAD_RHOS, a))  # noqa: E731
    log(f"slice check: test accuracy at γ=ρ·tr(G)/d, {cfg.num_layers}-layer backbone "
        f"[{fmt(accs)}]; no-layer control (mean of token embeddings) [{fmt(accs0)}]; "
        f"chance {1 / c:.4f}")
    log(f"slice check: pooled test embeddings, mean cosine {cos:.4f} and "
        f"participation ratio {pr:.1f} of d={d} (backbone) vs {cos0:.4f} and "
        f"{pr0:.1f} (no layers); checks took {time.perf_counter() - t0:.1f} s")
    if abs(accs[0] - acc) * len(te) > 1:
        fail(f"the aggregate re-solved at γ=0 gives {accs[0]}, run_analytic gave {acc}")
    if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs + accs0):
        fail(f"head accuracies {accs} / {accs0} are not fractions")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    if torch.cuda.device_count() != 1:
        fail(f"CUDA_VISIBLE_DEVICES names {torch.cuda.device_count()} devices; "
             "this smoke run uses one")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the port's package is not at {src / 'repro_torch'}; run from a checkout")
    sys.path.insert(0, str(src))
    from repro_torch.config import FLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic as D
    from repro_torch.fl import api
    from repro_torch.kernels import gram as G
    from repro_torch.kernels import ref
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    header(G)
    rows = kernel_phase(G, ref)
    small_check(get_config, D, T, train, FLConfig)
    launches = slice_phase(G, get_config, D, T, train, FLConfig, api)

    main_row = rows[0]
    max_err = max(r["max_abs_err"] for r in rows)
    # ``kernel_ms`` and ``max_err`` repeat ``ms`` and ``max_abs_err``: the
    # kernels line is read under both names
    kernel = dict(
        name="gram_update", route="cuda",
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:86",
        launches=launches, max_abs_err=max_err, max_err=max_err,
        ms=main_row["ms"], kernel_ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"], shapes=rows)
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
