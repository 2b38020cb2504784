#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX
package, and fails (non-zero exit, no result line) without a GPU or
without the repository around it. Phases, each fatal on failure:

  1. header: the card's name and power limit (nvidia-smi), the TF32
     switches (must be off), and the build of every kernel of the path
     (one nvcc for each of the five sources, all at once), with registers
     and spills;
  2. kernels: ``gram_update``, the four panel kernels of the streamed
     Cholesky, ``blocked_cholesky``, ``cholesky_solve``,
     ``multi_gamma_solve``, ``chol_rank_update`` and ``flash_attention``
     against their plain versions on the card, at the shapes of the main
     paths, ragged shapes and (the factors and the sweep) an input that is
     not positive definite; ``panel_tri_inv`` also against
     ``ref.invert_blocked_ref`` (the plain twin of its blocked inverse),
     ``panel_factor`` against ``ref.panel_factor_blocked_ref`` (that of
     its blocked factor and inverse),
     ``blocked_cholesky``, ``cholesky_solve`` and ``multi_gamma_solve``
     also against themselves on a repeated call (the same bits), the last
     two also against the plain twins of their schedules
     (``ref.solve_right_looking_ref``, ``ref.multi_gamma_blocked_ref``),
     ``gram_update`` also against ``ref.gram_upper_ref`` (its upper-tile
     schedule) and for an exactly symmetric G; ``flash_attention`` also at
     the split-KV decode's edges (a one-key cache, a band that is no
     multiple of the chunk, a window inside one chunk, a cache unwritten
     past q_offset, rows past every key, a GQA group of 8, bf16), with
     each call's regime, chunks and CUDA launches (two for a split decode)
     logged and checked;
     one f32 call of ``blocked_cholesky`` (1, 1536), ``cholesky_solve``
     (1, 1536, 16), ``multi_gamma_solve`` (2304, 16, 16 γs) and the rank
     update profiled by kernel; then the f64 instance of each solve-side kernel
     at its f64 path's shape against its f64 plain version (relative
     1e-10); each timed beside the plain version, one library call that
     computes the same function, and the card's bound; the times of the earlier
     designs of the redesigned kernels and paths (PERF.md) are logged beside
     this run's; the two products summed over one streamed factor at
     d = 2304 (f32 and f64) beside torch.mm / torch.addmm over the same
     shapes, and one streamed factor at d = 2304 (f32, f64) and d = 6144
     profiled into panel_factor, panel_trsm, panel_update and the rest;
  3. streamed factor and solve of one SPD system at d = 6144 (the width
     of nemotron4_15b and grok1): the kernel route against the plain
     route on the card, timed beside torch.linalg, and an indefinite
     system that must come back as NaNs;
  4. small check: a reduced ``run_analytic`` on the card (kernels) against
     the same run on the CPU (plain versions), same weights;
  5. slice: ``run_analytic`` at the full width of minicpm_2b (all 40
     layers, random f32 weights from a seed), with the Gram kernel's and
     the flash kernel's launches (wrapper calls, and the CUDA launches
     they made) counted over exactly that run; then, at
     the same width, the
     kernel's fold of a real batch against the plain fold, the card's
     pooled embeddings against the CPU's, the same aggregate solved at
     γ > 0 on the host, and a no-layer control of how much signal the data
     hold;
  6. device solve: that aggregate moved to the card in f32 and solved by
     ``AnalyticEngine("torch", use_kernel=True)`` at three ridges, with the
     panel kernels' launches counted over exactly those solves (9 / 9 / 8 /
     9 per factor and solve at d = 2304), held against the plain route on
     the card and the host's f64 weight, and scored on the test set;
  7. γ sweep: that aggregate through ``solve_multi_gamma`` at 16 ridges,
     answered by one ``multi_gamma_solve`` launch and no
     eigendecomposition, against the plain route on the card and the
     host's f64 sweep; then γ = 0 on a rank-deficient aggregate, which
     must reroute to the eigendecomposition and give the host's pinv
     answer;
  8. narrow solves: the paper tables' features (d = 128) and a seeded
     system at granite_moe_3b_a800m's width (d = 1536) through the
     engine's ``solve`` and ``factor`` / ``factor_solve``, one
     ``blocked_cholesky`` and one ``cholesky_solve`` launch per solve;
  9. rank update: a straggler's 64-row root folded into the cached factor
     of the slice's aggregate by one ``chol_rank_update`` call, against
     the refactor on the card and host f64;
 10. f64 device engine: ``AnalyticEngine("torch", dtype=torch.float64,
     use_kernel=True)`` on the slice's aggregate: the streamed solve at
     panels of 128, a narrow d = 1536 solve, the 16-ridge sweep and the
     straggler's rank update, each route's launches counted, each answer
     within 10·κ·u64 of the numpy_f64 engine, each timed beside
     torch.linalg in f64;
 11. paper round: the paper's single round (``fl.afl.run_afl``) on the
     card's pooled embeddings of the slice's data (the flash kernel's
     launches counted over exactly that call, 40 a forward): Table 1's
     partitions at K = 100 (iid, NIID-1 α = 0.1, NIID-2 s = 2) and Figure
     2's K = 1000 (NIID-1 α = 0.1), each with the joint solve's test
     accuracy and a weight within 10·κ·u64 of ``joint_ridge`` (accuracy
     only if the host Gram is singular), its host seconds split into local
     stages, submits and solve; ``run_afl(backbone_fn=…)`` with the
     backbone on the card, the same accuracy; then the same round on the
     card at K = 16: each client an ``AnalyticState`` on the card, its rows
     folded 64 at a time by ``launch.steps.make_analytic_train_step``
     (``use_kernel=True``: one ``gram_update`` launch a batch, 40 flash
     launches, nothing else), the 16 states merged in both orders, the
     merged Gram within 1e-5 (relative Frobenius) of the host's f64 XᵀX,
     and ``core.streaming.solve`` at ρ ∈ {1e-2, 1} within 10·κ·u32 of the
     host server's weight with its test accuracy; its own JSON line
     ``{"paper_round": ...}``;
 12. serve, after the minicpm weights are freed: ``launch.serve.serve`` of
     gemma3_12b at full width (all 48 layers, random f32 weights from a
     seed), a prefill of 4 × 2048 tokens and 15 greedy decode steps
     against a 2064-slot KV cache, with the flash kernel's launches
     counted over exactly that run (48 + 48 × 15 calls; 48 + 2 × 48 × 15
     CUDA launches, every decode call split); a profiled decode step's
     flash time logged; then a teacher-forced
     forward over the prompt and the generated tokens that must give the
     logits decode gave, layers 0 (local) and 5 (global) of the prefill
     through the kernel against the plain version on their real q, k, v,
     and a reduced gemma3 serve on the card against the same run on the
     CPU.

Each path's launches are counted from zero just before it runs. It then
prints the kernels' JSON line (ten kernels), and last the device line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# One card: every phase runs on device 0, and the last line counts it.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.bfloat16: 989e12,
              torch.float64: 67e12}      # f64 in the tensor cores (34 outside them)
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


def time_cuda(fn, reps: int = 50, trials: int = 7, warmup: int = 3) -> float:
    """Median device milliseconds per call of ``fn``.

    A sleep kernel holds the stream while the host queues ``reps`` calls
    between two CUDA events, so host overhead between launches does not
    count (unless queueing them takes longer than the sleep, as for the
    plain versions' column loops); warm-up first, median over ``trials``.
    """
    for _ in range(warmup):
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


def _bound(flops, nbytes, dtype=torch.float32):
    """Least milliseconds for the work, and what bounds it: the bytes each
    read or written once at the memory rate, or the operations at the
    input type's peak."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gram_bound(n, d, c, dtype):
    """Bound of (XᵀX, XᵀY). G is symmetric, so the function needs
    N·d·(d+1) flops for it (one triangle with its diagonal), plus 2·N·d·C
    for Q."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = n * d * (d + 1) + 2 * n * d * c
    nbytes = 4 * (d * d + d * c) + itemsize * n * (d + c)
    return (*_bound(flops, nbytes, dtype), flops, nbytes)


def header(K, build):
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
    t0 = time.perf_counter()
    modules = (K.G, K.P, K.B, K.R, K.FA)
    for built in build.load(*(m.SOURCE for m in modules)):
        log(f"build: {built.path.name} in {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    for m in modules:
        m.build()
    log(f"build: {len(modules)} sources in {time.perf_counter() - t0:.2f} s (in parallel)")


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
        g_twin, _ = ref.gram_upper_ref(x, y)          # the kernel's schedule, plain
        torch.testing.assert_close(g, g_twin, rtol=rtol, atol=atol)
        if not torch.equal(g, g.T):
            fail(f"gram kernel G is not symmetric at {(n, d, c)}")
        err = max(float((g - g_ref).abs().max()), float((q - q_ref).abs().max()))
        ms = time_cuda(lambda: G.gram_update(x, y))
        plain_ms = time_cuda(lambda: ref.gram_ref(x, y))
        library_ms = time_cuda(lambda: torch.mm(x.T, torch.cat([x, y], 1)))
        bound_ms, bound_by, flops, nbytes = gram_bound(n, d, c, dtype)
        dt = str(dtype).removeprefix("torch.")
        row = dict(n=n, d=d, c=c, dtype=dt, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes,
                   earlier_ms=EARLIER_MS.get(("gram_update", (n, d, c), dt)))
        rows.append(row)
        rows_per_split = G.split_rows(n, d, c, torch.cuda.get_device_properties(0).multi_processor_count)
        row["splits"] = -(-n // rows_per_split)
        log(f"gram_update N={n} d={d} C={c} {dt}: {G.blocks(d, c)} tiles ({len(G.upper_tiles(d))} "
            f"of G), N in {row['splits']} split(s); max|err|={err:.3e} "
            f"(rtol {rtol} atol {atol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.mm {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) = "
            f"{100 * bound_ms / ms:.1f}% of bound, torch.mm / kernel {library_ms / ms:.2f} "
            f"(before: {row['earlier_ms'] or 'n/a'} ms)")
    return rows


# The panel kernels against their plain versions: relative 1e-4 of the
# largest entry for the factor and inverse, the f32 bar of
# tests/test_distributed_cholesky.py (the same column sweep with sums in
# another order, blocks with condition numbers near 9); the Gram tolerances
# above for the two products (f32 sums of b terms in another order).
PANEL_REL = 1e-4
PANEL_B = 256
# the shapes the d = 2304 main path gives the kernels (b = 256, 9 panels):
# panel_trsm gets the full-height (d, b) slab, panel_update the trailing
# (d, d − o − b) slab, widest at the first panel and narrowest at the last;
# then d = 6144 and ragged
TRSM_SHAPES = [(2304, 256), (1000, 200)]
UPDATE_SHAPES = [(2304, 2048, 256), (2304, 256, 256), (6144, 5888, 256), (1000, 777, 200)]
FACTOR_WIDTHS = [256, 200]


def _rel(a, b) -> float:
    """Largest error relative to the largest entry of ``b``."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _spd_block(gen, b):
    """SPD (b, b) = XᵀX / 4b from 4b normal rows: condition number ≈ 9."""
    x = torch.randn((4 * b, b), generator=gen, device="cuda")
    return x.T @ x / (4 * b)


def _slab(gen, rows, cols, width):
    """A (rows, cols) column slab of a (rows, width) matrix, as the
    schedule hands the kernels slabs of its work matrix."""
    work = torch.randn((rows, width), generator=gen, device="cuda")
    return work[:, width - cols:]


def _kernel_row(name, shape, err, rel, ms, plain_ms, library_ms, flops, nbytes, note="",
                dtype=torch.float32):
    bound_ms, bound_by = _bound(flops, nbytes, dtype)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    dt = str(dtype).removeprefix("torch.")
    log(f"{name} {shape} {dt}: max|err|={err:.3e} (relative {rel:.2e}) kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib}, bound {bound_ms:.5f} ms ({bound_by}; "
        f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB) = {100 * bound_ms / ms:.2f}% "
        f"of bound{note}")
    return dict(shape=list(shape), dtype=dt, max_abs_err=err, rel_err=rel, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, bytes=nbytes)


# The times of the earlier designs of the kernels and paths that were
# redesigned onto tri_blocked.cuh, the panel schedules and gemm_nt.cuh
# (PERF.md §6 and §5: chip_smoke.py, NVIDIA H100 80GB HBM3 at 700.00 W),
# logged beside this run's: panel_tri_inv, panel_factor, blocked_cholesky
# and the streamed solves before their move onto tri_blocked.cuh (the
# streamed factor's profiled span and its panel_factor part); cholesky_solve,
# multi_gamma_solve, the sweeps and the narrow solves before the solve's
# and the sweep's move onto grids over all SMs; panel_trsm and
# panel_update on tile_gemm.cuh's loop; gram_update on that loop over both
# triangles of G; flash_attention as one 64-row tile for every regime
EARLIER_MS = {("gram_update", (64, 2304, 16), "float32"): 0.0359,
           ("gram_update", (8192, 2304, 16), "float32"): 3.3555,
           ("flash_attention", "serve prefill, local"): 4.1803,
           ("flash_attention", "serve prefill, global"): 5.5774,
           ("flash_attention", "serve decode, local"): 0.1328,
           ("flash_attention", "serve decode, global"): 0.2563,
           ("flash_attention", "trainer forward"): 0.1150,
           "train_s": 12.539, "prefill_s": 2.935, "decode_ms_per_token": 63.67,
           "decode_step_flash_ms": 7.36,
           ("panel_tri_inv", 256, "float32"): 0.3376, ("panel_tri_inv", 128, "float64"): 0.1209,
           ("panel_factor", 256, "float32"): 0.6935, ("panel_factor", 128, "float64"): 0.2328,
           ("streamed_factor", 2304, "float32"): (6.4195, 5.5564),
           ("streamed_factor", 2304, "float64"): (8.5145, 3.9926),
           ("streamed_factor", 6144, "float32"): (24.1273, 15.9952),
           ("panel_trsm", (2304, 256), "float32"): 0.0240,
           ("panel_trsm", (2304, 128), "float64"): 0.0215,
           ("panel_update", (2304, 2048, 256), "float32"): 0.0965,
           ("panel_update", (6144, 5888, 256), "float32"): 0.6848,
           ("panel_update", (2304, 2176, 128), "float64"): 0.1555,
           ("blocked_cholesky", 1536, "float32"): 16.616,
           ("blocked_cholesky", 128, "float32"): 0.2376,
           ("blocked_cholesky", 1536, "float64"): 27.9598,
           ("cholesky_solve", 1536, "float32"): 3.0586,
           ("cholesky_solve", 1536, "float64"): 3.8067,
           ("multi_gamma_solve", 2304, "float32"): 59.1287,
           ("multi_gamma_solve", 2304, "float64"): 96.7480,
           "device_solve": 11.19, "f64_solve": 10.02, "sweep": 61.98, "f64_sweep": 98.81,
           "narrow_1536": 4.37, "f64_narrow_1536": 5.75}


def _merge_levels(b: int) -> int:
    """Merge levels of invert_blocked on a b-wide block: log2 of its
    32-wide sub-blocks, rounded up."""
    return max(0, math.ceil(math.log2(-(-b // 32))))


def _factor_design(b: int, dtype) -> str:
    """panel_factor's design at width b, for a kernel row's note, with the
    column loops' time before it where PERF.md has one."""
    subs = -(-b // 32)
    dt = str(dtype).removeprefix("torch.")
    before = EARLIER_MS.get(("panel_factor", b, dt))
    return (f"blocked factor with a look-ahead ({subs} sub-panels of 32, 3 barriers each) "
            f"then invert_blocked ({_merge_levels(b)} merge levels), one launch"
            + ("" if before is None else f"; the column loops before {before} ms"))


def panel_phase(P, ref):
    """Each panel kernel against its plain version at the path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    rows = {n: [] for n in ("panel_factor", "panel_tri_inv", "panel_trsm", "panel_update")}
    for b in FACTOR_WIDTHS:
        a = _spd_block(gen, b)
        l, z = P.panel_factor(a)
        zi = P.panel_tri_inv(l)
        l_ref, z_ref = ref.panel_factor_ref(a)
        l_twin, z_twin = ref.panel_factor_blocked_ref(a)
        zi_ref = ref.panel_tri_inv_ref(l)
        torch.cuda.synchronize()
        rel = max(_rel(l, l_ref), _rel(z, z_ref), _rel(l, l_twin), _rel(z, z_twin))
        rel_i = max(_rel(zi, zi_ref), _rel(zi, ref.invert_blocked_ref(l)))
        if rel > PANEL_REL or rel_i > PANEL_REL:
            fail(f"panel kernels at b={b}: relative error {rel:.2e} / {rel_i:.2e} "
                 f"above {PANEL_REL}")
        if any(torch.triu(t, 1).any() for t in (l, z, zi)):
            fail(f"panel kernels at b={b}: upper triangle is not exactly zero")
        tri = b * (b + 1) // 2
        eye = torch.eye(b, device="cuda")
        pair_ms = time_cuda(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(a), eye, upper=False))
        rows["panel_factor"].append(_kernel_row(
            "panel_factor", (b,), max(_abs(l, l_ref), _abs(z, z_ref)), rel,
            time_cuda(lambda: P.panel_factor(a)),
            time_cuda(lambda: ref.panel_factor_ref(a), reps=3, trials=3, warmup=1),
            None, 2 * b ** 3 / 3, 4 * (tri + 2 * b * b),
            f"; torch.linalg.cholesky + solve_triangular {pair_ms:.4f} ms; "
            f"{_factor_design(b, torch.float32)}"))
        rows["panel_factor"][-1]["pair_ms"] = pair_ms
        rows["panel_tri_inv"].append(_kernel_row(
            "panel_tri_inv", (b,), _abs(zi, zi_ref), rel_i,
            time_cuda(lambda: P.panel_tri_inv(l)),
            time_cuda(lambda: ref.panel_tri_inv_ref(l), reps=3, trials=3, warmup=1),
            time_cuda(lambda: torch.linalg.solve_triangular(l, eye, upper=False)),
            b ** 3 / 3, 4 * (tri + b * b),
            f"; invert_blocked, {_merge_levels(b)} merge levels; the row loop before "
            f"{EARLIER_MS.get(('panel_tri_inv', b, 'float32'), 'n/a')} ms"))
    # a block that is not positive definite: NaN, through kernel and plain
    x = torch.randn((3, PANEL_B), generator=gen, device="cuda")
    l, z = P.panel_factor(x.T @ x)
    l_ref, _ = ref.panel_factor_ref(x.T @ x)
    torch.cuda.synchronize()
    if not (torch.isnan(l).any() and torch.isnan(z).any() and torch.isnan(l_ref).any()):
        fail("panel_factor of a rank-3 block gave no NaN")
    log(f"panel_factor of a rank-3 ({PANEL_B}, {PANEL_B}) block: NaN in L "
        f"{int(torch.isnan(l).sum())} entries (plain {int(torch.isnan(l_ref).sum())}), "
        f"upper triangle zero: {not bool(torch.triu(l, 1).any())}")

    rtol, atol = GRAM_TOL[torch.float32]
    for r, b in TRSM_SHAPES:
        raw = _slab(gen, r, b, r)
        zinv = torch.tril(torch.randn((b, b), generator=gen, device="cuda"))
        out, want = P.panel_trsm(raw, zinv), ref.panel_trsm_ref(raw, zinv)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
        rows["panel_trsm"].append(_kernel_row(
            "panel_trsm", (r, b), _abs(out, want), _rel(out, want),
            time_cuda(lambda: P.panel_trsm(raw, zinv)),
            time_cuda(lambda: ref.panel_trsm_ref(raw, zinv)),
            time_cuda(lambda: torch.mm(raw, zinv.T)),
            # zinv is lower triangular: its b(b+1)/2 entries, r·b·(b+1) flops
            r * b * (b + 1), 4 * (2 * r * b + b * (b + 1) // 2), _earlier("panel_trsm", (r, b))))
    for r, w, b in UPDATE_SHAPES:
        trail = _slab(gen, r, w, w + b)
        lp = torch.randn((r, b), generator=gen, device="cuda")
        pt = torch.randn((w, b), generator=gen, device="cuda")
        want = ref.panel_update_ref(trail, lp, pt)
        out = P.panel_update(trail, lp, pt, out=trail)     # in place, as the path does
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
        rows["panel_update"].append(_kernel_row(
            "panel_update", (r, w, b), _abs(out, want), _rel(out, want),
            time_cuda(lambda: P.panel_update(trail, lp, pt, out=trail)),
            time_cuda(lambda: ref.panel_update_ref(trail, lp, pt, out=trail)),
            time_cuda(lambda: torch.addmm(trail, lp, pt.T, alpha=-1)),
            2 * r * w * b, 4 * (2 * r * w + r * b + w * b), _earlier("panel_update", (r, w, b))))
    return rows


def _earlier(name, shape, dtype=torch.float32) -> str:
    """The earlier time of a product row (on tile_gemm.cuh's loop), for the log."""
    t = EARLIER_MS.get((name, shape, str(dtype).removeprefix("torch.")))
    return "" if t is None else f"; tile_gemm.cuh's loop before {t} ms"


def streamed_products(S, P, dtype, d=2304):
    """The two products over one streamed factor at d: panel_trsm on the
    full-height (d, b) slab at each of the d/b panels, panel_update on each
    trailing (d, d − o − b) slab; each summed over the factor's calls,
    beside torch.mm / torch.addmm summed over the same shapes."""
    b = S.stream_block(dtype)
    n = d // b
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d + b)
    work = torch.randn((d, d), generator=gen, device="cuda").to(dtype)
    zinv = torch.tril(torch.randn((b, b), generator=gen, device="cuda")).to(dtype)
    lp = torch.randn((d, b), generator=gen, device="cuda").to(dtype)
    raw = work[:, :b]
    t_trsm = time_cuda(lambda: P.panel_trsm(raw, zinv))
    t_mm = time_cuda(lambda: torch.mm(raw, zinv.T))
    upd, lib = [], []
    for o in range(0, d - b, b):
        trail = work[:, o + b:]
        pt = work[o + b:, :b]
        upd.append(time_cuda(lambda: P.panel_update(trail, lp, pt, out=trail)))
        lib.append(time_cuda(lambda: torch.addmm(trail, lp, pt.T, alpha=-1)))
    out = dict(dtype=str(dtype).removeprefix("torch."), d=d, b=b, trsm_calls=n,
               trsm_ms=n * t_trsm, trsm_library_ms=n * t_mm, update_calls=len(upd),
               update_ms=sum(upd), update_library_ms=sum(lib),
               update_widths=[d - o - b for o in range(0, d - b, b)],
               update_each_ms=upd, update_each_library_ms=lib)
    log(f"one streamed factor at d={d} {out['dtype']} (b = {b}): panel_trsm {n} x "
        f"{t_trsm:.4f} = {out['trsm_ms']:.4f} ms (torch.mm {out['trsm_library_ms']:.4f}); "
        f"panel_update over widths {out['update_widths'][0]}..{out['update_widths'][-1]}: "
        f"{len(upd)} calls, {out['update_ms']:.4f} ms (torch.addmm {out['update_library_ms']:.4f})")
    return out


# the streamed factor's kernels, as the profiler names them: panel_factor's
# kernel, then the two products by their epilogue (panel_trsm stores the
# product, panel_update subtracts it from T)
FACTOR_PARTS = ("factor_kernel", "StoreProduct", "SubtractFrom")


def factor_profiles(S):
    """One streamed factor under torch.profiler at d = 2304 (f32 and f64)
    and d = 6144 (f32): device milliseconds in panel_factor, panel_trsm,
    panel_update and the rest, and the idle share of the span."""
    out = []
    for d, dtype in ((2304, torch.float32), (2304, torch.float64), (6144, torch.float32)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(d)
        x = torch.randn((4 * d, d), generator=gen, device="cuda")
        a = (x.T @ x / (4 * d)).to(dtype)
        del x
        prof = kernel_breakdown(lambda: S.streamed_cholesky(a), FACTOR_PARTS)
        dt = str(dtype).removeprefix("torch.")
        span, pf = EARLIER_MS[("streamed_factor", d, dt)]
        what = (f"streamed factor d={d} {dt}, one call profiled (before: span {span} ms, "
                f"panel_factor {pf} ms on the column loops)")
        _log_breakdown(what, prof, dict(zip(FACTOR_PARTS, ("panel_factor", "panel_trsm",
                                                          "panel_update"))))
        out.append(dict(d=d, dtype=dt, profile=prof))
    return out


STREAM_D = 6144     # nemotron4_15b's and grok1's d_model
STREAM_C = 16
STREAM_REL = 1e-4   # tests/test_distributed_cholesky.py:66-73


def time_wall(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` to a synchronised end."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def streamed_phase(S, P):
    """One SPD system at d = 6144 factored and solved by the kernel route
    and by the plain route on the card."""
    d = STREAM_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6144)
    x = torch.randn((4 * d, d), generator=gen, device="cuda")
    a = x.T @ x / (4 * d)                 # condition number ≈ 9
    del x
    rhs = torch.randn((d, STREAM_C), generator=gen, device="cuda")
    counts = [f.launches for f in (P.panel_factor, P.panel_trsm, P.panel_update,
                                   P.panel_tri_inv)]
    l_k = S.streamed_cholesky(a)
    x_k = S.streamed_cholesky_solve(l_k, rhs)
    torch.cuda.synchronize()
    n = d // PANEL_B
    got = [f.launches - c for f, c in zip((P.panel_factor, P.panel_trsm, P.panel_update,
                                           P.panel_tri_inv), counts)]
    if got != [n, n, n - 1, n]:
        fail(f"streamed factor and solve at d={d} launched {got}, expected "
             f"{[n, n, n - 1, n]}")
    l_p = S.streamed_cholesky(a, use_kernel=False)
    x_p = S.streamed_cholesky_solve(l_p, rhs, use_kernel=False)
    x_64 = torch.linalg.solve(a.double(), rhs.double())
    rel_l, rel_x = _rel(l_k, l_p), _rel(x_k, x_p)
    log(f"streamed d={d}: kernel vs plain route on the card, relative L {rel_l:.2e}, "
        f"x {rel_x:.2e} (limit {STREAM_REL}); vs an f64 solve: kernel "
        f"{_rel(x_k, x_64):.2e}, plain {_rel(x_p, x_64):.2e}; launches "
        f"{dict(zip(('factor', 'trsm', 'update', 'tri_inv'), got))}")
    if not (rel_l < STREAM_REL and rel_x < STREAM_REL):
        fail(f"streamed d={d}: kernel route differs from the plain route")
    if torch.triu(l_k, 1).any() or not torch.isfinite(l_k).all():
        fail(f"streamed d={d}: the factor is not a clean finite lower triangle")
    bad = a.clone()
    bad[d // 2, d // 2] = -1.0            # indefinite, first seen at panel 12
    l_bad = S.streamed_cholesky(bad)
    x_bad = S.streamed_cholesky_solve(l_bad, rhs)
    torch.cuda.synchronize()
    if torch.isfinite(l_bad).all() or torch.isfinite(x_bad).all():
        fail("an indefinite system came back finite through the kernels")
    log(f"streamed d={d}: indefinite system through the kernels gives NaN in "
        f"{int(torch.isnan(l_bad).sum())} entries of L and {int(torch.isnan(x_bad).sum())} of x")

    ms_f = time_wall(lambda: S.streamed_cholesky(a), reps=5)
    ms_s = time_wall(lambda: S.streamed_cholesky_solve(l_k, rhs), reps=5)
    plain_f = time_wall(lambda: S.streamed_cholesky(a, use_kernel=False), reps=1)
    plain_s = time_wall(lambda: S.streamed_cholesky_solve(l_p, rhs, use_kernel=False), reps=1)
    lib_f = time_wall(lambda: torch.linalg.cholesky(a), reps=5)
    l_lib = torch.linalg.cholesky(a)
    lib_s = time_wall(lambda: torch.cholesky_solve(rhs, l_lib), reps=5)
    need = d ** 3 / 3
    done = sum(2 * d * PANEL_B * PANEL_B + 2 * d * (d - o - PANEL_B) * PANEL_B
               for o in range(0, d, PANEL_B))
    bound_ms, bound_by = _bound(need, 4 * 2 * d * d)
    log(f"streamed d={d}: factor kernel route {ms_f:.2f} ms, plain route {plain_f:.1f} ms, "
        f"torch.linalg.cholesky {lib_f:.2f} ms; solve (C={STREAM_C}) kernel route "
        f"{ms_s:.2f} ms, plain {plain_s:.1f} ms, torch.cholesky_solve {lib_s:.3f} ms; "
        f"factor bound {bound_ms:.3f} ms ({bound_by}: the d³/3 = {need / 1e9:.1f} GFLOP "
        f"a factor needs; the schedule does {done / 1e9:.1f} GFLOP in its products) = "
        f"{100 * bound_ms / ms_f:.2f}% of bound")
    return dict(d=d, rel_l=rel_l, rel_x=rel_x, factor_ms=ms_f, solve_ms=ms_s,
                plain_factor_ms=plain_f, plain_solve_ms=plain_s, library_factor_ms=lib_f,
                library_solve_ms=lib_s, bound_ms=bound_ms, schedule_gflop=done / 1e9)


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


def slice_phase(K, get_config, D, T, train, FLConfig, api):
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
    # one forward per batch: the train set's, then the test set's
    forwards = expected + len(te) // SLICE["batch"]
    fl = FLConfig(gamma=1.0)
    server = api.AFLServer(cfg.d_model, cfg.num_classes, gamma=fl.gamma)
    torch.cuda.reset_peak_memory_stats()
    _zero(K)
    t0 = time.perf_counter()
    acc, train_s = train.run_analytic(cfg, tr, te, fl, SLICE["batch"],
                                      use_kernel=True, device="cuda", params=params,
                                      coordinator=server)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(K)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"gram_update": expected, "flash_attention": cfg.num_layers * forwards}
    fa_cuda = K.FA.flash_attention.cuda_launches
    log(f"slice: run_analytic acc={acc:.4f} train_s={train_s:.3f} (before: "
        f"{EARLIER_MS['train_s']}) wall_s={wall:.3f} "
        f"gram_update launches={launches['gram_update']} (expected {expected}) "
        f"flash_attention launches={launches['flash_attention']} (expected "
        f"{cfg.num_layers} layers x {forwards} forwards = {want['flash_attention']}), "
        f"{fa_cuda} CUDA launches (one each: the short tile) peak_mem={peak:.2f} GB")
    _only(launches, want, "run_analytic")
    if fa_cuda != want["flash_attention"]:
        fail(f"run_analytic: flash_attention made {fa_cuda} CUDA launches, expected "
             f"{want['flash_attention']}")
    launches["flash_attention_cuda"] = fa_cuda
    if not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
        fail(f"accuracy {acc} is not a fraction")
    x_te = slice_checks(cfg, params, tr, te, server, acc, train, fl, api)
    return (launches, server, x_te, te.y[:len(x_te)],
            SimpleNamespace(cfg=cfg, params=params, tr=tr, te=te))


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
    return x_te


# the device solve of the slice's aggregate: γ = ρ·tr(G)/d at these ρ, and
# test accuracy equal to the host's within one test sample where the f32
# system is well enough conditioned (ρ ≥ 1e-2)
DEVICE_RHOS = (1e-4, 1e-2, 1.0)
DEVICE_ACC_RHOS = (1e-2, 1.0)
F32_U = 2.0 ** -24
# weights relative to the largest weight of the reference: against the
# plain route on the card (the same f32 system, sums in another order) at
# most DEVICE_PLAIN_REL; against the host's f64 weight (which also sees the
# f32 rounding of G) at most DEVICE_HOST_KU·κ·u
DEVICE_PLAIN_REL = 1e-4
DEVICE_HOST_KU = 10.0


def _card_stats(server, engine):
    """A server's aggregate: the raw Gram and the moment in host f64, and
    the same statistics in f32 on the card."""
    state = server.state()
    g = np.array(state["gram"], np.float64)
    np.fill_diagonal(g, state["gram_diag_raw"])      # raw Gram: no kγI
    q = np.array(state["moment"], np.float64)
    dev = torch.device("cuda")
    stats = engine.SuffStats(
        gram=torch.tensor(g, dtype=torch.float32, device=dev),
        moment=torch.tensor(q, dtype=torch.float32, device=dev),
        count=torch.tensor(float(state["count"]), device=dev),
        clients=torch.tensor(float(len(state["seen"])), device=dev))
    return g, q, stats


def _zero(K):
    for f in K.ALL.values():
        f.launches = 0
    K.FA.flash_attention.cuda_launches = 0


def _read(K) -> dict:
    return {name: f.launches for name, f in K.ALL.items()}


def _only(launches: dict, want: dict, what: str) -> None:
    """Fails unless the path launched exactly ``want`` (and nothing else)."""
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected:
        fail(f"{what} launched {launches}, expected {expected}")


def device_solve_phase(K, S, engine, api, server, x_te, y_te):
    """The slice's aggregate (raw Gram and moment, host f64) moved to the
    card as f32 statistics and solved through the panel kernels."""
    P = K.P
    g, q, stats = _card_stats(server, engine)
    d = g.shape[0]
    eng = engine.AnalyticEngine("torch", device="cuda", use_kernel=True)
    kernels = (P.panel_factor, P.panel_trsm, P.panel_update, P.panel_tri_inv)
    n = -(-d // PANEL_B)
    expected = [n, n, n - 1, n]
    scale = float(np.trace(g)) / d
    gammas = [rho * scale for rho in DEVICE_RHOS]
    weights, per_solve = [], []
    _zero(K)
    for gamma in gammas:
        before = [f.launches for f in kernels]
        weights.append(eng.solve(stats, target_gamma=gamma))
        torch.cuda.synchronize()
        per_solve.append([f.launches - b for f, b in zip(kernels, before)])
    launches = _read(K)
    log(f"device solve d={d}: panel launches per factor and solve {per_solve} "
        f"(expected {expected} each: factor, trsm, update, tri_inv)")
    if any(c != expected for c in per_solve):
        fail(f"device solves launched {per_solve}, expected {expected} each")
    _only(launches, {f.__name__: 3 * e for f, e in zip(kernels, expected)}, "device solves")

    evals = np.linalg.eigvalsh(g)
    for rho, gamma, w in zip(DEVICE_RHOS, gammas, weights):
        cond = float((evals[-1] + gamma) / (evals[0] + gamma))
        a = stats.gram + eng.backend.scalar(gamma) * eng.backend.eye(d)
        w_plain = S.streamed_cholesky_solve(S.streamed_cholesky(a, use_kernel=False),
                                            stats.moment, use_kernel=False)
        w_host = server.solve(target_gamma=gamma)
        w_cpu = w.double().cpu()
        rel_plain = _rel(w, w_plain)
        rel_host = _rel(w_cpu, torch.from_numpy(w_host))
        ku = cond * F32_U
        acc_card = api.evaluate_weight(w_cpu.numpy(), x_te, y_te)
        acc_host = api.evaluate_weight(w_host, x_te, y_te)
        log(f"device solve ρ={rho:g} (γ={gamma:.4g}, condition number {cond:.3e}, "
            f"max|w| {float(np.abs(w_host).max()):.3e}): relative to the largest "
            f"weight, card vs plain route on the card {rel_plain:.2e} (limit "
            f"{DEVICE_PLAIN_REL:g}), vs host f64 {rel_host:.2e} = {rel_host / ku:.3f}·κ·u "
            f"(limit {DEVICE_HOST_KU:g}·κ·u = {DEVICE_HOST_KU * ku:.2e}); accuracy card "
            f"{acc_card:.4f} host {acc_host:.4f}")
        if not torch.isfinite(w).all():
            fail(f"device solve at ρ={rho} is not finite")
        if rel_plain > DEVICE_PLAIN_REL:
            fail(f"device solve at ρ={rho}: {rel_plain:.2e} from the plain route")
        if rel_host > DEVICE_HOST_KU * ku:
            fail(f"device solve at ρ={rho}: {rel_host:.2e} from the host's f64 weight, "
                 f"more than {DEVICE_HOST_KU:g}·κ·u")
        if rho in DEVICE_ACC_RHOS and abs(acc_card - acc_host) * len(y_te) > 1:
            fail(f"device solve at ρ={rho}: accuracy {acc_card} on the card vs "
                 f"{acc_host} on the host")

    # what one solve costs (after the counted run): the kernel route, the
    # library's Cholesky on the card, and the host's f64 LAPACK solve
    gamma = gammas[-1]
    a = stats.gram + eng.backend.scalar(gamma) * eng.backend.eye(d)
    ms_card = time_wall(lambda: eng.solve(stats, target_gamma=gamma), reps=5)
    ms_lib = time_wall(lambda: torch.cholesky_solve(stats.moment, torch.linalg.cholesky(a)),
                       reps=5)
    host = engine.AnalyticEngine("numpy_f64")
    host_stats = engine.SuffStats(g, q, 0.0, 1.0)
    t_host = []
    for _ in range(3):
        t0 = time.perf_counter()
        host.solve(host_stats, target_gamma=gamma)
        t_host.append(1e3 * (time.perf_counter() - t0))
    log(f"device solve d={d} (factor and solve, C={stats.moment.shape[1]}): kernel route "
        f"{ms_card:.2f} ms (before: {EARLIER_MS['device_solve']} ms), torch.linalg.cholesky + cholesky_solve {ms_lib:.2f} ms on "
        f"the card; host f64 (numpy, {os.cpu_count()} cores) "
        f"{statistics.median(t_host):.1f} ms")
    return launches


# --- the blocked kernels and the rank update: kernel phase ---------------------

# each kernel against its plain version (the reference's algorithm in torch,
# on the card): relative 1e-4 of the largest entry, PANEL_REL's bar
BLOCKED_REL = 1e-4
# the path's shapes first (the narrow solves' d = 1536 and 128, the sweep
# and the rank update of the d = 2304 aggregate), then ragged ones
FACTOR_SHAPES = [(1, 1536), (1, 128), (3, 130)]           # (m, d)
SOLVE_SHAPES = [(1, 1536, 16), (1, 128, 40)]              # (m, d, c)
SWEEP_SHAPES = [(2304, 16, 16), (130, 7, 11)]             # (d, c, n_g)
RANK_SHAPES = [(2304, 64), (2304, 144), (130, 3)]         # (d, k); 144 = d//16


# blocked_cholesky's three kernels, as the profiler names them; the solve's
# inverse grid and the two steps of its substitutions (forward_ and
# backward_ each); the sweep's factor and substitutions
BLOCKED_PARTS = ("chol_diag_kernel", "chol_trsm_kernel", "chol_trailing_kernel")
SOLVE_PARTS = ("solve_inverse_kernel", "_apply_kernel", "_update_kernel")
SWEEP_PARTS = BLOCKED_PARTS + SOLVE_PARTS[1:]


def time_auto(fn) -> float:
    """Median device milliseconds per call of ``fn``, queueing as many calls
    per trial as fit in about 50 ms (one for calls of a second or more)."""
    t = time_wall(fn, reps=1)
    reps = max(1, min(50, int(50.0 / max(t, 1e-3))))
    trials = 1 if t > 1000 else 3 if t > 5 else 7
    return time_cuda(fn, reps=reps, trials=trials, warmup=1)


def _tri(d: int) -> int:
    return d * (d + 1) // 2


def _check_close(name, shape, got, want) -> float:
    rel = _rel(got, want)
    if not rel <= BLOCKED_REL:
        fail(f"{name} {shape}: relative error {rel:.2e} against the plain version, "
             f"above {BLOCKED_REL}")
    return rel


def blocked_phase(K, ref):
    """blocked_cholesky, cholesky_solve, multi_gamma_solve and
    chol_rank_update against their plain versions at the path's shapes."""
    B, R = K.B, K.R
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = {n: [] for n in ("blocked_cholesky", "cholesky_solve", "multi_gamma_solve",
                            "chol_rank_update")}
    for m, d in FACTOR_SHAPES:
        a = torch.stack([_spd_block(gen, d) for _ in range(m)])
        l, want = B.blocked_cholesky(a), ref.blocked_cholesky_ref(a)
        torch.cuda.synchronize()
        rel = _check_close("blocked_cholesky", (m, d), l, want)
        if torch.triu(l, 1).any() or not torch.isfinite(l).all():
            fail(f"blocked_cholesky {(m, d)}: not a clean finite lower triangle")
        if not torch.equal(B.blocked_cholesky(a), l):
            fail(f"blocked_cholesky {(m, d)}: a repeated call gave other bits")
        rows["blocked_cholesky"].append(_kernel_row(
            "blocked_cholesky", (m, d), _abs(l, want), rel,
            time_auto(lambda: B.blocked_cholesky(a)),
            time_auto(lambda: ref.blocked_cholesky_ref(a)),
            time_auto(lambda: torch.linalg.cholesky(a)),
            m * d ** 3 / 3, 4 * m * (_tri(d) + d * d),
            f"; library torch.linalg.cholesky; {B.cuda_launches(d)} CUDA launches a call; "
            f"the one-block kernel before "
            f"{EARLIER_MS.get(('blocked_cholesky', d, 'float32'), 'n/a')} ms"))
        if d == NARROW_WIDE_D:
            rows["blocked_cholesky"][-1]["profile"] = prof = kernel_breakdown(
                lambda: B.blocked_cholesky(a), BLOCKED_PARTS)
            _log_breakdown(f"blocked_cholesky {(m, d)} float32, one call profiled", prof)
    x = torch.randn((3, 200), generator=gen, device="cuda")
    a = torch.stack([_spd_block(gen, 200), x.T @ x])      # PD, then rank 3
    l, want = B.blocked_cholesky(a), ref.blocked_cholesky_ref(a)
    torch.cuda.synchronize()
    if not (torch.isfinite(l[0]).all() and torch.isnan(l[1]).any()
            and torch.isnan(want[1]).any()) or torch.triu(l, 1).any():
        fail("blocked_cholesky of a PD and a rank-3 system: NaN not confined to the "
             "second, or the upper triangle not zero")
    log(f"blocked_cholesky of a PD and a rank-3 (200, 200) system: the first finite "
        f"(relative {_rel(l[0], want[0]):.2e} from plain), NaN in {int(torch.isnan(l[1]).sum())} "
        f"entries of the second (plain {int(torch.isnan(want[1]).sum())})")

    for m, d, c in SOLVE_SHAPES:
        l = ref.blocked_cholesky_ref(torch.stack([_spd_block(gen, d) for _ in range(m)]))
        b = torch.randn((m, d, c), generator=gen, device="cuda")
        x, want = B.cholesky_solve(l, b), ref.cholesky_solve_ref(l, b)
        torch.cuda.synchronize()
        rel = _check_close("cholesky_solve", (m, d, c), x, want)
        _check_close("cholesky_solve against its right-looking twin", (m, d, c), x,
                     ref.solve_right_looking_ref(l, b))
        if not torch.equal(B.cholesky_solve(l, b), x):
            fail(f"cholesky_solve {(m, d, c)}: a repeated call gave other bits")
        rows["cholesky_solve"].append(_kernel_row(
            "cholesky_solve", (m, d, c), _abs(x, want), rel,
            time_auto(lambda: B.cholesky_solve(l, b)),
            time_auto(lambda: ref.cholesky_solve_ref(l, b)),
            time_auto(lambda: torch.cholesky_solve(b, l)),
            2 * m * d * d * c, 4 * m * (_tri(d) + 2 * d * c),
            f"; library torch.cholesky_solve; {B.solve_cuda_launches(d)} CUDA launches a "
            f"call; the one-block kernel before "
            f"{EARLIER_MS.get(('cholesky_solve', d, 'float32'), 'n/a')} ms"))
        if d == NARROW_WIDE_D:
            rows["cholesky_solve"][-1]["profile"] = prof = kernel_breakdown(
                lambda: B.cholesky_solve(l, b), SOLVE_PARTS)
            _log_breakdown(f"cholesky_solve {(m, d, c)} float32, one call profiled", prof)

    for d, c, n_g in SWEEP_SHAPES:
        a = _spd_block(gen, d)
        q = torch.randn((d, c), generator=gen, device="cuda")
        gammas = torch.logspace(-4, 0, n_g, device="cuda") * torch.trace(a) / d
        eye = torch.eye(d, device="cuda")

        def library(a=a, q=q, gammas=gammas, eye=eye, d=d, c=c, n_g=n_g):
            l = torch.linalg.cholesky(a + gammas[:, None, None] * eye)
            return torch.cholesky_solve(q.expand(n_g, d, c), l)

        def plain(a=a, q=q, gammas=gammas):
            return ref.multi_gamma_solve_ref(a, q, gammas)

        w, want = B.multi_gamma_solve(a, q, gammas), plain()
        torch.cuda.synchronize()
        rel = max(_check_close("multi_gamma_solve", (d, c, n_g), w[j], want[j])
                  for j in range(n_g))
        twin = ref.multi_gamma_blocked_ref(a, q, gammas)
        for j in range(n_g):
            _check_close("multi_gamma_solve against its blocked twin", (d, c, n_g), w[j], twin[j])
        if not torch.equal(B.multi_gamma_solve(a, q, gammas), w):
            fail(f"multi_gamma_solve {(d, c, n_g)}: a repeated call gave other bits")
        rows["multi_gamma_solve"].append(_kernel_row(
            "multi_gamma_solve", (d, c, n_g), _abs(w, want), rel,
            time_auto(lambda: B.multi_gamma_solve(a, q, gammas)), time_auto(plain),
            time_auto(library), n_g * (d ** 3 / 3 + 2 * d * d * c),
            4 * (_tri(d) + d * c + n_g + n_g * d * c),
            f"; library batched torch.linalg.cholesky + torch.cholesky_solve; "
            f"{B.sweep_cuda_launches(d)} CUDA launches a call; the one-block kernel before "
            f"{EARLIER_MS.get(('multi_gamma_solve', d, 'float32'), 'n/a')} ms"))
        if d == 2304:
            rows["multi_gamma_solve"][-1]["profile"] = prof = kernel_breakdown(
                lambda: B.multi_gamma_solve(a, q, gammas), SWEEP_PARTS)
            _log_breakdown(f"multi_gamma_solve {(d, c, n_g)} float32, one call profiled", prof)
    x = torch.randn((5, 64), generator=gen, device="cuda")
    w = B.multi_gamma_solve(x.T @ x, torch.randn((64, 3), generator=gen, device="cuda"),
                            torch.tensor([0.0, 1.0], device="cuda"))
    torch.cuda.synchronize()
    if torch.isfinite(w[0]).all() or not torch.isfinite(w[1]).all():
        fail("multi_gamma_solve on a rank-5 (64, 64) C: γ = 0 is not NaN, or γ = 1 is not "
             "finite")
    log(f"multi_gamma_solve on a rank-5 (64, 64) C: NaN in {int(torch.isnan(w[0]).sum())} "
        f"of {w[0].numel()} weights at γ = 0, none at γ = 1")

    for d, k in RANK_SHAPES:
        l = torch.linalg.cholesky(_spd_block(gen, d)).contiguous()   # cuSOLVER's is column-major
        xs = torch.randn((k, d), generator=gen, device="cuda")
        out, want = R.chol_rank_update(l, xs), ref.chol_rank_update_ref(l, xs)
        torch.cuda.synchronize()
        rel = _check_close("chol_rank_update", (d, k), out, want)
        if torch.triu(out, 1).any() or not torch.isfinite(out).all():
            fail(f"chol_rank_update {(d, k)}: not a clean finite lower triangle")
        rows["chol_rank_update"].append(_kernel_row(
            "chol_rank_update", (d, k), _abs(out, want), rel,
            time_auto(lambda: R.chol_rank_update(l, xs)),
            time_auto(lambda: ref.chol_rank_update_ref(l, xs)),
            time_auto(lambda: torch.linalg.cholesky(l @ l.T + xs.T @ xs)),
            2 * k * d * d, 4 * (2 * d * d + k * d),
            f"; library torch.linalg.cholesky(L·Lᵀ + xsᵀ·xs); {d} sequential columns in "
            f"{-(-d // R.NB)} panels, {R.cuda_launches(d, k)} CUDA launches a call"))
        if d >= 2048:
            rows["chol_rank_update"][-1]["profile"] = prof = kernel_breakdown(
                lambda: R.chol_rank_update(l, xs),
                ("panel_kernel", "trailing_kernel", "transpose_kernel"))
            _log_breakdown(f"chol_rank_update {(d, k)} float32, one call profiled", prof)
    return rows


def kernel_breakdown(fn, parts) -> dict:
    """One call of ``fn`` under torch.profiler: device milliseconds and
    launches by part (the first of ``parts`` each kernel's name contains,
    else "other"), the span from the first kernel's start to the last one's
    end, and the share of that span no kernel ran. None where the profiler
    saw no device activity."""
    fn()
    _, spans = _device_spans(fn)
    if not spans:
        return None
    by = {}
    for start, end, name in spans:
        part = next((p for p in parts if p in name), "other")
        ms, n = by.get(part, (0.0, 0))
        by[part] = (ms + (end - start) / 1e3, n + 1)
    span = (spans[-1][1] - spans[0][0]) / 1e3
    return dict(by=by, span_ms=span, idle_share=1 - _busy_ms(spans) / span)


def _log_breakdown(what, r, names=None) -> None:
    if r is None:
        log(f"{what}: the profiler saw no device activity (not measured)")
        return
    names = names or {}
    parts = ", ".join(f"{names.get(p, p)} {ms:.4f} ms in {n} ({1e3 * ms / n:.2f} us each)"
                      for p, (ms, n) in r["by"].items())
    log(f"{what}: device span {r['span_ms']:.4f} ms (idle share {r['idle_share']:.3f}); {parts}")


# --- the f64 instances of the solve-side kernels: kernel phase -------------------

# each f64 instance against its plain version in f64 on the same inputs:
# relative 1e-10 of the largest entry, the reference's x64 bar for its
# kernel solves (tests/test_solve_kernels.py); bound at the f64 peak
F64_REL = 1e-10
F64_PANEL_B = 128        # the f64 panel kernels' width (panel.MAX_PANEL)


def f64_kernel_phase(K, ref):
    """Every solve-side kernel's f64 instance at the shape its f64 main path
    gives it, against its f64 plain version, timed beside it, the f64
    library call and the bound. Rows join each kernel's table."""
    P, B, R = K.P, K.B, K.R
    f64 = torch.float64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(64)
    rows = {}

    def check(name, shape, got, want):
        rel = _rel(got, want)
        if not rel <= F64_REL or not torch.isfinite(got).all():
            fail(f"{name} {shape} float64: relative error {rel:.2e} against the plain "
                 f"version, above {F64_REL}")
        return rel

    def add(name, shape, got, want, kernel, plain, library, flops, nbytes, note=""):
        rel = check(name, shape, got, want)
        rows.setdefault(name, []).append(_kernel_row(
            name, shape, _abs(got, want), rel, time_auto(kernel), time_auto(plain),
            None if library is None else time_auto(library), flops, nbytes, note, f64))

    b = F64_PANEL_B
    a = _spd_block(gen, b).double()
    l, z = P.panel_factor(a)
    l_ref, z_ref = ref.panel_factor_ref(a)
    l_twin, z_twin = ref.panel_factor_blocked_ref(a)
    torch.cuda.synchronize()
    check("panel_factor", (b,), l, l_ref)
    check("panel_factor against the blocked twin", (b,), l, l_twin)
    check("panel_factor's inverse against the blocked twin", (b,), z, z_twin)
    tri, eye = b * (b + 1) // 2, torch.eye(b, device="cuda", dtype=f64)
    pair_ms = time_auto(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky(a), eye, upper=False))
    add("panel_factor", (b,), z, z_ref, lambda: P.panel_factor(a),
        lambda: ref.panel_factor_ref(a), None, 2 * b ** 3 / 3, 8 * (tri + 2 * b * b),
        f"; torch.linalg.cholesky + solve_triangular {pair_ms:.4f} ms; {_factor_design(b, f64)}")
    rows["panel_factor"][-1]["pair_ms"] = pair_ms
    zi = P.panel_tri_inv(l)
    check("panel_tri_inv against the blocked twin", (b,), zi, ref.invert_blocked_ref(l))
    add("panel_tri_inv", (b,), zi, ref.panel_tri_inv_ref(l),
        lambda: P.panel_tri_inv(l), lambda: ref.panel_tri_inv_ref(l),
        lambda: torch.linalg.solve_triangular(l, eye, upper=False), b ** 3 / 3,
        8 * (tri + b * b), f"; invert_blocked, {_merge_levels(b)} merge levels; the row loop "
        f"before {EARLIER_MS[('panel_tri_inv', b, 'float64')]} ms")
    d = 2304
    raw = _slab(gen, d, b, d).double()
    zinv = torch.tril(torch.randn((b, b), generator=gen, device="cuda")).double()
    add("panel_trsm", (d, b), P.panel_trsm(raw, zinv), ref.panel_trsm_ref(raw, zinv),
        lambda: P.panel_trsm(raw, zinv), lambda: ref.panel_trsm_ref(raw, zinv),
        lambda: torch.mm(raw, zinv.T), d * b * (b + 1), 8 * (2 * d * b + tri),
        _earlier("panel_trsm", (d, b), f64))
    # the f64 path's widest and narrowest trailing updates (first and last panel)
    for w in (d - b, b):
        trail = _slab(gen, d, w, w + b).double()
        lp = torch.randn((d, b), generator=gen, device="cuda").double()
        pt = torch.randn((w, b), generator=gen, device="cuda").double()
        add("panel_update", (d, w, b), P.panel_update(trail, lp, pt),
            ref.panel_update_ref(trail, lp, pt), lambda: P.panel_update(trail, lp, pt, out=trail),
            lambda: ref.panel_update_ref(trail, lp, pt, out=trail),
            lambda: torch.addmm(trail, lp, pt.T, alpha=-1), 2 * d * w * b,
            8 * (2 * d * w + d * b + w * b), _earlier("panel_update", (d, w, b), f64))

    n = NARROW_WIDE_D
    a = _spd_block(gen, n).double()[None]
    add("blocked_cholesky", (1, n), B.blocked_cholesky(a), ref.blocked_cholesky_ref(a),
        lambda: B.blocked_cholesky(a), lambda: ref.blocked_cholesky_ref(a),
        lambda: torch.linalg.cholesky(a), n ** 3 / 3, 8 * (_tri(n) + n * n),
        f"; {B.cuda_launches(n)} CUDA launches a call; the one-block kernel "
        f"before {EARLIER_MS[('blocked_cholesky', n, 'float64')]} ms")
    l = ref.blocked_cholesky_ref(a)
    rhs = torch.randn((1, n, NARROW_C), generator=gen, device="cuda").double()
    add("cholesky_solve", (1, n, NARROW_C), B.cholesky_solve(l, rhs),
        ref.cholesky_solve_ref(l, rhs), lambda: B.cholesky_solve(l, rhs),
        lambda: ref.cholesky_solve_ref(l, rhs), lambda: torch.cholesky_solve(rhs, l),
        2 * n * n * NARROW_C, 8 * (_tri(n) + 2 * n * NARROW_C),
        f"; {B.solve_cuda_launches(n)} CUDA launches a call; the one-block kernel before "
        f"{EARLIER_MS[('cholesky_solve', n, 'float64')]} ms")
    c, n_g = 16, 16
    a = _spd_block(gen, d).double()
    q = torch.randn((d, c), generator=gen, device="cuda").double()
    gammas = torch.logspace(-4, 0, n_g, device="cuda", dtype=f64) * torch.trace(a) / d
    eye = torch.eye(d, device="cuda", dtype=f64)
    add("multi_gamma_solve", (d, c, n_g), B.multi_gamma_solve(a, q, gammas),
        ref.multi_gamma_solve_ref(a, q, gammas), lambda: B.multi_gamma_solve(a, q, gammas),
        lambda: ref.multi_gamma_solve_ref(a, q, gammas),
        lambda: torch.cholesky_solve(q.expand(n_g, d, c),
                                     torch.linalg.cholesky(a + gammas[:, None, None] * eye)),
        n_g * (d ** 3 / 3 + 2 * d * d * c), 8 * (_tri(d) + d * c + n_g + n_g * d * c),
        f"; {B.sweep_cuda_launches(d)} CUDA launches a call; the one-block kernel before "
        f"{EARLIER_MS[('multi_gamma_solve', d, 'float64')]} ms")
    k = STRAGGLER_ROWS
    l = torch.linalg.cholesky(a).contiguous()
    xs = torch.randn((k, d), generator=gen, device="cuda").double()
    add("chol_rank_update", (d, k), R.chol_rank_update(l, xs),
        ref.chol_rank_update_ref(l, xs), lambda: R.chol_rank_update(l, xs),
        lambda: ref.chol_rank_update_ref(l, xs),
        lambda: torch.linalg.cholesky(l @ l.T + xs.T @ xs), 2 * k * d * d,
        8 * (2 * d * d + k * d), f"; {R.cuda_launches(d, k)} CUDA launches a call")
    rows["chol_rank_update"][-1]["profile"] = prof = kernel_breakdown(
        lambda: R.chol_rank_update(l, xs), ("panel_kernel", "trailing_kernel", "transpose_kernel"))
    _log_breakdown(f"chol_rank_update {(d, k)} float64, one call profiled", prof)
    return rows


# --- the γ sweep of the slice's aggregate ---------------------------------------

SWEEP_RHOS = np.logspace(-4, 0, 16)      # γ = ρ·tr(G)/d
SWEEP_ACC_RHO = 1e-2                     # equal accuracy from here up, as DEVICE_ACC_RHOS
# a rank-deficient aggregate: one client with half as many rows as d
RANKDEF_ROWS = 1152
# pinv cutoff for that grid, on the card and the host alike: above the f32
# eigenvalues' rounding (at most about d·u = 1.4e-4 of the largest) and
# below the smallest nonzero eigenvalue (about 1/34 of the largest for
# 1152 normal rows in 2304 dimensions)
RANKDEF_RCOND = 1e-3


def _counted_eigh(eng) -> list:
    """Counts the eigendecompositions of ``eng``'s backend: the sweep's
    fallback route."""
    calls = [0]
    eigh = eng.backend.eigh

    def counted(a):
        calls[0] += 1
        return eigh(a)

    eng.backend.eigh = counted
    return calls


def sweep_phase(K, ref, S, engine, api, server, x_te, y_te):
    """The slice's aggregate through ``solve_multi_gamma`` at 16 ridges,
    then γ = 0 on a rank-deficient aggregate."""
    g, q, stats = _card_stats(server, engine)
    d, c = q.shape
    eng = engine.AnalyticEngine("torch", device="cuda", use_kernel=True)
    eighs = _counted_eigh(eng)
    scale = float(np.trace(g)) / d
    gammas = [float(rho * scale) for rho in SWEEP_RHOS]
    _zero(K)
    t0 = time.perf_counter()
    ws = eng.solve_multi_gamma(stats, gammas)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = _read(K)
    log(f"sweep d={d} C={c}: {len(gammas)} ridges in {wall:.1f} ms (with the host's "
        f"trust check), launches {launches}, eigendecompositions {eighs[0]}")
    _only(launches, {"multi_gamma_solve": 1}, "the sweep")
    if eighs[0]:
        fail("the sweep fell back to the eigendecomposition")
    plain = ref.multi_gamma_solve_ref(stats.gram, stats.moment,
                                      torch.tensor(gammas, device="cuda"))
    host = server.solve_multi_gamma(gammas)
    evals = np.linalg.eigvalsh(g)
    worst = [0.0, 0.0]
    for rho, gamma, w, w_p, w_h in zip(SWEEP_RHOS, gammas, ws, plain, host):
        cond = float((evals[-1] + gamma) / (evals[0] + gamma))
        ku = cond * F32_U
        rel_plain = _rel(w, w_p)
        rel_host = _rel(w.double().cpu(), torch.from_numpy(w_h))
        acc_card = api.evaluate_weight(w.double().cpu().numpy(), x_te, y_te)
        acc_host = api.evaluate_weight(w_h, x_te, y_te)
        worst = [max(worst[0], rel_plain), max(worst[1], rel_host / ku)]
        log(f"sweep ρ={rho:.3g} (γ={gamma:.4g}, κ={cond:.3e}): card vs plain route "
            f"{rel_plain:.2e} (limit {DEVICE_PLAIN_REL:g}), vs host f64 {rel_host:.2e} = "
            f"{rel_host / ku:.3f}·κ·u (limit {DEVICE_HOST_KU:g}·κ·u); accuracy card "
            f"{acc_card:.4f} host {acc_host:.4f}")
        if not torch.isfinite(w).all() or rel_plain > DEVICE_PLAIN_REL:
            fail(f"sweep at ρ={rho:.3g}: {rel_plain:.2e} from the plain route")
        if rel_host > DEVICE_HOST_KU * ku:
            fail(f"sweep at ρ={rho:.3g}: {rel_host:.2e} from the host's f64 weight, more "
                 f"than {DEVICE_HOST_KU:g}·κ·u")
        if rho >= SWEEP_ACC_RHO and abs(acc_card - acc_host) * len(y_te) > 1:
            fail(f"sweep at ρ={rho:.3g}: accuracy {acc_card} on the card vs {acc_host}")
    ms_card = time_wall(lambda: eng.solve_multi_gamma(stats, gammas), reps=3)
    ms_fused = time_wall(lambda: S.multi_gamma_solve(stats.gram, stats.moment, gammas), reps=3)
    eye = torch.eye(d, device="cuda")
    gt = torch.tensor(gammas, device="cuda")
    ms_lib = time_wall(lambda: torch.cholesky_solve(
        stats.moment.expand(len(gammas), d, c),
        torch.linalg.cholesky(stats.gram + gt[:, None, None] * eye)), reps=3)
    t_host = []
    for _ in range(2):
        fresh = api.AFLServer.from_state(server.state())
        t1 = time.perf_counter()
        fresh.solve_multi_gamma(gammas)
        t_host.append(1e3 * (time.perf_counter() - t1))
    log(f"sweep d={d}, {len(gammas)} ridges: engine kernel route {ms_card:.2f} ms "
        f"(before: {EARLIER_MS['sweep']} ms; multi_gamma_solve alone {ms_fused:.2f} ms), "
        f"batched torch.linalg.cholesky + "
        f"cholesky_solve {ms_lib:.2f} ms on the card; host f64 eigendecomposition sweep "
        f"(AFLServer, {os.cpu_count()} cores) {statistics.median(t_host):.1f} ms; worst "
        f"card vs plain {worst[0]:.2e}, vs host {worst[1]:.3f}·κ·u")

    # γ = 0 on a rank-deficient aggregate: the kernel cannot answer it
    rng = np.random.default_rng(RANKDEF_ROWS)
    xr = rng.standard_normal((RANKDEF_ROWS, d))
    yr = np.eye(c)[rng.integers(0, c, RANKDEF_ROWS)]
    host_eng = engine.AnalyticEngine("numpy_f64")
    hs = host_eng.client_stats(xr, yr)
    cs = engine.SuffStats(*(torch.tensor(np.asarray(v, np.float64), dtype=torch.float32,
                                         device="cuda") for v in hs[:4]))
    scale_r = float(np.trace(hs.gram)) / d
    grid = [0.0, 1e-2 * scale_r, scale_r]
    eighs[0] = 0
    _zero(K)
    ws = eng.solve_multi_gamma(cs, grid, rcond=RANKDEF_RCOND)
    torch.cuda.synchronize()
    fallback = _read(K)
    _only(fallback, {"multi_gamma_solve": 1}, "the rank-deficient sweep")
    if eighs[0] != 1:
        fail(f"the rank-deficient sweep ran {eighs[0]} eigendecompositions, expected 1")
    fused = S.multi_gamma_solve(cs.gram, cs.moment, grid)
    want = host_eng.solve_multi_gamma(hs, grid, rcond=RANKDEF_RCOND)
    evals = np.linalg.eigvalsh(hs.gram)
    nonzero = evals[evals > RANKDEF_RCOND * evals[-1]]
    for gamma, w, w_f, w_h in zip(grid, ws, fused, want):
        cond = float((evals[-1] + gamma) / (nonzero[0] + gamma))
        rel = _rel(w.double().cpu(), torch.from_numpy(w_h))
        limit = d * cond * F32_U
        log(f"rank-deficient sweep (N={RANKDEF_ROWS} < d={d}, rank {len(nonzero)}) γ={gamma:.4g}: "
            f"the kernel's weights {'finite' if torch.isfinite(w_f).all() else 'NaN'} "
            f"({int(torch.isnan(w_f).sum())} NaN), answered by the eigendecomposition: "
            f"vs host pinv {rel:.2e} = {rel / (cond * F32_U):.2f}·κ·u with κ={cond:.3g} over "
            f"the kept spectrum (limit d·κ·u = {limit:.2e}, the f32 eigendecomposition's "
            f"backward error)")
        if not torch.isfinite(w).all() or rel > limit:
            fail(f"rank-deficient sweep at γ={gamma:.4g}: {rel:.2e} from the host's pinv "
                 "answer")
    return {name: launches[name] + fallback[name] for name in launches}


# --- narrow systems: the blocked factor and solve --------------------------------

NARROW_FEATURES = dict(n=8000, dim=128, num_classes=40, separation=0.45, seed=0)
NARROW_WIDE_D = 1536     # granite_moe_3b_a800m's d_model, the widest below 2048
NARROW_C = 16


def _narrow_solves(K, eng, stats, what):
    """``solve`` and ``factor`` + ``factor_solve`` of one system: one
    blocked_cholesky and one cholesky_solve launch each."""
    _zero(K)
    w = eng.solve(stats)
    f = eng.factor(stats)
    w2 = eng.factor_solve(f, stats.moment)
    torch.cuda.synchronize()
    launches = _read(K)
    _only(launches, {"blocked_cholesky": 2, "cholesky_solve": 2}, what)
    if not torch.equal(w, w2):
        fail(f"{what}: solve and factor + factor_solve differ")
    return w, f, launches


def narrow_phase(K, ref, engine, api, D):
    """The paper tables' feature configuration (d = 128) and a seeded system
    at d = 1536 through the engine's narrow route."""
    ds = D.gaussian_mixture(**NARROW_FEATURES)
    tr, te = D.train_test_split(ds, 0.25, seed=0)
    c = NARROW_FEATURES["num_classes"]
    host = engine.AnalyticEngine("numpy_f64")
    hs = host.client_stats(tr.x.astype(np.float64), np.eye(c)[tr.y])
    cs = engine.SuffStats(*(torch.tensor(np.asarray(v, np.float64), dtype=torch.float32,
                                         device="cuda") for v in hs[:4]))
    eng = engine.AnalyticEngine("torch", device="cuda", use_kernel=True)
    w, _, launches = _narrow_solves(K, eng, cs, "the d = 128 feature solve")
    w_host = host.solve(hs)
    evals = np.linalg.eigvalsh(hs.gram)
    cond = float(evals[-1] / evals[0])
    rel = _rel(w.double().cpu(), torch.from_numpy(w_host))
    acc_card = api.evaluate_weight(w.double().cpu().numpy(), te.x, te.y)
    acc_host = api.evaluate_weight(w_host, te.x, te.y)
    log(f"narrow d={hs.dim} (gaussian_mixture {NARROW_FEATURES}, {len(tr)} train / "
        f"{len(te)} test): launches {launches}; vs host f64 {rel:.2e} = "
        f"{rel / (cond * F32_U):.3f}·κ·u with κ={cond:.3g} (limit {DEVICE_HOST_KU:g}·κ·u); "
        f"accuracy card {acc_card:.4f} host {acc_host:.4f}")
    if rel > DEVICE_HOST_KU * cond * F32_U:
        fail(f"narrow d={hs.dim}: {rel:.2e} from the host's f64 weight")
    if acc_card != acc_host:
        fail(f"narrow d={hs.dim}: accuracy {acc_card} on the card vs {acc_host} on the host")

    d = NARROW_WIDE_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    a = _spd_block(gen, d)
    rhs = torch.randn((d, NARROW_C), generator=gen, device="cuda")
    one = torch.tensor(1.0, device="cuda")
    stats = engine.SuffStats(a, rhs, one, one)
    w, f, more = _narrow_solves(K, eng, stats, f"the d = {d} solve")
    w_plain = ref.cholesky_solve_ref(ref.blocked_cholesky_ref(a[None]), rhs[None])[0]
    w_64 = torch.linalg.solve(a.double(), rhs.double())
    evals = torch.linalg.eigvalsh(a.double())
    cond = float(evals[-1] / evals[0])
    rel_plain, rel_64 = _rel(w, w_plain), _rel(w, w_64)
    ms_card = time_wall(lambda: eng.solve(stats), reps=5)
    ms_lib = time_wall(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(a)), reps=5)
    log(f"narrow d={d} C={NARROW_C} (XᵀX/4d, κ={cond:.3g}): launches {more}; card vs plain "
        f"route {rel_plain:.2e} (limit {DEVICE_PLAIN_REL:g}), vs f64 {rel_64:.2e} = "
        f"{rel_64 / (cond * F32_U):.2f}·κ·u (limit {DEVICE_HOST_KU:g}·κ·u); factor and solve "
        f"{ms_card:.2f} ms on the kernel route (before: {EARLIER_MS['narrow_1536']} ms), "
        f"torch.linalg.cholesky + cholesky_solve "
        f"{ms_lib:.3f} ms")
    if rel_plain > DEVICE_PLAIN_REL or rel_64 > DEVICE_HOST_KU * cond * F32_U:
        fail(f"narrow d={d}: {rel_plain:.2e} from the plain route, {rel_64:.2e} from f64")
    if torch.triu(f.handle, 1).any():
        fail(f"narrow d={d}: the factor's upper triangle is not zero")
    return {name: launches[name] + more[name] for name in launches}


# --- a straggler folded into the cached factor -----------------------------------

STRAGGLER_ROWS = 64
RANK_RHO = 1e-2          # the factor's ridge γ = ρ·tr(G)/d


def _straggler(api, server, x_te, y_te, fl, c):
    """A straggler's report of STRAGGLER_ROWS held-out pooled embeddings
    (folded on the card), and a copy of ``server`` that has merged it."""
    dev = torch.device("cuda")
    emb = torch.tensor(x_te[:STRAGGLER_ROWS], dtype=torch.float32, device=dev)
    onehot = F.one_hot(torch.as_tensor(y_te[:STRAGGLER_ROWS], device=dev), c).float()
    report = api.AFLClient(10_000, gamma=fl.gamma, backend="torch", device=dev,
                           use_kernel=True).update(emb, onehot).report()
    merged_server = api.AFLServer.from_state(server.state())
    merged_server.submit(report)
    return report, merged_server


def rank_update_phase(K, engine, api, server, x_te, y_te, fl):
    """Factor the slice's aggregate on the card, then fold a straggler's
    64-row root into the factor with one chol_rank_update launch."""
    g, _, stats = _card_stats(server, engine)
    d = g.shape[0]
    c = stats.moment.shape[1]
    eng = engine.AnalyticEngine("torch", device="cuda", use_kernel=True)
    gamma = RANK_RHO * float(np.trace(g)) / d
    fact = eng.factor(stats, target_gamma=gamma)              # the panel kernels
    dev = torch.device("cuda")
    report, merged_server = _straggler(api, server, x_te, y_te, fl, c)
    g_m, q_m, merged = _card_stats(merged_server, engine)
    root = torch.tensor(report.root, dtype=torch.float32, device=dev)
    _zero(K)
    t0 = time.perf_counter()
    updated = eng.factor_update(fact, merged, root, target_gamma=gamma)
    torch.cuda.synchronize()
    ms_update = 1e3 * (time.perf_counter() - t0)
    launches = _read(K)
    _only(launches, {"chol_rank_update": 1}, "the factor update")
    refactor = eng.factor(merged, target_gamma=gamma)
    a_m = g_m + gamma * np.eye(d)
    evals = np.linalg.eigvalsh(a_m)
    cond = float(evals[-1] / evals[0])
    ku = cond * F32_U
    l_host = np.linalg.cholesky(a_m)
    w = eng.factor_solve(updated, merged.moment)
    w_host = engine.AnalyticEngine("numpy_f64").solve(
        engine.SuffStats(g_m, q_m, 0.0, 1.0), target_gamma=gamma)
    rel_re = _rel(updated.handle, refactor.handle)
    rel_l = _rel(updated.handle.double().cpu(), torch.from_numpy(l_host))
    rel_w = _rel(w.double().cpu(), torch.from_numpy(w_host))
    ms_re = time_wall(lambda: eng.factor(merged, target_gamma=gamma), reps=3)
    ms_fu = time_wall(lambda: eng.factor_update(fact, merged, root, target_gamma=gamma), reps=3)
    a_card = merged.gram + gamma * torch.eye(d, device=dev)
    ms_lib = time_wall(lambda: torch.linalg.cholesky(a_card), reps=3)
    log(f"rank update d={d}: a {root.shape[0]}-row root (report of {STRAGGLER_ROWS} held-out "
        f"pooled embeddings) at γ={gamma:.4g} (ρ={RANK_RHO:g}, κ={cond:.3e}): launches "
        f"{launches}, {ms_update:.2f} ms with the NaN check; updated L vs the kernel route's "
        f"refactor {rel_re:.2e} = {rel_re / ku:.3f}·κ·u, vs host f64 Cholesky {rel_l:.2e} = "
        f"{rel_l / ku:.3f}·κ·u; its factor_solve vs host f64 weight {rel_w:.2e} = "
        f"{rel_w / ku:.3f}·κ·u (limits {DEVICE_HOST_KU:g}·κ·u); factor_update again "
        f"{ms_fu:.2f} ms (median of 3), refactor on the card {ms_re:.2f} ms, "
        f"torch.linalg.cholesky {ms_lib:.2f} ms")
    if max(rel_re, rel_l, rel_w) > DEVICE_HOST_KU * ku:
        fail(f"rank update: {rel_re:.2e} / {rel_l:.2e} / {rel_w:.2e} from the refactor, the "
             "host factor and the host weight")
    if torch.triu(updated.handle, 1).any():
        fail("rank update: the updated factor's upper triangle is not zero")
    return launches


# --- the f64 device engine on the slice's aggregate ------------------------------

F64_U = 2.0 ** -53


def _f64_stats(server, engine):
    """A server's aggregate as f64 statistics on the card (raw Gram)."""
    g, q, stats = _card_stats(server, engine)
    dev = torch.device("cuda")
    return g, q, engine.SuffStats(torch.tensor(g, dtype=torch.float64, device=dev),
                                  torch.tensor(q, dtype=torch.float64, device=dev),
                                  stats.count.double(), stats.clients.double())


def _f64_check(what, rel, cond) -> str:
    if not rel <= DEVICE_HOST_KU * cond * F64_U:
        fail(f"f64 {what}: {rel:.2e} from numpy_f64, more than {DEVICE_HOST_KU:g}·κ·u64 "
             f"(κ={cond:.3e})")
    return (f"{rel:.2e} = {rel / (cond * F64_U):.3f}·κ·u64 (κ={cond:.3e}; limit "
            f"{DEVICE_HOST_KU:g}·κ·u64)")


def f64_engine_phase(K, S, engine, api, server, x_te, y_te, fl):
    """``AnalyticEngine("torch", dtype=torch.float64, use_kernel=True)`` on
    the card, each route counted from zero: the slice's aggregate solved
    through the streamed route at panels of 128, a narrow d = 1536 system,
    the γ sweep and a straggler's rank update; each held against the
    numpy_f64 engine within 10·κ·u64 and timed beside torch.linalg in f64."""
    f64 = torch.float64
    P = K.P
    g, q, stats = _f64_stats(server, engine)
    d, c = q.shape
    eng = engine.AnalyticEngine("torch", dtype=f64, device="cuda", use_kernel=True)
    host = engine.AnalyticEngine("numpy_f64")
    eighs = _counted_eigh(eng)
    evals = np.linalg.eigvalsh(g)
    scale = float(np.trace(g)) / d
    dev = torch.device("cuda")
    total = {name: 0 for name in K.ALL}

    def counted(fn, want, what):
        _zero(K)
        out = fn()
        torch.cuda.synchronize()
        got = _read(K)
        _only(got, want, what)
        for name in total:
            total[name] += got[name]
        return out

    # the streamed route at d = 2304: panels of STREAM_BLOCK_F64
    gamma = RANK_RHO * scale
    b = S.stream_block(f64)
    n = -(-d // b)
    w = counted(lambda: eng.solve(stats, target_gamma=gamma),
                {"panel_factor": n, "panel_trsm": n, "panel_update": n - 1,
                 "panel_tri_inv": n}, "the f64 streamed solve")
    cond = float((evals[-1] + gamma) / (evals[0] + gamma))
    rel = _rel(w.cpu(), torch.from_numpy(server.solve(target_gamma=gamma)))
    a = stats.gram + gamma * torch.eye(d, device=dev, dtype=f64)
    ms = time_wall(lambda: eng.solve(stats, target_gamma=gamma), reps=3)
    ms_lib = time_wall(lambda: torch.cholesky_solve(stats.moment, torch.linalg.cholesky(a)),
                       reps=3)
    log(f"f64 solve d={d} (streamed, panels of {b}: {n} / {n} / {n - 1} / {n} launches) at "
        f"ρ={RANK_RHO:g}: vs numpy_f64 {_f64_check('solve', rel, cond)}; kernel route "
        f"{ms:.2f} ms (before: {EARLIER_MS['f64_solve']} ms), torch.linalg.cholesky + cholesky_solve f64 {ms_lib:.2f} ms")
    times = dict(solve_ms=ms, solve_library_ms=ms_lib, solve_rel=rel)

    # a narrow system: d = 1536 through blocked_cholesky and cholesky_solve
    nd = NARROW_WIDE_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(nd + 64)
    an = _spd_block(gen, nd).double()
    rhs = torch.randn((nd, NARROW_C), generator=gen, device="cuda").double()
    one = torch.tensor(1.0, device=dev, dtype=f64)
    sn = engine.SuffStats(an, rhs, one, one)
    wn = counted(lambda: eng.solve(sn), {"blocked_cholesky": 1, "cholesky_solve": 1},
                 f"the f64 d = {nd} solve")
    an_h, rhs_h = an.cpu().numpy(), rhs.cpu().numpy()
    w_h = host.solve(engine.SuffStats(an_h, rhs_h, 1.0, 1.0))
    ev = np.linalg.eigvalsh(an_h)
    rel = _rel(wn.cpu(), torch.from_numpy(w_h))
    ms = time_wall(lambda: eng.solve(sn), reps=3)
    ms_lib = time_wall(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(an)), reps=3)
    log(f"f64 narrow d={nd}: vs numpy_f64 {_f64_check('narrow solve', rel, ev[-1] / ev[0])}; "
        f"kernel route {ms:.2f} ms (before: {EARLIER_MS['f64_narrow_1536']} ms), "
        f"torch.linalg.cholesky + cholesky_solve f64 {ms_lib:.3f} ms")
    times.update(narrow_ms=ms, narrow_library_ms=ms_lib, narrow_rel=rel)

    # the γ sweep: one multi_gamma_solve launch, no eigendecomposition
    gammas = [float(rho * scale) for rho in SWEEP_RHOS]
    ws = counted(lambda: eng.solve_multi_gamma(stats, gammas), {"multi_gamma_solve": 1},
                 "the f64 sweep")
    if eighs[0]:
        fail("the f64 sweep fell back to the eigendecomposition")
    worst = 0.0
    for rho, gm, wg, wh in zip(SWEEP_RHOS, gammas, ws, server.solve_multi_gamma(gammas)):
        cond = float((evals[-1] + gm) / (evals[0] + gm))
        rel = _rel(wg.cpu(), torch.from_numpy(wh))
        worst = max(worst, rel / (cond * F64_U))
        log(f"f64 sweep ρ={rho:.3g}: vs numpy_f64 {_f64_check(f'sweep at ρ={rho:.3g}', rel, cond)}")
    gt = torch.tensor(gammas, device=dev, dtype=f64)
    eye = torch.eye(d, device=dev, dtype=f64)
    ms = time_wall(lambda: eng.solve_multi_gamma(stats, gammas), reps=2)
    ms_lib = time_wall(lambda: torch.cholesky_solve(
        stats.moment.expand(len(gammas), d, c),
        torch.linalg.cholesky(stats.gram + gt[:, None, None] * eye)), reps=2)
    log(f"f64 sweep d={d}, {len(gammas)} ridges: engine kernel route {ms:.2f} ms (before: "
        f"{EARLIER_MS['f64_sweep']} ms), batched "
        f"torch.linalg.cholesky + cholesky_solve f64 {ms_lib:.2f} ms; worst {worst:.3f}·κ·u64")
    times.update(sweep_ms=ms, sweep_library_ms=ms_lib, sweep_worst_ku=worst)

    # a straggler folded into the cached f64 factor: one chol_rank_update call
    fact = eng.factor(stats, target_gamma=gamma)
    report, merged_server = _straggler(api, server, x_te, y_te, fl, c)
    g_m, q_m, merged = _f64_stats(merged_server, engine)
    root = torch.tensor(report.root, dtype=f64, device=dev)
    t0 = time.perf_counter()
    updated = counted(lambda: eng.factor_update(fact, merged, root, target_gamma=gamma),
                      {"chol_rank_update": 1}, "the f64 factor update")
    ms_update = 1e3 * (time.perf_counter() - t0)
    # the numpy_f64 engine folds the same root into its own factor: the
    # root's f32 rounding (rootᵀroot against the report's Gram) is common
    # to both, and not the kernel's error
    stats_h = engine.SuffStats(g, q, 0.0, 1.0)
    merged_h = engine.SuffStats(g_m, q_m, 0.0, 1.0)
    f_h = host.factor_update(host.factor(stats_h, target_gamma=gamma), merged_h,
                             np.asarray(report.root, np.float64), target_gamma=gamma)
    ev = np.linalg.eigvalsh(g_m + gamma * np.eye(d))
    cond = float(ev[-1] / ev[0])
    rel_l = _rel(updated.handle.cpu(), torch.from_numpy(np.asarray(f_h.handle).T))
    w_u = eng.factor_solve(updated, merged.moment)
    rel_w = _rel(w_u.cpu(), torch.from_numpy(host.factor_solve(f_h, q_m)))
    if torch.triu(updated.handle, 1).any():
        fail("f64 rank update: the updated factor's upper triangle is not zero")
    ms_re = time_wall(lambda: eng.factor(merged, target_gamma=gamma), reps=3)
    ms_fu = time_wall(lambda: eng.factor_update(fact, merged, root, target_gamma=gamma), reps=3)
    a_card = merged.gram + gamma * eye
    ms_lib = time_wall(lambda: torch.linalg.cholesky(a_card), reps=3)
    log(f"f64 rank update d={d}, a {root.shape[0]}-row root: {ms_update:.2f} ms with the NaN "
        f"check; updated L vs numpy_f64's update {_f64_check('rank update L', rel_l, cond)}; "
        f"its factor_solve vs numpy_f64 {_f64_check('rank update weight', rel_w, cond)}; "
        f"factor_update again {ms_fu:.2f} ms (median of 3), refactor on the card "
        f"{ms_re:.2f} ms, torch.linalg.cholesky f64 {ms_lib:.2f} ms")
    times.update(update_ms=ms_update, update_again_ms=ms_fu, refactor_ms=ms_re,
                 cholesky_library_ms=ms_lib, update_rel_l=rel_l, update_rel_w=rel_w)
    log(f"f64 engine: launches {total}")
    return total, times


# --- the paper's single round: fl/afl.run_afl and core/streaming ----------------

# Table 1's partitions at K = 100 and Figure 2's largest K (about 3 rows a
# client, far below d): (K, scheme, options)
PAPER_SETTINGS = [
    (100, "iid", {}),
    (100, "niid1", dict(alpha=0.1)),
    (100, "niid2", dict(shards_per_client=2)),
    (1000, "niid1", dict(alpha=0.1)),
]
PAPER_BACKBONE = (100, "niid1", dict(alpha=0.1))    # run_afl's own embedding branch
PAPER_KU = 10.0          # AFL weight vs the joint solve: within 10·κ·u64
DEVICE_ROUND_K = 16      # the device round: NIID-1 α = 0.1 over 16 clients
# merged device Gram vs host f64 XᵀX, relative Frobenius: f32 accumulation
# over 3072 rows is about √N·u32 ≈ 3e-6
DEVICE_GRAM_REL = 1e-5


class _TimedCoordinator:
    """An ``AFLServer`` whose submits and solves are timed on the host clock
    (``run_afl`` takes any object with ``dim``, ``gamma``, ``submit`` and
    ``solve``)."""

    def __init__(self, server):
        self.server, self.submit_s, self.solve_s = server, 0.0, 0.0
        self.dim, self.gamma = server.dim, server.gamma

    def submit(self, report):
        t0 = time.perf_counter()
        out = self.server.submit(report)
        self.submit_s += time.perf_counter() - t0
        return out

    def solve(self, target_gamma=0.0):
        t0 = time.perf_counter()
        out = self.server.solve(target_gamma=target_gamma)
        self.solve_s += time.perf_counter() - t0
        return out


def _fro(a, b) -> float:
    """‖a − b‖_F / ‖b‖_F."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _add_launches(total: dict, K) -> None:
    for name, n in _read(K).items():
        total[name] = total.get(name, 0) + n
    total["flash_attention_cuda"] = (total.get("flash_attention_cuda", 0)
                                     + K.FA.flash_attention.cuda_launches)


def paper_round_phase(K, sl, train, afl, partition, streaming, ST, api, D, FLConfig):
    """The paper's single round on the card's embeddings of the slice's data
    (full-width minicpm_2b): Table 1's partitions and Figure 2's K = 1000
    through ``run_afl`` against the joint solve, ``run_afl`` with the
    backbone itself, and the same round on the card through
    ``make_analytic_train_step`` and ``core.streaming`` (K = 16)."""
    cfg, params, tr, te = sl.cfg, sl.params, sl.tr, sl.te
    d, c, batch = cfg.d_model, cfg.num_classes, SLICE["batch"]
    total = {}

    def backbone(tokens):
        """The port's pooled forward on the card, ``batch`` rows a forward
        (the slice's grouping, whatever ``run_afl`` hands it)."""
        return torch.cat([train.embed(params, cfg, tokens[i:i + batch])
                          for i in range(0, len(tokens), batch)])

    # 1. embeddings of the train and test sets, counted over exactly that call
    forwards = -(-len(tr) // batch) + -(-len(te) // batch)
    _zero(K)
    t0 = time.perf_counter()
    x_tr = afl.embed_with_backbone(backbone, tr.x)
    x_te = afl.embed_with_backbone(backbone, te.x)
    embed_s = time.perf_counter() - t0
    got = _read(K)
    _only(got, {"flash_attention": cfg.num_layers * forwards}, "the paper round's embeddings")
    _add_launches(total, K)
    log(f"paper round: embedded {len(tr)} train + {len(te)} test rows on the card in "
        f"{embed_s:.3f} s, {forwards} forwards, flash_attention launches "
        f"{got['flash_attention']} (expected {cfg.num_layers} x {forwards})")
    if x_tr.shape != (len(tr), d) or not np.isfinite(x_tr).all() \
            or not np.isfinite(x_te).all():
        fail(f"paper round: embeddings {x_tr.shape} not finite or not ({len(tr)}, {d})")
    ds_tr, ds_te = D.Dataset(x_tr, tr.y, c), D.Dataset(x_te, te.y, c)
    x64 = x_tr.astype(np.float64)
    y64 = np.eye(c)[tr.y]
    gram, moment = x64.T @ x64, x64.T @ y64
    evals = np.linalg.eigvalsh(gram)
    kappa = float(evals[-1] / evals[0]) if evals[0] > 0 else math.inf
    case = ("the host Gram is positive definite: each weight held within "
            f"{PAPER_KU:g}·κ·u64 and on accuracy" if math.isfinite(kappa) else
            "the host Gram is singular (κ = ∞): accuracy held only")
    t0 = time.perf_counter()
    w_joint, acc_joint = afl.joint_ridge(ds_tr, ds_te, gamma=0.0)
    joint_s = time.perf_counter() - t0
    log(f"paper round: host Gram d={d} eigenvalues [{evals[0]:.4e}, {evals[-1]:.4e}], "
        f"κ={kappa:.4e}; {case}; joint ridge (γ=0) acc={acc_joint:.4f} in {joint_s:.3f} s")

    # 2. Table 1's partitions and Figure 2's K = 1000 on those embeddings
    settings, servers = [], {}
    for k, scheme, kw in PAPER_SETTINGS:
        fl = FLConfig(num_clients=k, gamma=1.0, partition=scheme, **kw)
        coord = _TimedCoordinator(api.AFLServer(d, c, gamma=fl.gamma))
        t0 = time.perf_counter()
        res = afl.run_afl(ds_tr, ds_te, fl, coordinator=coord)
        wall = time.perf_counter() - t0
        rel = float(np.abs(res.weight - w_joint).max() / np.abs(w_joint).max())
        sizes = np.array(res.client_sizes)
        row = dict(K=k, partition=scheme, **kw, accuracy=res.accuracy,
                   rel_to_joint=rel, rel_to_joint_ku=(rel / (kappa * F64_U)
                                                      if math.isfinite(kappa) else None),
                   train_seconds=res.train_seconds, wall_s=wall,
                   local_stages_s=res.train_seconds - coord.submit_s - coord.solve_s,
                   submits_s=coord.submit_s, solve_s=coord.solve_s,
                   rows_min=int(sizes.min()), rows_median=float(np.median(sizes)),
                   rows_max=int(sizes.max()), empty_clients=int((sizes == 0).sum()))
        settings.append(row)
        servers[(k, scheme)] = coord.server
        opts = "".join(f" {n}={v}" for n, v in kw.items())
        log(f"paper round: run_afl K={k} {scheme}{opts}: acc={res.accuracy:.4f} "
            f"(joint {acc_joint:.4f}); weight vs joint {rel:.3e} relative"
            + (f" = {row['rel_to_joint_ku']:.4f}·κ·u64" if math.isfinite(kappa) else "")
            + f"; train_seconds={res.train_seconds:.3f} (local stages and partition "
            f"{row['local_stages_s']:.3f}, submits {coord.submit_s:.3f}, solve "
            f"{coord.solve_s:.3f}); rows a client min {row['rows_min']} median "
            f"{row['rows_median']:g} max {row['rows_max']}, {row['empty_clients']} empty")
        if res.accuracy != acc_joint:
            fail(f"run_afl K={k} {scheme}: accuracy {res.accuracy} != the joint "
                 f"solve's {acc_joint}")
        if math.isfinite(kappa) and not rel <= PAPER_KU * kappa * F64_U:
            fail(f"run_afl K={k} {scheme}: weight {rel:.3e} from the joint solve, more "
                 f"than {PAPER_KU:g}·κ·u64 = {PAPER_KU * kappa * F64_U:.3e}")

    # 3. run_afl's own embedding branch, the backbone on the card
    k, scheme, kw = PAPER_BACKBONE
    _zero(K)
    res = afl.run_afl(tr, te, FLConfig(num_clients=k, gamma=1.0, partition=scheme, **kw),
                      backbone_fn=backbone)
    got = _read(K)
    _only(got, {"flash_attention": cfg.num_layers * forwards}, "run_afl(backbone_fn=…)")
    _add_launches(total, K)
    same = next(s for s in settings if (s["K"], s["partition"]) == (k, scheme))
    w_same = servers[(k, scheme)].solve(target_gamma=0.0)
    backbone_rel = float(np.abs(res.weight - w_same).max() / np.abs(w_same).max())
    log(f"paper round: run_afl(backbone_fn=…) K={k} {scheme}: acc={res.accuracy:.4f} "
        f"(step 2: {same['accuracy']:.4f}), weight vs step 2's {backbone_rel:.3e} relative, "
        f"train_seconds={res.train_seconds:.3f} with the embedding, flash_attention "
        f"launches {got['flash_attention']}")
    if res.accuracy != same["accuracy"]:
        fail(f"run_afl(backbone_fn=…) accuracy {res.accuracy} != {same['accuracy']} on "
             "the same embeddings")

    # 4. the device round: K = 16 clients, each an AnalyticState on the card
    parts = partition.make_partition(tr.y, DEVICE_ROUND_K, "niid1", alpha=0.1, seed=0)
    step = ST.make_analytic_train_step(cfg, use_kernel=True)
    batches = sum(-(-len(p) // batch) for p in parts)
    _zero(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = []
    for idx in parts:
        s = streaming.init_state(d, c, device="cuda")
        for i in range(0, len(idx), batch):
            rows = idx[i:i + batch]
            s = step(params, s, {"tokens": tr.x[rows], "labels": tr.y[rows]})
        states.append(s)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    got = _read(K)
    _only(got, {"gram_update": batches, "flash_attention": cfg.num_layers * batches},
          "the device round's fold")
    _add_launches(total, K)
    _zero(K)
    t0 = time.perf_counter()
    merged = states[0]
    for s in states[1:]:
        merged = streaming.merge_states(merged, s)
    torch.cuda.synchronize()
    merge_ms = 1e3 * (time.perf_counter() - t0)
    reverse = states[-1]
    for s in states[-2::-1]:
        reverse = streaming.merge_states(reverse, s)
    g_dev = merged.gram.double().cpu().numpy()
    gram_rel = _fro(g_dev, gram)
    gram_rel_rev = _fro(reverse.gram.double().cpu().numpy(), gram)
    order_rel = _fro(reverse.gram.double().cpu().numpy(), g_dev)
    moment_rel = _fro(merged.moment.double().cpu().numpy(), moment)
    sizes = [len(p) for p in parts]
    log(f"paper round: device round K={DEVICE_ROUND_K} niid1 α=0.1 (rows a client "
        f"{sizes}): {batches} batches of at most {batch} folded in {fold_s:.3f} s, "
        f"gram_update launches {got['gram_update']} (expected Σ⌈n_k/{batch}⌉ = "
        f"{batches}), flash_attention {got['flash_attention']} (expected "
        f"{cfg.num_layers} x {batches}); {DEVICE_ROUND_K} states merged in "
        f"{merge_ms:.3f} ms; merged Gram vs host f64 XᵀX {gram_rel:.3e} relative "
        f"Frobenius (reverse order {gram_rel_rev:.3e}, the two orders {order_rel:.3e}; "
        f"limit {DEVICE_GRAM_REL:g}), moment {moment_rel:.3e}, count "
        f"{float(merged.count):g}")
    if float(merged.count) != len(tr):
        fail(f"device round: merged count {float(merged.count)} != {len(tr)}")
    if not max(gram_rel, gram_rel_rev) <= DEVICE_GRAM_REL:
        fail(f"device round: merged Gram {max(gram_rel, gram_rel_rev):.3e} from host "
             f"f64, more than {DEVICE_GRAM_REL:g}")

    host = servers[(k, scheme)]          # K = 100 NIID-1: the host f64 aggregate
    scale = float(np.trace(gram)) / d
    solves = []
    for rho in DEVICE_ACC_RHOS:
        gamma = rho * scale
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = streaming.solve(merged, gamma)
        torch.cuda.synchronize()
        solve_ms = 1e3 * (time.perf_counter() - t0)
        w = w.double().cpu().numpy()
        w_host = host.solve(target_gamma=gamma)
        w_own = np.linalg.solve(g_dev + gamma * np.eye(d),
                                merged.moment.double().cpu().numpy())
        cond = float((evals[-1] + gamma) / (evals[0] + gamma))
        ku = cond * F32_U
        rel = float(np.abs(w - w_host).max() / np.abs(w_host).max())
        rel_own = float(np.abs(w - w_own).max() / np.abs(w_own).max())
        acc, acc_host = (api.evaluate_weight(w, x_te, te.y),
                         api.evaluate_weight(w_host, x_te, te.y))
        solves.append(dict(rho=rho, gamma=gamma, kappa=cond, rel_host=rel,
                           rel_host_ku=rel / ku, rel_own_stats=rel_own,
                           accuracy=acc, accuracy_host=acc_host, solve_ms=solve_ms))
        log(f"paper round: streaming.solve ρ={rho:g} (γ={gamma:.4g}, κ={cond:.3e}) on the "
            f"card in {solve_ms:.2f} ms: vs the host server's f64 weight {rel:.3e} = "
            f"{rel / ku:.3f}·κ·u32 (limit {DEVICE_HOST_KU:g}·κ·u32), vs host f64 on the "
            f"card's own merged statistics {rel_own:.3e}; accuracy card {acc:.4f} host "
            f"{acc_host:.4f}")
        if not rel <= DEVICE_HOST_KU * ku:
            fail(f"streaming.solve at ρ={rho}: {rel:.3e} from the host's f64 weight, "
                 f"more than {DEVICE_HOST_KU:g}·κ·u32")
        if acc != acc_host:
            fail(f"streaming.solve at ρ={rho}: accuracy {acc} on the card vs {acc_host} "
                 "on the host")
    _only(_read(K), {}, "the device round's merges and solves (torch.linalg)")
    log(json.dumps({"paper_round": dict(
        arch=cfg.name, d=d, classes=c, train_rows=len(tr), test_rows=len(te),
        embed_s=embed_s, kappa=kappa if math.isfinite(kappa) else None,
        gram_case="positive definite" if math.isfinite(kappa) else "singular",
        joint_accuracy=acc_joint, joint_s=joint_s, settings=settings,
        backbone_run=dict(K=k, partition=scheme, accuracy=res.accuracy,
                          rel_to_step2=backbone_rel, train_seconds=res.train_seconds),
        device_round=dict(K=DEVICE_ROUND_K, client_rows=sizes, batches=batches,
                          fold_s=fold_s, merge_ms=merge_ms, gram_rel=gram_rel,
                          gram_rel_reverse=gram_rel_rev, order_rel=order_rel,
                          moment_rel=moment_rel, solves=solves),
        launches=total)}))
    return total


# --- flash attention: kernel phase ----------------------------------------------

# tests/test_kernels_attention.py's tolerances: (rtol, atol)
ATTN_TOL = {torch.float32: (2e-5, 4e-4), torch.bfloat16: (2e-2, 0.4)}
# (name, (B, Hq, Hkv, Sq, Skv, D), kw, dtype): the serve path's prefill and
# decode step first (gemma3_12b, window 1024 on local layers), then slice
# 1's trainer forward (minicpm_2b), then the reference tests' ragged cases,
# then the split-KV decode's edges at the serve step's widths
ATTN_SHAPES = [
    ("serve prefill, local", (4, 16, 8, 2048, 2048, 256), dict(window=1024), torch.float32),
    ("serve prefill, global", (4, 16, 8, 2048, 2048, 256), dict(), torch.float32),
    ("serve decode, local", (4, 16, 8, 1, 2064, 256), dict(window=1024, q_offset=2048),
     torch.float32),
    ("serve decode, global", (4, 16, 8, 1, 2064, 256), dict(q_offset=2048), torch.float32),
    ("trainer forward", (64, 36, 36, 32, 32, 64), dict(), torch.float32),
    ("MQA, ragged S and D", (1, 4, 1, 96, 96, 80), dict(), torch.float32),
    ("window 100", (1, 4, 2, 192, 192, 64), dict(window=100), torch.float32),
    ("non-causal 64 x 200", (1, 4, 4, 64, 200, 64), dict(causal=False), torch.float32),
    ("bf16 GQA", (2, 8, 2, 128, 128, 64), dict(), torch.bfloat16),
    ("bf16 MQA, ragged", (1, 4, 1, 96, 96, 80), dict(), torch.bfloat16),
    ("decode, one-key cache", (4, 16, 8, 1, 1, 256), dict(q_offset=0), torch.float32),
    ("decode, Skv not a chunk multiple", (4, 16, 8, 1, 1001, 256), dict(q_offset=1000),
     torch.float32),
    ("decode, window inside one chunk", (4, 16, 8, 1, 2064, 256), dict(window=12, q_offset=2048),
     torch.float32),
    ("decode, cache past q_offset unwritten", (4, 16, 8, 1, 2064, 256), dict(q_offset=300),
     torch.float32),
    ("decode, rows past every key", (4, 16, 8, 1, 40, 256), dict(window=50, q_offset=100),
     torch.float32),
    ("decode, GQA group of 8", (4, 32, 4, 1, 2064, 128), dict(q_offset=2048), torch.float32),
    ("decode, bf16", (4, 16, 8, 1, 2064, 256), dict(window=1024, q_offset=2048), torch.bfloat16),
]


def attention_plan(FA, shape, kw) -> tuple[str, int, int]:
    """(regime, chunks, CUDA launches) of one flash call at ``shape``."""
    b, hq, hkv, sq, skv, d = shape
    rows = hq // hkv * sq
    if rows > FA.DECODE_MAX_ROWS:
        return ("short tile" if rows <= 32 else "prefill tile"), 1, 1
    splits = FA.decode_plan(b, hkv, sq, skv, causal=kw.get("causal", True),
                            window=kw.get("window"), q_offset=kw.get("q_offset", 0),
                            sms=torch.cuda.get_device_properties(0).multi_processor_count)[3]
    return "split decode", splits, 2 if splits > 1 else 1


def _mask_kw(kw) -> dict:
    return {n: kw[n] for n in ("causal", "window", "q_offset") if n in kw}


def attention_bound(ref, shape, kw, dtype):
    """Least milliseconds for attention at ``shape``: 4·D flops for each
    visible (query, key) pair of each query head at the type's peak,
    against q and o and the keys and values some row sees, each moved once."""
    b, hq, hkv, sq, skv, d = shape
    mask = ref.attention_mask(sq, skv, **_mask_kw(kw), device="cpu")
    pairs = int(mask.sum())
    keys = int(mask.any(0).sum())
    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops = 4 * b * hq * d * pairs
    nbytes = itemsize * d * (2 * b * hq * sq + 2 * b * hkv * keys)
    return (*_bound(flops, nbytes, dtype), flops, nbytes)


def _sdpa_library(ref, q, k, v, kw):
    """One PyTorch call for the same function (a yardstick; the port never
    calls it): scaled_dot_product_attention with the same mask and GQA."""
    mask = ref.attention_mask(q.shape[2], k.shape[2], **_mask_kw(kw), device=q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=kw.get("scale"), enable_gqa=True)


def check_attention(FA, ref, q, k, v, kw, what):
    """The kernel against the plain version at the f32/bf16 tolerances;
    returns (plain output, max |err|)."""
    out = FA.flash_attention(q, k, v, **kw)
    want = ref.mha_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[q.dtype]
    err = float((out.float() - want.float()).abs().max())
    try:
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)
    except AssertionError as exc:
        fail(f"flash_attention {what}: {exc}")
    return want, err


def attention_phase(FA, ref):
    rows = []
    for i, (what, shape, kw, dtype) in enumerate(ATTN_SHAPES):
        b, hq, hkv, sq, skv, d = shape
        gen = torch.Generator(device="cuda")
        gen.manual_seed(100 + i)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])
        before = FA.flash_attention.cuda_launches
        _, err = check_attention(FA, ref, q, k, v, kw, f"{what} {shape}")
        regime, splits, cuda_launches = attention_plan(FA, shape, kw)
        if FA.flash_attention.cuda_launches - before != cuda_launches:
            fail(f"flash_attention {what}: {FA.flash_attention.cuda_launches - before} CUDA "
                 f"launches, expected {cuda_launches} ({regime}, {splits} chunks)")
        ms = time_auto(lambda: FA.flash_attention(q, k, v, **kw))
        plain_ms = time_auto(lambda: ref.mha_ref(q, k, v, **kw))
        library_ms = time_auto(_sdpa_library(ref, q, k, v, kw))
        bound_ms, bound_by, flops, nbytes = attention_bound(ref, shape, kw, dtype)
        dt = str(dtype).removeprefix("torch.")
        rtol, atol = ATTN_TOL[dtype]
        earlier = EARLIER_MS.get(("flash_attention", what))
        rows.append(dict(case=what, shape=list(shape), kw=kw, dtype=dt, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes, regime=regime,
                         chunks=splits, cuda_launches_per_call=cuda_launches,
                         earlier_ms=earlier))
        log(f"flash_attention {what} (B, Hq, Hkv, Sq, Skv, D)={shape} {kw} {dt}: {regime}, "
            f"{splits} chunk(s), {cuda_launches} CUDA launch(es) a call; "
            f"max|err|={err:.3e} (rtol {rtol} atol {atol}) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) "
            f"= {100 * bound_ms / ms:.2f}% of bound (before: {earlier or 'n/a'} ms)")
    return rows


# --- serve: gemma3_12b at full width ---------------------------------------------

SERVE = dict(arch="gemma3_12b", batch=4, prompt=2048, gen=16, seed=0)
# decode's logits against a teacher-forced forward over the same tokens:
# largest difference relative to the row's largest |logit| (f32 through 48
# layers with sums in another order, attention over the cache by the
# decode shape of the kernel against one prefill-shaped call)
SERVE_TF_REL = 1e-3
# reduced gemma3 serve, card against CPU: rtol and atol relative to the
# largest |logit|, as the CPU parity tests hold the port to the reference
SERVE_SMALL = dict(batch=2, prompt=80, gen=8)
SERVE_SMALL_REL = 1e-4


PROFILE_DECODE_STEPS = 4


def _kernel_category(name: str) -> str:
    if "flash_" in name:
        return "flash_attention"
    if any(t in name.lower() for t in ("gemm", "gemv", "cutlass")):
        return "matmul"
    return "other"


def _device_spans(fn):
    """``fn`` under torch.profiler: host milliseconds to a synchronised end,
    and the card's kernels as (start, end, name) in microseconds, sorted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return wall_ms, sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in prof.events() if e.device_type == DeviceType.CUDA)


def _busy_ms(spans) -> float:
    """Milliseconds in the union of the kernels' intervals."""
    busy, reach = 0.0, -math.inf
    for start, end, _ in spans:
        if end > reach:
            busy += (end - max(start, reach)) / 1e3
            reach = end
    return busy


def profile_window(fn) -> dict:
    """``fn`` under torch.profiler: host wall to a synchronised end, the
    card's kernel time by category, the union of kernel intervals (busy)
    and the idle share. None where the profiler saw no device activity."""
    wall_ms, spans = _device_spans(fn)
    if not spans:
        return None
    by = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for start, end, name in spans:
        by[_kernel_category(name)] += (end - start) / 1e3
    busy = _busy_ms(spans)
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                kernels=len(spans), by_ms=by)


def serve_profile(ST, cfg, params, out, p, g) -> dict:
    """Where the serve path's time goes, after the counted run: a prefill
    and two warm-up decode steps, then four steps timed one by one to a
    synchronised end, all before any profiling; then PROFILE_DECODE_STEPS
    steps under the profiler, and one more prefill under it."""
    prefill = ST.make_prefill_step(cfg, p + g)
    decode = ST.make_serve_step(cfg)
    batch = {"tokens": torch.from_numpy(out[:, :p]).cuda()}
    state = {}
    pos = p

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, batch)

    def step():
        nonlocal pos
        tok = state["logits"].argmax(-1)
        state["logits"], state["cache"] = decode(params, state["cache"], tok, pos)
        pos += 1

    def steps():
        for _ in range(PROFILE_DECODE_STEPS):
            step()

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    timed(run_prefill)
    step_ms = [timed(step) for _ in range(2 + 4)]
    dec = profile_window(steps)
    pre = profile_window(run_prefill)
    del state
    for name, r, n in (("prefill", pre, 1), ("decode", dec, PROFILE_DECODE_STEPS)):
        if r is None:
            log(f"serve profile: {name}: the profiler saw no device activity (not measured)")
            continue
        log(f"serve profile: {name}, per {'call' if n == 1 else 'step'}: wall {r['wall_ms'] / n:.2f} ms, "
            f"card busy {r['busy_ms'] / n:.2f} ms (idle share {r['idle_share']:.3f}), "
            f"{r['kernels'] / n:.0f} kernels; kernel time flash_attention "
            f"{r['by_ms']['flash_attention'] / n:.2f} ms, matmul {r['by_ms']['matmul'] / n:.2f} ms, "
            f"other {r['by_ms']['other'] / n:.2f} ms")
    if dec is not None:
        log(f"serve profile: flash_attention per decode step {dec['by_ms']['flash_attention'] / PROFILE_DECODE_STEPS:.3f} ms "
            f"(before: {EARLIER_MS['decode_step_flash_ms']} ms)")
    log(f"serve profile: decode steps one by one to a synchronised end, before any "
        f"profiling (2 warm-up first): "
        f"{', '.join(f'{t:.2f}' for t in step_ms)} ms")
    return dict(prefill=pre, decode=dec, decode_steps=PROFILE_DECODE_STEPS,
                decode_step_ms=step_ms)


def serve_phase(K, get_config, T, L, serve_mod, ST, ref):
    FA = K.FA
    cfg = get_config(SERVE["arch"])
    b, p, g = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    window, theta = T.layer_meta(cfg, cfg.num_layers)
    n_global = int((window == 0).sum())
    kv_gb = 2 * cfg.num_layers * b * cfg.num_kv_heads * (p + g) * cfg.resolved_head_dim * 4 / 1e9
    log(f"serve: {cfg.name} full width d={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} layers={cfg.num_layers} ({cfg.num_layers - n_global} local "
        f"window {cfg.window}, {n_global} global) (no cut); {n_params / 1e9:.3f}B params "
        f"{cfg.dtype} ({4 * n_params / 1e9:.2f} GB) init {t_init:.2f} s; batch {b}, prompt "
        f"{p}, gen {g}, KV cache {kv_gb:.2f} GB")
    steps = []
    torch.cuda.reset_peak_memory_stats()
    _zero(K)
    out, prefill_s, decode_s = serve_mod.serve(
        cfg, b, p, g, seed=SERVE["seed"], device="cuda", params=params,
        on_step=lambda i, logits: steps.append(logits))
    torch.cuda.synchronize()
    launches = _read(K)
    fa_cuda = FA.flash_attention.cuda_launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.num_layers * g                      # one prefill, g - 1 decode steps
    # a decode call split over several chunks launches two kernels
    want_cuda = cfg.num_layers + sum(
        attention_plan(FA, (b, cfg.num_heads, cfg.num_kv_heads, 1, p + g, cfg.resolved_head_dim),
                       dict(q_offset=pos, window=int(w) or None))[2]
        for pos in range(p, p + g - 1) for w in window)
    log(f"serve: prefill_s={prefill_s:.3f} (before: {EARLIER_MS['prefill_s']}) decode "
        f"{1e3 * decode_s / (g - 1):.2f} ms/token (before: "
        f"{EARLIER_MS['decode_ms_per_token']}) "
        f"({b * (g - 1) / decode_s:.1f} tok/s over {g - 1} steps of batch {b}) "
        f"peak_mem={peak:.2f} GB flash_attention launches={launches['flash_attention']} "
        f"(expected {cfg.num_layers} prefill + {cfg.num_layers} x {g - 1} decode = {want}), "
        f"{fa_cuda} CUDA launches (expected {want_cuda})")
    _only(launches, {"flash_attention": want}, "serve")
    if fa_cuda != want_cuda:
        fail(f"serve: flash_attention made {fa_cuda} CUDA launches, expected {want_cuda}")
    launches["flash_attention_cuda"] = fa_cuda
    dec = torch.stack(steps, 1)                    # (B, g, V)
    if out.shape != (b, p + g) or not torch.isfinite(dec).all():
        fail(f"serve gave tokens {out.shape} and finite logits {bool(torch.isfinite(dec).all())}")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("serve produced tokens outside the vocabulary")

    # teacher-forced: one forward over the prompt and the fed tokens
    toks = torch.from_numpy(out[:, :p + g - 1]).cuda()
    hidden = T.forward(params, cfg, {"tokens": toks})
    tf = T.lm_logits(params, cfg, hidden[:, p - 1:])
    del hidden
    rel = float(((tf - dec).abs().amax(-1) / tf.abs().amax(-1)).max())
    agree = float((tf.argmax(-1) == dec.argmax(-1)).float().mean())
    log(f"serve check: decode logits vs a teacher-forced forward over {p + g - 1} tokens: "
        f"largest |diff| / row max|logit| = {rel:.3e} (limit {SERVE_TF_REL:g}; max|logit| "
        f"{float(tf.abs().max()):.3f}); greedy token agreement {agree:.4f}; tail of sequence 0 "
        f"{out[0, -8:].tolist()}")
    if not rel <= SERVE_TF_REL:
        fail(f"serve: decode logits {rel:.3e} from the teacher-forced forward")
    del tf, dec, steps

    breakdown = serve_profile(ST, cfg, params, out, p, g)

    # layers 0 (local) and 5 (global) of the prefill: real q, k, v
    batch = {"tokens": torch.from_numpy(out[:, :p]).cuda()}
    x, positions = T.embed_inputs(params, cfg, batch)
    dims = T._attn_dims(cfg)
    layer_rows = []
    with torch.no_grad():
        for i in range(6):
            lp = params["layers"][i]
            w, th = int(window[i]), float(theta[i])
            if i in (0, 5):
                h = L.norm_apply(lp["ln1"], x, cfg.norm_eps, cfg.norm)
                q, k, v = L.qkv_project(lp["attn"], dims, h, positions, th, cfg.norm_eps)
                kw = dict(window=w or None)
                want, err = check_attention(FA, ref, q, k, v, kw, f"serve layer {i}")
                ms = time_auto(lambda: FA.flash_attention(q, k, v, **kw))
                layer_rows.append(dict(layer=i, window=w, max_abs_err=err, ms=ms))
                log(f"serve check: layer {i} ({'local' if w else 'global'}, theta {th:g}) "
                    f"prefill attention on its real q, k, v {tuple(q.shape)}: kernel vs plain "
                    f"max|err|={err:.3e} (max|out| {float(want.abs().max()):.3f}), kernel "
                    f"{ms:.4f} ms")
                del h, q, k, v, want
            x, _ = T._block_fwd(lp, cfg, x, positions, w, th)
    del x, params
    gc.collect()
    torch.cuda.empty_cache()

    # reduced gemma3: the same serve on the card and on the CPU
    small = get_config(SERVE["arch"]).reduced()
    p_cpu = T.init_params(small, seed=1, device="cpu")
    runs = {}
    for dev, prm in (("cuda", _params_to(p_cpu, "cuda")), ("cpu", p_cpu)):
        seen = []
        toks_s, _, _ = serve_mod.serve(small, SERVE_SMALL["batch"], SERVE_SMALL["prompt"],
                                       SERVE_SMALL["gen"], seed=1, device=dev, params=prm,
                                       on_step=lambda i, lg: seen.append(lg.cpu()))
        runs[dev] = (toks_s, torch.stack(seen, 1))
    (tg, lg_g), (tc, lg_c) = runs["cuda"], runs["cpu"]
    err_small = float((lg_g - lg_c).abs().max())
    top = float(lg_c.abs().max())
    log(f"serve check: reduced {small.name} (window {small.window}, global_every "
        f"{small.global_every}, heads {small.num_heads}/{small.num_kv_heads}) serve of "
        f"{SERVE_SMALL}: card vs CPU tokens equal {bool((tg == tc).all())}, logits "
        f"max|diff| {err_small:.3e} (max|logit| {top:.3f}; rtol {SERVE_SMALL_REL:g}, atol "
        f"{SERVE_SMALL_REL:g}·max|logit|)")
    if not (tg == tc).all():
        fail("reduced serve: the card's tokens differ from the CPU's")
    torch.testing.assert_close(lg_g, lg_c, rtol=SERVE_SMALL_REL, atol=SERVE_SMALL_REL * top)
    return launches, dict(prefill_s=prefill_s, decode_ms_per_token=1e3 * decode_s / (g - 1),
                          tok_s=b * (g - 1) / decode_s, peak_gb=peak, tf_rel=rel,
                          tf_token_agreement=agree, layers=layer_rows, profile=breakdown)


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
    from repro_torch.core import engine
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic as D
    from repro_torch.core import streaming
    from repro_torch.fl import afl, api, partition
    from repro_torch.kernels import blocked as B
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gram as G
    from repro_torch.kernels import panel as P
    from repro_torch.kernels import rank_update as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import solve as S
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    # every kernel's wrapper, by name: each path's launches are counted on these
    K = SimpleNamespace(G=G, P=P, B=B, R=R, FA=FA, ALL={
        "gram_update": G.gram_update, "panel_factor": P.panel_factor,
        "panel_tri_inv": P.panel_tri_inv, "panel_trsm": P.panel_trsm,
        "panel_update": P.panel_update, "blocked_cholesky": B.blocked_cholesky,
        "cholesky_solve": B.cholesky_solve, "multi_gamma_solve": B.multi_gamma_solve,
        "chol_rank_update": R.chol_rank_update, "flash_attention": FA.flash_attention})
    header(K, build)
    rows = {"gram_update": kernel_phase(G, ref)}
    rows.update(panel_phase(P, ref))
    rows.update(blocked_phase(K, ref))
    for name, more in f64_kernel_phase(K, ref).items():
        rows[name].extend(more)
    rows["flash_attention"] = attention_phase(FA, ref)
    products = [streamed_products(S, P, dt) for dt in (torch.float32, torch.float64)]
    profiles = factor_profiles(S)
    streamed = streamed_phase(S, P)
    small_check(get_config, D, T, train, FLConfig)
    slice_launches, server, x_te, y_te, sl = slice_phase(K, get_config, D, T, train,
                                                         FLConfig, api)
    paths = [slice_launches,
             device_solve_phase(K, S, engine, api, server, x_te, y_te),
             sweep_phase(K, ref, S, engine, api, server, x_te, y_te),
             narrow_phase(K, ref, engine, api, D),
             rank_update_phase(K, engine, api, server, x_te, y_te, FLConfig(gamma=1.0))]
    f64_launches, f64_times = f64_engine_phase(K, S, engine, api, server, x_te, y_te,
                                               FLConfig(gamma=1.0))
    paths.append(f64_launches)
    paths.append(paper_round_phase(K, sl, train, afl, partition, streaming, ST, api, D,
                                   FLConfig))
    del server, sl
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, served = serve_phase(K, get_config, T, L, serve_mod, ST, ref)
    paths.append(serve_launches)
    launches = {name: sum(p[name] for p in paths) for name in K.ALL}
    if not all(launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    flash_cuda = sum(p.get("flash_attention_cuda", 0) for p in paths)

    sources = {"gram_update": ("gram.cu", "gram.py:86"),
               "panel_factor": ("panel.cu", "solve.py:469"),
               "panel_tri_inv": ("panel.cu", "solve.py:491"),
               "panel_trsm": ("panel.cu", "solve.py:508"),
               "panel_update": ("panel.cu", "solve.py:536"),
               "blocked_cholesky": ("blocked.cu", "solve.py:253"),
               "cholesky_solve": ("blocked.cu", "solve.py:295"),
               "multi_gamma_solve": ("blocked.cu", "solve.py:346"),
               "chol_rank_update": ("rank_update.cu", "solve.py:774"),
               "flash_attention": ("flash_attention.cu", "flash_attention.py:106")}
    kernels = []
    for name, (src, where) in sources.items():
        main_row = rows[name][0]          # the main path's shape comes first
        max_err = max(r["max_abs_err"] for r in rows[name])
        # ``kernel_ms`` and ``max_err`` repeat ``ms`` and ``max_abs_err``:
        # the kernels line is read under both names
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{where}",
            launches=launches[name], max_abs_err=max_err, max_err=max_err,
            ms=main_row["ms"], kernel_ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shapes=rows[name],
            **({"cuda_launches": flash_cuda} if name == "flash_attention" else {})))
    log(json.dumps({"streamed": streamed}))
    log(json.dumps({"streamed_products": products, "factor_profiles": profiles}))
    log(json.dumps({"f64_engine": f64_times}))
    log(json.dumps({"serve": served}))
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
