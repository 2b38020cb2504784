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
     1e-10); then the panel kernels at every shape phase 14's tile plans
     give them (``SHARD_PLANS``: the widths 144, 192, 220, f64 96, and
     slabs of a shard's (r, d_p) work copy, the updates in place); each
     timed beside the plain version, one library call that
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
 18. precision "f32_x2" (after 3, before any model loads): the split
     instances of ``panel_trsm`` (2304, 256), ``panel_update`` (2304,
     2048, 256) and (6144, 5888, 256), ``blocked_cholesky`` (1, 1536) and
     (1, 128), ``cholesky_solve`` (1, 1536, 16) and ``multi_gamma_solve``
     (2304, 16, 16 γs) against their plain split versions (``kernels.ref``
     with ``precision="f32_x2"``: the products bit for bit, the blocked
     ones, and their twins, at the native rows' tolerance; at one panel the
     factor's bits are the native instance's), each call one wrapper
     launch and one split launch, the blocked ones profiled for the native
     schedule's CUDA launches, each timed beside the native instance and
     the plain version, its bound the split products' flops three times
     and the diagonal blocks' once; bit for bit the plain split where no
     sum order is left to differ (``panel_trsm`` at b = 1 on 2^20 values
     with exponents −30…30, ``cholesky_solve`` at d = 1, and at the
     shapes above operands with one nonzero term in every output of every
     product: a diagonal zinv, one entry a row of lp, a system whose
     factor has diagonal blocks and one entry a row below them), where the
     native instance's bits must differ; then the entry points in f32_x2 with
     every count from zero (the streamed factor and solve at d = 2304, the
     blocked ones at d = 1536, the 16-ridge sweep at d = 2304: the native
     schedule's launches, every product's through its split instance),
     the streamed answer against the plain route's, and the reference
     test's bound on its seeded systems (``_spd``, n_mult = 8) against
     host f64: x2's error ≤ 4 × native's + 1e-9, and < 1e-4; its own JSON
     line ``{"f32_x2": ...}``;
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
     partitions at K = 100 (iid, NIID-1 α = 0.1, NIID-2 s = 2; Figure 2's
     K = 1000 is host f64 alone, held to the reference by
     tests/test_torch_fl.py on the CPU), each with the joint solve's test
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
 13. federation (after 11, before 12): ``python -m
     repro_torch.launch.serve --federation --coordinator async`` at d = 2304
     in a subprocess (no card, a free port, a ledger directory; its
     ``federation up:`` line awaited within a time limit, stopped at the
     phase's end whatever the outcome); full-width minicpm_2b's
     ``launch.train.run_analytic(server_url=…)`` posts its report there
     (48 Gram and 2560 flash launches counted over exactly that call), and
     the served head must be, bit for bit, an in-process ``AFLServer``'s
     solve of the report the ledger recorded and (when the client's report
     repeats bit for bit, else within rtol 1e-4) the slice's weight, with the
     slice's accuracy; the served ``state()`` through ``checkpoint.save`` /
     ``load_server`` and a ``WarmStandby`` replaying the ledger solve to
     the same bits; then ``fl.afl.run_afl(coordinator=url)`` at K = 100 over
     HTTP (NIID-1 α = 0.1, a second served federation, sync) and over
     ``mux://`` (iid, an in-process ``serve_mux``) on phase 11's
     embeddings, each weight phase 11's in-process weight bit for bit, with
     the seconds split into local stages, encoding, submits on the wire and
     the solve, and the bytes and seconds a report; its own JSON line
     ``{"federation": ...}``;
 14. sharded (after 13, before 12): the sharded coordinator
     (``fl.api.ShardedCoordinator`` over ``core.distributed``'s thread mesh,
     eight shards on cuda:0): (a) phase 11's K = 100 NIID-1 round through
     ``run_afl`` into four coordinators at once (d = 2304, tiles of 288
     rows): the tiled distributed factor in f32 (``run_afl``'s own solve,
     panels of 144: 128 / 128 / 120 / 0 panel launches a solve) and f64
     (panels of 96: 192 / 192 / 184 / 0), the whole-leaf psum over eight
     participants and the tiled gather branch (no panel kernel), each
     within 10·κ·u of its type of phase 11's host f64 weight, at its
     accuracy, a second solve the same bits, none answered by the host
     engine (``host_fallbacks`` 0); (b) phase 3's d = 6144 system
     through ``make_tiled_federated_solve`` over 8 shards (f32 192 / 192 /
     184, f64 384 / 384 / 376) and 7 padded ones (f32 196 / 196 / 189),
     each within 10·κ·u of numpy f64, its peak device bytes above its
     uploaded tiles (host f64 arrays, as the coordinator passes them)
     below one (d, d) system (the gather branch's at or above one), timed
     beside the one-shard streamed solve and torch.linalg, and one 8-shard
     f32 factor profiled and its host time split into the collectives and
     the rest; (c) ``python -m repro_torch.launch.serve
     --federation --coordinator sharded --shards 8 --tiled`` on the card
     in a subprocess (handled as phase 13's), ``run_afl(coordinator=url)``
     at K = 100 whose head is the in-process coordinator's bits, ``grow(4)``
     and ``shrink(8)`` over the wire (``mesh_epoch`` advancing, the head
     within the f32 bar and the bits of the in-process coordinator after
     the same resize), and the served ``state()`` restored in an
     ``AFLServer`` to the host weight's bits; its own JSON line
     ``{"sharded": ...}``;
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
     CPU;
 15. the backbone zoo, one model on the card at a time: (a)
     ``launch.serve.serve`` at full width (random f32 weights from a seed,
     batch 4, prompt 512, 8 tokens) of granite_moe_3b_a800m (moe, 32
     layers), zamba2_7b (hybrid, 81 layers: 68 Mamba2 and 13 applications
     of the shared block), seamless_m4t_medium (encdec, 12 + 12 layers,
     512 encoder frames), grok1_314b (moe with a logit softcap of 30, its
     depth cut to 2 of 64 layers: the whole stack needs about 1.26 TB) and
     xlstm_350m (24 layers, no attention), each one's flash launches
     counted from zero against the expected numbers (32, 13, 36 then 24,
     2, 0 a prefill / a decode step) and its CUDA launches against each
     call's regime, and decode's logits against a teacher-forced forward
     (not for MoE: decode's capacity group is the batch); (b) each family
     at 5 layers (two groups and a tail for hybrid and xLSTM), card
     against CPU: the MoE routing first (every slot; a difference is
     reported with its top-k margin), then tokens equal and logits within
     relative 1e-4; (c) the flash kernel at the zoo's shapes (granite,
     grok1's softcap, zamba2's D 112, seamless's non-causal encoder and
     cross-attention decode) is in the kernel phase, the softcap rows'
     library time compiled flex_attention's (SDPA has no softcap), held
     to the plain version first; (d) the paper's
     Table 4 on the card: ``run_analytic`` with the Gram kernel on
     full-width granite (Gram and flash launches counted; xlstm's setting
     was cut for phase 18, tests/test_torch_zoo.py holds it on the CPU), then
     ``run_afl`` at K = 100 iid and NIID-1 on the card's embeddings, each
     equal in accuracy to the joint solve and within 10·κ·u64 of its
     weight; its own JSON line ``{"zoo": ...}``;
 16. training, the gradient and LM modes, after the zoo's models are
     freed: (a) ``models.layers.sdpa`` under grad (``FlashSDPA``: the
     flash kernel's forward, one launch, and the plain attention's
     gradient recomputed) against autograd of ``sdpa_plain`` at four
     shapes (the LM phase's own, a GQA one with a window, grok1's softcap,
     a non-causal one): output, dq, dk and dv within rtol / atol 1e-4 of
     the largest entry; at the LM shape the kernel's forward timed beside
     the plain version and SDPA, and FlashSDPA's forward + backward beside
     SDPA's; (b) one ``launch.steps.make_full_train_step`` of minicpm_2b
     at full width, depth cut to 2 of 40 layers, on the card and on the
     CPU from the same weights (loss within rtol 1e-5, each leaf's Δp
     within 1e-3 of its largest plus one f32 spacing, 2 flash launches);
     (c) ``launch.train.run_gradient`` on whole minicpm_2b (1024 × 32
     tokens, 16 classes, batch 64, 2 rounds) above chance, 40 flash
     launches a forward; (d) ``launch.train.run_lm`` on whole minicpm_2b,
     8 steps of 4 × 256 tokens, every loss finite, with ms a step,
     tokens/s, peak memory and 40 flash launches a step; (e)
     ``examples/torch_train_100m.py``'s ``main`` at its defaults, its
     asserts holding; its own JSON line ``{"training": ...}``;
 17. the dry run (its grid of every arch and shape on one card left the
     smoke for phase 19: ``python -m repro_torch.launch.dryrun`` and
     tests/test_torch_dryrun.py keep it): (b) the dry run's per-step
     function (a meta walk) against the card at minicpm_2b's analytic
     step of the slice's batch (64 × 32, ``use_kernel=True``) and
     gemma3_12b's prefill at 4 × 2048 and one decode step against a
     2048-slot cache, all full width in f32: the static bytes those of
     the card's tensors exactly, the predicted peak within 10% of
     ``max_memory_allocated`` over the step, the walk's flops the card's
     ``FlopCounterMode`` count + ``attention_flops`` + the Gram's
     2·N·d·(d + C) exactly, and the median of 5 timed steps giving a
     roofline share and an MFU of at most 1; (c)
     ``examples/torch_serve_demo.py`` and ``torch_federated_niid.py`` on
     the card, their flash launches counted; its own JSON line
     ``{"dryrun": ...}``;
 19. the partitioned steps (``launch.partitioned``): four ranks
     (``core.distributed.run_ranks``) on this one card as a (2, 2)
     ('data', 'model') mesh, their collectives through buffers each rank
     maps by CUDA IPC (``core.distributed.share_collectives``; NCCL
     refuses two ranks on one card), run full-width granite_moe_3b_a800m
     (32 layers, f32) as DTensors under the sharding rules: the analytic
     train step on 4 × 512 tokens, a prefill of 4 × 512 and 4 greedy
     decode steps, flash and Gram kernels on each rank's shards; then this
     process runs the same steps on the card on one rank, each MoE call
     routed by the ranks' expert choices: the Gram within 1e-4 of its
     largest entry and the count exact, every logit within 1e-3 of its
     row's largest |logit|, the same tokens, and the MoE slots equal; each
     rank's collectives (counted as they run, and by ``CommDebugMode``)
     equal, op for op, rank 0's steps walked on a fake process group of
     the same mesh. Then three more families the same way (one spawn of
     the ranks runs all four models in turn), in f32 at full
     width: xlstm_350m whole (24 layers; train step on 4 × 128, a prefill
     of 4 × 128, 4 decode steps; its Gram and logits held to 1.8e-3 and
     4e-3, twice what its ranks read, since its random weights amplify a
     GEMM's rounding alone to about 1e-3), zamba2_7b with its depth cut to 15 of 81
     layers (two groups of five Mamba2 layers and the shared block, then a
     tail of three) and seamless_m4t_medium whole (12 + 12 layers), each
     on 4 × 512 with 4 decode steps; each recurrence on its rank's batch
     and head shard (its carries' local shapes checked on every rank), the
     walk counting the per-token loops by trip count, and 4 × rank 0's
     walked flops within 1% of one device's (no rank repeats another's
     work); flash and Gram launches, peak bytes, wall and collectives per
     rank and family; its own JSON line ``{"partitioned": ...}``.

Each path's launches are counted from zero just before it runs. It then
prints the kernels' JSON line (ten kernels; the five with a split
instance carry its rows, ``"precision": "f32_x2"``), and last the device line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# One card: every phase runs on device 0, and the last line counts it.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
# flex_attention, the softcap rows' library yardstick, compiles through
# inductor and Triton: their caches go to the checkout's ignored build/
_BUILD = Path(__file__).resolve().parent / "build"
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(_BUILD / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD / "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# the H100's peaks (repro_torch.launch.mesh: HBM_BW, PEAK_FLOPS), set by
# main() once the port is on the path
PEAK_BYTES_S = PEAK_FLOPS = None
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
    a, rhs = _stream_system(d)
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


# --- precision "f32_x2": the split products (phase 18) -------------------------

X2 = "f32_x2"
# the five kernels with a split instance; their rows join the kernels line
# with "precision": "f32_x2"
X2_KERNELS = ("panel_trsm", "panel_update", "blocked_cholesky", "cholesky_solve",
              "multi_gamma_solve")
X2_TRSM_SHAPES = [(2304, 256)]
X2_UPDATE_SHAPES = [(2304, 2048, 256), (6144, 5888, 256)]
X2_FACTOR_SHAPES = [(1, 1536), (1, 128)]
X2_SOLVE_SHAPES = [(1, 1536, 16)]
X2_SWEEP_SHAPES = [(2304, 16, 16)]
X2_STREAM_D = 2304
X2_BLOCKED_D = 1536


def _x2_zero(K) -> None:
    for name in X2_KERNELS:
        K.ALL[name].x2_launches = 0


def _x2_read(K) -> dict:
    return {name: K.ALL[name].x2_launches for name in X2_KERNELS}


def _x2_system(gen, d):
    """The reference property test's system (tests/test_solve_kernels.py's
    ``_spd`` with n_mult = 8: XᵀX from 8d normal rows, plus 0.5·I), drawn
    and formed on the card in f64."""
    x = torch.randn((8 * d, d), generator=gen, device="cuda", dtype=torch.float64)
    return x.T @ x + 0.5 * torch.eye(d, device="cuda", dtype=torch.float64)


def _x2_factor_flops(d, panel):
    """A factor's flops under f32_x2: d³/3 less the diagonal blocks' b³/3
    (panels of ``panel``, the last ragged), which stay native, counted
    three times for the split products, and the diagonal blocks once."""
    diag = sum(min(panel, d - o) ** 3 / 3 for o in range(0, d, panel))
    return 3 * (d ** 3 / 3 - diag) + diag


def _one_term_system(gen, d, panel):
    """An SPD (d, d) f32 system whose blocked factor, solve and sweep have
    at most one nonzero term in every output of every product: a diagonal
    in [2, 3), and for each panel after the first one entry a row in the
    panel before it, in distinct columns, within ±0.5 (diagonally
    dominant). Each diagonal block of its factor is then diagonal and each
    block below one a scaled partial permutation, so no sum order is left
    to differ between two schedules; the split products still round as
    the reference's do, and unlike a native product."""
    a = torch.diag(2 + torch.rand(d, generator=gen, device="cuda"))
    for o in range(panel, d, panel):
        rows = torch.arange(o, min(o + panel, d), device="cuda")
        cols = o - panel + torch.randperm(panel, generator=gen, device="cuda")[:rows.numel()]
        e = torch.rand(rows.numel(), generator=gen, device="cuda") - 0.5
        a[rows, cols] = e
        a[cols, rows] = e
    return a


def _one_term_rows(gen, r, b):
    """(r, b) with one nonzero normal entry a row, in a random column."""
    lp = torch.zeros((r, b), device="cuda")
    lp[torch.arange(r, device="cuda"),
       torch.randint(0, b, (r,), generator=gen, device="cuda")] = torch.randn(
           r, generator=gen, device="cuda")
    return lp


def _spread_exponents(gen, shape, lo, hi, positive=False):
    """f32 values with exponents spread over lo..hi (both signs unless
    ``positive``): every product of their split halves stays a normal f32."""
    v = (1 + torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)) * 2.0 ** \
        torch.randint(lo, hi + 1, shape, generator=gen, device="cuda").double()
    if not positive:
        v *= torch.randint(0, 2, shape, generator=gen, device="cuda").double() * 2 - 1
    return v.float()


def _launch_calls(fn) -> tuple[int, int]:
    """One synchronised call of ``fn`` (after a warm-up) under
    torch.profiler, padded as ``_device_spans`` pads: the host's CUDA
    kernel launch calls, and the kernels the device side recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = prof.events()
    calls = sum(1 for e in events if e.device_type != DeviceType.CUDA
                and e.name.startswith("cudaLaunchKernel"))
    return calls, sum(1 for e in events if e.device_type == DeviceType.CUDA)


def precision_phase(K, ref, S):
    """Phase 18: the split products' instances of the five kernels against
    their plain split versions at the main paths' shapes, timed beside the
    native instance; the bit checks; the streamed and blocked entry points
    driven in f32_x2 with every count from zero; the reference test's bound
    against host f64. Returns the driven path's launches and the summary."""
    t0 = time.perf_counter()
    P, B = K.P, K.B
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    rows = {name: [] for name in X2_KERNELS}

    def row(name, shape, got, native_got, want, kernel, native, plain, flops, nbytes,
            cuda_launches, timer=time_cuda):
        """The split instance, and the native one, against the plain split
        version (before the timed calls, which may update ``got`` in place);
        ``flops`` counts the split products three times, the diagonal
        blocks' work, which stays native, once."""
        err, rel, native_err = _abs(got, want), _rel(got, want), _abs(native_got, want)
        ms, native_ms, plain_ms = timer(kernel), timer(native), timer(plain)
        r = _kernel_row(name, shape, err, rel, ms, plain_ms, None,
                        flops, nbytes, f"; f32_x2, native instance {native_ms:.4f} ms "
                        f"({ms / native_ms:.2f}x) and max|err| {native_err:.3e} against the "
                        f"plain split, {cuda_launches} CUDA launches a call")
        r.update(precision=X2, native_ms=native_ms, native_max_abs_err=native_err,
                 cuda_launches=cuda_launches)
        rows[name].append(r)
        return r

    def counted(wrapper, fn):
        """``fn``'s result, failing unless it launched ``wrapper`` once and
        its split instance once."""
        n, x2 = wrapper.launches, wrapper.x2_launches
        out = fn()
        torch.cuda.synchronize()
        if (wrapper.launches - n, wrapper.x2_launches - x2) != (1, 1):
            fail(f"{wrapper.__name__} in f32_x2: launches {wrapper.launches - n}, split "
                 f"launches {wrapper.x2_launches - x2}, expected 1 and 1")
        return out

    def profiled_launches(name, shape, fn, parts, want):
        """One split call profiled: device time by kernel, and its CUDA
        launches, the host's launch calls, against the schedule's ``want``
        (the native one: one host loop serves both instances). The device
        side is logged beside it: here the profiler drops the first kernel
        of the sweep at d = 2304 (121 of 122 natively and in f32_x2, PR 27's
        breakdown as well), while the host records all 122 calls."""
        prof = kernel_breakdown(fn, parts)
        _log_breakdown(f"{name} {shape} f32_x2, one call profiled", prof)
        calls, seen = _launch_calls(fn)
        log(f"{name} {shape} f32_x2: {calls} CUDA launch calls (the device side shows "
            f"{seen}), the schedule makes {want}")
        if calls != want:
            fail(f"{name} {shape} f32_x2: {calls} CUDA launch calls, expected {want} (the "
                 "native schedule's)")
        if prof is not None:
            prof.update(launch_calls=calls, kernels_seen=seen)
        return prof

    for r, b in X2_TRSM_SHAPES:
        raw = _slab(gen, r, b, r)
        zinv = torch.tril(torch.randn((b, b), generator=gen, device="cuda"))
        out = counted(P.panel_trsm, lambda: P.panel_trsm(raw, zinv, precision=X2))
        want = ref.panel_trsm_ref(raw, zinv, precision=X2)
        if not torch.equal(out, want):
            fail(f"panel_trsm {(r, b)} f32_x2: not the plain split version's bits "
                 f"(max|err| {_abs(out, want):.3e})")
        row("panel_trsm", (r, b), out, P.panel_trsm(raw, zinv), want,
            lambda: P.panel_trsm(raw, zinv, precision=X2), lambda: P.panel_trsm(raw, zinv),
            lambda: ref.panel_trsm_ref(raw, zinv, precision=X2),
            3 * r * b * (b + 1), 4 * (2 * r * b + b * (b + 1) // 2), 1)
    for r, w, b in X2_UPDATE_SHAPES:
        trail = _slab(gen, r, w, w + b)
        lp = torch.randn((r, b), generator=gen, device="cuda")
        pt = torch.randn((w, b), generator=gen, device="cuda")
        want = ref.panel_update_ref(trail, lp, pt, precision=X2)
        native = P.panel_update(trail, lp, pt)
        out = counted(P.panel_update,
                      lambda: P.panel_update(trail, lp, pt, out=trail, precision=X2))
        if not torch.equal(out, want):
            fail(f"panel_update {(r, w, b)} f32_x2: not the plain split version's bits "
                 f"(max|err| {_abs(out, want):.3e})")
        row("panel_update", (r, w, b), out, native, want,
            lambda: P.panel_update(trail, lp, pt, out=trail, precision=X2),
            lambda: P.panel_update(trail, lp, pt, out=trail),
            lambda: ref.panel_update_ref(trail, lp, pt, out=trail, precision=X2),
            3 * 2 * r * w * b, 4 * (2 * r * w + r * b + w * b), 1)

    for m, d in X2_FACTOR_SHAPES:
        a = torch.stack([_spd_block(gen, d) for _ in range(m)])
        l = counted(B.blocked_cholesky, lambda: B.blocked_cholesky(a, precision=X2))
        want = ref.blocked_cholesky_ref(a, precision=X2)
        _check_close("blocked_cholesky f32_x2", (m, d), l, want)
        if torch.triu(l, 1).any() or not torch.equal(B.blocked_cholesky(a, precision=X2), l):
            fail(f"blocked_cholesky {(m, d)} f32_x2: upper triangle not zero, or a repeated "
                 "call gave other bits")
        native = B.blocked_cholesky(a)
        if d <= B.PANEL and not torch.equal(l, native):
            fail(f"blocked_cholesky {(m, d)} f32_x2: one panel has no split product, yet "
                 "the split instance's bits are not the native instance's")
        r = row("blocked_cholesky", (m, d), l, native, want,
                lambda: B.blocked_cholesky(a, precision=X2), lambda: B.blocked_cholesky(a),
                lambda: ref.blocked_cholesky_ref(a, precision=X2),
                m * _x2_factor_flops(d, B.PANEL), 4 * m * (_tri(d) + d * d),
                B.cuda_launches(d), time_auto)
        if d == X2_BLOCKED_D:
            r["profile"] = profiled_launches("blocked_cholesky", (m, d),
                                             lambda: B.blocked_cholesky(a, precision=X2),
                                             BLOCKED_PARTS, B.cuda_launches(d))
    for m, d, c in X2_SOLVE_SHAPES:
        l = B.blocked_cholesky(torch.stack([_spd_block(gen, d) for _ in range(m)]))
        b = torch.randn((m, d, c), generator=gen, device="cuda")
        x = counted(B.cholesky_solve, lambda: B.cholesky_solve(l, b, precision=X2))
        want = ref.cholesky_solve_ref(l, b, precision=X2)
        _check_close("cholesky_solve f32_x2", (m, d, c), x, want)
        _check_close("cholesky_solve f32_x2 against its right-looking twin", (m, d, c), x,
                     ref.solve_right_looking_ref(l, b, precision=X2))
        r = row("cholesky_solve", (m, d, c), x, B.cholesky_solve(l, b), want,
                lambda: B.cholesky_solve(l, b, precision=X2), lambda: B.cholesky_solve(l, b),
                lambda: ref.cholesky_solve_ref(l, b, precision=X2), 3 * 2 * m * d * d * c,
                4 * m * (_tri(d) + 2 * d * c), B.solve_cuda_launches(d), time_auto)
        r["profile"] = profiled_launches("cholesky_solve", (m, d, c),
                                         lambda: B.cholesky_solve(l, b, precision=X2),
                                         SOLVE_PARTS, B.solve_cuda_launches(d))
    for d, c, n_g in X2_SWEEP_SHAPES:
        a = _spd_block(gen, d)
        q = torch.randn((d, c), generator=gen, device="cuda")
        gammas = torch.logspace(-4, 0, n_g, device="cuda") * torch.trace(a) / d
        w = counted(B.multi_gamma_solve, lambda: B.multi_gamma_solve(a, q, gammas, precision=X2))
        want = ref.multi_gamma_solve_ref(a, q, gammas, precision=X2)
        twin = ref.multi_gamma_blocked_ref(a, q, gammas, X2)
        for j in range(n_g):
            _check_close("multi_gamma_solve f32_x2", (d, c, n_g), w[j], want[j])
            _check_close("multi_gamma_solve f32_x2 against its blocked twin", (d, c, n_g),
                         w[j], twin[j])
        r = row("multi_gamma_solve", (d, c, n_g), w, B.multi_gamma_solve(a, q, gammas), want,
                lambda: B.multi_gamma_solve(a, q, gammas, precision=X2),
                lambda: B.multi_gamma_solve(a, q, gammas),
                lambda: ref.multi_gamma_solve_ref(a, q, gammas, precision=X2),
                n_g * (_x2_factor_flops(d, B.PANEL) + 3 * 2 * d * d * c),
                4 * (_tri(d) + d * c + n_g + n_g * d * c),
                B.sweep_cuda_launches(d), time_auto)
        r["profile"] = profiled_launches("multi_gamma_solve", (d, c, n_g),
                                         lambda: B.multi_gamma_solve(a, q, gammas,
                                                                     precision=X2),
                                         SWEEP_PARTS, B.sweep_cuda_launches(d))

    # bits: where each output is one product of split halves (panel_trsm at
    # b = 1; cholesky_solve at d = 1, z = 1 / l in both), every product is
    # exact and no sum order is left to differ; a contracted split is not
    bits = {}
    raw = _spread_exponents(gen, (1 << 20, 1), -30, 30)
    zinv = _spread_exponents(gen, (1, 1), -30, 30)
    got, want = P.panel_trsm(raw, zinv, precision=X2), ref.panel_trsm_ref(raw, zinv, precision=X2)
    bits["panel_trsm_b1"] = dict(values=raw.numel(), equal=bool(torch.equal(got, want)),
                                 differ=int((got != want).sum()))
    l1 = _spread_exponents(gen, (4096, 1, 1), -15, 15, positive=True)
    b1 = _spread_exponents(gen, (4096, 1, 16), -30, 30)
    got = B.cholesky_solve(l1, b1, precision=X2)
    want = ref.solve_right_looking_ref(l1, b1, precision=X2)
    bits["cholesky_solve_d1"] = dict(values=b1.numel(), equal=bool(torch.equal(got, want)),
                                     differ=int((got != want).sum()))

    # bits at the main paths' shapes: operands with one nonzero term in
    # every output of every product (a diagonal zinv, one entry a row of
    # lp, _one_term_system), so each split instance (F32Narrow, F32Mid,
    # tile_gemm's trsm and trailing update, the substitutions) must give
    # the plain split's bits; its native instance must not, everywhere
    def one_term(key, got, want, native):
        bits[key] = dict(values=got.numel(), equal=bool(torch.equal(got, want)),
                         differ=int((got != want).sum()),
                         native_differ=int((native != want).sum()))

    for r, b in X2_TRSM_SHAPES:
        raw = torch.randn((r, b), generator=gen, device="cuda")
        zinv = torch.diag(1 + torch.rand(b, generator=gen, device="cuda"))
        one_term(f"panel_trsm_{r}x{b}", P.panel_trsm(raw, zinv, precision=X2),
                 ref.panel_trsm_ref(raw, zinv, precision=X2), P.panel_trsm(raw, zinv))
    for r, w, b in X2_UPDATE_SHAPES:
        trail = torch.randn((r, w), generator=gen, device="cuda")
        lp = _one_term_rows(gen, r, b)
        pt = torch.randn((w, b), generator=gen, device="cuda")
        one_term(f"panel_update_{r}x{w}x{b}", P.panel_update(trail, lp, pt, precision=X2),
                 ref.panel_update_ref(trail, lp, pt, precision=X2),
                 P.panel_update(trail, lp, pt))
    a1 = torch.stack([_one_term_system(gen, X2_BLOCKED_D, B.PANEL) for _ in range(2)])
    one_term(f"blocked_cholesky_2x{X2_BLOCKED_D}", B.blocked_cholesky(a1, precision=X2),
             ref.blocked_cholesky_ref(a1, precision=X2), B.blocked_cholesky(a1))
    l1 = ref.blocked_cholesky_ref(a1[:1])
    b1 = torch.randn((1, X2_BLOCKED_D, STREAM_C), generator=gen, device="cuda")
    one_term(f"cholesky_solve_{X2_BLOCKED_D}x{STREAM_C}", B.cholesky_solve(l1, b1, precision=X2),
             ref.cholesky_solve_ref(l1, b1, precision=X2), B.cholesky_solve(l1, b1))
    for d, c, n_g in X2_SWEEP_SHAPES:
        a1 = _one_term_system(gen, d, B.PANEL)
        q1 = torch.randn((d, c), generator=gen, device="cuda")
        g1 = torch.logspace(-4, 0, n_g, device="cuda")
        one_term(f"multi_gamma_solve_{d}x{c}x{n_g}", B.multi_gamma_solve(a1, q1, g1, precision=X2),
                 ref.multi_gamma_solve_ref(a1, q1, g1, precision=X2),
                 B.multi_gamma_solve(a1, q1, g1))
    log(f"f32_x2 bit checks: {bits}")
    if not all(v["equal"] for v in bits.values()):
        fail(f"f32_x2 split instances differ from the plain split in bits: {bits}")
    if not all(v["native_differ"] for k, v in bits.items() if "native_differ" in v):
        fail(f"f32_x2: a native instance gave the plain split's bits on a one-term check, "
             f"which then cannot tell the two apart: {bits}")

    # the entry points in f32_x2, every count from zero: the streamed factor
    # and solve at d = 2304, the blocked factor and solve at d = 1536, the
    # 16-ridge sweep at d = 2304
    a_s64, a_b64 = _x2_system(gen, X2_STREAM_D), _x2_system(gen, X2_BLOCKED_D)
    q_s64 = torch.randn((X2_STREAM_D, STREAM_C), generator=gen, device="cuda",
                        dtype=torch.float64)
    q_b64 = q_s64[:X2_BLOCKED_D]
    a_s, a_b, q_s, q_b = a_s64.float(), a_b64.float(), q_s64.float(), q_b64.float()
    gammas = torch.logspace(-4, 0, 16, device="cuda") * torch.trace(a_s) / X2_STREAM_D
    n = X2_STREAM_D // S.DEFAULT_STREAM_BLOCK

    def drive(prec):
        l = S.streamed_cholesky(a_s, precision=prec)
        x_s = S.streamed_cholesky_solve(l, q_s, precision=prec)
        x_b = S.cholesky_solve(S.blocked_cholesky(a_b[None], precision=prec), q_b[None],
                               precision=prec)[0]
        w = S.multi_gamma_solve(a_s, q_s, gammas, precision=prec)
        torch.cuda.synchronize()
        return x_s, x_b, w

    _zero(K)
    _x2_zero(K)
    t_path = time.perf_counter()
    x_s, x_b, w = drive(X2)
    path_s = time.perf_counter() - t_path
    launches, x2_launches = _read(K), _x2_read(K)
    _only(launches, {"panel_factor": n, "panel_trsm": n, "panel_update": n - 1,
                     "panel_tri_inv": n, "blocked_cholesky": 1, "cholesky_solve": 1,
                     "multi_gamma_solve": 1}, "the f32_x2 entry points")
    want_x2 = {name: launches[name] for name in X2_KERNELS}
    if x2_launches != want_x2 or not all(x2_launches.values()):
        fail(f"f32_x2 entry points: split launches {x2_launches}, expected {want_x2}")
    x_s_n, x_b_n, w_n = drive("native")
    plain_s = S.streamed_cholesky_solve(
        S.streamed_cholesky(a_s, use_kernel=False, precision=X2), q_s, use_kernel=False,
        precision=X2)
    _check_close("the streamed route f32_x2 against the plain route", X2_STREAM_D, x_s, plain_s)

    # the reference test's bound against host f64: x2 ≤ 4 × native + 1e-9, < 1e-4
    host = {"streamed": (a_s64, q_s64), "blocked": (a_b64, q_b64), "sweep": (a_s64, q_s64)}
    answers = {"streamed": (x_s, x_s_n), "blocked": (x_b, x_b_n), "sweep": (w[0], w_n[0])}
    bound = {}
    for route, (a64, q64) in host.items():
        sys64 = a64.cpu().numpy()
        if route == "sweep":
            sys64 = sys64 + float(gammas[0]) * np.eye(sys64.shape[0])   # the smallest γ
        want = torch.from_numpy(np.linalg.solve(sys64, q64.cpu().numpy()))
        x2, native = answers[route]
        e2, en = _rel(x2.cpu(), want), _rel(native.cpu(), want)
        bound[route] = dict(d=sys64.shape[0], x2=e2, native=en, ratio=e2 / en)
        log(f"f32_x2 {route} d={sys64.shape[0]}: error against host f64 {e2:.3e}, native "
            f"{en:.3e} (x2 / native {e2 / en:.3f}; bound 4 × native + 1e-9, and 1e-4)")
        if not (e2 <= 4 * en + 1e-9 and e2 < 1e-4):
            fail(f"f32_x2 {route}: error {e2:.3e} against host f64 outside the reference "
                 f"test's bound (native {en:.3e})")
    stream_ms = {p: time_wall(lambda p=p: S.streamed_cholesky_solve(
        S.streamed_cholesky(a_s, precision=p), q_s, precision=p), reps=5)
        for p in ("native", X2)}
    wall = time.perf_counter() - t0
    log(f"f32_x2: the entry points launched {launches}, split launches {x2_launches} "
        f"({path_s:.3f} s); streamed factor + solve at d={X2_STREAM_D}: {stream_ms[X2]:.3f} "
        f"ms, native {stream_ms['native']:.3f} ms; phase 18 wall {wall:.1f} s")
    summary = dict(launches=launches, x2_launches=x2_launches, bits=bits, bound=bound,
                   streamed_ms=stream_ms, path_s=path_s, wall_s=wall,
                   rows={name: [{k: v for k, v in r.items() if k != "profile"}
                                for r in rs] for name, rs in rows.items()})
    log(json.dumps({"f32_x2": summary}))
    return launches, rows


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
            SimpleNamespace(cfg=cfg, params=params, tr=tr, te=te, acc=acc, server=server,
                            weight=server.solve(target_gamma=0.0)))


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

# Table 1's partitions at K = 100: (K, scheme, options). Figure 2's K = 1000
# is host f64 alone (no card code, about 99 s): tests/test_torch_fl.py holds
# it to the reference on the CPU
PAPER_SETTINGS = [
    (100, "iid", {}),
    (100, "niid1", dict(alpha=0.1)),
    (100, "niid2", dict(shards_per_client=2)),
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
    (full-width minicpm_2b): Table 1's partitions
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

    # 2. Table 1's partitions on those embeddings
    settings, servers, weights, accuracies = [], {}, {}, {}
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
        weights[(k, scheme)], accuracies[(k, scheme)] = res.weight, res.accuracy
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
    return total, SimpleNamespace(ds_tr=ds_tr, ds_te=ds_te, weights=weights,
                                  accuracies=accuracies, kappa=kappa)


# --- federation serving: the paper's upload, over the wire ---------------------

FED_UP_S = 120.0        # the served federation's "federation up:" line, at most
FED_STOP_S = 30.0       # SIGINT to exit, then killed
# the report's tolerance when the client's report does not repeat bit for bit
# (tests/test_torch_slice.py: the client report against the reference's)
FED_REPORT_RTOL = 1e-4
FED_WIRE = [(100, "niid1", dict(alpha=0.1), "http"), (100, "iid", {}, "mux")]


class _ServedFederation:
    """``python -m repro_torch.launch.serve --federation …`` in a subprocess:
    no card (``CUDA_VISIBLE_DEVICES`` empty) unless ``card``, a free port, its URL read from
    the ``federation up:`` line within ``FED_UP_S``; SIGINT on exit, then
    killed after ``FED_STOP_S``, whatever the outcome."""

    def __init__(self, root: Path, args, card: bool = False):
        import queue
        import re
        import threading

        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        if not card:
            env["CUDA_VISIBLE_DEVICES"] = ""
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
             "--port", "0", *args], cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        lines: queue.Queue = queue.Queue()

        def pump():
            for line in self.proc.stdout:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
        self.out, self.url = [], None
        deadline = time.monotonic() + FED_UP_S
        try:
            while self.url is None:
                try:
                    line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    fail(f"served federation not up within {FED_UP_S:g} s: {self.out}")
                if line is None:
                    fail(f"served federation exited ({self.proc.wait()}): {self.out}")
                self.out.append(line.rstrip())
                m = re.search(r"federation up: (\S+)", line)
                self.url = m.group(1) if m else None
        except BaseException:
            self.close()
            raise
        self.up_s = time.perf_counter() - t0

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)          # shut down cleanly
            try:
                self.proc.wait(timeout=FED_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=FED_STOP_S)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _timed_remote(service):
    """A ``RemoteCoordinator`` that times its submits (encoding apart from
    the wire and the server), its solves and the bytes it sends."""

    class TimedRemote(service.RemoteCoordinator):
        made = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.encode_s = self.submit_s = self.solve_s = 0.0
            self.sizes = []
            TimedRemote.made.append(self)

        def submit(self, report):
            t0 = time.perf_counter()
            payload = report.to_bytes()
            t1 = time.perf_counter()
            out = self.submit_bytes(payload)
            self.encode_s += t1 - t0
            self.submit_s += time.perf_counter() - t1
            self.sizes.append(len(payload))
            return out

        def solve(self, target_gamma=0.0):
            t0 = time.perf_counter()
            out = super().solve(target_gamma)
            self.solve_s += time.perf_counter() - t0
            return out

    return TimedRemote


def _bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def federation_phase(K, sl, pr, train, afl, api, service, mux, replication,
                     checkpoint, FLConfig):
    """The paper's single upload over the wire. (a) the serve CLI hosts an
    async federation at d = 2304 with a ledger; (b) full-width minicpm_2b's
    ``run_analytic(server_url=…)`` folds on the card and posts its report
    there, and the head must be the in-process heads' bits; (c) the paper
    round at K = 100 over HTTP (NIID-1, a second served federation) and over
    ``mux://`` (iid, an in-process ``serve_mux``), each weight the
    in-process ``run_afl``'s bits; (d) the served state through a checkpoint
    and through a warm standby replaying the ledger, the same bits."""
    import tempfile

    root = Path(__file__).resolve().parent
    cfg, params, tr, te = sl.cfg, sl.params, sl.tr, sl.te
    d, c, batch = cfg.d_model, cfg.num_classes, SLICE["batch"]
    fl = FLConfig(gamma=1.0)
    total, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="afl-federation-") as tmp:
        tmp = Path(tmp)
        ledger = tmp / "ledger"
        # (a) + (b): the entry point, and a full-width client on the card
        with _ServedFederation(root, ["--coordinator", "async", "--dim", str(d),
                                      "--classes", str(c), "--gamma", str(fl.gamma),
                                      "--ledger-dir", str(ledger)]) as fed:
            log(f"federation: served async federation up in {fed.up_s:.2f} s at "
                f"{fed.url} (d={d} C={c}, ledger {ledger})")
            expected = len(tr) // batch
            forwards = expected + len(te) // batch
            _zero(K)
            t0 = time.perf_counter()
            acc, train_s = train.run_analytic(cfg, tr, te, fl, batch, use_kernel=True,
                                              device="cuda", params=params,
                                              server_url=fed.url)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _read(K)
            fa_cuda = K.FA.flash_attention.cuda_launches
            _only(got, {"gram_update": expected,
                        "flash_attention": cfg.num_layers * forwards},
                  "run_analytic(server_url=…)")
            if fa_cuda != cfg.num_layers * forwards:
                fail(f"run_analytic(server_url=…): {fa_cuda} flash CUDA launches, "
                     f"expected {cfg.num_layers * forwards}")
            _add_launches(total, K)
            rc = service.RemoteCoordinator(fed.url)
            try:
                info = rc.describe()
                w_remote = rc.solve()
                t0 = time.perf_counter()
                state = rc.state()
                state_s = time.perf_counter() - t0
            finally:
                rc.close()
            records = replication.LedgerTailer(ledger).poll()
            if len(records) != 1 or info["num_clients"] != 1:
                fail(f"federation: {len(records)} ledger records and "
                     f"{info['num_clients']} clients after one run_analytic")
            report = api.ClientReport.from_bytes(records[0][2])
            oracle = api.AFLServer(d, c, gamma=fl.gamma)
            oracle.submit(report)
            w_oracle = oracle.solve()
            stats, slice_stats = oracle._stats, sl.server._stats
            report_same = (_bits(stats.gram, slice_stats.gram)
                           and _bits(stats.moment, slice_stats.moment))
            report_rel = max(_rel(torch.from_numpy(stats.gram),
                                  torch.from_numpy(slice_stats.gram)),
                             _rel(torch.from_numpy(stats.moment),
                                  torch.from_numpy(slice_stats.moment)))
            slice_rel = float(np.abs(w_remote - sl.weight).max()
                              / np.abs(sl.weight).max())
            log(f"federation: run_analytic(server_url=…) acc={acc:.4f} (slice "
                f"{sl.acc:.4f}) train_s={train_s:.3f} wall_s={wall:.3f}; launches "
                f"gram_update {got['gram_update']} (expected {expected}), "
                f"flash_attention {got['flash_attention']} (expected {cfg.num_layers} "
                f"x {forwards}), {fa_cuda} CUDA; report on the wire "
                f"{len(records[0][2])} bytes (root {'none' if report.root is None else report.root.shape}); "
                f"remote head vs in-process solve of the ledger's report: "
                f"{'the same bits' if _bits(w_remote, w_oracle) else 'DIFFERENT'}; "
                f"the report vs the slice's: "
                + ("the same bits" if report_same else f"differs, {report_rel:.3e} relative")
                + f"; remote head vs the slice's weight {slice_rel:.3e} relative")
            if not _bits(w_remote, w_oracle):
                fail("federation: the served head is not the in-process solve of the "
                     "report its ledger recorded, bit for bit")
            if report_same and not _bits(w_remote, sl.weight):
                fail("federation: the same report, yet the served head is not the "
                     "slice's weight bit for bit")
            if not report_same and report_rel > FED_REPORT_RTOL:
                fail(f"federation: the client's report is {report_rel:.3e} from the "
                     f"slice's, more than {FED_REPORT_RTOL:g}")
            if acc != sl.acc:
                fail(f"federation: accuracy {acc} over the wire, {sl.acc} in the slice")
            out["client"] = dict(
                accuracy=acc, slice_accuracy=sl.acc, train_s=train_s, wall_s=wall,
                server_up_s=fed.up_s, report_bytes=len(records[0][2]),
                launches=dict(got, flash_attention_cuda=fa_cuda),
                head_equals_ledger_solve=True, report_equals_slice=report_same,
                report_rel_to_slice=report_rel, head_rel_to_slice=slice_rel)

            # (d) the state carried across: a checkpoint, and a warm standby
            t0 = time.perf_counter()
            checkpoint.save(tmp / "ck", state)
            restored = checkpoint.load_server(tmp / "ck")
            w_ck = restored.solve()
            ck_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            standby = replication.WarmStandby(
                ledger, ctor_kw=dict(dim=d, num_classes=c, gamma=fl.gamma))
            w_sb = standby.promote().solve()
            sb_s = time.perf_counter() - t0
            log(f"federation: state() over the wire in {state_s:.3f} s, through "
                f"checkpoint.save / load_server into a fresh AFLServer and solved in "
                f"{ck_s:.3f} s: {'the same bits' if _bits(w_ck, w_remote) else 'DIFFERENT'}; "
                f"a WarmStandby replaying the ledger ({standby.applied} records) and "
                f"promoted in {sb_s:.3f} s: "
                f"{'the same bits' if _bits(w_sb, w_remote) else 'DIFFERENT'}")
            if not (_bits(w_ck, w_remote) and _bits(w_sb, w_remote)):
                fail("federation: a checkpoint or a warm standby of the served state "
                     "does not solve to the served head's bits")
            out["state"] = dict(state_s=state_s, checkpoint_s=ck_s, standby_s=sb_s,
                                standby_records=standby.applied,
                                checkpoint_bits=True, standby_bits=True)

        # (c) the paper round over the wire, at K = 100
        rounds = []
        for k, scheme, kw, wire in FED_WIRE:
            fl_k = FLConfig(num_clients=k, gamma=fl.gamma, partition=scheme, **kw)
            timed = _timed_remote(service)
            real = service.RemoteCoordinator
            if wire == "http":
                served = _ServedFederation(root, ["--coordinator", "sync", "--dim", str(d),
                                                  "--classes", str(c),
                                                  "--gamma", str(fl.gamma)])
            else:
                served = mux.serve_mux(service.FederationService(
                    api.AFLServer(d, c, gamma=fl.gamma)))
            try:
                url = served.url
                service.RemoteCoordinator = timed       # run_afl's own URL branch
                t0 = time.perf_counter()
                res = afl.run_afl(pr.ds_tr, pr.ds_te, fl_k, coordinator=url)
                wall = time.perf_counter() - t0
            finally:
                service.RemoteCoordinator = real
                for remote in timed.made:
                    remote.close()
                served.close()
            (remote,) = timed.made
            w_local = pr.weights[(k, scheme)]
            sizes = np.array(remote.sizes)
            local_s = res.train_seconds - remote.encode_s - remote.submit_s - remote.solve_s
            row = dict(K=k, partition=scheme, **kw, transport=url.split(":")[0],
                       accuracy=res.accuracy, accuracy_in_process=pr.accuracies[(k, scheme)],
                       weight_bits=_bits(res.weight, w_local),
                       train_seconds=res.train_seconds, wall_s=wall,
                       local_stages_s=local_s, encode_s=remote.encode_s,
                       submits_s=remote.submit_s, solve_s=remote.solve_s,
                       reports=int(len(sizes)), bytes_total=int(sizes.sum()),
                       bytes_per_report=float(sizes.mean()),
                       s_per_report=remote.submit_s / len(sizes),
                       wire_gb_s=float(sizes.sum()) / remote.submit_s / 1e9)
            rounds.append(row)
            opts = "".join(f" {n}={v}" for n, v in kw.items())
            log(f"federation: run_afl K={k} {scheme}{opts} over {row['transport']}:// "
                f"acc={res.accuracy:.4f} (in process {row['accuracy_in_process']:.4f}); "
                f"weight vs the in-process run_afl's: "
                f"{'the same bits' if row['weight_bits'] else 'DIFFERENT'}; "
                f"train_seconds={res.train_seconds:.3f} (local stages and partition "
                f"{local_s:.3f}, encoding {remote.encode_s:.3f}, submits on the wire "
                f"{remote.submit_s:.3f}, solve {remote.solve_s:.3f}); {len(sizes)} reports, "
                f"{row['bytes_total'] / 1e9:.3f} GB, {row['bytes_per_report'] / 1e6:.3f} MB "
                f"and {1e3 * row['s_per_report']:.1f} ms a report on the wire "
                f"({row['wire_gb_s']:.3f} GB/s)")
            if not row["weight_bits"] or res.accuracy != row["accuracy_in_process"]:
                fail(f"federation: run_afl K={k} {scheme} over {row['transport']} is not "
                     "the in-process run_afl's weight bit for bit, or its accuracy")
    out["rounds"] = rounds
    log(json.dumps({"federation": dict(arch=cfg.name, d=d, classes=c, **out,
                                       launches=total)}))
    return total


# --- the sharded coordinator: the tile-parallel Cholesky over a shard mesh -----

SHARDS = 8
SHARD_ROUND = (100, "niid1", dict(alpha=0.1))    # phase 11's K = 100 NIID-1 round
# panel launches (factor, trsm, update, tri_inv) of one tiled distributed solve:
# n·P / n·P / n·(P − 1) / 0, P = d_p / panel_width(rows, stream_block(dtype))
SHARD_STREAM = [(8, torch.float32), (8, torch.float64), (7, torch.float32)]
SHARD_GROW, SHARD_SHRINK = 4, 8                  # 8 → 12 → 4 shards over the wire


def _expected_panels(S, d_p, rows, n, dtype) -> list:
    panels = d_p // S.panel_width(rows, S.stream_block(dtype))
    return [n * panels, n * panels, n * (panels - 1), 0]


# the tile plans of phase 14 (d, shards, dtype), the served grow (12) and
# shrink (4) included: the panel kernels get each plan's panel width b, and
# slabs of a shard's (r, d_p) work copy with r the tile rows, not d
SHARD_PLANS = [(2304, 8, torch.float32), (2304, 8, torch.float64),
               (6144, 8, torch.float32), (6144, 8, torch.float64),
               (6144, 7, torch.float32), (2304, 12, torch.float32),
               (2304, 4, torch.float32)]


def sharded_kernel_phase(P, ref, S, api):
    """Each panel kernel against its plain version at the shapes phase 14's
    tile plans give it: ``panel_factor`` at each panel width,
    ``panel_trsm`` on an (r, b) column slab of a shard's (r, d_p) work copy,
    and ``panel_update`` in place on that copy's widest and narrowest
    trailing slab, as the schedule calls it, with the columns left of the
    slab checked untouched. Timed beside the plain version and the library
    call; the rows join each kernel's table."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rows, seen = {}, set()

    def work(r, d_p, dtype):
        return torch.randn((r, d_p), generator=gen, device="cuda", dtype=dtype)

    def check(name, shape, dtype, got, want):
        dt = str(dtype).removeprefix("torch.")
        rel = _rel(got, want)
        if dtype == torch.float64 or name == "panel_factor":
            bar = F64_REL if dtype == torch.float64 else PANEL_REL
            if not (rel <= bar and torch.isfinite(got).all()):
                fail(f"{name} {shape} {dt} (sharded plan): relative error {rel:.2e} "
                     f"against the plain version, above {bar}")
        else:
            torch.testing.assert_close(got, want, rtol=GRAM_TOL[dtype][0],
                                       atol=GRAM_TOL[dtype][1])
        return rel

    def add(name, shape, dtype, got, want, kernel, plain, library, flops, nbytes, note):
        rel = check(name, shape, dtype, got, want)
        rows.setdefault(name, []).append(_kernel_row(
            name, shape, _abs(got, want), rel, time_auto(kernel), time_auto(plain),
            None if library is None else time_auto(library), flops, nbytes, note, dtype))

    for d, n, dtype in SHARD_PLANS:
        r = api.ShardedCoordinator._plan_tile_rows(d, n)
        d_p, b = n * r, S.panel_width(r, S.stream_block(dtype))
        size = torch.tensor([], dtype=dtype).element_size()
        note = f"; sharded plan d={d} over {n} shards (tiles of {r} rows, d_p={d_p})"
        if ("factor", b, dtype) not in seen:
            seen.add(("factor", b, dtype))
            a = _spd_block(gen, b).to(dtype)
            l, z = P.panel_factor(a)
            l_twin, z_twin = ref.panel_factor_blocked_ref(a)
            torch.cuda.synchronize()
            check("panel_factor", (b,), dtype, l, l_twin)
            check("panel_factor's inverse", (b,), dtype, z, z_twin)
            if torch.triu(l, 1).any() or torch.triu(z, 1).any():
                fail(f"panel_factor at b={b} (sharded plan): upper triangle not exactly zero")
            l_ref, z_ref = ref.panel_factor_ref(a)
            check("panel_factor's inverse", (b,), dtype, z, z_ref)
            add("panel_factor", (b,), dtype, l, l_ref, lambda: P.panel_factor(a),
                lambda: ref.panel_factor_ref(a), None, 2 * b ** 3 / 3,
                size * (_tri(b) + 2 * b * b), note + f"; {_factor_design(b, dtype)}")
        if ("trsm", r, b, dtype) not in seen:
            seen.add(("trsm", r, b, dtype))
            raw = work(r, d_p, dtype)[:, d_p - b:]
            zinv = torch.tril(torch.randn((b, b), generator=gen, device="cuda", dtype=dtype))
            add("panel_trsm", (r, b), dtype, P.panel_trsm(raw, zinv),
                ref.panel_trsm_ref(raw, zinv), lambda: P.panel_trsm(raw, zinv),
                lambda: ref.panel_trsm_ref(raw, zinv), lambda: torch.mm(raw, zinv.T),
                r * b * (b + 1), size * (2 * r * b + _tri(b)), note + f", row stride {d_p}")
        for w in (d_p - b, b):                  # the first panel's update and the last's
            if ("update", r, w, b, dtype) in seen:
                continue
            seen.add(("update", r, w, b, dtype))
            full = work(r, d_p, dtype)
            left = full[:, :d_p - w].clone()
            trail = full[:, d_p - w:]
            lp = torch.randn((r, b), generator=gen, device="cuda", dtype=dtype)
            pt = torch.randn((w, b), generator=gen, device="cuda", dtype=dtype)
            want = ref.panel_update_ref(trail, lp, pt)
            got = P.panel_update(trail, lp, pt, out=trail)     # in place, as the path does
            torch.cuda.synchronize()
            if not torch.equal(full[:, :d_p - w], left):
                fail(f"panel_update ({r}, {w}, {b}) in place at row stride {d_p}: it wrote "
                     "outside its slab")
            add("panel_update", (r, w, b), dtype, got, want,
                lambda: P.panel_update(trail, lp, pt, out=trail),
                lambda: ref.panel_update_ref(trail, lp, pt, out=trail),
                lambda: torch.addmm(trail, lp, pt.T, alpha=-1), 2 * r * w * b,
                size * (2 * r * w + r * b + w * b), note + f", in place at row stride {d_p}")
    return rows


class _Tee:
    """One ``run_afl`` round into several coordinators at once: every report
    goes to each (host seconds per coordinator kept); ``solve`` answers the
    first's. ``run_afl`` takes any object with ``dim``, ``gamma``,
    ``submit`` and ``solve``."""

    def __init__(self, coords: dict):
        self.coords = coords
        first = next(iter(coords.values()))
        self.dim, self.gamma = first.dim, first.gamma
        self.submit_s = dict.fromkeys(coords, 0.0)

    def submit(self, report):
        for name, coord in self.coords.items():
            t0 = time.perf_counter()
            coord.submit(report)
            self.submit_s[name] += time.perf_counter() - t0
        return True

    def solve(self, target_gamma=0.0):
        return next(iter(self.coords.values())).solve(target_gamma)


def _stream_system(d=None):
    """Phase 3's seeded SPD system: (a, rhs) in f32 on the card."""
    d = d or STREAM_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6144)
    x = torch.randn((4 * d, d), generator=gen, device="cuda")
    a = x.T @ x / (4 * d)                 # condition number ≈ 9
    del x
    return a, torch.randn((d, STREAM_C), generator=gen, device="cuda")


def _tiled(a, rhs, n, rows, dtype):
    """(n, rows, d_p) and (n, rows, C) zero-padded row tiles of (a, rhs)."""
    d, d_p = a.shape[0], n * rows
    g = torch.zeros((d_p, d_p), dtype=dtype, device="cuda")
    g[:d, :d] = a
    m = torch.zeros((d_p, rhs.shape[1]), dtype=dtype, device="cuda")
    m[:d] = rhs
    return g.reshape(n, rows, d_p), m.reshape(n, rows, rhs.shape[1])


PANEL_NAMES = ("panel_factor", "panel_trsm", "panel_update", "panel_tri_inv")


def _host(tiles) -> list:
    """Row tiles as the coordinator keeps them: host f64 arrays."""
    return [t.double().cpu().numpy() for t in tiles]


def _peak_above(fn, uploaded: int) -> int:
    """Peak device bytes of ``fn()`` above what was allocated before it and
    above the ``uploaded`` bytes of its tiles."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base - uploaded, out


def host_split(S, DD, mesh, gt, mt, b) -> dict:
    """Host milliseconds of one tiled distributed factor + solve, split on
    each shard's thread into the collectives (the barrier's waits and its
    combine) and the rest (the schedule's Python and its launches), beside
    the wall of the whole run and of an empty run of the same threads."""
    group, n = DD.ShardGroup(mesh), len(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    group.run(lambda s: None)
    empty = time.perf_counter() - t0

    def fn(s):
        spent = [0.0, 0]

        def timed(collective):
            def call(x):
                t = time.perf_counter()
                out = collective(x)
                spent[0] += time.perf_counter() - t
                spent[1] += 1
                return out
            return call

        t = time.perf_counter()
        gather, psum = timed(s.gather), timed(s.psum)
        tile_l, zs = S.tile_cholesky_factor(gt[s.index], shard=s.index, n_shards=n,
                                            gather=gather, block=b)
        S.tile_cholesky_solve(tile_l, mt[s.index], zs, shard=s.index, n_shards=n,
                              gather=gather, psum=psum, block=b)
        return time.perf_counter() - t, spent[0], spent[1]

    t0 = time.perf_counter()
    per = group.run(fn)
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    own = statistics.mean(p[0] for p in per)
    coll = statistics.mean(p[1] for p in per)
    return dict(wall_ms=1e3 * wall, issued_ms=1e3 * issued, empty_run_ms=1e3 * empty,
                shard_ms=1e3 * own, collective_ms=1e3 * coll, schedule_ms=1e3 * (own - coll),
                collectives=per[0][2])


def sharded_stream(K, S, DD, api, total):
    """Phase 3's d = 6144 system (nemotron4_15b's and grok1's head width)
    as row tiles on cuda:0 through ``make_tiled_federated_solve``: 8 shards
    in f32 and f64 and 7 (padded) in f32, each held to numpy f64, its panel
    launches counted, its peak device bytes above the uploaded tiles read
    on host f64 tiles as ``ShardedCoordinator`` passes them, and timed
    beside the one-shard streamed solve and torch.linalg; the gather branch
    beside the 8-shard f32 one, and one profiled 8-shard f32 factor with
    the host split of one solve."""
    names, cuda = PANEL_NAMES, ["cuda:0"]
    a, rhs = _stream_system()
    ds = a.shape[0]
    a64 = a.double()
    ev = torch.linalg.eigvalsh(a64)
    kappa_s = float(ev[-1] / ev[0])
    x_np = np.linalg.solve(a64.cpu().numpy(), rhs.double().cpu().numpy())
    systems = []
    for n, dtype in SHARD_STREAM:
        dt = str(dtype).removeprefix("torch.")
        rows_s = api.ShardedCoordinator._plan_tile_rows(ds, n)
        d_p = n * rows_s
        mesh = DD.federation_mesh(n, cuda)
        dist = DD.make_tiled_federated_solve(mesh, distributed_factor=True, dim=ds,
                                             dtype=dtype)
        expect = _expected_panels(S, d_p, rows_s, n, dtype)
        gt, mt = _tiled(a, rhs, n, rows_s, dtype)
        hg, hm = _host(gt), _host(mt)
        size = gt.element_size()
        uploaded = size * (gt.numel() + mt.numel())
        # a first call: what it leaves allocated (each shard thread's cuBLAS
        # handle and workspace) is the library's, not the schedule's, so the
        # peak below is read after it
        before = torch.cuda.memory_allocated()
        dist(hg, hm)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - before
        _zero(K)
        peak, w = _peak_above(lambda: dist(hg, hm), uploaded)
        got = _read(K)
        _only(got, dict(zip(names, expect)), f"tiled solve d={ds} over {n} shards {dt}")
        _add_launches(total, K)
        u = F64_U if dtype == torch.float64 else F32_U
        rel = _rel(w.cpu(), torch.from_numpy(x_np))
        system_bytes = d_p * d_p * size
        row = dict(shards=n, dtype=dt, rows=rows_s, d_p=d_p,
                   panel=S.panel_width(rows_s, S.stream_block(dtype)),
                   launches=dict(zip(names, expect)), rel_numpy=rel,
                   rel_numpy_ku=rel / (kappa_s * u), kappa=kappa_s,
                   peak_above_tiles_bytes=peak, uploaded_tiles_bytes=uploaded,
                   system_bytes=system_bytes, first_call_kept_bytes=kept)
        if not rel <= PAPER_KU * kappa_s * u:
            fail(f"tiled solve d={ds} over {n} shards {dt}: {rel:.3e} from numpy f64, more "
                 f"than {PAPER_KU:g}·κ·u")
        if not peak < system_bytes:
            fail(f"tiled solve d={ds} over {n} shards {dt}: {peak} bytes above the uploaded "
                 f"tiles, not below one ({d_p}, {d_p}) system ({system_bytes})")
        row["ms"] = time_wall(lambda: dist(gt, mt), reps=3)
        row["host_tiles_ms"] = time_wall(lambda: dist(hg, hm), reps=3)
        ad = a.to(dtype)
        rd = rhs.to(dtype)
        row["streamed_ms"] = time_wall(
            lambda: S.streamed_cholesky_solve(S.streamed_cholesky(ad), rd), reps=3)
        row["library_ms"] = time_wall(
            lambda: torch.cholesky_solve(rd, torch.linalg.cholesky(ad)), reps=3)
        if (n, dtype) == (SHARDS, torch.float32):
            gather = DD.make_tiled_federated_solve(mesh, dim=ds, dtype=dtype)
            g_peak, w_g = _peak_above(lambda: gather(hg, hm), uploaded)
            row["gather_peak_above_tiles_bytes"] = g_peak
            row["gather_rel_numpy"] = _rel(w_g.cpu(), torch.from_numpy(x_np))
            row["gather_ms"] = time_wall(lambda: gather(gt, mt), reps=3)
            if not g_peak >= system_bytes:
                fail(f"the gather branch at d={ds} peaked {g_peak} bytes above the uploaded "
                     f"tiles, less than one system ({system_bytes}): the measure is broken")
            b = row["panel"]
            prof = kernel_breakdown(lambda: DD.ShardGroup(mesh).run(
                lambda s: S.tile_cholesky_factor(gt[s.index], shard=s.index, n_shards=n,
                                                 gather=s.gather, block=b)),
                FACTOR_PARTS)
            _log_breakdown(f"sharded factor d={ds} over {n} shards f32 (panels of {b}), one "
                           "call profiled", prof,
                           dict(zip(FACTOR_PARTS, ("panel_factor", "panel_trsm",
                                                   "panel_update"))))
            row["factor_profile"] = prof
            row["host_split"] = split = host_split(S, DD, mesh, gt, mt, b)
            log(f"sharded: one factor + solve d={ds} over {n} shards f32, host split: wall "
                f"{split['wall_ms']:.2f} ms ({split['issued_ms']:.2f} ms until every thread "
                f"returned); an empty run of the {n} threads {split['empty_run_ms']:.3f} ms; "
                f"a shard's thread {split['shard_ms']:.2f} ms, of it "
                f"{split['collective_ms']:.2f} ms in {split['collectives']} collectives "
                f"(barrier waits and combines) and {split['schedule_ms']:.2f} ms in the "
                f"schedule's Python and launches (means over the shards)")
        del gt, mt, hg, hm, ad, rd
        systems.append(row)
        log(f"sharded: d={ds} over {n} shards {dt} (tiles of {rows_s} rows, d_p={d_p}, "
            f"panels of {row['panel']}): launches {row['launches']}; vs numpy f64 "
            f"{rel:.3e} = {row['rel_numpy_ku']:.3f}·κ·u (κ={kappa_s:.3f}, limit "
            f"{PAPER_KU:g}·κ·u); peak {peak / 1e6:.1f} MB above the {uploaded / 1e6:.1f} MB "
            f"of uploaded host tiles (one system {system_bytes / 1e6:.1f} MB; the first "
            f"call left {kept / 1e6:.1f} MB allocated: the shard threads' library "
            f"workspaces); solve {row['ms']:.2f} ms on device tiles, "
            f"{row['host_tiles_ms']:.2f} ms on host f64 tiles, one-shard streamed "
            f"factor + solve {row['streamed_ms']:.2f} ms, torch.linalg.cholesky + "
            f"cholesky_solve {row['library_ms']:.2f} ms"
            + (f"; gather branch {row['gather_ms']:.2f} ms, peak "
               f"{row['gather_peak_above_tiles_bytes'] / 1e6:.1f} MB above the uploaded "
               f"tiles, vs numpy {row['gather_rel_numpy']:.3e}" if "gather_ms" in row else ""))
    del a, rhs, a64
    return systems


def sharded_phase(K, S, DD, sl, pr, afl, api, service, FLConfig):
    """The sharded coordinator (``fl.api.ShardedCoordinator``,
    ``core.distributed``) on the card: (a) phase 11's K = 100 NIID-1 round
    at minicpm_2b's head width through eight row tiles on cuda:0, the
    distributed factor in f32 and f64, the whole-leaf psum and the gather
    branch; (b) phase 3's d = 6144 system over 8 and 7 shards through
    ``make_tiled_federated_solve``, timed beside the one-shard streamed
    solve and torch.linalg, its peak device bytes, and one profiled factor;
    (c) the served sharded federation, grown and shrunk over the wire."""
    root = Path(__file__).resolve().parent
    d, c = sl.cfg.d_model, sl.cfg.num_classes
    k, scheme, kw = SHARD_ROUND
    fl = FLConfig(num_clients=k, gamma=1.0, partition=scheme, **kw)
    w_host = pr.weights[(k, scheme)]              # phase 11's AFLServer (host f64)
    acc_host = pr.accuracies[(k, scheme)]
    kappa = pr.kappa
    cuda = ["cuda:0"]
    total, out = {}, {}

    def held(what, w, u):
        """``w`` against the host f64 weight: within 10·κ·u of its type (phase
        6's bar in f32, phase 10's in f64), where the host Gram is definite."""
        rel = float(np.abs(w - w_host).max() / np.abs(w_host).max())
        if math.isfinite(kappa):
            bar = DEVICE_HOST_KU * kappa * u
            if not rel <= bar:
                fail(f"sharded: {what} is {rel:.3e} from the host f64 weight, more than "
                     f"{bar:.3e}")
            return rel, rel / (kappa * u)
        return rel, None

    # (a) one round into four coordinators: the tiled distributed factor in
    # f32 (run_afl's own solve) and f64, the whole-leaf psum over eight
    # participants on the card, and the tiled gather branch
    coords = {
        "tiled_f32": api.ShardedCoordinator(d, c, gamma=fl.gamma, tiled_gram=True,
                                            num_shards=SHARDS, devices=cuda),
        "tiled_f64": api.ShardedCoordinator(d, c, gamma=fl.gamma, tiled_gram=True,
                                            num_shards=SHARDS, devices=cuda,
                                            dtype=torch.float64),
        "whole_leaf_f32": api.ShardedCoordinator(d, c, gamma=fl.gamma, num_shards=SHARDS,
                                                 devices=cuda * SHARDS),
        "gather_f32": api.ShardedCoordinator(d, c, gamma=fl.gamma, tiled_gram=True,
                                             num_shards=SHARDS, devices=cuda,
                                             distributed_factor=False),
    }
    rows = coords["tiled_f32"]._tile_rows
    tee = _Tee(coords)
    _zero(K)
    t0 = time.perf_counter()
    res = afl.run_afl(pr.ds_tr, pr.ds_te, fl, coordinator=tee)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read(K)
    want = _expected_panels(S, SHARDS * rows, rows, SHARDS, torch.float32)
    names = PANEL_NAMES
    _only(got, dict(zip(names, want)), "run_afl through the tiled f32 coordinator")
    _add_launches(total, K)
    rel, ku = held("run_afl's tiled f32 weight", res.weight, F32_U)
    log(f"sharded: run_afl K={k} {scheme} α={kw['alpha']} into 4 ShardedCoordinators "
        f"(d={d}, {SHARDS} shards on cuda:0, tiles of {rows} rows, panels of "
        f"{S.panel_width(rows, S.stream_block(torch.float32))}) in {wall:.3f} s "
        f"(train_seconds {res.train_seconds:.3f}; host submits "
        + ", ".join(f"{n} {s:.3f} s" for n, s in tee.submit_s.items())
        + f"); acc={res.accuracy:.4f} (phase 11 {acc_host:.4f}); weight vs host f64 "
        f"{rel:.3e}" + (f" = {ku:.3f}·κ·u32" if ku is not None else "")
        + f"; panel launches of its solve {dict(zip(names, want))}")
    if res.accuracy != acc_host:
        fail(f"sharded: run_afl accuracy {res.accuracy} != phase 11's {acc_host}")
    solves, first = {}, {}
    for name, coord in coords.items():
        dtype = coord.dtype
        tiled_dist = coord.tiled_gram and coord.distributed_factor
        expect = (_expected_panels(S, SHARDS * rows, rows, SHARDS, dtype) if tiled_dist
                  else [0, 0, 0, 0])
        counts = []
        weights = []
        for _ in range(2):                    # the second: the same bits
            _zero(K)
            t0 = time.perf_counter()
            weights.append(coord.solve())
            ms = 1e3 * (time.perf_counter() - t0)
            counts.append(_read(K))
            _add_launches(total, K)
        for c_ in counts:
            _only(c_, dict(zip(names, expect)), f"sharded solve {name}")
        same = _bits(weights[0], weights[1])
        first[name] = weights[0]
        u = F64_U if dtype == torch.float64 else F32_U
        rel, ku = held(f"the {name} solve", weights[0], u)
        acc = api.evaluate_weight(weights[0], pr.ds_te.x, pr.ds_te.y)
        solves[name] = dict(dtype=str(dtype).removeprefix("torch."), ms=ms,
                            participants=len(coord.mesh), launches=dict(zip(names, expect)),
                            rel_host=rel, rel_host_ku=ku, repeat_bits=same, accuracy=acc)
        log(f"sharded: {name} solve ({len(coord.mesh)} participants, "
            f"{solves[name]['dtype']}) {ms:.1f} ms (second call, host wall); panel "
            f"launches {dict(zip(names, expect))} each solve; vs host f64 {rel:.3e}"
            + (f" = {ku:.3f}·κ·u{'64' if u == F64_U else '32'}" if ku is not None else "")
            + f"; acc={acc:.4f}; repeat solve "
            + ("the same bits" if same else "DIFFERENT"))
        if not same:
            fail(f"sharded: a second {name} solve gave other bits")
        if coord.host_fallbacks:
            fail(f"sharded: {coord.host_fallbacks} {name} solves were non-finite on the "
                 "card and answered by the host engine")
        if name != "tiled_f32" and acc != acc_host:
            fail(f"sharded: {name} accuracy {acc} != phase 11's {acc_host}")
    if not _bits(first["tiled_f32"], res.weight):
        fail("sharded: the tiled f32 coordinator's solve is not run_afl's weight")
    mirror = coords["tiled_f32"]          # the served federation's twin, resized alike
    out["round"] = dict(K=k, partition=scheme, **kw, d=d, shards=SHARDS, rows=rows,
                        accuracy=res.accuracy, accuracy_host=acc_host, kappa=kappa,
                        train_seconds=res.train_seconds, wall_s=wall,
                        submit_s=tee.submit_s, solves=solves)

    # (b) phase 3's d = 6144 system over 8 and 7 shards
    out["stream"] = sharded_stream(K, S, DD, api, total)

    # (c) the served sharded federation, grown and shrunk over the wire
    with _ServedFederation(root, ["--coordinator", "sharded", "--shards", str(SHARDS),
                                  "--tiled", "--dim", str(d), "--classes", str(c),
                                  "--gamma", str(fl.gamma)], card=True) as fed:
        log(f"sharded: served sharded federation up in {fed.up_s:.2f} s at {fed.url} "
            f"({fed.out[-1].strip()})")
        t0 = time.perf_counter()
        res_w = afl.run_afl(pr.ds_tr, pr.ds_te, fl, coordinator=fed.url)
        wire_s = time.perf_counter() - t0
        if not _bits(res_w.weight, first["tiled_f32"]):
            fail("sharded: the served head is not the in-process ShardedCoordinator's "
                 "solve of the same reports, bit for bit")
        steps = []
        rc = service.RemoteCoordinator(fed.url)
        try:
            for verb, n in (("grow", SHARD_GROW), ("shrink", SHARD_SHRINK)):
                before = rc.describe()
                t0 = time.perf_counter()
                epoch = getattr(rc, verb)(n)
                resize_s = time.perf_counter() - t0
                info = rc.describe()
                t0 = time.perf_counter()
                w = rc.solve()
                solve_s = time.perf_counter() - t0
                rel, ku = held(f"the served head after {verb}({n})", w, F32_U)
                # the in-process twin takes the same resize: its solve, on the
                # card and not the host's (host_fallbacks 0), is the served one
                getattr(mirror, verb)(n)
                if not _bits(w, mirror.solve()) or mirror.host_fallbacks:
                    fail(f"sharded: the served head after {verb}({n}) is not the in-process "
                         "coordinator's card solve after the same resize, bit for bit")
                steps.append(dict(verb=verb, n=n, shards=info["num_shards"],
                                  mesh_epoch=info["mesh_epoch"], resize_s=resize_s,
                                  solve_s=solve_s, rel_host=rel, rel_host_ku=ku,
                                  twin_bits=True))
                log(f"sharded: {verb}({n}) over the wire in {resize_s:.3f} s: "
                    f"{before['num_shards']} → {info['num_shards']} shards, mesh_epoch "
                    f"{before['mesh_epoch']} → {info['mesh_epoch']}; solve {solve_s:.3f} s, "
                    f"vs host f64 {rel:.3e}" + (f" = {ku:.3f}·κ·u32" if ku is not None else "")
                    + "; the in-process twin's bits after the same resize")
                if not (epoch == info["mesh_epoch"] > before["mesh_epoch"]):
                    fail(f"sharded: {verb} did not advance mesh_epoch ({before} → {info})")
            state = rc.state()
        finally:
            rc.close()
    w_state = api.AFLServer.from_state(state).solve()
    if not _bits(w_state, w_host):
        fail("sharded: the served state does not restore in an AFLServer to the host "
             "weight's bits")
    log(f"sharded: run_afl K={k} {scheme} over HTTP to the served 8-shard tiled "
        f"federation in {wire_s:.3f} s (train_seconds {res_w.train_seconds:.3f}), "
        f"acc={res_w.accuracy:.4f}; the served head the in-process coordinator's bits; "
        f"its state() restored in an AFLServer solves to the host weight's bits")
    out["served"] = dict(up_s=fed.up_s, wire_s=wire_s, train_seconds=res_w.train_seconds,
                         accuracy=res_w.accuracy, head_bits=True, state_bits=True,
                         steps=steps)
    log(json.dumps({"sharded": dict(arch=sl.cfg.name, **out, launches=total)}))
    return total


# --- flash attention: kernel phase ----------------------------------------------

# tests/test_kernels_attention.py's tolerances: (rtol, atol)
ATTN_TOL = {torch.float32: (2e-5, 4e-4), torch.bfloat16: (2e-2, 0.4)}
# (name, (B, Hq, Hkv, Sq, Skv, D), kw, dtype): the serve path's prefill and
# decode step first (gemma3_12b, window 1024 on local layers), then slice
# 1's trainer forward (minicpm_2b), then the reference tests' ragged cases,
# then the split-KV decode's edges at the serve step's widths, then the
# zoo's serve shapes (batch 4, prompt 512, the last decode step of 8):
# granite's group of 3 at D 64, grok1's logit softcap of 30 at D 128 over 48
# / 8 heads, zamba2's D 112 (in the D = 128 instance), seamless's
# non-causal encoder and cross-attention decode over 512 frames
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
    ("granite prefill", (4, 24, 8, 512, 512, 64), dict(), torch.float32),
    ("granite decode", (4, 24, 8, 1, 520, 64), dict(q_offset=518), torch.float32),
    ("grok1 softcap prefill", (4, 48, 8, 512, 512, 128), dict(softcap=30.0), torch.float32),
    ("grok1 prefill, no softcap", (4, 48, 8, 512, 512, 128), dict(), torch.float32),
    ("grok1 softcap decode", (4, 48, 8, 1, 520, 128), dict(q_offset=518, softcap=30.0),
     torch.float32),
    ("grok1 decode, no softcap", (4, 48, 8, 1, 520, 128), dict(q_offset=518), torch.float32),
    ("zamba2 D 112 prefill", (4, 32, 32, 512, 512, 112), dict(), torch.float32),
    ("zamba2 D 112 decode", (4, 32, 32, 1, 520, 112), dict(q_offset=518), torch.float32),
    ("seamless encoder, non-causal", (4, 16, 16, 512, 512, 64), dict(causal=False),
     torch.float32),
    ("seamless cross-attention decode", (4, 16, 16, 1, 512, 64), dict(causal=False),
     torch.float32),
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
    against q and o and the keys and values some row sees, each moved once.
    A softcap's tanh per pair is not counted: at D >= 64 it is under 1% of
    the pair's operations."""
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
    calls it): scaled_dot_product_attention with the same mask and GQA,
    or, with a logit softcap, which SDPA lacks, ``_flex_library``."""
    if kw.get("softcap"):
        return _flex_library(q, k, v, kw)
    mask = ref.attention_mask(q.shape[2], k.shape[2], **_mask_kw(kw), device=q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=kw.get("scale"), enable_gqa=True)


_FLEX = {}


def _flex_library(q, k, v, kw):
    """flex_attention, compiled (inductor's Triton kernels), with the cap
    tanh(s / c) · c of the scaled logits as its ``score_mod`` and the mask
    as its block mask (``ref.attention_mask``'s rule), GQA on."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cap = float(kw["softcap"])
    causal, window, off = kw.get("causal", True), kw.get("window"), kw.get("q_offset", 0)

    def mask_mod(b, h, qi, ki):
        keep = ki >= 0
        if causal:
            keep = keep & (ki <= qi + off)
        if window is not None:
            keep = keep & (ki > qi + off - window)
        return keep

    def score_mod(score, b, h, qi, ki):
        return torch.tanh(score / cap) * cap

    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    block = create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2], device=q.device)
    return lambda: _FLEX["fn"](q, k, v, score_mod=score_mod, block_mask=block,
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
        want, err = check_attention(FA, ref, q, k, v, kw, f"{what} {shape}")
        regime, splits, cuda_launches = attention_plan(FA, shape, kw)
        if FA.flash_attention.cuda_launches - before != cuda_launches:
            fail(f"flash_attention {what}: {FA.flash_attention.cuda_launches - before} CUDA "
                 f"launches, expected {cuda_launches} ({regime}, {splits} chunks)")
        ms = time_auto(lambda: FA.flash_attention(q, k, v, **kw))
        plain_ms = time_auto(lambda: ref.mha_ref(q, k, v, **kw))
        library = _sdpa_library(ref, q, k, v, kw)
        rtol, atol = ATTN_TOL[dtype]
        library_err = None
        if kw.get("softcap"):     # flex_attention: held to the plain version first
            library_err = float((library().float() - want.float()).abs().max())
            if not library_err <= atol:
                fail(f"flex_attention at flash_attention {what} is another function: "
                     f"max|err| {library_err:.3e} from the plain version (atol {atol})")
        library_ms = time_auto(library)
        bound_ms, bound_by, flops, nbytes = attention_bound(ref, shape, kw, dtype)
        dt = str(dtype).removeprefix("torch.")
        earlier = EARLIER_MS.get(("flash_attention", what))
        rows.append(dict(case=what, shape=list(shape), kw=kw, dtype=dt, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         library=("flex_attention" if kw.get("softcap") else
                                  "scaled_dot_product_attention"),
                         library_max_abs_err=library_err, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes, regime=regime,
                         chunks=splits, cuda_launches_per_call=cuda_launches,
                         earlier_ms=earlier))
        log(f"flash_attention {what} (B, Hq, Hkv, Sq, Skv, D)={shape} {kw} {dt}: {regime}, "
            f"{splits} chunk(s), {cuda_launches} CUDA launch(es) a call; "
            f"max|err|={err:.3e} (rtol {rtol} atol {atol}) kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {rows[-1]['library']} {library_ms:.4f} ms"
            f"{'' if library_err is None else f' (max|err| {library_err:.3e})'}, bound "
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


# host seconds a profiled call sits inside the profiler's window on each
# side (tests/test_torch_cuda.py's PROFILE_PAD_S: a call at the window's
# edge lost kernels)
PROFILE_PAD_S = 0.02


def _device_spans(fn):
    """``fn`` under torch.profiler, PROFILE_PAD_S inside the window on each
    side: host milliseconds to a synchronised end (the pads not counted),
    and the card's kernels as (start, end, name) in microseconds, sorted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        time.sleep(PROFILE_PAD_S)
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
    with torch.no_grad():
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


# --- the backbone zoo: the other four families at full width ------------------

# (arch, depth cut, flash launches per prefill, per decode step): the
# expected counts, each also derived from the config by zoo_flash_calls
ZOO = [
    ("granite_moe_3b_a800m", None, 32, 32),
    ("zamba2_7b", None, 13, 13),
    ("seamless_m4t_medium", None, 36, 24),
    ("grok1_314b", 2, 2, 2),          # 64 layers need about 1.26 TB: depth cut to 2
    ("xlstm_350m", None, 0, 0),
]
ZOO_SERVE = dict(batch=4, prompt=512, gen=8, seed=0)
# decode against the teacher-forced forward, largest |diff| / row max|logit|:
# SERVE_TF_REL, but for xLSTM, whose 24 layers of exponentially gated
# recurrences amplify the f32 rounding of its projections (decode's
# matmuls take 4 rows, the forward's 2048: other kernels, other sums).
# In f64 the port's decode equals its forward to 1e-10 on the CPU
# (tests/test_torch_zoo.py), so the gap is rounding. Its bar is 2.5x the
# reading on an H100 80GB HBM3 at 700 W, 2.818e-3 in three runs of the same
# seed (the forward of row 0 alone against the batch's: 1.342e-3, logged
# beside it).
ZOO_TF_REL = {"xlstm": 7e-3}
ZOO_SMALL = dict(batch=2, prompt=40, gen=6, layers=5)   # groups and tails for hybrid / xLSTM
# Table 4 (the paper's backbone claim) on the card: dense (phase 11),
# moe and xlstm here, on the slice's data
# xlstm_350m's setting left the smoke for phase 18 (48.3 s, most of it the
# per-token prefill loop phase 15(a) already serves at full width);
# tests/test_torch_zoo.py holds its reduced run_analytic to the reference
TABLE4 = dict(archs=("granite_moe_3b_a800m",), samples=4096, seq=32,
              batch=64, classes=16)
TABLE4_SETTINGS = [(100, "iid", {}), (100, "niid1", dict(alpha=0.1))]


def zoo_flash_calls(cfg, b, p, g):
    """Every flash call of ``serve(cfg, b, p, g)`` as (phase, shape, kw):
    one prefill, then g - 1 decode steps at positions p .. p + g - 2."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cap = {"softcap": cfg.logit_softcap} if cfg.logit_softcap else {}
    fam = cfg.arch_type
    if fam == "xlstm":
        return []
    n = cfg.num_layers // cfg.shared_attn_every if fam == "hybrid" else cfg.num_layers
    calls = [("prefill", (b, hq, hkv, p, p, hd), dict(cap))] * n
    mem = min(cfg.encoder_seq, p)
    if fam == "encdec":
        calls = ([("prefill", (b, hq, hkv, mem, mem, hd), dict(causal=False))]
                 * cfg.encoder_layers + calls
                 + [("prefill", (b, hq, hkv, p, mem, hd), dict(causal=False))] * n)
    for pos in range(p, p + g - 1):
        calls += [("decode", (b, hq, hkv, 1, p + g, hd), dict(cap, q_offset=pos))] * n
        if fam == "encdec":
            calls += [("decode", (b, hq, hkv, 1, mem, hd), dict(causal=False))] * n
    return calls


def _routing_spy(M):
    """Wrap ``models.moe.moe_apply`` so that each call's expert assignment
    (``route``'s slots and router probabilities) is kept, in call order."""
    seen, orig = [], M.moe_apply

    def spy(p, x, moe, activation):
        r = M.route(p, M._groups(x, moe)[0], moe)
        seen.append((r.slot.cpu(), r.probs.cpu(), moe.top_k))
        return orig(p, x, moe, activation)

    return seen, spy, orig


def _routing_diff(card, cpu) -> str:
    """'' when every MoE call assigned every (token, choice) the same slot,
    else the first difference with its top-k margin on the CPU (the gap
    between the k-th and the next router probability)."""
    if len(card) != len(cpu):
        return f"{len(card)} MoE calls on the card, {len(cpu)} on the CPU"
    for i, ((sg, _, k), (sc, pc, _)) in enumerate(zip(card, cpu)):
        bad = (sg != sc).any(-1).nonzero()
        if len(bad):
            n, t = (int(v) for v in bad[0])
            top = pc[n, t].sort(descending=True).values
            return (f"MoE call {i}: {len(bad)} token(s) routed differently, first group {n} "
                    f"token {t}: card slots {sg[n, t].tolist()} CPU {sc[n, t].tolist()}, "
                    f"top-{k} margin {float(top[k - 1] - top[k]):.3e}")
    return ""


def zoo_small(get_config, T, serve_mod, M, arch):
    """Reduced ``arch`` at ZOO_SMALL's depth, card against CPU: routing (MoE)
    first, then tokens equal and logits within SERVE_SMALL_REL."""
    small = get_config(arch).reduced(num_layers=ZOO_SMALL["layers"])
    p_cpu = T.init_params(small, seed=1, device="cpu")
    runs = {}
    for dev, prm in (("cuda", _params_to(p_cpu, "cuda")), ("cpu", p_cpu)):
        seen = []
        routes, spy, orig = _routing_spy(M)
        M.moe_apply = spy
        try:
            toks, _, _ = serve_mod.serve(small, ZOO_SMALL["batch"], ZOO_SMALL["prompt"],
                                         ZOO_SMALL["gen"], seed=1, device=dev, params=prm,
                                         on_step=lambda i, lg: seen.append(lg.cpu()))
        finally:
            M.moe_apply = orig
        runs[dev] = (toks, torch.stack(seen, 1), routes)
    (tg, lg_g, rg), (tc, lg_c, rc) = runs["cuda"], runs["cpu"]
    routing = _routing_diff(rg, rc)
    err = float((lg_g - lg_c).abs().max())
    top = float(lg_c.abs().max())
    log(f"zoo check: reduced {small.name} ({small.arch_type}, {small.num_layers} layers) serve "
        f"of {ZOO_SMALL}: card vs CPU "
        + (f"MoE routing equal over {len(rg)} calls, " if rg else "")
        + f"tokens equal {bool((tg == tc).all())}, logits max|diff| {err:.3e} (max|logit| "
        f"{top:.3f}; rtol {SERVE_SMALL_REL:g}, atol {SERVE_SMALL_REL:g}·max|logit|)")
    if routing:
        fail(f"zoo {arch}: the card routes differently from the CPU: {routing}")
    if not (tg == tc).all():
        fail(f"zoo {arch}: reduced serve tokens differ between the card and the CPU")
    torch.testing.assert_close(lg_g, lg_c, rtol=SERVE_SMALL_REL, atol=SERVE_SMALL_REL * top)
    return dict(max_abs_err=err, max_logit=top, moe_calls=len(rg))


def zoo_serve(K, cfg, full_layers, T, serve_mod, want_prefill, want_decode):
    """Full-width serve of ``cfg`` (ZOO_SERVE), its flash launches counted
    from zero against the expected numbers; decode's logits against a
    teacher-forced forward where decode computes the forward's function
    (not MoE: decode's capacity group is the batch, not the prompt)."""
    FA = K.FA
    b, p, g = ZOO_SERVE["batch"], ZOO_SERVE["prompt"], ZOO_SERVE["gen"]
    calls = zoo_flash_calls(cfg, b, p, g)
    n_pre = sum(1 for c in calls if c[0] == "prefill")
    n_dec = (len(calls) - n_pre) // (g - 1)
    if (n_pre, n_dec) != (want_prefill, want_decode):
        fail(f"zoo {cfg.name}: the config gives {n_pre} prefill and {n_dec} decode flash "
             f"calls, expected {want_prefill} and {want_decode}")
    want_cuda = sum(attention_plan(FA, shape, kw)[2] for _, shape, kw in calls)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=ZOO_SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    steps = []
    torch.cuda.reset_peak_memory_stats()
    _zero(K)
    out, prefill_s, decode_s = serve_mod.serve(
        cfg, b, p, g, seed=ZOO_SERVE["seed"], device="cuda", params=params,
        on_step=lambda i, logits: steps.append(logits))
    torch.cuda.synchronize()
    launches = _read(K)
    fa_cuda = FA.flash_attention.cuda_launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    dec = torch.stack(steps, 1)
    _only(launches, {"flash_attention": len(calls)}, f"zoo serve {cfg.name}")
    if fa_cuda != want_cuda:
        fail(f"zoo serve {cfg.name}: flash_attention made {fa_cuda} CUDA launches, "
             f"expected {want_cuda}")
    launches["flash_attention_cuda"] = fa_cuda
    if out.shape != (b, p + g) or not torch.isfinite(dec).all() \
            or not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail(f"zoo serve {cfg.name}: tokens {out.shape}, finite logits "
             f"{bool(torch.isfinite(dec).all())}, all in the vocabulary "
             f"{bool(((out >= 0) & (out < cfg.vocab_size)).all())}")
    row = dict(arch=cfg.name, family=cfg.arch_type, layers=cfg.num_layers,
               params_b=n_params / 1e9, init_s=t_init, prefill_s=prefill_s,
               decode_ms_per_token=1e3 * decode_s / (g - 1), tok_s=b * (g - 1) / decode_s,
               peak_gb=peak, flash_launches=len(calls), flash_prefill=n_pre,
               flash_decode_step=n_dec, flash_cuda_launches=fa_cuda)
    if cfg.arch_type == "xlstm":
        layer_steps = p * cfg.num_layers
        row["prefill_ms_per_token_layer"] = 1e3 * prefill_s / layer_steps
    batch = {"tokens": torch.from_numpy(out[:, :p + g - 1]).cuda()}
    if cfg.encoder_layers:
        from repro_torch.launch.inputs import sample_batch

        batch["enc_feats"] = sample_batch(cfg, b, p, seed=ZOO_SERVE["seed"],
                                          with_labels=False, device="cuda")["enc_feats"]
    row["profile"] = zoo_profile(T, cfg, params, dict(batch, tokens=batch["tokens"][:, :p]),
                                 p + g)
    if cfg.arch_type != "moe":
        with torch.no_grad():
            hidden = T.forward(params, cfg, batch)
            tf = T.lm_logits(params, cfg, hidden[:, p - 1:])
            # the same forward of row 0 alone: other matmul shapes, the same function
            alone = T.lm_logits(params, cfg, T.forward(params, cfg, {
                k: v[:1] for k, v in batch.items()})[:, p - 1:])
        del hidden
        row["tf_rel"] = float(((tf - dec).abs().amax(-1) / tf.abs().amax(-1)).max())
        row["tf_token_agreement"] = float((tf.argmax(-1) == dec.argmax(-1)).float().mean())
        row["row_alone_rel"] = float(((tf[:1] - alone).abs().amax(-1)
                                      / tf[:1].abs().amax(-1)).max())
        row["tf_limit"] = ZOO_TF_REL.get(cfg.arch_type, SERVE_TF_REL)
        del tf, alone
        if not row["tf_rel"] <= row["tf_limit"]:
            fail(f"zoo serve {cfg.name}: decode logits {row['tf_rel']:.3e} from the "
                 f"teacher-forced forward (limit {row['tf_limit']:g})")
    cut = "" if cfg.num_layers == full_layers else \
        f" (depth cut from {full_layers}: the full stack does not fit one card)"
    log(f"zoo serve: {cfg.name} ({cfg.arch_type}) full width d={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} layers="
        f"{cfg.num_layers}{cut}; {n_params / 1e9:.3f}B params ({4 * n_params / 1e9:.2f} GB) "
        f"init {t_init:.2f} s; batch {b} prompt {p} gen {g}: prefill_s={prefill_s:.3f} decode "
        f"{row['decode_ms_per_token']:.2f} ms/token ({row['tok_s']:.1f} tok/s) peak_mem="
        f"{peak:.2f} GB; flash_attention launches {len(calls)} ({n_pre} prefill + {n_dec} x "
        f"{g - 1} decode), {fa_cuda} CUDA launches (expected {want_cuda})"
        + (f"; per-token loop {row['prefill_ms_per_token_layer']:.3f} ms per token per layer"
           if "prefill_ms_per_token_layer" in row else "")
        + (f"; decode vs teacher-forced forward {row['tf_rel']:.3e} of the row's max|logit| "
           f"(limit {row['tf_limit']:g}), token agreement {row['tf_token_agreement']:.4f}; "
           f"the forward of row 0 alone vs in the batch {row['row_alone_rel']:.3e}"
           if "tf_rel" in row else "; no teacher-forced check (MoE: decode's capacity "
           "group is the batch)"))
    for name, r in row["profile"].items():
        if r is not None:
            log(f"zoo profile: {cfg.name} {name}: wall {r['wall_ms']:.2f} ms, card busy "
                f"{r['busy_ms']:.2f} ms (idle share {r['idle_share']:.3f}), {r['kernels']} "
                f"kernels; flash_attention {r['by_ms']['flash_attention']:.2f} ms, matmul "
                f"{r['by_ms']['matmul']:.2f} ms, other {r['by_ms']['other']:.2f} ms")
    del params, steps, dec
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


def zoo_profile(T, cfg, params, batch, max_seq) -> dict:
    """After the counted run: one prefill of the served prompt and one
    decode step from its cache under the profiler (xLSTM: the decode step
    only, from the start state; its prefill is some 10⁵ small kernels, and
    its per-token time is logged by the serve)."""
    tok = batch["tokens"][:, -1]
    pos = batch["tokens"].shape[1]
    out = {"prefill": None}
    if cfg.arch_type == "xlstm":
        cache = T.init_cache(cfg, tok.shape[0], max_seq, device="cuda")
    else:
        T.prefill(params, cfg, batch, max_seq)                  # warm-up
        state = {}
        out["prefill"] = profile_window(
            lambda: state.update(cache=T.prefill(params, cfg, batch, max_seq)[1]))
        cache = state["cache"]
    T.decode_step(params, cfg, tok, cache, pos)                 # warm-up
    out["decode_step"] = profile_window(lambda: T.decode_step(params, cfg, tok, cache, pos))
    return out


def table4(K, cfg, D, T, train, afl, api, FLConfig):
    """``run_analytic`` (Gram kernel) on full-width ``cfg``, its Gram and
    flash launches counted; then the card's embeddings of the same data
    through ``run_afl`` at TABLE4_SETTINGS against the joint solve (equal
    accuracy, the weight within PAPER_KU·κ·u64 where the Gram is
    definite)."""
    c, batch = TABLE4["classes"], TABLE4["batch"]
    cfg = dataclasses.replace(cfg, num_classes=c)
    ds = D.token_classification(n=TABLE4["samples"], seq=TABLE4["seq"], vocab=cfg.vocab_size,
                                num_classes=c, seed=0)
    tr, te = D.train_test_split(ds, 0.25, seed=0)
    params = T.init_params(cfg, seed=0, device="cuda")
    per_forward = cfg.num_layers if cfg.arch_type in ("dense", "moe") else 0
    forwards = len(tr) // batch + len(te) // batch
    _zero(K)
    t0 = time.perf_counter()
    acc, train_s = train.run_analytic(cfg, tr, te, FLConfig(gamma=1.0), batch,
                                      use_kernel=True, device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = _read(K)
    want = {"gram_update": len(tr) // batch, "flash_attention": per_forward * forwards}
    _only(counted, want, f"table 4 run_analytic {cfg.name}")

    def backbone(tokens):
        return torch.cat([train.embed(params, cfg, tokens[i:i + batch])
                          for i in range(0, len(tokens), batch)])

    x_tr = afl.embed_with_backbone(backbone, tr.x)
    x_te = afl.embed_with_backbone(backbone, te.x)
    launches = _read(K)                 # run_analytic's and the embeddings' launches
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    del params
    if not (np.isfinite(x_tr).all() and np.isfinite(x_te).all()):
        fail(f"table 4 {cfg.name}: embeddings are not finite")
    ds_tr, ds_te = D.Dataset(x_tr, tr.y, c), D.Dataset(x_te, te.y, c)
    x64 = x_tr.astype(np.float64)
    evals = np.linalg.eigvalsh(x64.T @ x64)
    kappa = float(evals[-1] / evals[0]) if evals[0] > 0 else math.inf
    w_joint, acc_joint = afl.joint_ridge(ds_tr, ds_te, gamma=0.0)
    rows = []
    for k, scheme, kw in TABLE4_SETTINGS:
        res = afl.run_afl(ds_tr, ds_te, FLConfig(num_clients=k, gamma=1.0, partition=scheme,
                                                 **kw),
                          coordinator=api.AFLServer(cfg.d_model, c, gamma=1.0))
        rel = float(np.abs(res.weight - w_joint).max() / np.abs(w_joint).max())
        rows.append(dict(K=k, partition=scheme, accuracy=res.accuracy, rel_to_joint=rel,
                         rel_to_joint_ku=rel / (kappa * F64_U) if math.isfinite(kappa)
                         else None))
        log(f"table 4: {cfg.name} run_afl K={k} {scheme}: acc={res.accuracy:.4f} (joint "
            f"{acc_joint:.4f}); weight vs joint {rel:.3e} relative"
            + (f" = {rows[-1]['rel_to_joint_ku']:.4f}·κ·u64" if math.isfinite(kappa) else
               " (κ = ∞: accuracy held only)"))
        if res.accuracy != acc_joint:
            fail(f"table 4 {cfg.name} run_afl K={k} {scheme}: accuracy {res.accuracy} != "
                 f"the joint solve's {acc_joint}")
        if math.isfinite(kappa) and not rel <= PAPER_KU * kappa * F64_U:
            fail(f"table 4 {cfg.name} run_afl K={k} {scheme}: weight {rel:.3e} from the "
                 f"joint solve, more than {PAPER_KU:g}·κ·u64")
    log(f"table 4: {cfg.name} ({cfg.arch_type}, d={cfg.d_model}, full width) run_analytic "
        f"--kernel acc={acc:.4f} train_s={train_s:.3f} wall_s={wall:.3f}, gram_update "
        f"launches {counted['gram_update']} (expected {want['gram_update']}), flash "
        f"{counted['flash_attention']} (expected {want['flash_attention']}); host Gram "
        f"κ={kappa:.4e}, joint ridge acc={acc_joint:.4f}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(arch=cfg.name, family=cfg.arch_type, d=cfg.d_model, accuracy=acc,
                          train_s=train_s, wall_s=wall, kappa=kappa, joint_accuracy=acc_joint,
                          run_afl=rows)


def zoo_phase(K, get_config, T, serve_mod, M, D, train, afl, api, FLConfig):
    """(a) each ZOO config served at full width, launches counted; (b) each
    family reduced, card against CPU; (d) Table 4 on the card. (c), the
    flash kernel at the zoo's shapes, is in the attention phase."""
    total, served, small, t4 = {}, [], {}, []
    for arch, layers, want_pre, want_dec in ZOO:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        launches, row = zoo_serve(K, cfg, full.num_layers, T, serve_mod, want_pre, want_dec)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        served.append(row)
        small[arch] = zoo_small(get_config, T, serve_mod, M, arch)
    for arch in TABLE4["archs"]:
        launches, row = table4(K, get_config(arch), D, T, train, afl, api, FLConfig)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        t4.append(row)
    return total, dict(serve=served, small=small, table4=t4)


# --- training: the gradient and LM modes ------------------------------------------

# (name, (B, Hq, Hkv, S, S, D), kw): attention under grad on the card, the
# LM phase's own shape first (minicpm_2b at batch 4 × 256), then a GQA
# shape with a window (gemma3_12b-like at batch 1), grok1's softcap and a
# non-causal one (seamless's encoder)
TRAIN_ATTN = [
    ("lm", (4, 36, 36, 256, 256, 64), dict(causal=True)),
    ("gqa window", (1, 16, 8, 512, 512, 256), dict(causal=True, window=128)),
    ("softcap", (1, 48, 8, 256, 256, 128), dict(causal=True, softcap=30.0)),
    ("non-causal", (2, 16, 16, 512, 512, 64), dict(causal=False)),
]
# FlashSDPA's output and dq, dk, dv against autograd of sdpa_plain:
# rtol and atol relative to the largest entry
TRAIN_GRAD_REL = 1e-4
# one full step, card against CPU on the same weights: minicpm_2b at full
# width, depth cut to 2 of 40 layers (the CPU's step is the time limit)
TRAIN_STEP = dict(arch="minicpm_2b", layers=2, batch=2, seq=32, lr=1e-2)
# the loss within rtol TRAIN_LOSS_RTOL; each leaf's Δp within
# TRAIN_DP_REL of its largest, plus one f32 spacing of the parameter: each
# device rounds p − lr·g to f32 once (on the CPU the port's Δp lies exactly
# one spacing from the reference's where it lies above 1e-4 of the largest)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_DP_REL = 1e-3
TRAIN_GRADIENT = dict(arch="minicpm_2b", samples=1024, seq=32, classes=16, batch=64,
                      rounds=2)
TRAIN_LM = dict(arch="minicpm_2b", steps=8, batch=4, seq=256)


def grad_attention_phase(FA, ref, L):
    """``layers.sdpa`` under grad on the card (``FlashSDPA``: one flash
    launch, the plain backward) against autograd of ``sdpa_plain`` at
    TRAIN_ATTN; at the LM shape also timed: the kernel's forward beside the
    plain version and SDPA, and FlashSDPA's forward + backward beside SDPA's.
    Returns the flash row of the LM shape and the checks."""
    checks, row = [], None
    for i, (what, shape, kw) in enumerate(TRAIN_ATTN):
        b, hq, hkv, sq, skv, d = shape
        gen = torch.Generator(device="cuda")
        gen.manual_seed(300 + i)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").requires_grad_(True)
                   for s in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])
        g = torch.randn((b, hq, sq, d), generator=gen, device="cuda")
        before = FA.flash_attention.launches
        out = L.sdpa(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), g)
        torch.cuda.synchronize()
        if FA.flash_attention.launches - before != 1:
            fail(f"training attention {what}: {FA.flash_attention.launches - before} flash "
                 "launches under grad, expected 1 (the forward)")
        if not isinstance(out.grad_fn, L.FlashSDPA._backward_cls):
            fail(f"training attention {what}: the output's grad_fn is {out.grad_fn}, "
                 "not FlashSDPA's")
        want = L.sdpa_plain(q, k, v, **kw)
        wants = torch.autograd.grad(want, (q, k, v), g)
        errs = {}
        for name, a, w in zip(("out", "dq", "dk", "dv"), (out.detach(), *got),
                              (want.detach(), *wants)):
            scale = float(w.abs().max())
            errs[name] = float((a - w).abs().max()) / scale
            try:
                torch.testing.assert_close(a, w, rtol=TRAIN_GRAD_REL,
                                           atol=TRAIN_GRAD_REL * scale)
            except AssertionError as exc:
                fail(f"training attention {what} {shape} {kw}: {name}: {exc}")
        checks.append(dict(case=what, shape=list(shape), kw=kw, rel_err=errs))
        log(f"training attention {what} (B, Hq, Hkv, Sq, Skv, D)={shape} {kw}: FlashSDPA "
            f"against autograd of sdpa_plain, largest |err| / max: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (rtol and atol {TRAIN_GRAD_REL:g} of the max)")
        if i:
            continue
        qd, kd, vd = (t.detach() for t in (q, k, v))
        with torch.no_grad():
            ms = time_auto(lambda: FA.flash_attention(qd, kd, vd, **kw))
            plain_ms = time_auto(lambda: ref.mha_ref(qd, kd, vd, **kw))
            library = _sdpa_library(ref, qd, kd, vd, kw)
            library_ms = time_auto(library)
        mask = ref.attention_mask(sq, skv, **_mask_kw(kw), device="cuda")

        def fwd_bwd():
            torch.autograd.grad(L.sdpa(q, k, v, **kw), (q, k, v), g)

        def plain_fwd_bwd():
            torch.autograd.grad(L.sdpa_plain(q, k, v, **kw), (q, k, v), g)

        def library_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               enable_gqa=True), (q, k, v), g)

        fb_ms, plain_fb_ms, lib_fb_ms = (time_auto(f) for f in (fwd_bwd, plain_fwd_bwd,
                                                                 library_fwd_bwd))
        bound_ms, bound_by, flops, nbytes = attention_bound(ref, shape, kw, torch.float32)
        row = dict(case="lm training forward", shape=list(shape), kw=kw, dtype="float32",
                   max_abs_err=errs["out"] * float(want.detach().abs().max()), ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library="scaled_dot_product_attention", bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes, regime="prefill tile",
                   chunks=1, cuda_launches_per_call=1, fwd_bwd_ms=fb_ms,
                   plain_fwd_bwd_ms=plain_fb_ms, library_fwd_bwd_ms=lib_fb_ms)
        log(f"flash_attention lm training forward {shape} {kw}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}) = {100 * bound_ms / ms:.2f}% of bound; forward + backward: "
            f"FlashSDPA {fb_ms:.4f} ms, sdpa_plain {plain_fb_ms:.4f} ms, SDPA "
            f"{lib_fb_ms:.4f} ms")
        del out, got, want, wants
    return row, checks


def _dp_check(old, new, ref_new, what):
    """Each leaf's Δp of ``new`` against ``ref_new``'s (the CPU's), both
    from ``old``: within TRAIN_DP_REL of the largest plus one f32 spacing
    of the parameter. Returns the worst error over the leaf's largest Δp,
    past that spacing and in all."""
    worst = worst_raw = 0.0
    for o, a, b in zip(old, new, ref_new):
        dp, dr = a.cpu().double() - o.double(), b.double() - o.double()
        top = float(dr.abs().max())
        err = (dp - dr).abs()
        past = (err - torch.from_numpy(np.spacing(np.abs(b.numpy()))).double()).clamp(min=0)
        if not float(past.max()) <= TRAIN_DP_REL * top:
            fail(f"{what}: a leaf's Δp is {float(err.max()):.3e} from the CPU's, "
                 f"max|Δp| {top:.3e}")
        if top:
            worst_raw = max(worst_raw, float(err.max()) / top)
            worst = max(worst, float(past.max()) / top)
    return worst, worst_raw


def train_step_check(K, get_config, T, ST, optim):
    """(b) one ``make_full_train_step`` of minicpm_2b at full width, 2 layers,
    on the card and on the CPU from the same weights."""
    c = TRAIN_STEP
    cfg = dataclasses.replace(get_config(c["arch"]), num_layers=c["layers"])
    from repro_torch.launch.inputs import sample_batch

    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    p_gpu = _params_to(p_cpu, "cuda")
    old = [p.clone() for p in optim.tree_leaves(p_cpu)]
    step = ST.make_full_train_step(cfg)
    _zero(K)
    t0 = time.perf_counter()
    _, loss_gpu = step(p_gpu, sample_batch(cfg, c["batch"], c["seq"], seed=0, device="cuda"),
                       c["lr"])
    loss_gpu = float(loss_gpu)
    card_s = time.perf_counter() - t0
    launches = _read(K)
    _only(launches, {"flash_attention": cfg.num_layers}, "training step (2 layers)")
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    t0 = time.perf_counter()
    _, loss_cpu = step(p_cpu, sample_batch(cfg, c["batch"], c["seq"], seed=0, device="cpu"),
                       c["lr"])
    cpu_s = time.perf_counter() - t0
    loss_cpu = float(loss_cpu)
    if not abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu):
        fail(f"training step: loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    worst, worst_raw = _dp_check(old, optim.tree_leaves(p_gpu), optim.tree_leaves(p_cpu),
                                 "training step (2 layers)")
    log(f"training step: {cfg.name} at full width, {cfg.num_layers} of 40 layers, batch "
        f"{c['batch']} × {c['seq']}, lr {c['lr']:g}: loss card {loss_gpu:.7f} CPU "
        f"{loss_cpu:.7f}; Δp worst {worst_raw:.3e} of a leaf's max|Δp| ({worst:.3e} past "
        f"one f32 spacing; limit {TRAIN_DP_REL:g}); flash launches "
        f"{launches['flash_attention']}; card {card_s:.3f} s, CPU {cpu_s:.3f} s")
    del p_cpu, p_gpu, old
    return launches, dict(loss_card=loss_gpu, loss_cpu=loss_cpu, dp_worst=worst_raw,
                          dp_worst_past_spacing=worst, card_s=card_s, cpu_s=cpu_s,
                          flash_launches=launches["flash_attention"])


def run_gradient_check(K, get_config, D, train, FLConfig):
    """(c) ``run_gradient`` on whole minicpm_2b, its flash launches counted
    (the backbone forward of every batch of every round and of the test
    set, 40 each)."""
    c = TRAIN_GRADIENT
    cfg = dataclasses.replace(get_config(c["arch"]), num_classes=c["classes"])
    ds = D.token_classification(n=c["samples"], seq=c["seq"], vocab=cfg.vocab_size,
                                num_classes=c["classes"], seed=0)
    tr, te = D.train_test_split(ds, 0.25, seed=0)
    forwards = c["rounds"] * (len(tr) // c["batch"]) + len(te) // c["batch"]
    _zero(K)
    t0 = time.perf_counter()
    acc, train_s = train.run_gradient(cfg, tr, te, FLConfig(gamma=1.0), c["batch"],
                                      c["rounds"], device="cuda")
    wall = time.perf_counter() - t0
    launches = _read(K)
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    _only({n: launches[n] for n in K.ALL}, {"flash_attention": cfg.num_layers * forwards},
          "run_gradient")
    chance = 1.0 / c["classes"]
    log(f"run_gradient: {cfg.name} whole, {c['samples']} × {c['seq']} tokens, "
        f"{c['classes']} classes, batch {c['batch']}, {c['rounds']} rounds: acc={acc:.4f} "
        f"(chance {chance:.4f}) train_s={train_s:.3f} wall_s={wall:.3f}, flash launches "
        f"{launches['flash_attention']} ({cfg.num_layers} × {forwards} forwards)")
    if not acc > chance:
        fail(f"run_gradient accuracy {acc} is not above chance {chance}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(accuracy=acc, chance=chance, train_s=train_s, wall_s=wall,
                          flash_launches=launches["flash_attention"])


def run_lm_check(K, get_config, T, ST, train):
    """(d) ``run_lm`` on whole minicpm_2b, its flash launches counted (40
    forward launches a step), peak memory from the weights' init on; then
    one more step of the same shape profiled (not counted: the launches
    are read before it)."""
    from repro_torch.launch.inputs import sample_batch

    c = TRAIN_LM
    cfg = get_config(c["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(K)
    t0 = time.perf_counter()
    losses = train.run_lm(cfg, c["steps"], c["batch"], c["seq"], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = _read(K)
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    _only({n: launches[n] for n in K.ALL}, {"flash_attention": cfg.num_layers * c["steps"]},
          "run_lm")
    if len(losses) != c["steps"] or not all(math.isfinite(v) for v in losses):
        fail(f"run_lm losses {losses}")
    tokens = c["steps"] * c["batch"] * c["seq"]
    # where a step's time goes: one more step of the same shape, profiled
    params = T.init_params(cfg, seed=0, device="cuda")
    step = ST.make_full_train_step(cfg)
    batch = sample_batch(cfg, c["batch"], c["seq"], seed=0, device="cuda")
    step(params, batch, 1e-3)
    prof = profile_window(lambda: step(params, batch, 1e-3))
    del params, batch
    log(f"run_lm: {cfg.name} whole, {c['steps']} steps of {c['batch']} × {c['seq']} "
        f"tokens: losses {[round(v, 4) for v in losses]}; wall {wall:.3f} s (init "
        f"included) = {1e3 * wall / c['steps']:.1f} ms a step, {tokens / wall:.1f} tokens/s; "
        f"peak {peak:.2f} GB; flash launches {launches['flash_attention']}; one profiled "
        f"step {json.dumps(prof)}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(losses=losses, wall_s=wall, ms_per_step=1e3 * wall / c["steps"],
                          tokens_per_s=tokens / wall, peak_gb=peak,
                          flash_launches=launches["flash_attention"], profile=prof)


def example_check(K):
    """(e) ``examples/torch_train_100m.py``'s ``main`` at its defaults (its
    asserts hold or it raises), its flash launches counted: 12 a step and
    12 a forward of its probe's 20 batches."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "torch_train_100m.py"
    spec = importlib.util.spec_from_file_location("torch_train_100m", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    _zero(K)
    t0 = time.perf_counter()
    try:
        out = ex.main([])
    except AssertionError as exc:
        fail(f"examples/torch_train_100m.py: {exc}")
    wall = time.perf_counter() - t0
    launches = _read(K)
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    layers = ex.CFG_100M.num_layers
    _only({n: launches[n] for n in K.ALL},
          {"flash_attention": layers * (out["steps"] + -(-2500 // 128))},
          "examples/torch_train_100m.py")
    log(f"example torch_train_100m: {out['params'] / 1e6:.1f}M params, loss "
        f"{out['loss_head']:.3f} → {out['loss_tail']:.3f} in {out['steps']} steps "
        f"({out['pretrain_s']:.3f} s), AFL probe {out['probe_accuracy']:.4f} = centralized "
        f"{out['joint_accuracy']:.4f} > chance {out['chance']:.4f}; wall {wall:.3f} s, flash "
        f"launches {launches['flash_attention']}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(out, wall_s=wall, flash_launches=launches["flash_attention"])


def training_phase(K, ref, get_config, D, T, L, ST, train, FLConfig, optim):
    """The gradient and LM modes on the card: (a) attention under grad, (b)
    one full step card against CPU, (c) ``run_gradient``, (d) ``run_lm``,
    (e) the 100M example. Returns the summed launches, the LM shape's flash
    row and the phase's JSON."""
    t0 = time.perf_counter()
    row, attn = grad_attention_phase(K.FA, ref, L)
    total, out = {}, dict(attention=attn)
    for name, (launches, res) in (
            ("step", train_step_check(K, get_config, T, ST, optim)),
            ("run_gradient", run_gradient_check(K, get_config, D, train, FLConfig)),
            ("run_lm", run_lm_check(K, get_config, T, ST, train)),
            ("example", example_check(K))):
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
        out[name] = res
    out["wall_s"] = time.perf_counter() - t0
    log(f"training phase: {out['wall_s']:.1f} s")
    return total, row, out


# --- the dry run: its grid, its prediction against the card, two examples --------

# (b) two full-width f32 steps the smoke already runs, predicted by the
# dry run's per-step function and measured on the card: (what, arch,
# InputShape fields, kind)
DRYRUN_STEPS = [("minicpm_2b analytic step", "minicpm_2b", ("slice_batch", 32, 64, "train")),
                ("gemma3_12b prefill", "gemma3_12b", ("serve_prefill", 2048, 4, "prefill")),
                ("gemma3_12b decode step", "gemma3_12b", ("serve_decode", 2048, 4, "decode"))]
DRYRUN_PEAK_REL = 0.10      # predicted peak within 10% of the card's
DRYRUN_TIMED = 5            # a step's time: the median of 5 synchronised runs


def _timed_step(fn, args, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    return statistics.median(times)


def dryrun_step_check(K, what, cfg, shape, params, DR, CA, M):
    """(b) for one step: the dry run's prediction (a meta walk, the flash
    variant) against the step on the card. Static bytes exact; the peak
    within ``DRYRUN_PEAK_REL`` of ``max_memory_allocated`` over the step;
    the flops identity: the walk's = the card's ``FlopCounterMode`` count
    (which does not see the extension kernels) + ``attention_flops`` + the
    Gram's 2·N·d·(d + C); the median time's roofline share and MFU at most
    1. Returns the step's launches and its record."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    pred = DR.step_cost(cfg, shape, "flash", use_kernel=True)
    walk_s = time.perf_counter() - t0
    cost = pred["cost"]
    fn, args, static = DR.build_step(cfg, shape, "flash", device="cuda", use_kernel=True,
                                     params=params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - CA.storage_bytes(args, "cuda")
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)                                     # also the warm-up
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    card_static = {k: CA.storage_bytes(v, "cuda") for k, v in static.items() if k != "cache"}
    if "cache" in static:
        card_static["cache"] = CA.storage_bytes(out[1] if shape.kind == "prefill"
                                                else static["cache"], "cuda")
    del out
    _zero(K)
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
        torch.cuda.synchronize()
    del out
    launches = _read(K)
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    counted = int(fc.get_total_flops())
    attn = int(pred["attn_flops"])
    gram = 0
    if shape.kind == "train":
        n, d, c = shape.global_batch, cfg.d_model, cfg.num_classes
        gram = 2 * n * d * (d + c)
    t = _timed_step(fn, args, DRYRUN_TIMED)
    del fn, args, static
    bound_s = max(cost.flops / M.PEAK_FLOPS[cfg.param_dtype], cost.bytes_accessed / M.HBM_BW)
    share, mfu = bound_s / t, cost.flops / (t * M.PEAK_FLOPS[cfg.param_dtype])
    rec = dict(step=what, shape=dataclasses.asdict(shape), walk_s=walk_s,
               static_predicted=pred["static"], static_card=card_static,
               peak_predicted=cost.peak_bytes, peak_card=peak,
               peak_rel=(cost.peak_bytes - peak) / peak,
               peak_aval=cost.peak_aval_shape, temp_predicted=cost.temp_bytes,
               flops_walk=cost.flops, flops_card_counted=counted, attn_flops=attn,
               gram_flops=gram, bytes_walk=cost.bytes_accessed, step_s=t,
               bound_s=bound_s, bound_by="operations" if bound_s == cost.flops / M.PEAK_FLOPS[
                   cfg.param_dtype] else "bytes", roofline_share=share, mfu=mfu,
               launches={k: v for k, v in launches.items() if v})
    log(f"dry run vs card: {what} {shape.global_batch} × {shape.seq_len}: static "
        f"{card_static} (predicted {pred['static']}); peak {peak} B card, "
        f"{cost.peak_bytes} B predicted ({100 * rec['peak_rel']:+.2f}%; largest "
        f"intermediate {cost.peak_aval_shape}); flops walk {cost.flops} = card "
        f"{counted} + attention {attn} + Gram {gram} "
        f"({'exact' if cost.flops == counted + attn + gram else 'DIFFERS'}); step "
        f"{1e3 * t:.2f} ms (median of {DRYRUN_TIMED}), bound {1e3 * bound_s:.2f} ms "
        f"({rec['bound_by']}): roofline share {share:.4f}, MFU {mfu:.4f}; launches "
        f"{rec['launches']}")
    if card_static != pred["static"]:
        fail(f"{what}: static bytes {card_static} on the card, {pred['static']} predicted")
    if abs(rec["peak_rel"]) > DRYRUN_PEAK_REL:
        fail(f"{what}: predicted peak {cost.peak_bytes} B is {100 * rec['peak_rel']:+.2f}% "
             f"of the card's {peak} B, past ±{100 * DRYRUN_PEAK_REL:g}%")
    if cost.flops != counted + attn + gram:
        fail(f"{what}: walk flops {cost.flops} != card {counted} + attention {attn} "
             f"+ Gram {gram}")
    if not (0 < share <= 1.0 and 0 < mfu <= 1.0):
        fail(f"{what}: roofline share {share:.4f}, MFU {mfu:.4f}: the count is short")
    return launches, rec


def dryrun_example_check(K, root, zoo_calls, get_config):
    """(c) ``examples/torch_serve_demo.py`` and ``torch_federated_niid.py``
    on the card (their ``main``), their flash launches counted: every
    serve call of the demo (``zoo_flash_calls``), and one a layer for each
    embedding batch of the sweep."""
    import importlib.util

    total, out = {}, {}
    for name in ("torch_serve_demo", "torch_federated_niid"):
        spec = importlib.util.spec_from_file_location(name, root / "examples" / f"{name}.py")
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        _zero(K)
        t0 = time.perf_counter()
        try:
            res = ex.main([])
        except AssertionError as exc:
            fail(f"examples/{name}.py: {exc}")
        wall = time.perf_counter() - t0
        launches = _read(K)
        launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
        if name == "torch_serve_demo":
            want = sum(len(zoo_calls(get_config(arch).reduced(), ex.BATCH, ex.PROMPT, ex.GEN))
                       for arch, _ in ex.REQUESTS)
            out[name] = dict(wall_s=wall, **{a: dict(prefill_s=r["prefill_s"],
                                                     decode_s=r["decode_s"])
                                             for a, r in res.items()})
        else:
            want = res["batches"] * res["layers"]
            afl = {r["afl"] for r in res["rows"].values()}
            if len(afl) != 1:
                fail(f"examples/{name}.py: the AFL column varies: {res['rows']}")
            out[name] = dict(wall_s=wall, rows=res["rows"])
        _only({n: launches[n] for n in K.ALL}, {"flash_attention": want}, f"examples/{name}.py")
        out[name]["flash_launches"] = launches["flash_attention"]
        log(f"example {name}: wall {wall:.2f} s, flash launches "
            f"{launches['flash_attention']} ({launches['flash_attention_cuda']} CUDA)")
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
    return total, out


def dryrun_phase(K, root, get_config, InputShape):
    """Phase 17: (b) the prediction of three full-width steps against the
    card, (c) two examples on the card ((a), the grid, left the smoke for
    phase 19)."""
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    out = {}
    total, steps, params, loaded = {}, [], None, None
    for what, arch, fields in DRYRUN_STEPS:
        cfg = get_config(arch)
        if arch == SLICE["arch"]:
            cfg = dataclasses.replace(cfg, num_classes=SLICE["classes"])
        if loaded != arch:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            params, loaded = T.init_params(cfg, seed=0, device="cuda"), arch
        launches, rec = dryrun_step_check(K, what, cfg, InputShape(*fields), params, DR, CA, M)
        steps.append(rec)
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["steps"] = steps
    launches, out["examples"] = dryrun_example_check(K, root, zoo_flash_calls, get_config)
    for n, v in launches.items():
        total[n] = total.get(n, 0) + v
    out["wall_s"] = time.perf_counter() - t0
    log(f"dry run phase: {out['wall_s']:.1f} s")
    return total, out


# --- phase 19: the partitioned steps on four ranks of this card ----------------

# granite decodes 4 steps, which leaves the phase's time to the families
PART_PLAN = dict(arch="granite_moe_3b_a800m", batch=4, seq=512, decode=4)
PART_MESH = ((2, 2), ("data", "model"))
PART_TIMEOUT_S = 420
PART_GRAM_REL = 1e-4        # the Gram's largest |Δ| over its largest entry
PART_LOGIT_REL = 1e-3       # a logit's |Δ| over its row's largest |logit|
# a token the ranks send to another expert than the one-rank router's own
# top-k must be a near-tie there: its k-th and (k+1)-th probabilities
# (about 1/40 each) at most this far apart
PART_TIE = 1e-4
# the families after granite, at full width in f32 on the same mesh:
# xlstm_350m whole (24 layers, mLSTM and sLSTM), zamba2_7b's depth cut to
# 15 of 81 layers (two groups of five Mamba2 layers and the shared block,
# then a tail of three), seamless_m4t_medium whole (12 + 12 layers)
PART_FAMILIES = [
    dict(arch="xlstm_350m", batch=4, seq=128, decode=4),
    dict(arch="zamba2_7b", batch=4, seq=512, decode=4, layers=15),
    dict(arch="seamless_m4t_medium", batch=4, seq=512, decode=4),
]
# no rank may repeat another's work: 4 × rank 0's walked flops over the
# one-device walk's, the train and prefill steps
PART_REPEAT = 1.01
# a family's (Gram, logit) bars where they are not PART_GRAM_REL /
# PART_LOGIT_REL. Full-width xLSTM with random weights moves by about 1e-3
# with its GEMMs' shapes alone: on an H100, one rank on each half of a
# 4 × 256 batch against one rank on the whole (no mesh) differs by 7.462e-4
# of the Gram's largest entry and 1.335e-3 of a row's largest logit, and
# its ranks by 7.459e-4 and 1.816e-3. At 4 × 128 its ranks read 8.605e-4
# and 1.989e-3 (at 4 × 256 the same bits in four runs); the bars are twice those
PART_FAMILY_REL = {"xlstm_350m": (1.8e-3, 4.0e-3)}


def partitioned_phase(K):
    """Phase 19: four ranks on this card as a (2, 2) mesh run full-width
    granite's partitioned analytic step, prefill and greedy decode steps
    (``launch.partitioned.run_steps``); rank 0's steps are walked on a fake
    process group of the same mesh meanwhile; then this process runs the
    steps on one rank, each MoE call routed by the ranks' expert choices.
    Fails unless the ranks equal the one-rank steps (the Gram to
    ``PART_GRAM_REL``, the count exact, logits to ``PART_LOGIT_REL`` of a
    row's largest, the tokens and every MoE call's slots equal), every
    choice the one-rank router would make otherwise is a near-tie (top-k
    margin at most ``PART_TIE``), each rank's collectives equal the walk's
    op for op, and every rank launched the flash and Gram kernels. Then
    the families of ``PART_FAMILIES`` on the same mesh, each held the same
    way (:func:`family_partitioned`); the phase fails on any miss."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.distributed import collective_backend, run_isolated, run_ranks
    from repro_torch.launch import partitioned as PT

    plan = PT.Plan(**PART_PLAN)
    plans = [plan] + [PT.Plan(**spec) for spec in PART_FAMILIES]
    shape, axes = PART_MESH
    world = math.prod(shape)
    backend = collective_backend(world, "cuda")
    t0 = time.perf_counter()
    # one spawn of the ranks runs every model in turn; rank 0's steps of
    # each are walked meanwhile, each also on one device
    with ThreadPoolExecutor(1) as pool:
        walk = pool.submit(run_isolated, PT.predict, plans, shape, axes, "cuda", whole=True,
                           timeout=PART_TIMEOUT_S)
        all_ranks = run_ranks(PT.plans_main, shape, axes, device="cuda", backend=backend,
                              args=(plans, "cuda", (plan.arch,)), timeout=PART_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        preds = walk.result()
    walk_s = time.perf_counter() - t0
    ranks, pred = [r[0] for r in all_ranks], preds[0]
    cfg = plan.config()
    k = cfg.moe.top_k
    # the ranks' routing, joined: every step's MoE calls' slots and choices
    joined = {name: [(PT.assemble([rec["steps"][name]["routing"][i][0] for rec in ranks], shape),
                      PT.assemble([rec["steps"][name]["routing"][i][1] for rec in ranks], shape))
                     for i in range(len(ranks[0]["steps"][name]["routing"]))]
              for name in ranks[0]["steps"]}
    gc.collect()
    torch.cuda.empty_cache()
    _zero(K)
    t1 = time.perf_counter()
    # one rank, routed by the ranks' expert choices (teacher forcing)
    one = PT.one_rank_steps(plan, device="cuda",
                            choices={n: [c for _, c in calls] for n, calls in joined.items()})
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    launches = _read(K)
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches

    # the same results; every difference is gathered before the phase fails
    problems = []
    ties, tie_max, calls = 0, 0.0, 0
    for name, ranks_calls in joined.items():
        mine = one["routing"][name]
        if len(mine) != len(ranks_calls) or len(mine) != cfg.num_layers:
            problems.append(f"{name}: {len(ranks_calls)} MoE calls on the ranks, "
                            f"{len(mine)} on one rank, want {cfg.num_layers}")
            continue
        for i, ((r_slot, r_top), (slot, _top, probs, own)) in enumerate(zip(ranks_calls, mine)):
            calls += 1
            if not torch.equal(r_slot, slot):
                problems.append(f"{name} MoE call {i}: slots differ under the same choices")
            flipped = (r_top.sort(-1).values != own.sort(-1).values).any(-1)
            if flipped.any():
                top = probs[flipped].sort(-1, descending=True).values
                margins = top[:, k - 1] - top[:, k]
                ties += int(flipped.sum())
                tie_max = max(tie_max, float(margins.max()))
    if tie_max > PART_TIE:
        problems.append(f"{ties} token(s) routed to other experts than one rank's own top-{k}, "
                        f"the widest at a margin of {tie_max:.3e} (> {PART_TIE:g})")
    log(f"partitioned: routing over {calls} MoE calls: slots equal under the ranks' choices; "
        f"{ties} (token, layer) choice(s) the one-rank router breaks the other way, each a "
        f"near-tie (top-{k} margin at most {tie_max:.3e})")
    g1 = one["state"]["gram"].double()
    rows = []
    for r, rec in enumerate(ranks):
        st = rec["state"]
        gram_rel = float((st["gram"].double() - g1).abs().max() / g1.abs().max())
        logit_rel = [float(((a.double() - b.double()).abs().amax(-1)
                            / b.double().abs().amax(-1)).max())
                     for a, b in zip(rec["logits"], one["logits"])]
        tokens_equal = all(bool(torch.equal(a, b)) for a, b in zip(rec["tokens"],
                                                                   one["tokens"]))
        rows.append(dict(rank=r, gram_rel=gram_rel, count=float(st["count"]),
                         logit_rel=max(logit_rel), logit_rel_by_step=logit_rel,
                         tokens_equal=tokens_equal, peak_bytes=rec["peak_bytes"],
                         flash_launches=sum(v["flash_launches"] for v in rec["steps"].values()),
                         gram_launches=sum(v["gram_launches"] for v in rec["steps"].values()),
                         step_s={n: v["seconds"] for n, v in rec["steps"].items()}))
        if gram_rel > PART_GRAM_REL:
            problems.append(f"rank {r}'s Gram off by {gram_rel:.3e} of its largest entry")
        if not float(st["count"]) == float(one["state"]["count"]) == plan.batch:
            problems.append(f"rank {r}'s count {float(st['count'])}")
        if max(logit_rel) > PART_LOGIT_REL:
            problems.append(f"rank {r}'s logits off by "
                            + ", ".join(f"{e:.3e}" for e in logit_rel)
                            + " of a row's largest (prefill, then each decode step)")
        if not tokens_equal:
            problems.append(f"rank {r}'s greedy tokens differ from one rank's")
        if not (rows[-1]["flash_launches"] and rows[-1]["gram_launches"]):
            problems.append(f"rank {r} launched flash {rows[-1]['flash_launches']}, "
                            f"Gram {rows[-1]['gram_launches']} times")
        for name, step in rec["steps"].items():
            got = [tuple(x) for x in step["collectives"]]
            want = [tuple(x) for x in pred["steps"][name]["collectives"]]
            if got != want:
                first = next(i for i in range(max(len(got), len(want)))
                             if got[i:i + 1] != want[i:i + 1])
                problems.append(f"rank {r}'s {name} issued {len(got)} collectives, the walk "
                                f"predicts {len(want)}; at {first}: {got[first:first + 1]} "
                                f"against {want[first:first + 1]}")
            if step["comm_debug"] != len(got):
                problems.append(f"rank {r}'s {name}: CommDebugMode counts "
                                f"{step['comm_debug']} collectives, the walk's counter "
                                f"{len(got)}")
    for row in rows:
        log(f"partitioned: rank {row['rank']}: Gram {row['gram_rel']:.3e}, logits "
            + ", ".join(f"{e:.3e}" for e in row["logit_rel_by_step"])
            + f"; flash {row['flash_launches']} / Gram {row['gram_launches']} launches, "
            f"peak {row['peak_bytes']} B, steps "
            + ", ".join(f"{n} {v:.2f} s" for n, v in row["step_s"].items()))
    if problems:
        fail("partitioned: " + " | ".join(problems))
    wall = time.perf_counter() - t0
    coll = {name: dict(count=len(v["collectives"]),
                       bytes={k: sum(x[3] for x in v["collectives"] if x[0] == k)
                              for k in sorted({x[0] for x in v["collectives"]})})
            for name, v in pred["steps"].items()}
    log(f"partitioned: collectives a rank (walk = ranks, op for op): "
        + "; ".join(f"{k} {v['count']} {v['bytes']}" for k, v in coll.items()))
    log(f"partitioned ({backend}, {world} ranks on one card, one spawn for "
        f"{len(plans)} models): ranks {ranks_s:.1f} s, walk done at {walk_s:.1f} s; "
        f"granite one rank {one_s:.1f} s, checked at {wall:.1f} s")
    for r in rows:
        for name in ("flash_attention", "gram_update"):
            launches[name] += r["flash_launches" if name == "flash_attention"
                                else "gram_launches"]
    del one, ranks, joined
    for r in all_ranks:
        r[0] = None
    gc.collect()
    torch.cuda.empty_cache()
    families, problems = {}, []
    for i, spec in enumerate(PART_FAMILIES, 1):
        more, families[spec["arch"]], missed = family_partitioned(
            K, spec, [r[i] for r in all_ranks], preds[i])
        problems += missed
        for name, n in more.items():
            launches[name] = launches.get(name, 0) + n
    if problems:
        fail("partitioned: " + " | ".join(problems))
    log(f"partitioned phase: ranks {ranks_s:.1f} s (steps a rank: granite "
        f"{max(sum(r['step_s'].values()) for r in rows):.1f} s, "
        + ", ".join(f"{k} {v['rank_s']:.1f} s" for k, v in families.items())
        + f"), wall {time.perf_counter() - t0:.1f} s")
    return launches, dict(plan=PART_PLAN, mesh=list(shape), backend=backend, ranks=rows,
                          collectives=coll, wall_s=wall, ranks_s=ranks_s, one_rank_s=one_s,
                          near_ties=dict(choices=ties, widest_margin=tie_max, calls=calls),
                          walk={k: dict(flops=v["cost"]["flops"],
                                        bytes=v["cost"]["bytes_accessed"],
                                        peak=v["cost"]["peak_bytes"])
                                for k, v in pred["steps"].items()},
                          families=families, phase_wall_s=time.perf_counter() - t0)


def _local_scans(cfg, batch: int, mesh: tuple) -> dict:
    """The carry shapes of each recurrence on a rank: the batch over 'data',
    the heads over 'model' (both divide at the phase's shapes)."""
    b, tp = batch // mesh[0], mesh[1]
    if cfg.arch_type == "xlstm":
        heads, dh = cfg.num_heads // tp, 2 * cfg.d_model // cfg.num_heads
        return {"mlstm": ((b, heads, dh, dh), (b, heads, dh), (b, heads)),
                "slstm": ((b, heads, dh),) * 3 + ((b, heads),)}
    if cfg.arch_type == "hybrid":
        nh = cfg.ssm.num_heads
        return {"ssd": ((b, nh // tp, cfg.ssm.d_state, cfg.ssm.expand * cfg.d_model // nh),)}
    return {}


def family_partitioned(K, spec: dict, ranks: list, pred: dict):
    """One family of ``PART_FAMILIES`` on four ranks of this card: its
    partitioned train step, prefill and greedy decode steps against the
    same steps on one rank (the Gram to ``PART_GRAM_REL``, logits to
    ``PART_LOGIT_REL`` of a row's largest, or to the family's own bars of
    ``PART_FAMILY_REL``; the count exact, the same tokens), each rank's
    collectives against rank 0's steps walked on a
    fake process group (op for op, the recurrences by trip count), each
    rank's recurrent carries at its local shapes, the flash kernel (where
    the family attends) and the Gram kernel launched on every rank, and
    4 × rank 0's walked flops within ``PART_REPEAT`` of one device's.
    ``ranks`` are the ranks' records of the family's steps, ``pred`` rank
    0's walk of them. Returns (the launches, the family's record, its
    problems)."""
    from repro_torch.launch import partitioned as PT

    plan = PT.Plan(**spec)
    shape, _ = PART_MESH
    cfg = plan.config()
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _zero(K)
    t1 = time.perf_counter()
    one = PT.one_rank_steps(plan, device="cuda")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    launches = _read(K)
    launches["flash_attention_cuda"] = K.FA.flash_attention.cuda_launches
    del one["routing"]
    g1 = one["state"]["gram"].double()
    gram_bar, logit_bar = PART_FAMILY_REL.get(spec["arch"], (PART_GRAM_REL, PART_LOGIT_REL))

    what = spec["arch"]
    attends = cfg.arch_type != "xlstm"
    want_scans = _local_scans(cfg, plan.batch, shape)
    repeat = PT.repeated_work(pred, math.prod(shape))
    problems, rows = [], []
    for r, rec in enumerate(ranks):
        st = rec["state"]
        gram_rel = float((st["gram"].double() - g1).abs().max() / g1.abs().max())
        logit_rel = [float(((a.double() - b.double()).abs().amax(-1)
                            / b.double().abs().amax(-1)).max())
                     for a, b in zip(rec["logits"], one["logits"])]
        tokens_equal = all(bool(torch.equal(a, b)) for a, b in zip(rec["tokens"],
                                                                   one["tokens"]))
        flash = sum(v["flash_launches"] for v in rec["steps"].values())
        gram = sum(v["gram_launches"] for v in rec["steps"].values())
        rows.append(dict(rank=r, gram_rel=gram_rel, count=float(st["count"]),
                         logit_rel=max(logit_rel), tokens_equal=tokens_equal,
                         peak_bytes=rec["peak_bytes"], flash_launches=flash,
                         gram_launches=gram,
                         step_s={n: v["seconds"] for n, v in rec["steps"].items()}))
        if gram_rel > gram_bar:
            problems.append(f"{what}: rank {r}'s Gram off by {gram_rel:.3e} of its largest "
                            f"(bar {gram_bar:.3e})")
        if not float(st["count"]) == float(one["state"]["count"]) == plan.batch:
            problems.append(f"{what}: rank {r}'s count {float(st['count'])}")
        if max(logit_rel) > logit_bar:
            problems.append(f"{what}: rank {r}'s logits off by "
                            + ", ".join(f"{e:.3e}" for e in logit_rel)
                            + f" of a row's largest (prefill, then each decode step; bar "
                            f"{logit_bar:.3e})")
        if not tokens_equal:
            problems.append(f"{what}: rank {r}'s greedy tokens differ from one rank's")
        if not gram or (attends and not flash) or (not attends and flash):
            problems.append(f"{what}: rank {r} launched flash {flash}, Gram {gram} times")
        for name in ("train", "prefill"):
            # every scan's (name, carry shapes): a layer at other shapes differs
            got = set(rec["steps"][name]["scans"])
            if got != set(want_scans.items()):
                problems.append(f"{what}: rank {r}'s {name} carries {sorted(got)}, want "
                                f"{want_scans}")
        for name, step in rec["steps"].items():
            got = [tuple(x) for x in step["collectives"]]
            want = [tuple(x) for x in pred["steps"][name]["collectives"]]
            if got != want:
                first = next(i for i in range(max(len(got), len(want)))
                             if got[i:i + 1] != want[i:i + 1])
                problems.append(f"{what}: rank {r}'s {name} issued {len(got)} collectives, "
                                f"the walk predicts {len(want)}; at {first}: "
                                f"{got[first:first + 1]} against {want[first:first + 1]}")
            if step["comm_debug"] != len(got):
                problems.append(f"{what}: rank {r}'s {name}: CommDebugMode counts "
                                f"{step['comm_debug']} collectives, the walk's counter "
                                f"{len(got)}")
    for name in ("train", "prefill"):
        if repeat[name] > PART_REPEAT:
            problems.append(f"{what}: {name} repeats work: 4 × rank 0's flops are "
                            f"{repeat[name]:.4f} × one device's")
    for name in ("flash_attention", "gram_update"):
        launches[name] += sum(row["flash_launches" if name == "flash_attention"
                                  else "gram_launches"] for row in rows)
    checks_s = time.perf_counter() - t0
    coll = {name: dict(count=len(v["collectives"]),
                       bytes={k: sum(x[3] for x in v["collectives"] if x[0] == k)
                              for k in sorted({x[0] for x in v["collectives"]})})
            for name, v in pred["steps"].items()}
    wall_rank = max(sum(row["step_s"].values()) for row in rows)
    log(f"partitioned {what} ({cfg.num_layers} layers, {plan.batch} × {plan.seq}): "
        f"steps {wall_rank:.2f} s a rank at most, one rank {one_s:.1f} s, checks "
        f"{checks_s:.1f} s; Gram "
        + ", ".join(f"{row['gram_rel']:.3e}" for row in rows) + "; logits "
        + ", ".join(f"{row['logit_rel']:.3e}" for row in rows)
        + f" (bars {gram_bar:.3e}, {logit_bar:.3e})"
        + f"; peak " + ", ".join(str(row["peak_bytes"]) for row in rows) + " B a rank; "
        f"flash {rows[0]['flash_launches']} / Gram {rows[0]['gram_launches']} a rank; "
        f"carries {want_scans}; 4 × rank 0 / one device flops "
        + ", ".join(f"{k} {v:.4f}" for k, v in repeat.items()))
    log(f"partitioned {what}: collectives a rank (walk = ranks, op for op): "
        + "; ".join(f"{k} {v['count']} {v['bytes']}" for k, v in coll.items()))
    return launches, dict(plan=spec, ranks=rows, collectives=coll, rank_s=wall_rank,
                          checks_s=checks_s, one_rank_s=one_s, repeated_work=repeat,
                          bars=dict(gram=gram_bar, logits=logit_bar),
                          carries={k: [list(x) for x in v] for k, v in want_scans.items()},
                          walk={k: dict(flops=v["cost"]["flops"],
                                        bytes=v["cost"]["bytes_accessed"],
                                        peak=v["cost"]["peak_bytes"])
                                for k, v in pred["steps"].items()}), problems


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
    global PEAK_BYTES_S, PEAK_FLOPS
    from repro_torch.launch import mesh
    PEAK_BYTES_S, PEAK_FLOPS = mesh.HBM_BW, mesh.PEAK_FLOPS
    from repro_torch.config import FLConfig, InputShape
    from repro_torch.core import engine
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic as D
    from repro_torch.core import distributed, streaming
    from repro_torch import checkpoint
    from repro_torch.fl import afl, api, mux, partition, replication, service
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
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch import optim

    # every kernel's wrapper, by name: each path's launches are counted on these
    K = SimpleNamespace(G=G, P=P, B=B, R=R, FA=FA, ALL={
        "gram_update": G.gram_update, "panel_factor": P.panel_factor,
        "panel_tri_inv": P.panel_tri_inv, "panel_trsm": P.panel_trsm,
        "panel_update": P.panel_update, "blocked_cholesky": B.blocked_cholesky,
        "cholesky_solve": B.cholesky_solve, "multi_gamma_solve": B.multi_gamma_solve,
        "chol_rank_update": R.chol_rank_update, "flash_attention": FA.flash_attention})
    marks = [t_start]

    def lap(what: str) -> None:
        """Log the wall since the last lap: where the smoke's time limit goes."""
        marks.append(time.perf_counter())
        log(f"wall: {what} {marks[-1] - marks[-2]:.1f} s (total {marks[-1] - t_start:.1f} s)")

    header(K, build)
    lap("build")
    rows = {"gram_update": kernel_phase(G, ref)}
    rows.update(panel_phase(P, ref))
    rows.update(blocked_phase(K, ref))
    for name, more in f64_kernel_phase(K, ref).items():
        rows[name].extend(more)
    for name, more in sharded_kernel_phase(P, ref, S, api).items():
        rows[name].extend(more)
    lap("kernel phases 1-5")
    rows["flash_attention"] = attention_phase(FA, ref)
    lap("attention")
    products = [streamed_products(S, P, dt) for dt in (torch.float32, torch.float64)]
    profiles = factor_profiles(S)
    streamed = streamed_phase(S, P)
    x2_launches, x2_rows = precision_phase(K, ref, S)
    for name, more in x2_rows.items():
        rows[name].extend(more)
    lap("streamed and f32_x2")
    small_check(get_config, D, T, train, FLConfig)
    slice_launches, server, x_te, y_te, sl = slice_phase(K, get_config, D, T, train,
                                                         FLConfig, api)
    paths = [x2_launches, slice_launches,
             device_solve_phase(K, S, engine, api, server, x_te, y_te),
             sweep_phase(K, ref, S, engine, api, server, x_te, y_te),
             narrow_phase(K, ref, engine, api, D),
             rank_update_phase(K, engine, api, server, x_te, y_te, FLConfig(gamma=1.0))]
    f64_launches, f64_times = f64_engine_phase(K, S, engine, api, server, x_te, y_te,
                                               FLConfig(gamma=1.0))
    paths.append(f64_launches)
    lap("slice and device engine")
    paper_launches, pr = paper_round_phase(K, sl, train, afl, partition, streaming, ST,
                                           api, D, FLConfig)
    paths.append(paper_launches)
    lap("paper round")
    paths.append(federation_phase(K, sl, pr, train, afl, api, service, mux, replication,
                                  checkpoint, FLConfig))
    lap("federation")
    paths.append(sharded_phase(K, S, distributed, sl, pr, afl, api, service, FLConfig))
    lap("sharded")
    del server, sl, pr
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, served = serve_phase(K, get_config, T, L, serve_mod, ST, ref)
    paths.append(serve_launches)
    lap("serve")
    zoo_launches, zoo = zoo_phase(K, get_config, T, serve_mod, M, D, train, afl, api,
                                  FLConfig)
    paths.append(zoo_launches)
    lap("zoo")
    gc.collect()
    torch.cuda.empty_cache()
    training_launches, lm_row, training = training_phase(K, ref, get_config, D, T, L, ST,
                                                         train, FLConfig, optim)
    paths.append(training_launches)
    rows["flash_attention"].append(lm_row)
    lap("training")
    dryrun_launches, dryrun = dryrun_phase(K, Path(__file__).resolve().parent, get_config,
                                           InputShape)
    paths.append(dryrun_launches)
    lap("dry run")
    partitioned_launches, partitioned = partitioned_phase(K)
    paths.append(partitioned_launches)
    lap("partitioned")
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
    log(json.dumps({"zoo": zoo}))
    log(json.dumps({"training": training}))
    log(json.dumps({"dryrun": dryrun}))
    log(json.dumps({"partitioned": partitioned}))
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
