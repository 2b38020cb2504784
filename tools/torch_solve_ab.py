#!/usr/bin/env python3
"""Time the port's device-engine solves in one checkout, for A/B runs.

    python3 tools/torch_solve_ab.py --src <checkout>/src [--label NAME]

Imports ``repro_torch`` from ``--src``, so that one run on the card can
time two checkouts in turns (parent, change, change, parent), each in a
process of its own. Prints one JSON line: the label, the card's name and
power limit (nvidia-smi), and the milliseconds of
``AnalyticEngine("torch", use_kernel=True).solve`` (factor and solve, the
median of ``--reps`` calls, each timed on the host to a synchronised end)
on one seeded SPD system XᵀX/4d (condition number near 9) with C = 16
right-hand sides:

  * ``streamed_f32`` / ``streamed_f64``: d = 2304 (the streamed route:
    panel kernels, ``panel_tri_inv`` for every diagonal block of the solve)
    at γ = 0.01·tr/d;
  * ``narrow_f32`` / ``narrow_f64``: d = 1536 (``blocked_cholesky`` and
    ``cholesky_solve``);
  * ``sweep_f32`` / ``sweep_f64``: ``solve_multi_gamma`` on the d = 2304
    system at 16 ridges γ = ρ·tr/d, ρ from 1e-4 to 1 (one
    ``multi_gamma_solve`` call and the engine's check that every weight is
    finite).

Each streamed key also gets one call under torch.profiler
(``<key>_profile``): its host milliseconds to a synchronised end, the
card's kernels, and the milliseconds in the union of their intervals
(``busy_ms``), so that a difference between two checkouts can be split
into device time and the host's.

Needs a CUDA GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def _profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: host milliseconds to a
    synchronised end, the card's kernels, the milliseconds in the union of
    their intervals, and each kernel's milliseconds and launches by its
    function's name (``by_kernel``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy += (end - max(start, reach)) / 1e3
            reach = end
    by_kernel: dict[str, list] = {}
    for e in events:
        entry = by_kernel.setdefault(_kernel_name(e.name), [0.0, 0])
        entry[0] += (e.time_range.end - e.time_range.start) / 1e3
        entry[1] += 1
    return {"wall_ms": wall_ms, "kernels": len(spans), "busy_ms": busy, "by_kernel": by_kernel}


def _kernel_name(name: str) -> str:
    """A kernel's function name without its namespaces, template arguments
    and parameters: ``(anonymous namespace)::factor_kernel<double, 512,
    afl_tri::NoMarks>(...)`` is ``factor_kernel``."""
    head = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", head, maxsplit=1)[0].rsplit("::", 1)[-1].strip() or name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the checkout's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        sys.exit(f"no repro_torch package under {src}")
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    from repro_torch.core import engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    out = {"label": args.label, "src": str(src), "card": smi[0] if smi else None}
    for name, d, dtype in (("streamed_f32", 2304, torch.float32),
                           ("streamed_f64", 2304, torch.float64),
                           ("narrow_f32", 1536, torch.float32),
                           ("narrow_f64", 1536, torch.float64)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(d)
        x = torch.randn((4 * d, d), generator=gen, device="cuda", dtype=torch.float64)
        gram = (x.T @ x / (4 * d)).to(dtype)
        rhs = torch.randn((d, 16), generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        one = torch.tensor(1.0, device="cuda", dtype=dtype)
        stats = engine.SuffStats(gram, rhs, one, one)
        eng = engine.AnalyticEngine("torch", dtype=dtype, device="cuda", use_kernel=True)
        gamma = 0.01 * float(torch.trace(gram)) / d if d >= 2048 else 0.0
        w = eng.solve(stats, target_gamma=gamma)
        if not bool(torch.isfinite(w).all()):
            sys.exit(f"{name}: the solve is not finite")
        out[name] = _median_ms(lambda: eng.solve(stats, target_gamma=gamma), args.reps)
        if d >= 2048:
            out[f"{name}_profile"] = _profile(lambda: eng.solve(stats, target_gamma=gamma))
        if d >= 2048:
            sweep = f"sweep_{name.rsplit('_', 1)[1]}"
            gammas = [float(rho) * float(torch.trace(gram)) / d
                      for rho in torch.logspace(-4, 0, 16, dtype=torch.float64)]
            ws = eng.solve_multi_gamma(stats, gammas)
            if not all(bool(torch.isfinite(wg).all()) for wg in ws):
                sys.exit(f"{sweep}: the sweep is not finite")
            out[sweep] = _median_ms(lambda: eng.solve_multi_gamma(stats, gammas), args.reps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
