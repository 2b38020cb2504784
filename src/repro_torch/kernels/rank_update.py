"""CUDA kernels: the rank-k update of a lower Cholesky factor.

The port of the Pallas TPU kernel ``repro.kernels.solve.chol_rank_update``:
``chol(L Lᵀ + xsᵀ xs)``, the Householder column sweep of the reference's
``_rank_update_kernel`` computed as a blocked (compact WY) sweep: each
panel of ``NB`` columns sweeps its own rows on one SM (the rows of xsᵀ in
registers, the panel's block of L in shared memory), and its transform
reaches the rows below through a grid over all SMs. The
engine's ``factor_update`` folds a straggler's low-rank root into a cached
factor with it.

The kernels are ``csrc/rank_update.cu`` (its header states the design and
the bound on an H100), built by ``kernels.build`` and bound with
``ctypes``. They take contiguous CUDA tensors, both f32 or both f64.
``kernels.solve`` dispatches between this wrapper (CUDA tensors) and the
plain version in ``kernels.ref`` (CPU tensors); ``ref`` also holds
``chol_rank_update_blocked_ref``, the same blocked schedule in plain
PyTorch. The wrapper counts its calls in ``.launches``: one a call, which
makes :func:`cuda_launches` CUDA launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rank_update.cu"
NB = 32                  # panel width (kNb)
K_PASS = 256             # update rows folded per pass (kPass): ≥ 144, the d//16 budget at d = 2304
MAX_ROWS = 8192          # update rows a call takes, in ⌈k / K_PASS⌉ passes

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/rank_update.cu`` (once per source content), load it
    and declare its entry points."""
    built = _build.load(SOURCE)[0]
    for suffix in _build.SUFFIX.values():
        fn = getattr(built.lib, f"afl_chol_rank_update_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P]
        fn.restype = ctypes.c_int
    return built


def cuda_launches(d: int, k: int) -> int:
    """CUDA kernel launches of one call: per pass of ≤ K_PASS rows, one
    transpose, one panel sweep per panel and one trailing step per panel
    but the last (the copy of L into the output is one more operation)."""
    return -(-k // K_PASS) * 2 * -(-d // NB)


def _operand(name: str, t: torch.Tensor, shape: tuple[int, int], dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the rank-update kernel needs CUDA tensors, got "
                         f"{t.device} (kernels.solve takes the plain version for CPU "
                         "tensors)")
    if t.dtype not in _build.SUFFIX or t.dtype != dtype:
        raise TypeError(f"{name}: the rank-update kernel takes f32 or f64, L and xs of "
                        f"one dtype, got {t.dtype} (L is {dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides {t.stride()}")


def chol_rank_update(l: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``chol(L Lᵀ + xsᵀ xs)`` for a lower factor ``l`` (d, d) and update
    rows ``xs`` (k, d), 1 ≤ k ≤ 8192, into a new (d, d) tensor; the entries
    above the diagonal are copied from ``l``. Rows are folded ``K_PASS`` at
    a time."""
    if l.dim() != 2 or xs.dim() != 2 or l.shape[0] != l.shape[1] or l.shape[0] == 0:
        raise ValueError(f"chol_rank_update: expected L (d, d) and xs (k, d), got "
                         f"{tuple(l.shape)} and {tuple(xs.shape)}")
    d = l.shape[0]
    k = xs.shape[0]
    _operand("chol_rank_update L", l, (d, d), l.dtype)
    _operand("chol_rank_update xs", xs, (k, d), l.dtype)
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"chol_rank_update: k = {k} outside 1..{MAX_ROWS}")
    if xs.device != l.device:
        raise ValueError(f"chol_rank_update: L on {l.device}, xs on {xs.device}")
    fn = getattr(build().lib, f"afl_chol_rank_update_{_build.SUFFIX[l.dtype]}")
    out = torch.empty_like(l)
    xt = torch.empty((d, min(k, K_PASS)), dtype=l.dtype, device=l.device)   # xsᵀ, a pass
    ws = torch.empty(NB + NB * NB, dtype=l.dtype, device=l.device)         # amr and T
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(l.data_ptr(), xs.data_ptr(), out.data_ptr(), xt.data_ptr(), ws.data_ptr(),
                 d, k, stream)
    if err != 0:
        raise RuntimeError(f"chol_rank_update kernel launch failed with CUDA error {err}")
    chol_rank_update.launches += 1
    return out


chol_rank_update.launches = 0
