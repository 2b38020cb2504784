"""CUDA kernel: the rank-k update of a lower Cholesky factor.

The port of the Pallas TPU kernel ``repro.kernels.solve.chol_rank_update``:
``chol(L Lᵀ + xsᵀ xs)`` in one launch, the Householder column sweep of the
reference's ``_rank_update_kernel``. The engine's ``factor_update`` folds
a straggler's low-rank root into a cached factor with it.

The kernel is ``csrc/rank_update.cu`` (its header states the design and the
bound on an H100), built by ``kernels.build`` and bound with ``ctypes``. It
takes contiguous f32 CUDA tensors. ``kernels.solve`` dispatches between
this wrapper (CUDA tensors) and the plain version in ``kernels.ref`` (CPU
tensors). The wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rank_update.cu"
MAX_ROWS = 8192          # update rows the kernel's shared memory holds (k floats)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/rank_update.cu`` (once per source content), load it
    and declare its entry point."""
    built = _build.load(SOURCE)[0]
    built.lib.afl_chol_rank_update_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P]
    built.lib.afl_chol_rank_update_f32.restype = ctypes.c_int
    return built


def _operand(name: str, t: torch.Tensor, shape: tuple[int, int]) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the rank-update kernel needs CUDA tensors, got "
                         f"{t.device} (kernels.solve takes the plain version for CPU "
                         "tensors)")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the rank-update kernel takes f32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides {t.stride()}")


def chol_rank_update(l: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``chol(L Lᵀ + xsᵀ xs)`` for a lower factor ``l`` (d, d) and update
    rows ``xs`` (k, d), 1 ≤ k ≤ 8192, into a new (d, d) tensor; the entries
    above the diagonal are copied from ``l``."""
    if l.dim() != 2 or xs.dim() != 2 or l.shape[0] != l.shape[1] or l.shape[0] == 0:
        raise ValueError(f"chol_rank_update: expected L (d, d) and xs (k, d), got "
                         f"{tuple(l.shape)} and {tuple(xs.shape)}")
    d = l.shape[0]
    k = xs.shape[0]
    _operand("chol_rank_update L", l, (d, d))
    _operand("chol_rank_update xs", xs, (k, d))
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"chol_rank_update: k = {k} outside 1..{MAX_ROWS}")
    if xs.device != l.device:
        raise ValueError(f"chol_rank_update: L on {l.device}, xs on {xs.device}")
    lib = build().lib
    rt = torch.empty_like(l)                  # Lᵀ, swept in place
    xt = torch.empty((d, k), dtype=torch.float32, device=l.device)
    out = torch.empty_like(l)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afl_chol_rank_update_f32(l.data_ptr(), xs.data_ptr(), rt.data_ptr(),
                                           xt.data_ptr(), out.data_ptr(), d, k, stream)
    if err != 0:
        raise RuntimeError(f"chol_rank_update kernel launch failed with CUDA error {err}")
    chol_rank_update.launches += 1
    return out


chol_rank_update.launches = 0
