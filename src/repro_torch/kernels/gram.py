"""CUDA kernel: fused Gram-statistics update  G = XᵀX,  Q = XᵀY.

The port of the Pallas TPU kernel ``repro.kernels.gram.gram_update``. Every
analytic train step folds a batch of backbone embeddings ``X (N, d)`` and
one-hot targets ``Y (N, C)`` into the sufficient statistics through it.

The kernel is ``csrc/gram.cu`` (its header states the design and the bound
on an H100). ``kernels.build`` compiles it with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface on first use, and ``ctypes``
binds it. ``kernels.ops.gram_update`` dispatches between this wrapper (CUDA
tensors) and the plain version in ``kernels.ref`` (CPU tensors).

The kernel computes only the ``TILE``-sized tiles of G on and above the
diagonal and mirrors them (:func:`upper_tiles`); ``ref.gram_upper_ref`` is
the plain twin of that schedule. Where those tiles are too few to fill the
card, :func:`split_rows` cuts N over several blocks a tile, whose partial
tiles this wrapper's workspace holds until a second kernel adds them.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gram.cu"

_INT_MAX = 2**31 - 1

TILE = (64, 64)          # the kernel's tile of G and of Q: (rows, columns)
SPLIT_MIN_ROWS = 64      # no block of a split fold sums fewer rows of X


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/gram.cu`` (once per source content), load it and
    declare its entry points."""
    built = _build.load(SOURCE)[0]
    for name in ("afl_gram_update_f32", "afl_gram_update_bf16"):
        fn = getattr(built.lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return built


def upper_tiles(d: int) -> list[tuple[int, int]]:
    """The kernel's tiles of a (d, d) Gram, as (first row, first column):
    every ``TILE`` whose first column is at or right of its first row, row
    by row, as the kernel numbers its blocks. Together they cover the upper
    triangle (diagonal included) once."""
    bm, bn = TILE
    return [(i, j) for i in range(0, d, bm) for j in range(i, d, bn)]


def blocks(d: int, c: int) -> int:
    """The kernel's tiles (a block each): G's upper tiles, then Q's."""
    tiles = -(-d // TILE[0])
    return tiles * (tiles + 1) // 2 + tiles * -(-c // TILE[1])


def split_rows(n: int, d: int, c: int, sms: int) -> int:
    """Rows of X that one block sums: all ``n``, unless the tiles of G and
    Q are too few to fill ``sms`` SMs twice over; then ``n`` is cut into up
    to ``2·sms / tiles`` splits of at least ``SPLIT_MIN_ROWS`` rows (a
    multiple of the kernel's 16-row step), and a second kernel adds their
    partial tiles in split order."""
    want = -(-2 * sms // blocks(d, c))
    if want <= 1 or n <= SPLIT_MIN_ROWS:
        return max(n, 1)
    rows = max(SPLIT_MIN_ROWS, -(-n // want))
    return -(-rows // 16) * 16


def gram_update(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(XᵀX, XᵀY) in f32 through the CUDA kernel.

    x: (N, d), y: (N, C), contiguous CUDA tensors on one device, both f32,
    both bf16 or both f64. f64 inputs are cast to f32 before the launch:
    the fold accumulates in f32 whatever comes in, as the Pallas kernel and
    ``ref.gram_ref`` do (there is no f64 Gram kernel). Launches on the
    current stream (two kernels where :func:`split_rows` splits N);
    ``gram_update.launches`` counts the calls.
    """
    _build.reject_dtensor("gram_update", x, y)
    if not (x.is_cuda and y.is_cuda) or x.device != y.device:
        raise ValueError(
            f"gram kernel needs both inputs on one CUDA device, got "
            f"{x.device} and {y.device} (kernels.ops.gram_update takes the "
            "plain version for CPU tensors)")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float64) or y.dtype != x.dtype:
        raise TypeError(f"gram kernel takes f32, bf16 or f64 inputs of one dtype, "
                        f"got {x.dtype} and {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"gram kernel needs x (N, d) and y (N, C), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gram kernel needs contiguous inputs")
    n, d = x.shape
    c = y.shape[1]
    if d == 0 or max(n * d, n * c, d * d) > _INT_MAX:
        raise ValueError(f"gram kernel shape out of range: N={n} d={d} C={c}")
    if x.dtype == torch.float64:
        x, y = x.to(torch.float32), y.to(torch.float32)
    lib = build().lib
    fn = lib.afl_gram_update_f32 if x.dtype == torch.float32 else lib.afl_gram_update_bf16
    g = torch.empty((d, d), dtype=torch.float32, device=x.device)
    q = torch.empty((d, c), dtype=torch.float32, device=x.device)
    rows = split_rows(n, d, c, sm_count(x.device.index))
    part = None
    if n > rows:                         # the split's partial tiles
        part = torch.empty(-(-n // rows) * blocks(d, c) * TILE[0] * TILE[1],
                           dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), g.data_ptr(), q.data_ptr(),
                 n, d, c, rows, None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {err}")
    gram_update.launches += 1
    return g, q


gram_update.launches = 0
