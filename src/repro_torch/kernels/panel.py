"""CUDA kernels: the four panel kernels of the streamed Cholesky.

The ports of the Pallas TPU kernels ``repro.kernels.solve.panel_factor``,
``panel_tri_inv``, ``panel_trsm`` and ``panel_update``. The schedules in
``kernels.solve`` (``streamed_cholesky`` and ``streamed_cholesky_solve``)
call them once per panel of a wide system.

The kernels are ``csrc/panel.cu`` (its header states the designs and the
bounds on an H100; the two products run on the tile routine of
``csrc/gemm_nt.cuh``: the FP64 tensor cores in f64, FMA in f32), built by
``kernels.build`` and bound with ``ctypes``.
They take CUDA tensors whose rows have unit column stride, every operand
of one call f32 or every one f64 (each kernel has an instance of each); a
row stride larger than the width is passed to the kernel, so a column slab
of a larger matrix is read or written where it lies. ``kernels.ops``
dispatches between these wrappers (CUDA tensors) and the plain versions in
``kernels.ref`` (CPU tensors). Each wrapper counts its launches in
``.launches`` (under a lock: the shards of a mesh launch from threads).

The two products take the reference's ``precision``: ``"f32_x2"`` (f32
only) launches their split instance (``afl_panel_*_f32x2``: each operand
split into exact 12-bit halves as it is staged, three FFMA sums, the
reference's ``_make_mm2``), counted in ``.x2_launches`` as well.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "panel.cu"
# the widest (b, b) triangle one SM holds, packed, in each type: 128.5 KB
# at 256 in f32; at 256 in f64 it would be 257 KB, so 128 (kMaxPanel)
MAX_PANEL = {torch.float32: 256, torch.float64: 128}

_INT_MAX = 2**31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "afl_panel_factor": [_P, _I, _I, _P, _P, _P],
    "afl_panel_tri_inv": [_P, _I, _I, _P, _P],
    "afl_panel_trsm": [_P, _I, _P, _I, _P, _I, _I, _I, _P],
    "afl_panel_update": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P],
}
X2_SUFFIX = "f32x2"      # the split products' f32 instances: afl_panel_{trsm,update}_f32x2
_X2 = ("afl_panel_trsm", "afl_panel_update")


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/panel.cu`` (once per source content), load it and
    declare its entry points."""
    built = _build.load(SOURCE)[0]
    for name, argtypes in _SIGNATURES.items():
        for suffix in (*_build.SUFFIX.values(), *((X2_SUFFIX,) if name in _X2 else ())):
            fn = getattr(built.lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return built


_LAUNCHES = threading.Lock()


def _count(wrapper, x2: bool = False) -> None:
    """One more launch of ``wrapper`` (and of its split instance), under a
    lock: the shards of a ``core.distributed.ShardGroup`` launch from
    threads of their own."""
    with _LAUNCHES:
        wrapper.launches += 1
        if x2:
            wrapper.x2_launches += 1


def _entry(name: str, dtype: torch.dtype, x2: bool = False):
    return getattr(build().lib, f"afl_{name}_{X2_SUFFIX if x2 else _build.SUFFIX[dtype]}")


def _row_stride(name: str, t: torch.Tensor, shape: tuple[int, int],
                dtype: Optional[torch.dtype] = None) -> int:
    """Checks one operand and returns its row stride; ``dtype`` is the
    call's (its first operand's)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: panel kernels need CUDA tensors, got {t.device} "
                         "(kernels.ops takes the plain version for CPU tensors)")
    if t.dtype not in _build.SUFFIX or t.dtype != (dtype or t.dtype):
        raise TypeError(f"{name}: panel kernels take f32 or f64, every operand of one "
                        f"dtype, got {t.dtype}" + (f" beside {dtype}" if dtype else ""))
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    rows, cols = shape
    if cols > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: rows must have unit column stride, got "
                         f"strides {t.stride()}")
    ld = t.stride(0) if rows > 1 else cols
    if ld < cols or rows * ld > _INT_MAX:
        raise ValueError(f"{name}: row stride {ld} out of range for {shape}")
    return ld


def _same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"panel kernels need one device, got {[t.device for t in ts]}")


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _panel(diag: torch.Tensor, name: str) -> int:
    if diag.dim() != 2:
        raise ValueError(f"{name}: expected a (b, b) block, got {tuple(diag.shape)}")
    b = diag.shape[0]
    ld = _row_stride(name, diag, (b, b))
    widest = MAX_PANEL[diag.dtype]
    if not 1 <= b <= widest:
        raise ValueError(f"{name}: panel width {b} outside 1..{widest} for {diag.dtype} "
                         "(the kernel holds one packed triangle on one SM)")
    return ld


def panel_factor(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, L⁻¹)`` of one SPD (b, b) block, b ≤ 256 in f32 and ≤ 128 in
    f64; both clean lower triangles. Only the lower triangle of ``diag`` is
    read. A block that is not positive definite gives NaNs."""
    ld = _panel(diag, "panel_factor")
    b = diag.shape[0]
    fn = _entry("panel_factor", diag.dtype)
    l = torch.empty((b, b), dtype=diag.dtype, device=diag.device)
    z = torch.empty_like(l)
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(diag.data_ptr(), ld, b, l.data_ptr(), z.data_ptr(), stream)
    _check(err, "panel_factor")
    _count(panel_factor)
    return l, z


def panel_tri_inv(l: torch.Tensor) -> torch.Tensor:
    """``L⁻¹`` of one lower-triangular (b, b) block, b ≤ 256 in f32 and ≤ 128
    in f64 (its upper triangle is not read); a clean lower triangle."""
    ld = _panel(l, "panel_tri_inv")
    b = l.shape[0]
    fn = _entry("panel_tri_inv", l.dtype)
    z = torch.empty((b, b), dtype=l.dtype, device=l.device)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(l.data_ptr(), ld, b, z.data_ptr(), stream)
    _check(err, "panel_tri_inv")
    _count(panel_tri_inv)
    return z


def panel_trsm(raw: torch.Tensor, zinv: torch.Tensor, *,
               precision: str = "native") -> torch.Tensor:
    """``raw (r, b) @ zinv (b, b)ᵀ`` into a new contiguous (r, b) tensor;
    ``precision`` as the module says."""
    if raw.dim() != 2 or raw.shape[0] == 0 or raw.shape[1] == 0:
        raise ValueError(f"panel_trsm: expected a non-empty (r, b) slab, got "
                         f"{tuple(raw.shape)}")
    r, b = raw.shape
    ldr = _row_stride("panel_trsm raw", raw, (r, b))
    ldz = _row_stride("panel_trsm zinv", zinv, (b, b), raw.dtype)
    _same_device(raw, zinv)
    x2 = _ref.check_precision(precision, raw.dtype)
    fn = _entry("panel_trsm", raw.dtype, x2)
    out = torch.empty((r, b), dtype=raw.dtype, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(raw.data_ptr(), ldr, zinv.data_ptr(), ldz, out.data_ptr(), b, r, b, stream)
    _check(err, "panel_trsm")
    _count(panel_trsm, x2)
    return out


def panel_update(trail: torch.Tensor, lp: torch.Tensor, pt: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None,
                 precision: str = "native") -> torch.Tensor:
    """``trail (r, w) − lp (r, b) @ pt (w, b)ᵀ``; ``precision`` as the
    module says.

    Written into ``out`` when given (an (r, w) tensor of the same dtype on
    the same device, which may be ``trail`` itself but must not overlap ``lp`` or
    ``pt``), else into a new contiguous tensor.
    """
    if trail.dim() != 2 or lp.dim() != 2 or 0 in trail.shape or 0 in lp.shape:
        raise ValueError(f"panel_update: expected non-empty (r, w) and (r, b), got "
                         f"{tuple(trail.shape)} and {tuple(lp.shape)}")
    r, w = trail.shape
    b = lp.shape[1]
    ldt = _row_stride("panel_update trail", trail, (r, w))
    ldl = _row_stride("panel_update lp", lp, (r, b), trail.dtype)
    ldp = _row_stride("panel_update pt", pt, (w, b), trail.dtype)
    if out is None:
        out = torch.empty((r, w), dtype=trail.dtype, device=trail.device)
    ldo = _row_stride("panel_update out", out, (r, w), trail.dtype)
    _same_device(trail, lp, pt, out)
    x2 = _ref.check_precision(precision, trail.dtype)
    fn = _entry("panel_update", trail.dtype, x2)
    with torch.cuda.device(trail.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(trail.data_ptr(), ldt, lp.data_ptr(), ldl, pt.data_ptr(), ldp,
                 out.data_ptr(), ldo, r, w, b, stream)
    _check(err, "panel_update")
    _count(panel_update, x2)
    return out


panel_factor.launches = 0
panel_tri_inv.launches = 0
panel_trsm.launches = 0
panel_update.launches = 0
panel_trsm.x2_launches = 0
panel_update.x2_launches = 0
