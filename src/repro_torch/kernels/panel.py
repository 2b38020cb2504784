"""CUDA kernels: the four panel kernels of the streamed Cholesky.

The ports of the Pallas TPU kernels ``repro.kernels.solve.panel_factor``,
``panel_tri_inv``, ``panel_trsm`` and ``panel_update``. The schedules in
``kernels.solve`` (``streamed_cholesky`` and ``streamed_cholesky_solve``)
call them once per panel of a wide system.

The kernels are ``csrc/panel.cu`` (its header states the designs and the
bounds on an H100), built by ``kernels.build`` and bound with ``ctypes``.
They take f32 CUDA tensors whose rows have unit column stride; a row
stride larger than the width is passed to the kernel, so a column slab of
a larger matrix is read or written where it lies. ``kernels.ops``
dispatches between these wrappers (CUDA tensors) and the plain versions in
``kernels.ref`` (CPU tensors). Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "panel.cu"
MAX_PANEL = 256          # the panel kernels hold one (b, b) triangle on one SM

_INT_MAX = 2**31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "afl_panel_factor_f32": [_P, _I, _I, _P, _P, _P],
    "afl_panel_tri_inv_f32": [_P, _I, _I, _P, _P],
    "afl_panel_trsm_f32": [_P, _I, _P, _I, _P, _I, _I, _I, _P],
    "afl_panel_update_f32": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P],
}


@functools.cache
def build() -> _build.Build:
    """Compile ``csrc/panel.cu`` (once per source content), load it and
    declare its entry points."""
    built = _build.load(SOURCE)[0]
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


def _row_stride(name: str, t: torch.Tensor, shape: tuple[int, int]) -> int:
    """Checks one operand and returns its row stride."""
    if not t.is_cuda:
        raise ValueError(f"{name}: panel kernels need CUDA tensors, got {t.device} "
                         "(kernels.ops takes the plain version for CPU tensors)")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: panel kernels take f32, got {t.dtype}")
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
    if not 1 <= b <= MAX_PANEL:
        raise ValueError(f"{name}: panel width {b} outside 1..{MAX_PANEL}")
    return _row_stride(name, diag, (b, b))


def panel_factor(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, L⁻¹)`` of one SPD (b, b) block, b ≤ 256; both clean lower
    triangles. Only the lower triangle of ``diag`` is read. A block that is
    not positive definite gives NaNs."""
    ld = _panel(diag, "panel_factor")
    b = diag.shape[0]
    lib = build().lib
    l = torch.empty((b, b), dtype=torch.float32, device=diag.device)
    z = torch.empty_like(l)
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afl_panel_factor_f32(diag.data_ptr(), ld, b, l.data_ptr(),
                                       z.data_ptr(), stream)
    _check(err, "panel_factor")
    panel_factor.launches += 1
    return l, z


def panel_tri_inv(l: torch.Tensor) -> torch.Tensor:
    """``L⁻¹`` of one lower-triangular (b, b) block, b ≤ 256 (its upper
    triangle is not read); a clean lower triangle."""
    ld = _panel(l, "panel_tri_inv")
    b = l.shape[0]
    lib = build().lib
    z = torch.empty((b, b), dtype=torch.float32, device=l.device)
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afl_panel_tri_inv_f32(l.data_ptr(), ld, b, z.data_ptr(), stream)
    _check(err, "panel_tri_inv")
    panel_tri_inv.launches += 1
    return z


def panel_trsm(raw: torch.Tensor, zinv: torch.Tensor) -> torch.Tensor:
    """``raw (r, b) @ zinv (b, b)ᵀ`` into a new contiguous (r, b) tensor."""
    if raw.dim() != 2 or raw.shape[0] == 0 or raw.shape[1] == 0:
        raise ValueError(f"panel_trsm: expected a non-empty (r, b) slab, got "
                         f"{tuple(raw.shape)}")
    r, b = raw.shape
    ldr = _row_stride("panel_trsm raw", raw, (r, b))
    ldz = _row_stride("panel_trsm zinv", zinv, (b, b))
    _same_device(raw, zinv)
    lib = build().lib
    out = torch.empty((r, b), dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afl_panel_trsm_f32(raw.data_ptr(), ldr, zinv.data_ptr(), ldz,
                                     out.data_ptr(), b, r, b, stream)
    _check(err, "panel_trsm")
    panel_trsm.launches += 1
    return out


def panel_update(trail: torch.Tensor, lp: torch.Tensor, pt: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``trail (r, w) − lp (r, b) @ pt (w, b)ᵀ``.

    Written into ``out`` when given (an (r, w) f32 tensor on the same
    device, which may be ``trail`` itself but must not overlap ``lp`` or
    ``pt``), else into a new contiguous tensor.
    """
    if trail.dim() != 2 or lp.dim() != 2 or 0 in trail.shape or 0 in lp.shape:
        raise ValueError(f"panel_update: expected non-empty (r, w) and (r, b), got "
                         f"{tuple(trail.shape)} and {tuple(lp.shape)}")
    r, w = trail.shape
    b = lp.shape[1]
    ldt = _row_stride("panel_update trail", trail, (r, w))
    ldl = _row_stride("panel_update lp", lp, (r, b))
    ldp = _row_stride("panel_update pt", pt, (w, b))
    if out is None:
        out = torch.empty((r, w), dtype=torch.float32, device=trail.device)
    ldo = _row_stride("panel_update out", out, (r, w))
    _same_device(trail, lp, pt, out)
    lib = build().lib
    with torch.cuda.device(trail.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afl_panel_update_f32(trail.data_ptr(), ldt, lp.data_ptr(), ldl,
                                       pt.data_ptr(), ldp, out.data_ptr(), ldo,
                                       r, w, b, stream)
    _check(err, "panel_update")
    panel_update.launches += 1
    return out


panel_factor.launches = 0
panel_tri_inv.launches = 0
panel_trsm.launches = 0
panel_update.launches = 0
