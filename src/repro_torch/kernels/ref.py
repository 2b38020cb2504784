"""Plain PyTorch versions of the port's kernels.

The CPU takes these in place of the kernels (``kernels.ops``), and the
tests and ``chip_smoke.py`` hold each kernel against its version here.
The panel versions follow the reference's algorithm (its ``_factor_tile``
and ``_tri_inv_tile`` column loops, then matrix products), not LAPACK, so
the CPU route does the JAX package's arithmetic in the same order as far
as torch allows.
"""

from __future__ import annotations

from typing import Optional

import torch


def gram_ref(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.gram.gram_update``: (XᵀX, XᵀY) in f32."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    return xf.T @ xf, xf.T @ yf


def factor_tile(tile: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of one (m, m) SPD tile: a column sweep with
    masked full-width updates, the upper triangle written as zeros. A tile
    that is not positive definite gives NaNs (sqrt of a negative pivot)."""
    s = tile.clone()
    rows = torch.arange(s.shape[-1], device=s.device)
    for j in range(s.shape[-1]):
        pv = torch.sqrt(s[j, j])
        colm = torch.where(rows > j, s[:, j] / pv, torch.zeros((), dtype=s.dtype,
                                                               device=s.device))
        s -= colm[:, None] * colm[None, :]
        s[:, j] = torch.where(rows == j, pv, colm)
    return s


def tri_inv_tile(l: torch.Tensor) -> torch.Tensor:
    """Inverse of one (m, m) lower-triangular tile by forward substitution
    on the identity; the strict upper triangle of ``l`` is not read."""
    m = l.shape[-1]
    rows = torch.arange(m, device=l.device)
    eye = torch.eye(m, dtype=l.dtype, device=l.device)
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    z = torch.zeros_like(l)
    for i in range(m):
        strict = torch.where(rows < i, l[i], zero)
        z[i] = (eye[i] - strict @ z) / l[i, i]
    return z


def panel_factor_ref(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.panel.panel_factor``: ``(L, L⁻¹)``."""
    l = factor_tile(diag)
    return l, tri_inv_tile(l)


def panel_tri_inv_ref(l: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.panel.panel_tri_inv``: ``L⁻¹``."""
    return tri_inv_tile(l)


def panel_trsm_ref(raw: torch.Tensor, zinv: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.panel.panel_trsm``: ``raw @ zinvᵀ``."""
    return raw @ zinv.T


def panel_update_ref(trail: torch.Tensor, lp: torch.Tensor, pt: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``kernels.panel.panel_update``: ``trail − lp @ ptᵀ``
    (into ``out`` when given, which may be ``trail`` itself)."""
    return torch.sub(trail, lp @ pt.T, out=out)
