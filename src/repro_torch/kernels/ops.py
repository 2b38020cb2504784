"""Entry points for the port's kernels.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version in ``kernels.ref``. There is no fallback between the
two: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import ref
from repro_torch.kernels.solve import (  # noqa: F401  (re-exported)
    DEFAULT_BLOCK, DEFAULT_GAMMA_BLOCK, STREAM_MIN_DIM, blocked_cholesky,
    chol_rank_update, cholesky_solve, multi_gamma_solve, panels, streamed_cholesky,
    streamed_cholesky_solve)


def gram_update(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (XᵀX, XᵀY) in f32: the CUDA kernel on the card, else plain."""
    if x.is_cuda:
        return _gram.gram_update(x, y)
    return ref.gram_ref(x, y)


def panel_factor(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, L⁻¹)`` of one SPD diagonal block: the kernel on the card."""
    return panels(diag.device).panel_factor(diag)


def panel_tri_inv(l: torch.Tensor) -> torch.Tensor:
    """``L⁻¹`` of one lower-triangular block: the kernel on the card."""
    return panels(l.device).panel_tri_inv(l)


def panel_trsm(raw: torch.Tensor, zinv: torch.Tensor) -> torch.Tensor:
    """Panel trsm ``raw @ zinvᵀ``: the kernel on the card."""
    return panels(raw.device).panel_trsm(raw, zinv)


def panel_update(trail: torch.Tensor, lp: torch.Tensor, pt: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trailing update ``trail − lp @ ptᵀ``: the kernel on the card."""
    return panels(trail.device).panel_update(trail, lp, pt, out=out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """Causal / GQA / sliding-window attention: the CUDA kernel on the card,
    else the plain ``ref.mha_ref``."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, **kw)
    return ref.mha_ref(q, k, v, **kw)
