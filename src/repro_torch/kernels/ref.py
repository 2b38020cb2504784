"""Plain PyTorch versions of the port's kernels.

The CPU takes these in place of the kernels (``kernels.ops``), and the
tests and ``chip_smoke.py`` hold each kernel against its version here.
"""

from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.gram.gram_update``: (XᵀX, XᵀY) in f32."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    return xf.T @ xf, xf.T @ yf
