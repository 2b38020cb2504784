"""Entry points for the port's kernels.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version in ``kernels.ref``. There is no fallback between the
two: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import gram as _gram
from repro_torch.kernels import ref


def gram_update(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (XᵀX, XᵀY) in f32: the CUDA kernel on the card, else plain."""
    if x.is_cuda:
        return _gram.gram_update(x, y)
    return ref.gram_ref(x, y)
