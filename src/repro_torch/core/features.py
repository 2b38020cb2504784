"""Non-linear feature maps for the analytic head (paper §5 future work).

The port of ``repro.core.features``. "The AFL is established upon linear
classifiers and may be less effective with non-linear data distribution.
To address this, AFL can incorporate non-linear projections including
non-linear activations or kernel functions ... and the AA law holds
theoretically." — paper §5.

A fixed random feature map φ is applied to the frozen backbone's embeddings
*before* the Gram statistics. Because φ is deterministic and shared (seeded
like the backbone), the regression in φ-space is still linear ⇒ every AFL
property (AA law exactness, RI restore, partition invariance) holds verbatim
in φ-space. Two maps:

  * Random Fourier Features (RFF, Rahimi–Recht): φ(x) = √(2/D)·cos(xW + b)
    approximates an RBF kernel — the paper's "kernel functions" option.
  * Random ReLU features: φ(x) = relu(xW)/√D — the "non-linear activations"
    option (a one-layer random MLP head).

``w`` and ``b`` are drawn with numpy ``default_rng(seed)``, so they are the
reference's arrays bit for bit. A map applies to a numpy array in numpy and
to a ``torch.Tensor`` in torch, on the tensor's device and in its dtype (a
CUDA tensor stays on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["FeatureMap", "rff_map", "relu_map", "identity_map"]


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    """A fixed map x (…, d_in) → φ(x) (…, d_out), shareable by seed."""

    kind: str
    d_in: int
    d_out: int
    w: np.ndarray                 # (d_in, d_out)
    b: Optional[np.ndarray]       # (d_out,) or None
    scale: float

    def __call__(self, x):
        if self.kind == "id":
            return x
        if isinstance(x, torch.Tensor):
            h = x @ torch.as_tensor(self.w, dtype=x.dtype, device=x.device)
            h = h + torch.as_tensor(self.b, dtype=h.dtype, device=h.device)
            if self.kind == "rff":
                return self.scale * torch.cos(h)
            return self.scale * torch.clamp_min(h, 0)
        h = x @ np.asarray(self.w, dtype=x.dtype if hasattr(x, "dtype") else None)
        if self.kind == "rff":
            return self.scale * np.cos(h + np.asarray(self.b, h.dtype))
        return self.scale * np.maximum(h + np.asarray(self.b, h.dtype), 0)


def rff_map(d_in: int, d_out: int, lengthscale: float = 1.0,
            seed: int = 0) -> FeatureMap:
    """RBF-kernel random Fourier features, k(x,x') ≈ exp(−‖x−x'‖²/2ℓ²)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)) / lengthscale
    b = rng.uniform(0, 2 * np.pi, d_out)
    return FeatureMap("rff", d_in, d_out, w, b, float(np.sqrt(2.0 / d_out)))


def relu_map(d_in: int, d_out: int, seed: int = 0) -> FeatureMap:
    """One random ReLU layer with bias (bias breaks homogeneity — without it
    radius-like concepts are not representable)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)
    b = rng.standard_normal(d_out)
    return FeatureMap("relu", d_in, d_out, w, b, float(np.sqrt(1.0 / d_out)))


def identity_map(d_in: int) -> FeatureMap:
    return FeatureMap("id", d_in, d_in, np.eye(d_in), None, 1.0)
