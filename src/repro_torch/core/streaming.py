"""Device-side streaming Gram statistics (f32 tensors on the card).

The port of ``repro.core.streaming``. The AFL local stage never needs to
materialize the full ``(N, d)`` embedding matrix: ``C = XᵀX`` and
``Q = XᵀY`` are additive over batches, so a client folds mini-batches into
an ``AnalyticState`` accumulator.

This module is the paper-literal *device* API; the arithmetic lives in
:mod:`repro_torch.core.engine` (torch backend), shared with the host f64
path. ``AnalyticState`` keeps the reference's 3-field layout — (gram,
moment, count); :func:`to_stats` / :func:`from_stats` convert to the
engine's :class:`~repro_torch.core.engine.SuffStats` (which additionally
tracks the client count for lazy-γ bookkeeping).

Every function runs on the device and in the dtype of the state it is given.
``init_state`` places a new state on CUDA unless the caller names another
device. The Gram update is the AFL compute hot spot beyond the backbone:
``update_state(..., use_kernel=True)`` folds a batch on a CUDA tensor
through the hand-written Gram kernel (``kernels.ops.gram_update``), and on
a CPU tensor through its plain version. ``solve`` never takes the kernels,
as the reference's does not: it is ``torch.linalg`` on the state's device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import torch

from repro_torch.core.engine import AnalyticEngine, SuffStats
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "AnalyticState",
    "init_state",
    "update_state",
    "merge_states",
    "solve",
    "to_stats",
    "from_stats",
]


@functools.cache
def _engine(device: torch.device, dtype: torch.dtype, use_kernel: bool) -> AnalyticEngine:
    """One torch engine per (device, dtype, kernel route), built on first use:
    a torch engine resolves its device when it is built, so none is built
    while this module is imported."""
    return AnalyticEngine("torch", dtype=dtype, device=device, use_kernel=use_kernel)


def _state_engine(state: "AnalyticState", use_kernel: bool = False) -> AnalyticEngine:
    return _engine(state.gram.device, state.gram.dtype, use_kernel)


class AnalyticState(NamedTuple):
    """Sufficient statistics of a (partial) analytic regression.

    gram:  ``Σ XᵀX``  (d, d), f32
    moment: ``Σ XᵀY`` (d, C), f32
    count: number of samples folded in (0-d tensor; used for diagnostics
      and per-client sample-count bookkeeping, not needed by the solve).
    """

    gram: torch.Tensor
    moment: torch.Tensor
    count: torch.Tensor


def to_stats(state: AnalyticState,
             clients: Union[float, torch.Tensor] = 1.0) -> SuffStats:
    """View an accumulator as engine SuffStats for ``clients`` contributions."""
    return SuffStats(
        gram=state.gram,
        moment=state.moment,
        count=state.count,
        clients=torch.as_tensor(clients, dtype=state.gram.dtype,
                                device=state.gram.device),
    )


def from_stats(stats: SuffStats) -> AnalyticState:
    """Project engine SuffStats back onto the 3-field device layout."""
    return AnalyticState(gram=stats.gram, moment=stats.moment, count=stats.count)


def init_state(dim: int, num_classes: int, dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> AnalyticState:
    """Empty statistics on ``device`` (CUDA unless another is named)."""
    return from_stats(_engine(resolve_device(device), dtype, False)
                      .init(dim, num_classes))


def update_state(
    state: AnalyticState,
    embeddings: torch.Tensor,
    targets: torch.Tensor,
    *,
    use_kernel: bool = False,
) -> AnalyticState:
    """Fold a batch of (embeddings, one-hot targets) into the statistics.

    embeddings: (N, d) — any leading dims are flattened.
    targets: (N, C) one-hot (or soft) labels.
    Both are moved to the state's device and dtype.
    """
    eng = _state_engine(state, use_kernel)
    return from_stats(eng.update(to_stats(state, 0.0), embeddings, targets))


def merge_states(a: AnalyticState, b: AnalyticState) -> AnalyticState:
    """AA law in sufficient-statistics form: statistics simply add."""
    return from_stats(_state_engine(a).merge(to_stats(a, 0.0), to_stats(b, 0.0)))


def solve(state: AnalyticState,
          gamma: Union[float, torch.Tensor] = 0.0) -> torch.Tensor:
    """Ridge solve ``(C + γI)^{-1} Q`` on the state's device (Cholesky in its
    dtype, ``torch.linalg``).

    For γ=0 on rank-deficient C this is the caller's responsibility (use the
    host f64 path with pinv fallback); here γI is always added.
    """
    return _state_engine(state).solve(to_stats(state, 0.0), use_ri=True,
                                      target_gamma=float(gamma))
