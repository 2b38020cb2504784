"""Paper-faithful analytic learning API (host-side, float64).

The port of ``repro.core.analytic``. Implements, term-by-term, the math of AFL:

  - eq (4)/(13): local-stage (regularized) least-squares solution
  - Theorem 1 / eq (7)-(8): Absolute Aggregation (AA) law for two clients
  - eq (9)-(11): pairwise accumulated aggregation (AcAg) for K clients
  - Theorem 2 / eq (14)-(16): Regularization Intermediary (RI) restore

This module is the *paper-literal reference API*: it mirrors the paper's
released torch-f64 implementation symbol-for-symbol. The numerics themselves
live in ONE place — :mod:`repro_torch.core.engine` — and every function here is a
thin wrapper over the engine's ``numpy_f64`` backend. The pairwise recursion
(:func:`aa_merge` / :func:`aggregate_pairwise`) is intentionally literal
(matrix products per eq (10)) rather than algebraically simplified — it
exists to *validate* the AA law against the engine's sufficient-statistics
form, which production uses.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.engine import AnalyticEngine, Factorization

__all__ = [
    "ClientUpdate",
    "ridge_solve",
    "local_stage",
    "aa_merge",
    "aggregate_pairwise",
    "aggregate_sufficient_stats",
    "ri_restore",
    "afl_aggregate",
]

# The single host-f64 engine behind every function in this module. γ is per
# call here (the paper API passes it explicitly), so the instance default is
# irrelevant; it exists to own the backend.
_ENGINE = AnalyticEngine("numpy_f64")
_B = _ENGINE.backend


def ridge_solve(x: np.ndarray, y: np.ndarray, gamma: float) -> np.ndarray:
    """eq (13): ``(XᵀX + γI)^{-1} Xᵀ Y`` (γ=0 reduces to the MP solution, eq (4))."""
    stats = _ENGINE.client_stats(x, y)
    return _ENGINE.solve(stats, use_ri=True, target_gamma=gamma)


@dataclasses.dataclass(frozen=True)
class ClientUpdate:
    """What a client uploads after its one-epoch local stage (Algorithm 1).

    Attributes:
      weight: ``Ŵ_k^r = (X_kᵀX_k + γI)^{-1} X_kᵀ Y_k``   (eq. 13), shape (d, C).
      gram:   ``C_k^r = X_kᵀX_k + γI``                    (Algorithm 1 step 3),
              shape (d, d).
      gamma:  the regularization used locally (must match across clients).
    """

    weight: np.ndarray
    gram: np.ndarray
    gamma: float

    @property
    def dim(self) -> int:
        return self.weight.shape[0]


def local_stage(x: np.ndarray, y: np.ndarray, gamma: float) -> ClientUpdate:
    """Algorithm 1, Local Stage: returns (Ŵ_k^r, C_k^r)."""
    stats = _ENGINE.client_stats(x, y)
    gram = _ENGINE.regularized_gram(stats, gamma)
    weight = _B.solve_sym(gram, stats.moment)
    return ClientUpdate(weight=weight, gram=gram, gamma=gamma)


def _fsolve(f: Factorization, b: np.ndarray) -> np.ndarray:
    return _B.factor_solve(f, b)


def aa_merge(
    w_u: np.ndarray, c_u: np.ndarray, w_v: np.ndarray, c_v: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Theorem 1 / eq (9)-(10): merge two trained weights into the joint weight.

    Literal AA-law form:  ``W = 𝒲_u W_u + 𝒲_v W_v`` with
      𝒲_u = I - C_u^{-1} C_v (I - (C_u+C_v)^{-1} C_v)
      𝒲_v = I - C_v^{-1} C_u (I - (C_u+C_v)^{-1} C_u)

    Returns the merged (weight, gram). Grams add: C = C_u + C_v (eq. 11).
    Each symmetric matrix is factored once (engine backend) and the factor
    reused across the solves (identical math, ~2× fewer 512³ ops).
    """
    d = c_u.shape[0]
    eye = np.eye(d)
    c_sum = c_u + c_v
    # (C_u + C_v)^{-1} [C_v | C_u] from one factorization
    s = _fsolve(_B.factor(c_sum), np.concatenate([c_v, c_u], axis=1))
    s_v, s_u = s[:, :d], s[:, d:]
    cal_u = eye - _fsolve(_B.factor(c_u), c_v @ (eye - s_v))
    cal_v = eye - _fsolve(_B.factor(c_v), c_u @ (eye - s_u))
    return cal_u @ w_u + cal_v @ w_v, c_sum


def aggregate_pairwise(updates: Sequence[ClientUpdate]) -> tuple[np.ndarray, np.ndarray]:
    """Algorithm 1, Aggregation Stage (the paper's sequential AcAg loop).

    Aggregates clients one at a time with the AA law. Order does not matter
    (tested); the paper notes clients may be sampled in any order.
    Returns (Ŵ_agg^r, C_agg^r).
    """
    if not updates:
        raise ValueError("no client updates to aggregate")
    w_agg = updates[0].weight.copy()
    c_agg = updates[0].gram.copy()
    for upd in updates[1:]:
        w_agg, c_agg = aa_merge(w_agg, c_agg, upd.weight, upd.gram)
    return w_agg, c_agg


def aggregate_sufficient_stats(
    updates: Sequence[ClientUpdate],
) -> tuple[np.ndarray, np.ndarray]:
    """Production form: ΣC_k^r and ΣQ_k recovered from the uploads.

    Since Q_k = XᵀY = C_k^r Ŵ_k^r, the server can reconstruct the global
    normal equations without clients ever sharing raw features. Algebraically
    identical to :func:`aggregate_pairwise` (the AA law proves the
    associativity); numerically far cheaper (no per-step inverses).
    """
    c_sum = sum(u.gram for u in updates)
    q_sum = sum(u.gram @ u.weight for u in updates)
    return _B.solve_sym(c_sum, q_sum), c_sum


def ri_restore(
    w_agg_r: np.ndarray,
    c_agg_r: np.ndarray,
    num_clients: int,
    gamma: float,
    target_gamma: float = 0.0,
) -> np.ndarray:
    """Theorem 2 / eq (16): remove the accumulated ``Kγ`` regularization.

    ``Ŵ_agg = (C_agg^r − KγI)^{-1} C_agg^r Ŵ_agg^r`` restores the joint
    MP-inverse solution.  ``target_gamma`` generalizes eq (16): restoring to a
    small final ridge (instead of exactly 0) keeps the solve PD when even the
    *joint* dataset is rank-deficient; ``target_gamma=0`` is the paper's form.
    """
    return _ENGINE.ri_restore(
        w_agg_r, c_agg_r, num_clients, gamma, target_gamma=target_gamma)


def afl_aggregate(
    updates: Sequence[ClientUpdate],
    *,
    use_ri: bool = True,
    pairwise: bool = False,
    target_gamma: float = 0.0,
) -> np.ndarray:
    """Full AFL server: aggregate K client updates into the joint weight.

    Args:
      updates: one :class:`ClientUpdate` per client.
      use_ri: apply the RI restore (eq 16). Without it the result carries the
        accumulated KγI bias the paper ablates in Table 3.
      pairwise: use the literal AA-law recursion (paper Algorithm 1) instead of
        the sufficient-statistics solve. Both are tested equal.
    """
    gammas = {float(u.gamma) for u in updates}
    if len(gammas) != 1:
        raise ValueError(f"clients used different γ: {sorted(gammas)}")
    gamma = gammas.pop()
    if pairwise:
        w_r, c_r = aggregate_pairwise(updates)
    else:
        w_r, c_r = aggregate_sufficient_stats(updates)
    if not use_ri:
        return w_r
    return _ENGINE.ri_restore(
        w_r, c_r, len(updates), gamma, target_gamma=target_gamma)
