"""The sufficient-statistics engine: ONE implementation of AFL's math.

The port of ``repro.core.engine``, with the same semantics:

  * ``SuffStats``: the sufficient statistics of a (partial) analytic
    regression, in *raw-Gram* form — ``gram = Σ XᵀX`` with NO γ baked in,
    plus a ``clients`` counter so the per-client γI of the paper's
    C_k^r = X_kᵀX_k + γI is applied *lazily* at solve time
    (Σ C_k^r = Σ C_k + kγI, eq (15)).
  * ``AnalyticEngine``: update / merge / ri_restore / solve /
    solve_multi_gamma over a pluggable backend.

Backends:
  * ``numpy_f64`` — host numpy in float64, Cholesky with pseudo-inverse
    fallback for the rank-deficient γ=0 ablations (paper Table 3 / A.1).
    A copy of the reference backend; ``fl.api.AFLServer`` solves with it.
  * ``torch`` — tensors on a device (CUDA unless ``device`` names another),
    f32 by default, with an optional Kahan-compensated accumulator.
    ``use_kernel=True`` runs every route through the hand-written CUDA
    kernels, as the reference's jax backend runs its Pallas kernels: Gram
    updates (``kernels.ops.gram_update``); the factor and solve of a
    system at least ``STREAM_MIN_DIM`` = 2048 wide through the streamed
    panel Cholesky (``streamed_cholesky``, ``streamed_cholesky_solve``) and
    of a narrower one through ``blocked_cholesky`` / ``cholesky_solve``;
    the γ sweep through ``multi_gamma_solve``; the rank update through
    ``chol_rank_update``. On CPU tensors each takes its kernel's plain
    version. No route falls back to ``torch.linalg``, except the
    reference's own: a γ grid the fused sweep cannot answer (NaNs, or
    weights past the pinv bound) goes to the eigendecomposition.

Both backends pair a factorization handle (:meth:`AnalyticEngine.factor` /
:meth:`AnalyticEngine.factor_solve`) with a rank update
(:meth:`Factorization.rank_update`), so a serving coordinator caches the d³
Cholesky across polls and folds low-rank arrivals in O(k·d²).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref

try:  # d²·C triangular solves for cached factors (vs np.linalg.solve's LU)
    from scipy.linalg import solve_triangular as _solve_triangular
except ImportError:  # pragma: no cover - stay soft without scipy
    _solve_triangular = None

__all__ = [
    "SuffStats",
    "Factorization",
    "SweepFactorization",
    "SweepRefreshNeeded",
    "AnalyticEngine",
    "NumpyF64Backend",
    "TorchBackend",
    "get_backend",
    "to_numpy",
]

def to_numpy(a, dtype=np.float64) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.to(torch.float32)
        a = a.numpy()
    return np.asarray(a, dtype)


class SuffStats(NamedTuple):
    """Sufficient statistics of a (partial) analytic regression.

    gram:    ``Σ XᵀX``  (d, d) — RAW, no regularization baked in.
    moment:  ``Σ XᵀY``  (d, C).
    count:   number of samples folded in (scalar).
    clients: number of client contributions merged in (scalar). The paper's
             per-client +γI is applied lazily as ``clients·γ·I`` wherever a
             regularized aggregate is needed; the RI restore (Thm 2) then
             amounts to *not* adding it back (eq 16).
    gram_c / moment_c: optional Kahan compensation carries (same shapes as
             gram/moment; ``None`` unless the engine runs compensated
             accumulation).
    """

    gram: Any
    moment: Any
    count: Any
    clients: Any
    gram_c: Any = None
    moment_c: Any = None

    @property
    def dim(self) -> int:
        return self.gram.shape[0]

    @property
    def num_classes(self) -> int:
        return self.moment.shape[1]


@dataclasses.dataclass(frozen=True)
class Factorization:
    """Opaque reusable factorization of a regularized Gram matrix.

    ``handle`` is backend-specific (the host's upper factor R, or the torch
    backend's lower factor L; ``None`` marks the pinv fallback for singular
    systems, in which case ``matrix`` holds the system for the per-solve
    pseudo-inverse).

    ``backend`` is the backend that produced the factor; it makes the handle
    *updatable*: :meth:`rank_update` folds a positive rank-k perturbation
    ``XᵀX`` into the factor in O(k·d²) instead of the O(d³) refactorization.
    """

    handle: Any
    matrix: Any = None
    backend: Any = None

    @property
    def updatable(self) -> bool:
        """True when :meth:`rank_update` is available (a real triangular
        factor from a backend; the pinv fallback has nothing to rotate)."""
        return self.backend is not None and self.handle is not None

    def rank_update(self, xs) -> "Factorization":
        """chol(A) → chol(A + xsᵀ·xs) for update rows ``xs`` of shape (k, d):
        one Householder column sweep, O(k·d²)."""
        if not self.updatable:
            raise ValueError(
                "factorization is not rank-updatable (pinv fallback for a "
                "singular system, or constructed without a backend)")
        return self.backend.rank_update(self, xs)

    def rank_update_many(self, roots) -> "Factorization":
        """Fold a *sequence* of update roots in one pass — semantically
        ``functools.reduce(Factorization.rank_update, roots)``; on the host
        backend bit-for-bit so."""
        if not self.updatable:
            raise ValueError(
                "factorization is not rank-updatable (pinv fallback for a "
                "singular system, or constructed without a backend)")
        return self.backend.rank_update_many(self, roots)


class SweepRefreshNeeded(RuntimeError):
    """A rank-updated sweep handle cannot answer this γ grid exactly (the
    base spectrum hits the pinv cutoff with pending low-rank corrections) —
    re-eigendecompose the current statistics and retry."""


@dataclasses.dataclass(frozen=True)
class SweepFactorization:
    """Rank-updatable eigendecomposition handle for repeated multi-γ sweeps.

    ``vals/vecs`` are the eigendecomposition ``base = V Λ Vᵀ`` of the raw
    (RI) — or regularized (no-RI) — aggregate Gram at the time the handle
    was built. ``u`` accumulates the low-rank roots of every Gram delta
    merged since (host f64), with ``vu = Vᵀuᵀ`` cached so each sweep works
    in the fixed eigenbasis by exact Woodbury algebra:

        (B(γ) + uᵀu)⁻¹ Q  =  B⁻¹Q − B⁻¹uᵀ (I + u B⁻¹ uᵀ)⁻¹ u B⁻¹ Q,
        B(γ) = V (Λ+γ) Vᵀ

    With pending updates the pinv-style truncation would no longer equal
    the pseudo-inverse of the *updated* system, so that combination raises
    :class:`SweepRefreshNeeded`.
    """

    vals: Any
    vecs: Any
    backend: Any
    u: np.ndarray                 # (k, d) pending raw-Gram update roots
    vu: np.ndarray                # (d, k) = vecsᵀ · uᵀ, cached projection

    @property
    def rank(self) -> int:
        return int(self.u.shape[0])

    @property
    def dim(self) -> int:
        return int(self.u.shape[1])

    def rank_update(self, xs) -> "SweepFactorization":
        """Fold update rows ``xs (k, d)`` (``xsᵀxs`` = the merged raw-Gram
        delta) into the handle: append to ``u`` and project once."""
        xs = to_numpy(xs).reshape(-1, self.dim)
        if not xs.shape[0]:
            return self
        proj = to_numpy(self.vecs).T @ xs.T
        return dataclasses.replace(
            self, u=np.concatenate([self.u, xs], 0),
            vu=np.concatenate([self.vu, proj], 1))


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class NumpyF64Backend:
    """Host numpy, float64 — the paper-faithful reference arithmetic."""

    name = "numpy_f64"

    def asarray(self, a):
        return to_numpy(a)

    def eye(self, d, like=None):
        return np.eye(d)

    def zeros(self, shape):
        return np.zeros(shape, np.float64)

    def scalar(self, v):
        return float(v)

    def gram_update(self, x, y):
        x = self.asarray(x)
        y = self.asarray(y)
        return x.T @ x, x.T @ y, float(x.shape[0])

    def factor(self, a) -> Factorization:
        """Cholesky when PD; ``handle=None`` → pinv fallback per solve, so the
        γ=0 rank-deficient ablations run instead of raising. The handle is
        the UPPER factor R (A = RᵀR), C-contiguous, so the rank-update sweep
        walks contiguous rows."""
        try:
            return Factorization(
                np.ascontiguousarray(np.linalg.cholesky(a).T), backend=self)
        except np.linalg.LinAlgError:
            return Factorization(None, a, backend=self)

    def rank_update(self, f: Factorization, xs) -> Factorization:
        """Rank-k Cholesky update: R → chol(RᵀR + xsᵀxs)."""
        xs = self.asarray(xs).reshape(-1, f.handle.shape[0])
        return Factorization(_chol_rank_update(f.handle, xs), backend=self)

    def rank_update_many(self, f: Factorization, roots) -> Factorization:
        """One grouped column sweep over a sequence of update roots —
        bit-for-bit equal to folding them with :meth:`rank_update` one at a
        time (see :func:`_chol_rank_update_grouped`)."""
        d = f.handle.shape[0]
        roots = [self.asarray(x).reshape(-1, d) for x in roots]
        return Factorization(
            _chol_rank_update_grouped(f.handle, roots), backend=self)

    def factor_solve(self, f: Factorization, b):
        if f.handle is None:
            return np.linalg.pinv(f.matrix) @ b
        if _solve_triangular is not None:
            y = _solve_triangular(f.handle, b, trans="T", lower=False)
            return _solve_triangular(f.handle, y, lower=False)
        y = np.linalg.solve(f.handle.T, b)
        return np.linalg.solve(f.handle, y)

    def solve_sym(self, a, b):
        return self.factor_solve(self.factor(a), b)

    def eigh(self, a):
        return np.linalg.eigh(a)

    def safe_reciprocal(self, v, cutoff):
        """1/v where |v| > cutoff, else 0 — pinv-style spectral truncation."""
        return np.where(np.abs(v) > cutoff, 1.0 / np.where(v == 0, 1.0, v), 0.0)


class TorchBackend:
    """Tensors on one device; f32 by default.

    The counterpart of the reference's jax backend. Without ``use_kernel``
    the factor and solves are ``torch.linalg`` (the counterpart of
    ``jax.scipy.linalg.cho_factor`` / ``cho_solve``), with the host
    backend's pinv fallback when the system is not positive definite, and
    the rank update is the plain column sweep. ``use_kernel=True`` routes
    the Gram update, the factor and solve (streamed at ``STREAM_MIN_DIM``
    and wider, blocked below), the fused γ sweep and the rank update
    through the CUDA kernels, as the reference's jax backend does (CPU
    tensors take the kernels' plain versions). There is no pinv fallback
    on that route: a system that is not positive definite comes back as
    NaNs.
    """

    name = "torch"

    def __init__(self, dtype=None, device=None, use_kernel: bool = False):
        self.dtype = dtype or torch.float32
        self.device = resolve_device(device)
        self.use_kernel = use_kernel

    def asarray(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def eye(self, d, like=None):
        return torch.eye(d, dtype=self.dtype, device=self.device)

    def zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def scalar(self, v):
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def gram_update(self, x, y):
        x = self.asarray(x)
        y = self.asarray(y)
        x = x.reshape(-1, x.shape[-1])
        y = y.reshape(-1, y.shape[-1])
        if self.use_kernel:
            g, q = _kops.gram_update(x.contiguous(), y.contiguous())
            g = g.to(self.dtype)
            q = q.to(self.dtype)
        else:
            g = x.T @ x
            q = x.T @ y
        return g, q, self.scalar(float(x.shape[0]))

    def factor(self, a) -> Factorization:
        """Lower Cholesky factor L (A = LLᵀ); pinv fallback when A is not
        positive definite, as on the host backend. With ``use_kernel`` a
        system at least ``STREAM_MIN_DIM`` wide goes through
        ``streamed_cholesky``, a narrower one through ``blocked_cholesky``
        (NaNs when not positive definite)."""
        if self.use_kernel:
            if a.shape[-1] >= _kops.STREAM_MIN_DIM:
                return Factorization(_kops.streamed_cholesky(a), backend=self)
            return Factorization(_kops.blocked_cholesky(a[None])[0], backend=self)
        lower, info = torch.linalg.cholesky_ex(a)
        if int(info) != 0:
            return Factorization(None, a, backend=self)
        return Factorization(lower, backend=self)

    def rank_update(self, f: Factorization, xs) -> Factorization:
        """Rank-k update of a lower factor: one Householder column sweep,
        the ``chol_rank_update`` kernel with ``use_kernel``."""
        xs = self.asarray(xs).reshape(-1, f.handle.shape[0])
        if self.use_kernel:
            return Factorization(_kops.chol_rank_update(f.handle, xs), backend=self)
        return Factorization(_kref.chol_rank_update_ref(f.handle, xs), backend=self)

    def rank_update_many(self, f: Factorization, roots) -> Factorization:
        """The concatenated roots go through one rank-(Σk) sweep. Exact in
        exact arithmetic (a sum of Gram deltas is a Gram delta); the
        bit-for-bit-vs-sequential guarantee is the host backend's."""
        d = f.handle.shape[0]
        xs = [self.asarray(x).reshape(-1, d) for x in roots]
        return self.rank_update(f, torch.cat(xs, 0))

    def factor_solve(self, f: Factorization, b):
        b = self.asarray(b)
        if self.use_kernel:
            if f.handle.shape[-1] >= _kops.STREAM_MIN_DIM:
                return _kops.streamed_cholesky_solve(f.handle, b)
            return _kops.cholesky_solve(f.handle[None], b[None])[0]
        if f.handle is None:
            return torch.linalg.pinv(f.matrix, rtol=_PINV_RCOND) @ b
        return torch.cholesky_solve(b, f.handle)

    def solve_sym(self, a, b):
        return self.factor_solve(self.factor(a), b)

    def fused_sweep(self, a, b, gammas):
        """Whole-γ-grid solve ``(a + γ_j I) W_j = b`` through the fused
        sweep kernel (kernel path only) → (n_g, d, c); singular γs come
        back as NaNs."""
        return _kops.multi_gamma_solve(a, b, gammas)

    def eigh(self, a):
        return torch.linalg.eigh(a)

    def safe_reciprocal(self, v, cutoff):
        """1/v where |v| > cutoff, else 0 — pinv-style spectral truncation."""
        one = torch.ones_like(v)
        return torch.where(v.abs() > cutoff, one / torch.where(v == 0, one, v),
                           torch.zeros_like(v))


# numpy.linalg.pinv's default cutoff, so both backends truncate alike
_PINV_RCOND = 1e-15


def _chol_rank_update(R, xs):
    """Host rank-k Cholesky update: R upper with A = RᵀR → chol(A + xsᵀxs).

    One Householder column sweep over the implicit QR of ``[R; xs]``: at
    column i a single (k+1)-reflection annihilates all k update entries at
    once, so the work is k fused rank-1 updates — O(k·d²) flops in d
    vectorized iterations. The update is positive (a Gram delta), so the
    sweep cannot break down.
    """
    d = R.shape[0]
    R = np.array(R, np.float64, copy=True, order="C")
    xt = np.array(xs.T, np.float64, copy=True, order="C")  # (d, k) rows contiguous
    for i in range(d):
        w = xt[i]
        s = w @ w
        if s == 0.0:
            continue
        a = R[i, i]
        r = np.sqrt(a * a + s)
        amr = -s / (r + a)                 # a − r without cancellation
        beta = (r + a) / (r * s)           # 2 / uᵀu for u = [a−r; w]
        row = R[i, i + 1:]
        t = amr * row + xt[i + 1:] @ w     # uᵀ · [row; xs-tail]
        R[i, i] = r
        R[i, i + 1:] = row - (beta * amr) * t
        xt[i + 1:] -= (beta * t)[:, None] * w[None, :]
    return R


def _chol_rank_update_grouped(R, roots):
    """Grouped rank-(Σk) update: one column sweep folding a *sequence* of
    update-row groups, bit-for-bit equal to sequential per-group
    :func:`_chol_rank_update` calls (row i of R is touched only at column
    step i, and each group's own ``xt`` tail is private, so interleaving the
    groups performs the same scalar operations in the same order)."""
    d = R.shape[0]
    R = np.array(R, np.float64, copy=True, order="C")
    xts = [np.array(x.T, np.float64, copy=True, order="C") for x in roots]
    for i in range(d):
        for xt in xts:
            w = xt[i]
            s = w @ w
            if s == 0.0:
                continue
            a = R[i, i]
            r = np.sqrt(a * a + s)
            amr = -s / (r + a)
            beta = (r + a) / (r * s)
            row = R[i, i + 1:]
            t = amr * row + xt[i + 1:] @ w
            R[i, i] = r
            R[i, i + 1:] = row - (beta * amr) * t
            xt[i + 1:] -= (beta * t)[:, None] * w[None, :]
    return R


def _factor_has_nan(f: Factorization) -> bool:
    """True when a factor handle carries NaNs. A tensor is checked where it
    lies: one flag crosses to the host, not the (d, d) factor."""
    h = f.handle
    if isinstance(h, torch.Tensor):
        return bool(torch.isnan(h).any())
    return bool(np.isnan(np.asarray(h)).any())


def get_backend(name: str, **kwargs):
    """Backend registry: ``numpy_f64`` | ``torch`` (+ dtype / device /
    use_kernel)."""
    if name == "numpy_f64":
        if kwargs.get("use_kernel"):
            raise ValueError("the kernel path requires the torch backend")
        return NumpyF64Backend()
    if name == "torch":
        return TorchBackend(dtype=kwargs.get("dtype"), device=kwargs.get("device"),
                            use_kernel=bool(kwargs.get("use_kernel")))
    raise ValueError(f"unknown engine backend {name!r}")


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class AnalyticEngine:
    """Backend-agnostic AFL statistics→solve pipeline.

    One instance carries the protocol-level configuration (backend, the γ
    every client uses locally, accumulation policy); the statistics
    themselves travel as explicit :class:`SuffStats` values, so the engine
    is stateless.

    >>> eng = AnalyticEngine("numpy_f64", gamma=1.0)
    >>> stats = eng.merge(eng.client_stats(x1, y1), eng.client_stats(x2, y2))
    >>> w = eng.solve(stats)          # RI-restored joint solution (Thm 1+2)
    """

    def __init__(
        self,
        backend: str = "numpy_f64",
        *,
        gamma: float = 1.0,
        dtype=None,
        device=None,
        use_kernel: bool = False,
        kahan: bool = False,
    ):
        self.backend = get_backend(backend, dtype=dtype, device=device,
                                   use_kernel=use_kernel)
        self.gamma = float(gamma)
        if kahan and backend != "torch":
            raise ValueError("Kahan accumulation targets the f32 torch backend")
        self.kahan = bool(kahan)

    # -- accumulation -------------------------------------------------------

    def init(self, dim: int, num_classes: int) -> SuffStats:
        """Empty statistics (0 samples, 0 clients)."""
        b = self.backend
        comp_g = b.zeros((dim, dim)) if self.kahan else None
        comp_q = b.zeros((dim, num_classes)) if self.kahan else None
        return SuffStats(
            gram=b.zeros((dim, dim)),
            moment=b.zeros((dim, num_classes)),
            count=b.scalar(0.0),
            clients=b.scalar(0.0),
            gram_c=comp_g,
            moment_c=comp_q,
        )

    def update(self, stats: SuffStats, x, y) -> SuffStats:
        """Fold a batch of (embeddings, one-hot targets) into the statistics.

        Pure accumulation: ``clients`` is untouched — a participant marks
        itself with :meth:`finalize_client` (or arrives via
        :meth:`client_stats`) once its local stage is complete.
        """
        g_upd, q_upd, n = self.backend.gram_update(x, y)
        if self.kahan and stats.gram_c is not None:
            gram, gram_c = _kahan_add(stats.gram, stats.gram_c, g_upd)
            moment, moment_c = _kahan_add(stats.moment, stats.moment_c, q_upd)
        else:
            gram, gram_c = stats.gram + g_upd, stats.gram_c
            moment, moment_c = stats.moment + q_upd, stats.moment_c
        return SuffStats(gram, moment, stats.count + n, stats.clients,
                         gram_c, moment_c)

    def finalize_client(self, stats: SuffStats) -> SuffStats:
        """Mark accumulated statistics as ONE client's upload (clients=1)."""
        return stats._replace(clients=self.backend.scalar(1.0))

    def client_stats(self, x, y) -> SuffStats:
        """One client's local stage in a single call: raw stats, clients=1."""
        x = self.backend.asarray(x)
        y = self.backend.asarray(y)
        return self.finalize_client(
            self.update(self.init(x.shape[-1], y.shape[-1]), x, y))

    def merge(self, a: SuffStats, b: SuffStats) -> SuffStats:
        """The AA law in sufficient-statistics form: everything adds
        (Thm 1 / eq (11): C_agg = ΣC_k, Q_agg = ΣQ_k; client counts add for
        the lazy-γ bookkeeping of eq (15))."""
        return SuffStats(
            gram=a.gram + b.gram,
            moment=a.moment + b.moment,
            count=a.count + b.count,
            clients=a.clients + b.clients,
            gram_c=_maybe_add(a.gram_c, b.gram_c),
            moment_c=_maybe_add(a.moment_c, b.moment_c),
        )

    def merge_many(self, stats: SuffStats, uploads) -> SuffStats:
        """Left-fold a whole micro-batch of uploads in ONE stacked reduction,
        bit-for-bit equal to sequential :meth:`merge` calls on the host
        backend (``np.add.reduce`` over the leading axis accumulates in
        index order). Kahan-compensated statistics and the torch backend
        keep the sequential path."""
        uploads = list(uploads)
        if not uploads:
            return stats
        if (not isinstance(self.backend, NumpyF64Backend)
                or stats.gram_c is not None
                or any(u.gram_c is not None for u in uploads)):
            for u in uploads:
                stats = self.merge(stats, u)
            return stats
        gram = np.add.reduce(
            np.stack([np.asarray(stats.gram)]
                     + [np.asarray(u.gram) for u in uploads]), axis=0)
        moment = np.add.reduce(
            np.stack([np.asarray(stats.moment)]
                     + [np.asarray(u.moment) for u in uploads]), axis=0)
        count, clients = stats.count, stats.clients
        for u in uploads:
            count = count + u.count
            clients = clients + u.clients
        return SuffStats(gram, moment, count, clients,
                         stats.gram_c, stats.moment_c)

    # -- regularization bookkeeping -----------------------------------------

    def regularized_gram(self, stats: SuffStats, gamma: Optional[float] = None):
        """``C_agg^r = Σ XᵀX + kγI`` — the regularized aggregate the paper's
        Algorithm 1 materializes (here derived lazily from raw stats)."""
        g = self.gamma if gamma is None else float(gamma)
        d = stats.gram.shape[0]
        return stats.gram + (stats.clients * g) * self.backend.eye(d)

    def _system(self, stats: SuffStats, use_ri: bool, target_gamma: float):
        d = stats.gram.shape[0]
        eye = self.backend.eye(d)
        if use_ri:
            # RI restore (Thm 2 / eq 16) on raw stats: the kγI term would be
            # added (eq 15) and removed (eq 16) analytically — so it is never
            # materialized; only the final target ridge remains.
            return stats.gram + self.backend.scalar(target_gamma) * eye
        return stats.gram + stats.clients * self.backend.scalar(self.gamma) * eye

    # -- solves -------------------------------------------------------------

    def solve(self, stats: SuffStats, *, use_ri: bool = True,
              target_gamma: float = 0.0):
        """Joint weight over everything merged into ``stats``.

        use_ri=True  → the paper's full pipeline (exact joint solution,
                       restored to ``target_gamma`` ridge; 0 = eq 16).
        use_ri=False → the biased no-RI aggregate carrying the accumulated
                       ``kγI`` (paper Table 3 ablation).
        """
        return self.backend.solve_sym(
            self._system(stats, use_ri, target_gamma), stats.moment)

    def factor(self, stats: SuffStats, *, use_ri: bool = True,
               target_gamma: float = 0.0) -> Factorization:
        """Factor the regularized system once; reuse via :meth:`factor_solve`
        (one d³ factorization amortized over every straggler-poll solve)."""
        return self.backend.factor(self._system(stats, use_ri, target_gamma))

    def factor_solve(self, factorization: Factorization, b):
        """Solve against a cached factorization (d²·C instead of d³)."""
        return self.backend.factor_solve(factorization, b)

    def factor_update(
        self,
        factorization: Factorization,
        stats: SuffStats,
        root=None,
        *,
        use_ri: bool = True,
        target_gamma: float = 0.0,
        max_rank: Optional[int] = None,
    ) -> Factorization:
        """Fold a newly-merged low-rank delta into an existing factor.

        ``stats`` is the POST-merge aggregate (used only for the fallback);
        ``root`` is a (k, d) square root of the raw-Gram delta that was
        merged (``rootᵀ·root == ΔGram``), or a list of such roots folded in
        one grouped sweep. Within the rank budget (default d//16) and with
        an updatable factor this is the O(k·d²) rank-k update; otherwise —
        and when the updated factor carries NaNs — a full refactor from
        ``stats``.
        """
        if root is not None and use_ri and factorization.updatable:
            roots = list(root) if isinstance(root, (list, tuple)) else [root]
            roots = [self.backend.asarray(r).reshape(-1, stats.dim)
                     for r in roots]
            total = sum(int(r.shape[0]) for r in roots)
            budget = max(1, stats.dim // 16) if max_rank is None else int(max_rank)
            if total <= budget:
                updated = (factorization.rank_update(roots[0])
                           if len(roots) == 1
                           else factorization.rank_update_many(roots))
                if not _factor_has_nan(updated):
                    return updated
        return self.factor(stats, use_ri=use_ri, target_gamma=target_gamma)

    def ri_restore(self, w_agg_r, c_agg_r, num_clients: int,
                   gamma: Optional[float] = None, target_gamma: float = 0.0):
        """Theorem 2 / eq (16) in its explicit form, for *regularized*
        aggregates (Ŵ_agg^r, C_agg^r) as produced by the paper-literal
        Algorithm 1: ``Ŵ_agg = (C_agg^r − KγI)^{-1} C_agg^r Ŵ_agg^r``."""
        b = self.backend
        g = self.gamma if gamma is None else float(gamma)
        d = c_agg_r.shape[0]
        shift = b.scalar(num_clients * g - target_gamma) * b.eye(d)
        return b.solve_sym(c_agg_r - shift, c_agg_r @ w_agg_r)

    def solve_multi_gamma(self, stats: SuffStats, gammas: Sequence[float], *,
                          use_ri: bool = True, rcond: float = 1e-12):
        """Solve the same statistics under several target ridges at once.

        One eigendecomposition ``C = VΛVᵀ`` (d³) serves every γ:
        ``W(γ) = V (Λ+γ)^{-1} Vᵀ Q`` is then d²·C per γ. Eigenvalues with
        ``λ+γ <= rcond·λ_max`` are treated as zero (pinv semantics), so the
        γ=0 rank-deficient case matches the fallback of the direct solve.

        With ``use_kernel=True`` the whole grid goes through ONE fused
        factor-and-solve kernel call (``kernels.ops.multi_gamma_solve``),
        and falls back to the eigendecomposition only when a system in the
        grid is singular: NaNs, or weights larger than the pinv truncation
        allows (:func:`_cholesky_sweep_trustworthy`). That is a test on the
        data; an error of the kernel itself raises.
        """
        gammas = [float(g) for g in gammas]
        if getattr(self.backend, "use_kernel", False) and gammas:
            base = stats.gram if use_ri else self.regularized_gram(stats)
            ws = self.backend.fused_sweep(base, stats.moment, gammas)
            ws_host = to_numpy(ws)
            if (bool(np.isfinite(ws_host).all())
                    and _cholesky_sweep_trustworthy(base, stats.moment, ws_host, rcond)):
                return [ws[i] for i in range(len(gammas))]
        return self.sweep_solve(self.sweep_factor(stats, use_ri=use_ri),
                                stats.moment, gammas, rcond=rcond)

    def sweep_factor(self, stats: SuffStats, *,
                     use_ri: bool = True) -> SweepFactorization:
        """Eigendecompose the aggregate once for repeated γ sweeps; the
        handle is rank-updatable (:meth:`SweepFactorization.rank_update`)."""
        base = stats.gram if use_ri else self.regularized_gram(stats)
        vals, vecs = self.backend.eigh(base)
        d = stats.dim
        return SweepFactorization(vals, vecs, self.backend,
                                  u=np.zeros((0, d)), vu=np.zeros((d, 0)))

    def sweep_solve(self, handle: SweepFactorization, moment,
                    gammas: Sequence[float], *, rcond: float = 1e-12):
        """Solve the γ grid against a (possibly rank-updated) sweep handle.

        rank == 0 is the plain spectral sweep on the backend; with pending
        updates each γ costs one extra k×k solve (exact Woodbury, host
        f64). Raises :class:`SweepRefreshNeeded` when pending updates meet
        the pinv truncation cutoff.
        """
        b = handle.backend
        vals, vecs = handle.vals, handle.vecs
        vq = vecs.T @ b.asarray(moment)
        vals_host = to_numpy(vals)
        scale = abs(float(np.max(vals_host))) if vals_host.size else 1.0
        cutoff = rcond * max(scale, np.finfo(np.float32).tiny)
        k = handle.rank
        eye_k = np.eye(k)
        out = []
        for g in gammas:
            inv = b.safe_reciprocal(vals + b.scalar(float(g)), cutoff)
            if k == 0:
                out.append(vecs @ (inv[:, None] * vq))
                continue
            inv_h = to_numpy(inv)
            if np.any(inv_h == 0.0):
                raise SweepRefreshNeeded(
                    f"spectral truncation at γ={g} with {k} pending update "
                    "rows — rebuild the sweep handle from current stats")
            vq_h = to_numpy(vq)
            su = inv_h[:, None] * handle.vu                     # (d, k)
            cap = eye_k + handle.vu.T @ su                      # (k, k)
            rhs = su.T @ vq_h                                   # (k, C)
            coeff = inv_h[:, None] * vq_h - su @ np.linalg.solve(cap, rhs)
            out.append(to_numpy(vecs) @ coeff)
        return out


def _cholesky_sweep_trustworthy(base, moment, ws_host, rcond) -> bool:
    """Should a finite fused-Cholesky sweep be trusted, or does the grid
    need the eigendecomposition/pinv path?

    NaN catches exactly singular pivots, but rounding can leave a
    rank-deficient system's smallest pivots tiny and positive: the factor
    then succeeds with weights of norm ~1/λ_noise, where the pinv semantics
    (eigenvalues ≤ rcond·λ_max treated as zero) would have truncated. For
    any γ the pinv solution has ``‖W‖ ≤ ‖Q‖ / (rcond·λ_max)``, and
    trace(base) ≥ λ_max for a PSD base, so a solution with
    ``‖W‖·rcond·trace > ‖Q‖`` can only come from inverting spectrum the
    truncation would have zeroed. Conservative by at most the d× gap
    between trace and λ_max (an extra fallback is slower, never wrong)."""
    scale = float(np.sum(to_numpy(torch.diagonal(base))))
    q_norm = float(np.linalg.norm(to_numpy(moment)))
    w_norm = float(max(np.linalg.norm(w) for w in ws_host))
    return w_norm * float(rcond) * max(scale, np.finfo(np.float32).tiny) <= q_norm


def _kahan_add(total, comp, upd):
    """One compensated-summation step: returns (new_total, new_comp)."""
    y = upd - comp
    t = total + y
    comp = (t - total) - y
    return t, comp


def _maybe_add(a, b):
    if a is None or b is None:
        return None
    return a + b
