"""The device solve: the streamed panel Cholesky of one wide system, and
the blocked factor, solve, γ sweep and rank update.

The port of ``repro.kernels.solve``, in two parts.

**Blocked** (systems narrower than ``STREAM_MIN_DIM``, and the γ grid at
any width): :func:`blocked_cholesky`, :func:`cholesky_solve`,
:func:`multi_gamma_solve` and :func:`chol_rank_update` keep the
reference's shapes in and out. A CUDA tensor, f32 or f64, launches the
hand-written kernel (``kernels.blocked``, ``kernels.rank_update``), one
wrapper call per call (the rank update's wrapper makes its panel and
trailing launches within it); a CPU tensor takes the plain version in
``kernels.ref``. A system that is not positive definite gives NaNs;
nothing here raises or falls back on that.

**Streamed** (one system of at least ``STREAM_MIN_DIM``): a (d, d) system
is factored panel by panel: the (b, b) diagonal block is factored and
inverted (``panel_factor``), the full-height column slab is multiplied by
the inverse (``panel_trsm``) and masked into the panel's column of L, and
the trailing columns take the rank-b update (``panel_update``). The solve
inverts each diagonal block of L (``panel_tri_inv``) and runs forward and
backward substitution as products with those inverses.

The schedules :func:`tile_cholesky_factor` and :func:`tile_cholesky_solve`
keep the reference's signatures: each takes one shard's (r, d) row tile of
the system and the collectives ``gather`` and ``psum`` as callables: ``core.distributed`` runs them on
every shard of a mesh at once, with its collectives.
:func:`streamed_cholesky` and :func:`streamed_cholesky_solve` are their
one-shard instances. The
schedule is the reference's to the letter, full-height column slabs masked
afterwards, so that one shard stays bit-for-bit the distributed path. It
does about d³ flops where a factor needs d³/3: the masked rows above each
panel are computed and thrown away.

:func:`panels` picks the four panel functions, in one place for the
schedules and ``kernels.ops``: the CUDA kernels of ``kernels.panel`` for
tensors on a CUDA device when ``use_kernel=True``, else their plain
versions in ``kernels.ref`` (CPU tensors, or ``use_kernel=False`` on any
device). The substitution products of the solve are not panel kernels in
the reference either, and stay ``torch.matmul``.

Every entry point and schedule takes the reference's keyword
``precision``: ``"native"`` (the default) or ``"f32_x2"``, f32 only (an
unknown name or another dtype raises ``ValueError``, where the reference
would go on). ``"f32_x2"`` splits the products the reference splits (the
trsm, the trailing update, the substitutions; the panel products through
their split instances, the tile solve's four through ``ref.mm_x2``) and
leaves the diagonal blocks native. The name is checked once a call, by
the wrapper or plain version that chooses what to run (here only where
nothing else is called: an empty batch, the tile solve's products).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.kernels import blocked, panel, rank_update, ref

__all__ = [
    "blocked_cholesky",
    "cholesky_solve",
    "multi_gamma_solve",
    "chol_rank_update",
    "panels",
    "panel_width",
    "stream_block",
    "tile_cholesky_factor",
    "tile_cholesky_solve",
    "streamed_cholesky",
    "streamed_cholesky_solve",
    "DEFAULT_BLOCK",
    "DEFAULT_GAMMA_BLOCK",
    "DEFAULT_STREAM_BLOCK",
    "STREAM_BLOCK_F64",
    "DEFAULT_UPDATE_BLOCK",
    "STREAM_MIN_DIM",
]

DEFAULT_BLOCK = ref.BLOCK    # 128: panel width of the blocked path
DEFAULT_GAMMA_BLOCK = ref.GAMMA_BLOCK   # γs the plain sweep factors together
DEFAULT_STREAM_BLOCK = 256   # panel width for the streamed single-system path
# the streamed path's panel width in f64: the panel kernels hold one (b, b)
# triangle on one SM, 257 KB at b = 256 in f64 (panel.MAX_PANEL)
STREAM_BLOCK_F64 = 128
DEFAULT_UPDATE_BLOCK = 256   # row/col tile edge of the reference's syrk grid
STREAM_MIN_DIM = 2048        # the engine routes single systems this wide here


# the four panel functions as their plain versions, on any device
_PLAIN = SimpleNamespace(panel_factor=ref.panel_factor_ref,
                         panel_tri_inv=ref.panel_tri_inv_ref,
                         panel_trsm=ref.panel_trsm_ref,
                         panel_update=ref.panel_update_ref)


def panels(device, use_kernel: bool = True):
    """The four panel functions for tensors on ``device``: the CUDA kernels
    on a CUDA device when ``use_kernel``, else their plain versions."""
    return panel if use_kernel and torch.device(device).type == "cuda" else _PLAIN


def panel_width(rows: int, cap: int = DEFAULT_STREAM_BLOCK) -> int:
    """Largest panel width ≤ ``cap`` that divides ``rows`` — panels must tile
    the shard rows exactly so every panel has a single static owner shard."""
    b = min(cap, rows)
    while rows % b:
        b -= 1
    return b


def _ceil_mult(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _pad_spd(a: torch.Tensor, d_p: int) -> torch.Tensor:
    """Pad a (d, d) system to (d_p, d_p) with an identity tail — the padded
    block factors to I and never couples back (block diagonal)."""
    d = a.shape[-1]
    if d_p == d:
        return a
    out = torch.zeros((d_p, d_p), dtype=a.dtype, device=a.device)
    out[:d, :d] = a
    tail = torch.arange(d, d_p, device=a.device)
    out[tail, tail] = 1.0
    return out


def tile_cholesky_factor(tile: torch.Tensor, *, shard, n_shards: int, gather,
                         block: int, use_kernel: bool = True, in_place: bool = False,
                         precision: str = "native"):
    """Blocked right-looking Cholesky of a row-tiled global system.

    ``tile`` is this shard's ``(r, d)`` row slab of the global SPD system
    (``d = n_shards · r``); ``shard`` is the shard's index and
    ``gather(x) → (n_shards, …)`` stacks a per-shard tensor in shard order
    (``x[None]`` locally). ``block`` must divide ``r`` (see
    :func:`panel_width`) so each panel has one owner shard. Returns this
    shard's rows of the clean lower factor, and the per-panel inverse
    diagonal blocks. The factor is built in one copy of ``tile``, or, with
    ``in_place``, in ``tile`` itself (which is then returned).
    """
    r, d_p = tile.shape
    b = block
    k = panels(tile.device, use_kernel)
    rows_g = shard * r + torch.arange(r, device=tile.device)
    zero = torch.zeros((), dtype=tile.dtype, device=tile.device)
    work = tile if in_place else tile.clone()
    zs = []
    for p in range(d_p // b):
        o = p * b
        own = o // r                    # the panel lives on one shard
        lo = o - own * r                # the owner's local row offset
        diag = gather(work[lo:lo + b, o:o + b])[own]
        l_d, z = k.panel_factor(diag)
        zs.append(z)
        colv = k.panel_trsm(work[:, o:o + b], z, precision=precision)
        below = (rows_g >= o + b)[:, None]
        in_diag = ((rows_g >= o) & (rows_g < o + b))[:, None]
        ld_full = torch.zeros((r, b), dtype=tile.dtype, device=tile.device)
        ld_full[lo:lo + b] = l_d
        col = torch.where(below, colv, torch.where(in_diag, ld_full, zero))
        work[:, o:o + b] = col
        if d_p - o - b:
            pt = gather(col).reshape(n_shards * r, b)[o + b:]
            lp = torch.where(below, col, zero)
            trail = work[:, o + b:]
            k.panel_update(trail, lp, pt, out=trail, precision=precision)
    return work, zs


def tile_cholesky_solve(tile_l: torch.Tensor, q_tile: torch.Tensor, zs=None, *,
                        shard, n_shards: int, gather, psum, block: int,
                        use_kernel: bool = True, precision: str = "native") -> torch.Tensor:
    """``L Lᵀ x = q`` against a row-tiled factor from
    :func:`tile_cholesky_factor`; returns the replicated ``(d, C)`` solution.

    ``q_tile`` is this shard's rows of the right-hand side; ``psum`` sums a
    per-shard tensor over the shards (identity locally). ``zs`` are the
    inverse diagonal blocks, recomputed with ``panel_tri_inv`` when None.
    Forward sweep: the panel owner forms its (b, C) block from its own L
    rows and the psum broadcasts it; backward sweep: every shard adds its
    rows' partial product through the psum.
    """
    ref.check_precision(precision, tile_l.dtype)
    mm = ref.matmul(precision)
    r, d_p = tile_l.shape
    cdim = q_tile.shape[-1]
    b = block
    rows_g = shard * r + torch.arange(r, device=tile_l.device)
    zero = torch.zeros((), dtype=tile_l.dtype, device=tile_l.device)
    order = range(d_p // b)
    if zs is None:
        k = panels(tile_l.device, use_kernel)
        zs = []
        for p in order:
            o = p * b
            own, lo = o // r, o - (o // r) * r
            zs.append(k.panel_tri_inv(gather(tile_l[lo:lo + b, o:o + b])[own]))
    y = torch.zeros((d_p, cdim), dtype=q_tile.dtype, device=q_tile.device)
    for p in order:
        o = p * b
        own, lo = o // r, o - (o // r) * r
        rhs = q_tile[lo:lo + b]
        if o:
            rhs = rhs - mm(tile_l[lo:lo + b, :o], y[:o])
        y_p = mm(zs[p], rhs)
        if shard != own:
            y_p = torch.zeros_like(y_p)
        y[o:o + b] = psum(y_p)
    x = torch.zeros((d_p, cdim), dtype=q_tile.dtype, device=q_tile.device)
    for p in reversed(order):
        o = p * b
        lp = torch.where((rows_g >= o + b)[:, None], tile_l[:, o:o + b], zero)
        xs_local = x[shard * r:shard * r + r]
        total = psum(mm(lp.T, xs_local))
        x[o:o + b] = mm(zs[p].T, y[o:o + b] - total)
    return x


def stream_block(dtype: torch.dtype) -> int:
    """The streamed path's default panel width for ``dtype``:
    ``DEFAULT_STREAM_BLOCK``, or ``STREAM_BLOCK_F64`` in f64. The width
    changes the rounding, not the function."""
    return STREAM_BLOCK_F64 if dtype == torch.float64 else DEFAULT_STREAM_BLOCK


def streamed_cholesky(a: torch.Tensor, *, block: Optional[int] = None,
                      use_kernel: bool = True, precision: str = "native") -> torch.Tensor:
    """Single-system lower Cholesky ``a (d, d) SPD → L`` via panel streaming.

    The one-shard instance of :func:`tile_cholesky_factor`, at panels of
    ``block`` (default :func:`stream_block` of the dtype). A d that the
    panel width does not divide is padded with an identity tail and sliced
    back. Not positive definite → NaNs.
    """
    d = a.shape[-1]
    bs = min(block or stream_block(a.dtype), _ceil_mult(d, 8))
    d_p = _ceil_mult(d, bs)
    l, _ = tile_cholesky_factor(
        _pad_spd(a, d_p), shard=0, n_shards=1, gather=lambda v: v[None],
        block=bs, use_kernel=use_kernel, precision=precision)
    return l[:d, :d]


def streamed_cholesky_solve(l: torch.Tensor, b: torch.Tensor, *,
                            block: Optional[int] = None, use_kernel: bool = True,
                            precision: str = "native") -> torch.Tensor:
    """``L Lᵀ x = b`` against a :func:`streamed_cholesky` factor —
    ``l (d, d)`` lower, ``b (d, c)`` → ``x (d, c)``; ``block`` as there."""
    d = l.shape[-1]
    bs = min(block or stream_block(l.dtype), _ceil_mult(d, 8))
    d_p = _ceil_mult(d, bs)
    bp = b
    if d_p != d:
        bp = torch.zeros((d_p, b.shape[-1]), dtype=b.dtype, device=b.device)
        bp[:d] = b
    x = tile_cholesky_solve(
        _pad_spd(l, d_p), bp, None, shard=0, n_shards=1,
        gather=lambda v: v[None], psum=lambda v: v, block=bs,
        use_kernel=use_kernel, precision=precision)
    return x[:d]


# --- the blocked path --------------------------------------------------------


def blocked_cholesky(a: torch.Tensor, *, precision: str = "native") -> torch.Tensor:
    """Lower Cholesky factors of (m, d, d) SPD systems, panels of
    ``DEFAULT_BLOCK`` (the last one ragged); clean lower triangles, NaNs
    where a system is not positive definite."""
    m, d, _ = a.shape
    if m == 0:
        ref.check_precision(precision, a.dtype)
        return torch.zeros((0, d, d), dtype=a.dtype, device=a.device)
    if a.is_cuda:
        return blocked.blocked_cholesky(a.contiguous(), precision=precision)
    return ref.blocked_cholesky_ref(a, precision=precision)


def cholesky_solve(l: torch.Tensor, b: torch.Tensor, *,
                   precision: str = "native") -> torch.Tensor:
    """``L Lᵀ x = b`` for lower factors from :func:`blocked_cholesky`:
    ``l`` (m, d, d), ``b`` (m, d, c) → x (m, d, c)."""
    m, d, _ = l.shape
    if m == 0:
        ref.check_precision(precision, l.dtype)
        return torch.zeros((0, d, b.shape[-1]), dtype=b.dtype, device=b.device)
    if l.is_cuda:
        return blocked.cholesky_solve(l.contiguous(), b.contiguous(), precision=precision)
    return ref.cholesky_solve_ref(l, b, precision=precision)


def multi_gamma_solve(c: torch.Tensor, q: torch.Tensor, gammas, *,
                      precision: str = "native") -> torch.Tensor:
    """The fused γ sweep: ``(C + γ_j I) W_j = Q`` for the whole grid →
    (n_g, d, c). A γ whose system is singular comes back as NaNs (the
    engine then reroutes the grid to the eigendecomposition)."""
    gammas = torch.as_tensor(gammas, dtype=c.dtype, device=c.device)
    if gammas.shape[0] == 0:
        ref.check_precision(precision, c.dtype)
        return torch.zeros((0, *q.shape), dtype=c.dtype, device=c.device)
    if c.is_cuda:
        return blocked.multi_gamma_solve(c.contiguous(), q.contiguous(), gammas,
                                         precision=precision)
    return ref.multi_gamma_solve_ref(c, q, gammas, precision=precision)


def chol_rank_update(l: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``chol(L Lᵀ + xsᵀ xs)`` for a lower factor ``l`` (d, d) and update
    rows ``xs`` (k, d); ``l`` itself when k = 0."""
    if xs.shape[0] == 0:
        return l
    xs = xs.to(l.dtype)
    if l.is_cuda:
        return rank_update.chol_rank_update(l.contiguous(), xs.contiguous())
    return ref.chol_rank_update_ref(l, xs)
