"""Plain PyTorch versions of the port's kernels.

The CPU takes these in place of the kernels (``kernels.ops``), and the
tests and ``chip_smoke.py`` hold each kernel against its version here.
The solve versions follow the reference's algorithm (its ``_factor_tile``
and ``_tri_inv_tile`` column loops, ``_factor_panels`` / ``_solve_panels``
and ``_rank_update_kernel``'s sweep), not LAPACK, so the CPU route does
the JAX package's arithmetic in the same order as far as torch allows.
The tile loops take a batch of tiles on leading dimensions.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram as _gram

MASKED = -1e30           # the kernels' masked logit


def gram_ref(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.gram.gram_update``: (XᵀX, XᵀY) in f32."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    return xf.T @ xf, xf.T @ yf


def gram_upper_ref(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``csrc/gram.cu``'s schedule: G from its tiles on and
    above the diagonal only (``gram.upper_tiles``), each written where col
    >= row and mirrored where col > row, so G is exactly symmetric; Q =
    XᵀY."""
    xf = x.to(torch.float32)
    d = xf.shape[1]
    tile = _gram.TILE
    g = torch.empty((d, d), dtype=torch.float32, device=x.device)
    for i0, j0 in _gram.upper_tiles(d):
        rows = slice(i0, i0 + tile[0])
        cols = slice(j0, j0 + tile[1])
        t = xf[:, rows].T @ xf[:, cols]
        r = torch.arange(i0, min(i0 + tile[0], d), device=x.device)[:, None]
        c = torch.arange(j0, min(j0 + tile[1], d), device=x.device)[None, :]
        g[rows, cols] = torch.where(c >= r, t, g[rows, cols])
        g[cols, rows] = torch.where((c > r).T, t.T, g[cols, rows])
    return g, xf.T @ y.to(torch.float32)


def attention_mask(sq: int, skv: int, *, causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: True where query row s (at position q_offset + s)
    sees key j, as ``mha_ref`` and the flash kernel mask."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
            window: Optional[int] = None, scale: Optional[float] = None,
            q_offset: int = 0) -> torch.Tensor:
    """Plain version of ``kernels.flash_attention.flash_attention``.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA).
    ``q_offset``: absolute position of q[0] (decode: Skv - Sq).
    ``window``: query at position t attends to keys in [t - window + 1, t]
    (None = unbounded). The logits are materialized, in f32 throughout; a
    fully masked row gives zeros.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, group, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(torch.float32))
    mask = attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
    probs = torch.nan_to_num(probs, nan=0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)


def mha_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None, scale: Optional[float] = None,
                  q_offset: int = 0, sms: int = 132) -> torch.Tensor:
    """Plain twin of ``csrc/flash_attention.cu``'s split-KV decode (its
    regime for group · Sq <= ``flash_attention.DECODE_MAX_ROWS``): the band
    of visible keys cut by the wrapper's ``decode_plan`` (for ``sms`` SMs),
    each chunk's partial (m, l, unnormalised acc) over its keys, masked
    logits ``MASKED`` and their probabilities exactly 0, so a chunk that
    sees no key adds nothing; then the partials rescaled by their max and
    merged in chunk order, a row that sees no key giving zeros."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    lo, hi, chunk, splits = _fa.decode_plan(b, hkv, sq, skv, causal=causal, window=window,
                                            q_offset=q_offset, sms=sms)
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, group, sq, d)
    mask = attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    ms, ls, accs = [], [], []
    for s in range(splits):
        k0, k1 = lo + s * chunk, min(lo + (s + 1) * chunk, hi)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, k0:k1].to(torch.float32))
        logits = logits.masked_fill(~mask[:, k0:k1], MASKED)
        m = torch.cat([logits, torch.full_like(qf[..., :1], MASKED)], -1).amax(-1, keepdim=True)
        p = torch.where(logits > MASKED, torch.exp(logits - m), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, k0:k1].to(torch.float32)))
    top = torch.stack(ms).amax(0)
    l = sum(torch.exp(m - top) * x for m, x in zip(ms, ls))
    acc = sum(torch.exp(m - top) * x for m, x in zip(ms, accs))
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def factor_tile(tile: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of (..., m, m) SPD tiles: a column sweep
    with masked full-width updates, the upper triangle written as zeros. A
    tile that is not positive definite gives NaNs (sqrt of a negative
    pivot)."""
    s = tile.clone()
    rows = torch.arange(s.shape[-1], device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    for j in range(s.shape[-1]):
        pv = torch.sqrt(s[..., j, j])[..., None]
        colm = torch.where(rows > j, s[..., :, j] / pv, zero)
        s -= colm[..., :, None] * colm[..., None, :]
        s[..., :, j] = torch.where(rows == j, pv, colm)
    return s


def tri_inv_tile(l: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., m, m) lower-triangular tiles by forward substitution
    on the identity; the strict upper triangle of ``l`` is not read."""
    m = l.shape[-1]
    rows = torch.arange(m, device=l.device)
    eye = torch.eye(m, dtype=l.dtype, device=l.device)
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    z = torch.zeros_like(l)
    for i in range(m):
        strict = torch.where(rows < i, l[..., i, :], zero)
        acc = (strict[..., None, :] @ z)[..., 0, :]
        z[..., i, :] = (eye[i] - acc) / l[..., i, i][..., None]
    return z


SUB = 32                 # sub-block width of the blocked micro-routines (one warp)


def _pad_identity(a: torch.Tensor, bp: int) -> torch.Tensor:
    """The lower triangle of (..., b, b) blocks, padded to (..., bp, bp)
    with an identity tail."""
    b = a.shape[-1]
    out = torch.zeros((*a.shape[:-2], bp, bp), dtype=a.dtype, device=a.device)
    out[..., :b, :b] = torch.tril(a)
    tail = torch.arange(b, bp, device=a.device)
    out[..., tail, tail] = 1.0
    return out


def _padded(b: int, nb: int) -> int:
    return -(-b // nb) * nb


def invert_blocked_ref(l: torch.Tensor, nb: int = SUB) -> torch.Tensor:
    """The CUDA ``invert_blocked`` (``csrc/tri_blocked.cuh``) in plain
    PyTorch: the inverse of (..., b, b) lower-triangular blocks as the
    kernel computes it, to prove its algebra on the CPU (no path calls it).

    The block is padded to a multiple of ``nb`` with an identity tail; each
    ``nb``-wide diagonal sub-block is inverted by the column loop of
    :func:`tri_inv_tile` (one warp's forward substitution); neighbouring
    inverses are then merged level by level, Z21 = −Z22 · (L21 · Z11), the
    second block of a pair narrower where the sub-blocks do not pair up.
    The strict upper triangle of ``l`` is not read; the result's is zero.
    """
    b = l.shape[-1]
    bp = _padded(b, nb)
    z = _pad_identity(l, bp)
    lp = z.clone()
    for o in range(0, bp, nb):
        z[..., o:o + nb, o:o + nb] = tri_inv_tile(lp[..., o:o + nb, o:o + nb])
    s = nb
    while s < bp:
        for a in range(0, bp - s, 2 * s):
            e = min(a + 2 * s, bp)
            t = lp[..., a + s:e, a:a + s] @ z[..., a:a + s, a:a + s]
            z[..., a + s:e, a:a + s] = -(z[..., a + s:e, a + s:e] @ t)
        s *= 2
    return torch.tril(z[..., :b, :b])


def factor_blocked_ref(a: torch.Tensor, nb: int = SUB) -> torch.Tensor:
    """The CUDA ``factor_blocked`` (``csrc/tri_blocked.cuh``) in plain
    PyTorch: the lower Cholesky factor of (..., b, b) SPD blocks as the
    kernel computes it, to prove its algebra on the CPU (no path calls it).

    The block is padded to a multiple of ``nb`` with an identity tail. Per
    sub-panel of ``nb`` columns: the diagonal sub-block by the column sweep
    of :func:`factor_tile` (one warp), the rows below it by forward
    substitution against that factor (one thread a row, each x_c scaled by
    the reciprocal of its pivot and folded into the columns after it), then
    the rank-nb update of the trailing triangle. Only the lower triangle of ``a`` is
    read; a block that is not positive definite gives NaNs.
    """
    b = a.shape[-1]
    bp = _padded(b, nb)
    s = _pad_identity(a, bp)
    for o in range(0, bp, nb):
        e = o + nb
        l11 = factor_tile(s[..., o:e, o:e])
        s[..., o:e, o:e] = l11
        if e == bp:
            break
        x = s[..., e:, o:e].clone()
        for c in range(nb):
            x[..., :, c] *= 1.0 / l11[..., c, c][..., None]
            x[..., :, c + 1:] -= x[..., :, c:c + 1] * l11[..., None, c + 1:, c]
        s[..., e:, o:e] = x
        s[..., e:, e:] -= x @ _t(x)
    return torch.tril(s[..., :b, :b])


def panel_factor_ref(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.panel.panel_factor``: ``(L, L⁻¹)``."""
    l = factor_tile(diag)
    return l, tri_inv_tile(l)


def panel_factor_blocked_ref(diag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA ``panel_factor`` (``csrc/panel.cu``) in plain PyTorch:
    ``(L, L⁻¹)`` of one SPD block as the kernel computes them, the blocked
    factor (:func:`factor_blocked_ref`) and then the blocked inverse of that
    factor (:func:`invert_blocked_ref`), to prove its algebra on the CPU (no
    path calls it; the CPU route takes :func:`panel_factor_ref`)."""
    l = factor_blocked_ref(diag)
    return l, invert_blocked_ref(l)


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


BLOCK = 128              # panel width of the blocked path (the reference's DEFAULT_BLOCK)
GAMMA_BLOCK = 8          # γs the plain sweep factors together, as the reference's grid steps


def _panel_edges(d: int) -> list[tuple[int, int]]:
    """(start, end) of each diagonal panel of a d-wide system: ``BLOCK``
    wide, the last one ragged. The reference pads d with an identity tail
    instead; the padded rows factor to I and never couple back, so the
    entries kept are the same."""
    return [(o, min(o + BLOCK, d)) for o in range(0, d, BLOCK)]


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def factor_panels(a: torch.Tensor) -> tuple[torch.Tensor, list]:
    """Right-looking blocked Cholesky of (m, d, d) systems: the reference's
    ``_factor_panels``. Returns the clean lower factors and each panel's
    inverse diagonal block (which the solve reuses). Only the lower
    triangle of ``a`` is read."""
    d = a.shape[-1]
    a = a.clone()
    zs = []
    for o, e in _panel_edges(d):
        l11 = factor_tile(a[..., o:e, o:e])
        z = tri_inv_tile(l11)
        zs.append(z)
        a[..., o:e, o:e] = l11
        if e < d:
            l21 = a[..., e:, o:e] @ _t(z)
            a[..., e:, o:e] = l21
            a[..., e:, e:] -= l21 @ _t(l21)
    return torch.tril(a), zs


def solve_panels(l: torch.Tensor, b: torch.Tensor,
                 zs: Optional[list] = None) -> torch.Tensor:
    """``L Lᵀ x = b`` for (m, d, d) lower factors and (m, d, c) right-hand
    sides by blocked forward and backward substitution: the reference's
    ``_solve_panels``. ``zs`` are the inverse diagonal blocks, computed
    here when None."""
    d = l.shape[-1]
    edges = _panel_edges(d)
    if zs is None:
        zs = [tri_inv_tile(l[..., o:e, o:e]) for o, e in edges]
    y = torch.zeros(b.shape, dtype=b.dtype, device=b.device)
    for (o, e), z in zip(edges, zs):
        rhs = b[..., o:e, :]
        if o:
            rhs = rhs - l[..., o:e, :o] @ y[..., :o, :]
        y[..., o:e, :] = z @ rhs
    x = torch.zeros_like(y)
    for (o, e), z in reversed(list(zip(edges, zs))):
        rhs = y[..., o:e, :]
        if e < d:
            rhs = rhs - _t(l[..., e:, o:e]) @ x[..., e:, :]
        x[..., o:e, :] = _t(z) @ rhs
    return x


def blocked_cholesky_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.blocked.blocked_cholesky``: (m, d, d) SPD
    → clean lower factors; NaNs where a system is not positive definite."""
    return factor_panels(a)[0]


def cholesky_solve_ref(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.blocked.cholesky_solve``: ``L Lᵀ x = b``
    for l (m, d, d) and b (m, d, c)."""
    return solve_panels(l, b)


def multi_gamma_solve_ref(c: torch.Tensor, q: torch.Tensor,
                          gammas: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.blocked.multi_gamma_solve``: ``(C + γ_j I)
    W_j = Q`` for each γ, ``GAMMA_BLOCK`` systems factored together. Returns (n_g, d, c); a singular γ gives
    NaNs."""
    d, n_cls = q.shape
    gammas = gammas.to(c.dtype)
    eye = torch.eye(d, dtype=c.dtype, device=c.device)
    out = torch.empty((gammas.shape[0], d, n_cls), dtype=c.dtype, device=c.device)
    for g0 in range(0, gammas.shape[0], GAMMA_BLOCK):
        g = gammas[g0:g0 + GAMMA_BLOCK]
        l, zs = factor_panels(c[None] + g[:, None, None] * eye)
        out[g0:g0 + g.shape[0]] = solve_panels(l, q.expand(g.shape[0], d, n_cls), zs)
    return out


def solve_right_looking_ref(l: torch.Tensor, b: torch.Tensor,
                            zs: Optional[list] = None) -> torch.Tensor:
    """The CUDA ``cholesky_solve`` (``csrc/blocked.cu``) in plain PyTorch:
    ``L Lᵀ x = b`` for (m, d, d) lower factors and (m, d, c) right-hand
    sides as the kernel computes it, to prove its schedule on the CPU (no
    path calls it).

    Each diagonal block is inverted by :func:`invert_blocked_ref` (or
    taken from ``zs``, one per panel). Forward, right-looking: y_p = Z_p ·
    r_p, then the rows below the panel take r −= L_{>p,p} · y_p at once;
    r is ``b`` at the first panel (read, never copied) and the running
    right-hand side after it. Backward, mirrored: x_p = Z_pᵀ · y_p, then
    y_{<p} −= L_{p,<p}ᵀ · x_p. The strict upper triangle of ``l`` is not
    read.
    """
    d = l.shape[-1]
    edges = _panel_edges(d)
    if zs is None:
        zs = [invert_blocked_ref(l[..., o:e, o:e]) for o, e in edges]
    y = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    x = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    for (o, e), z in zip(edges, zs):
        r = b if o == 0 else x
        y[..., o:e, :] = z @ r[..., o:e, :]
        if e < d:
            x[..., e:, :] = r[..., e:, :] - l[..., e:, o:e] @ y[..., o:e, :]
    for (o, e), z in reversed(list(zip(edges, zs))):
        x[..., o:e, :] = _t(z) @ y[..., o:e, :]
        if o:
            y[..., :o, :] -= _t(l[..., o:e, :o]) @ x[..., o:e, :]
    return x


def multi_gamma_blocked_ref(c: torch.Tensor, q: torch.Tensor,
                            gammas: torch.Tensor) -> torch.Tensor:
    """The CUDA ``multi_gamma_solve`` (``csrc/blocked.cu``) in plain
    PyTorch: ``(C + γ_j I) W_j = Q`` for each γ as the kernel computes it,
    to prove its schedule on the CPU (no path calls it). Returns (n_g, d,
    c); a singular γ gives NaNs in its W_j only.

    Every γ's factor runs the ``blocked_cholesky`` panel schedule on C
    itself (no C + γI is formed): the first panel reads C, adds γ_j to its
    diagonal block's diagonal as it loads and writes a diagonal entry of
    the trailing block as (a + γ_j) − v; later panels read the factor.
    Each diagonal block is factored by :func:`factor_blocked_ref` and
    inverted by :func:`invert_blocked_ref`, every inverse is kept, and the
    solve is :func:`solve_right_looking_ref` with Q read by every γ. Only
    the lower triangle of C is read.
    """
    d, n_cls = q.shape
    g = gammas.to(c.dtype)
    n_g = g.shape[0]
    out = torch.zeros((n_g, d, d), dtype=c.dtype, device=c.device)
    src = c.expand(n_g, d, d)
    zs = []
    for o, e in _panel_edges(d):
        blk = src[..., o:e, o:e].clone()
        if o == 0:
            idx = torch.arange(e, device=c.device)
            blk[..., idx, idx] += g[:, None]
        l11 = factor_blocked_ref(blk)
        z = invert_blocked_ref(l11)
        zs.append(z)
        out[..., o:e, o:e] = l11
        if e < d:
            l21 = src[..., e:, o:e] @ _t(z)
            a22 = src[..., e:, e:].clone()
            if o == 0:
                idx = torch.arange(d - e, device=c.device)
                a22[..., idx, idx] += g[:, None]
            out[..., e:, e:] = a22 - l21 @ _t(l21)
            out[..., e:, o:e] = l21
        src = out
    return solve_right_looking_ref(torch.tril(out), q.expand(n_g, d, n_cls), zs)


def chol_rank_update_ref(l: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.rank_update.chol_rank_update``:
    ``chol(L Lᵀ + xsᵀ xs)`` for a lower factor ``l`` (d, d) and update rows
    ``xs`` (k, d).

    The reference's Householder column sweep: at column i one
    (k+1)-reflection annihilates all k update entries, and the tails of
    the column and of ``xsᵀ`` below the diagonal take its update. Zero
    update rows are no-ops (the ``s_`` guard). Entries above the diagonal
    are kept as they are. No branch on the data, so on the card the loop
    never waits for the device.
    """
    if xs.shape[0] == 0:
        return l
    l = l.clone()
    xt = xs.T.clone()                              # (d, k)
    for i in range(l.shape[0]):
        w = xt[i]
        s = w @ w
        s_ = torch.where(s > 0, s, torch.ones_like(s))   # w == 0 ⇒ t == 0
        a = l[i, i]
        r = torch.sqrt(a * a + s)
        amr = -s / (r + a)                         # a − r without cancellation
        beta = (r + a) / (r * s_)                  # 2 / uᵀu for u = [a − r; w]
        col = l[i + 1:, i]
        t = amr * col + xt[i + 1:] @ w
        l[i, i] = r
        l[i + 1:, i] = col - (beta * amr) * t
        xt[i + 1:] -= (beta * t)[:, None] * w[None, :]
    return l


def chol_rank_update_blocked_ref(l: torch.Tensor, xs: torch.Tensor, nb: int = 32,
                                 k_pass: int = 256) -> torch.Tensor:
    """The schedule of the CUDA ``chol_rank_update`` in plain PyTorch: the
    same function as :func:`chol_rank_update_ref`, computed as the kernel
    computes it, to prove its algebra on the CPU (the engine never calls
    it).

    ``xs`` is folded ``k_pass`` rows at a time. Within a pass each panel of
    ``nb`` columns runs the reference's column sweep on its own rows only,
    recording amr, β and W (the rows w_i as each was swept); the rows
    below take the panel's transform ``Q = I − V T Vᵀ`` with V =
    [diag(amr); W] at once: Y = l∘amr + x·Wᵀ, Y ← Y·T, l −= Y∘amr,
    x −= Y·W. T is upper triangular, from WᵀW by LAPACK's dlarft
    recurrence (the reflectors' L coordinates never overlap).
    """
    if xs.shape[0] == 0:
        return l
    d = l.shape[0]
    out = l.clone()
    for k0 in range(0, xs.shape[0], k_pass):
        xt = xs[k0:k0 + k_pass].T.clone()              # (d, kp)
        for p in range(0, d, nb):
            e = min(p + nb, d)
            n = e - p
            lp = out[p:e, p:e].clone()
            w = xt[p:e]                                # swept in place into W
            amr = torch.empty(n, dtype=l.dtype, device=l.device)
            beta = torch.empty(n, dtype=l.dtype, device=l.device)
            for i in range(n):
                wi = w[i]
                s = wi @ wi
                s_ = torch.where(s > 0, s, torch.ones_like(s))
                a = lp[i, i]
                r = torch.sqrt(a * a + s)
                amr[i] = -s / (r + a)
                beta[i] = (r + a) / (r * s_)
                col = lp[i + 1:, i]
                t = amr[i] * col + w[i + 1:] @ wi
                lp[i, i] = r
                lp[i + 1:, i] = col - (beta[i] * amr[i]) * t
                w[i + 1:] -= (beta[i] * t)[:, None] * wi[None, :]
            out[p:e, p:e] = lp
            if e == d:
                continue
            g = w @ w.T
            tm = torch.zeros((n, n), dtype=l.dtype, device=l.device)
            for b in range(n):
                tm[:b, b] = -beta[b] * (tm[:b, :b] @ g[:b, b])
                tm[b, b] = beta[b]
            y = (out[e:, p:e] * amr + xt[e:] @ w.T) @ tm
            out[e:, p:e] -= y * amr
            xt[e:] -= y @ w
    return out
