"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel
has no CPU mode). The file imports nothing of JAX, so it runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels_gram.py: rtol 2e-4 / atol 2e-3
for f32 (sums in another order), 2e-2 / 2e-1 for bf16; the flash-attention
kernel's those of tests/test_kernels_attention.py, rtol 2e-5 / atol 4e-4,
for f32, and for bf16 1e-2 of the largest |value| of the plain version in
f32 on the same inputs (``ATTN_BF16_REL``) and ``TWIN_BF16_REL`` of it
from the plain twin of the kernel's schedule. The solve kernels' f64 instances are held to
numpy f64 at 1e-10, the bar the reference holds its kernel solves to under
x64 (tests/test_solve_kernels.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import AnalyticEngine, SuffStats
from repro_torch.kernels import blocked as B
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gram as G
from repro_torch.kernels import ops, ref
from repro_torch.kernels import panel as P
from repro_torch.kernels import rank_update as R
from repro_torch.kernels import solve as S

TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (2e-2, 2e-1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _data(seed, n, d, c, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    y = torch.from_numpy(np.eye(c, dtype=np.float32)[rng.integers(0, c, n)])
    return x.to(device, dtype), y.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,dtype", [
    (64, 2304, 16, torch.float32),     # the main path's per-batch shape
    (1000, 200, 37, torch.float32),    # ragged everywhere
    (8, 256, 5, torch.float32),        # fewer rows than one staged step
    (2048, 384, 128, torch.bfloat16),
])
def test_gram_kernel_matches_plain(cuda, n, d, c, dtype):
    x, y = _data(0, n, d, c, dtype, cuda)
    before = G.gram_update.launches
    g, q = ops.gram_update(x, y)
    torch.cuda.synchronize()
    assert G.gram_update.launches == before + 1
    g_ref, q_ref = ref.gram_ref(x, y)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(g, g_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(q, q_ref, rtol=rtol, atol=atol)
    assert torch.equal(g, g.T)   # one FMA chain for G[i,j] and G[j,i]


@pytest.mark.cuda
def test_gram_kernel_rejects_bad_inputs(cuda):
    x, y = _data(1, 32, 16, 3, torch.float32, cuda)
    with pytest.raises(TypeError):
        G.gram_update(x.half(), y.half())
    with pytest.raises(TypeError):
        G.gram_update(x.double(), y)                  # two dtypes
    with pytest.raises(ValueError, match="contiguous"):
        G.gram_update(x.T.contiguous().T, y)
    with pytest.raises(ValueError):
        G.gram_update(x, y[:-1])


@pytest.mark.cuda
def test_gram_kernel_f64_input_folds_in_f32(cuda):
    """f64 inputs are cast to f32 and folded by the f32 kernel, as the
    Pallas kernel and the plain version accumulate in f32; the f64 engine
    on the card stores that fold in f64, as it does on the CPU."""
    x, y = _data(2, 300, 96, 4, torch.float64, cuda)
    before = G.gram_update.launches
    g, q = G.gram_update(x, y)
    torch.cuda.synchronize()
    assert G.gram_update.launches == before + 1
    assert g.dtype == q.dtype == torch.float32
    g32, q32 = G.gram_update(x.float(), y.float())
    assert torch.equal(g, g32) and torch.equal(q, q32)
    eng = AnalyticEngine("torch", dtype=torch.float64, device=cuda, use_kernel=True)
    s = eng.update(eng.init(96, 4), x, y)
    assert s.gram.dtype == torch.float64
    assert torch.equal(s.gram, g.double()) and torch.equal(s.moment, q.double())
    cpu = AnalyticEngine("torch", dtype=torch.float64, device="cpu", use_kernel=True)
    s_cpu = cpu.update(cpu.init(96, 4), x.cpu(), y.cpu())
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(s.gram.cpu(), s_cpu.gram, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_engine_kernel_path_matches_plain_path(cuda):
    """The torch backend with use_kernel folds the same statistics as
    without it, batch after batch."""
    eng_k = AnalyticEngine("torch", device=cuda, use_kernel=True)
    eng_p = AnalyticEngine("torch", device=cuda)
    s_k, s_p = eng_k.init(96, 4), eng_p.init(96, 4)
    before = G.gram_update.launches
    for seed in range(3):
        x, y = _data(seed, 50, 96, 4, torch.float32, cuda)
        s_k, s_p = eng_k.update(s_k, x, y), eng_p.update(s_p, x, y)
    assert G.gram_update.launches == before + 3
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(s_k.gram, s_p.gram, rtol=rtol, atol=atol)
    torch.testing.assert_close(s_k.moment, s_p.moment, rtol=rtol, atol=atol)


# --- the panel kernels of the streamed Cholesky -------------------------------
#
# Factor and inverse are held to their plain versions (the reference's column
# loops) at relative 1e-4 of the largest entry, the bar of
# tests/test_distributed_cholesky.py for f32 factors: f32 arithmetic in
# another order, on blocks with condition numbers near 10. The two products
# take the Gram tolerances above (f32 sums of 256 terms in another order).


def _rel(a, b):
    """Largest error relative to the largest entry of ``b``."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _spd_block(seed, b, device, rows=None):
    """An SPD (b, b) block XᵀX / rows from rows = 4b normal rows (cond ≈ 9)."""
    rng = np.random.default_rng(seed)
    rows = rows or 4 * b
    x = rng.standard_normal((rows, b))
    return torch.from_numpy(x.T @ x / rows).to(device, torch.float32)


def _inside(t, pad=3):
    """``t`` as a view inside a larger matrix: rows with a larger stride,
    as the schedule hands the kernels column slabs of its work matrix."""
    big = torch.full((t.shape[0] + pad, t.shape[1] + 2 * pad), float("nan"),
                     dtype=t.dtype, device=t.device)
    big[pad:pad + t.shape[0], pad:pad + t.shape[1]] = t
    return big[pad:pad + t.shape[0], pad:pad + t.shape[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 200, 16])     # the path's width, ragged, tiny
def test_panel_factor_and_tri_inv_match_plain(cuda, b):
    a = _inside(_spd_block(b, b, cuda))
    assert a.stride(0) > b
    before = (P.panel_factor.launches, P.panel_tri_inv.launches)
    l, z = ops.panel_factor(a)
    # the upper triangle of the input is not read
    z2 = ops.panel_tri_inv(_inside(l + torch.triu(torch.full_like(l, 7.0), 1)))
    torch.cuda.synchronize()
    assert (P.panel_factor.launches, P.panel_tri_inv.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    l_ref, z_ref = ref.panel_factor_ref(a)
    assert _rel(l, l_ref) < 1e-4 and _rel(z, z_ref) < 1e-4
    assert _rel(z2, ref.panel_tri_inv_ref(l)) < 1e-4
    for t in (l, z, z2):      # clean lower triangles
        assert torch.isfinite(t).all()
        assert not torch.triu(t, 1).any()
    # the inverse is the inverse
    eye = torch.eye(b, device=cuda, dtype=torch.float64)
    assert float((l.double() @ z.double() - eye).abs().max()) < 1e-4


@pytest.mark.cuda
def test_panel_factor_non_pd_gives_nan(cuda):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 256))).to(cuda, torch.float32)
    a = x.T @ x                                       # rank 3
    l, z = ops.panel_factor(a)
    l_ref, _ = ref.panel_factor_ref(a)
    torch.cuda.synchronize()
    assert torch.isnan(l).any() and torch.isnan(z).any()
    assert torch.isnan(l_ref).any()
    assert not torch.triu(l, 1).any()                 # NaN stays off the upper half


def _column_slab(x, width):
    """``x`` (r, c) as the last c columns of an (r, width) work matrix (row
    stride ``width``), as the schedule hands the products its slabs."""
    big = torch.full((x.shape[0], width), float("nan"), dtype=x.dtype, device=x.device)
    big[:, width - x.shape[1]:] = x
    return big[:, width - x.shape[1]:]


def _assert_product(got, want):
    """The products' bars: the Gram tolerances in f32, relative 1e-10 of
    the largest entry in f64."""
    if got.dtype == torch.float64:
        assert _rel(got, want) < REL64
    else:
        rtol, atol = TOL[torch.float32]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


# (r, b, dtype, ld): the d = 2304 path's slab in f32 (b = 256) and f64
# (b = 128), read where it lies in the (d, d) work matrix (16-byte aligned
# rows); ragged, with row strides and bases that are not 16-byte multiples;
# smaller than one tile
TRSM_CASES = [(2304, 256, torch.float32, 2304), (2304, 128, torch.float64, 2304),
              (1000, 200, torch.float32, 977), (1000, 200, torch.float64, 977),
              (20, 12, torch.float32, 15), (20, 12, torch.float64, 15)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,b,dtype,ld", TRSM_CASES)
def test_panel_trsm_matches_plain(cuda, r, b, dtype, ld):
    rng = np.random.default_rng(r + b)
    raw = _column_slab(torch.from_numpy(rng.standard_normal((r, b))).to(cuda, dtype), ld)
    zinv = torch.from_numpy(np.tril(rng.standard_normal((b, b)))).to(cuda, dtype)
    before = P.panel_trsm.launches
    out = ops.panel_trsm(raw, zinv)
    torch.cuda.synchronize()
    assert P.panel_trsm.launches == before + 1
    assert out.shape == (r, b) and out.is_contiguous()
    _assert_product(out, ref.panel_trsm_ref(raw, zinv))
    assert torch.equal(ops.panel_trsm(raw, zinv), out)     # the same bits again


# (r, w, b, dtype, odd): the d = 2304 path's widest and narrowest trailing
# updates in f32 (b = 256) and f64 (b = 128), d = 6144's widest; ragged,
# with every operand's row stride and base off 16-byte multiples (odd);
# smaller than one tile
UPDATE_CASES = [(2304, 2048, 256, torch.float32, False), (2304, 256, 256, torch.float32, False),
                (6144, 5888, 256, torch.float32, False),
                (2304, 2176, 128, torch.float64, False), (2304, 128, 128, torch.float64, False),
                (1000, 777, 200, torch.float32, True), (1000, 777, 200, torch.float64, True),
                (30, 20, 12, torch.float32, True), (30, 20, 12, torch.float64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,w,b,dtype,odd", UPDATE_CASES)
def test_panel_update_matches_plain_in_place(cuda, r, w, b, dtype, odd):
    rng = np.random.default_rng(w + b)
    dev = lambda a: torch.from_numpy(a).to(cuda, dtype)  # noqa: E731
    work = dev(rng.standard_normal((r, w + b + odd)))
    lp = dev(rng.standard_normal((r, b)))
    pt = dev(rng.standard_normal((w, b)))
    if odd:
        lp, pt = _column_slab(lp, b + 1), _column_slab(pt, b + 1)
    trail = work[:, b + odd:]                         # a slab of the work matrix
    orig = trail.clone()
    want = ref.panel_update_ref(trail, lp, pt)
    head = work[:, :b + odd].clone()
    before = P.panel_update.launches
    got = ops.panel_update(trail, lp, pt, out=trail)
    torch.cuda.synchronize()
    assert P.panel_update.launches == before + 1
    assert got.data_ptr() == trail.data_ptr()
    _assert_product(trail, want)
    assert torch.equal(work[:, :b + odd], head)       # nothing outside the slab
    fresh = ops.panel_update(orig, lp, pt)            # into a new tensor, the same bits
    assert fresh.is_contiguous() and torch.equal(fresh, trail)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_panel_products_carry_nan(cuda, dtype):
    lp = torch.ones((70, 16), device=cuda, dtype=dtype)
    lp[5, 3] = float("nan")
    pt = torch.ones((40, 16), device=cuda, dtype=dtype)
    out = ops.panel_update(torch.zeros((70, 40), device=cuda, dtype=dtype), lp, pt)
    trsm = ops.panel_trsm(lp, torch.eye(16, device=cuda, dtype=dtype))
    torch.cuda.synchronize()
    assert torch.isnan(out[5]).all() and torch.isfinite(out[:5]).all()
    assert torch.isnan(trsm[5, 3]) and torch.isfinite(trsm[6:]).all()


@pytest.mark.cuda
def test_panel_kernels_reject_bad_inputs(cuda):
    a = _spd_block(0, 32, cuda)
    before = [f.launches for f in (P.panel_factor, P.panel_tri_inv,
                                   P.panel_trsm, P.panel_update)]
    with pytest.raises(TypeError):
        P.panel_factor(a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        P.panel_tri_inv(a.cpu())
    with pytest.raises(ValueError):
        P.panel_factor(a[:, :31])                     # not square
    with pytest.raises(ValueError):
        P.panel_factor(torch.eye(257, device=cuda))   # wider than one SM holds
    with pytest.raises(ValueError):                   # in f64, wider than 128
        P.panel_factor(torch.eye(129, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        P.panel_trsm(a, a.double())                   # two dtypes
    with pytest.raises(ValueError, match="stride"):
        P.panel_trsm(a.T[:, :16], a[:16, :16])        # column-major slab
    with pytest.raises(ValueError):
        P.panel_trsm(a, a[:16, :16])                  # zinv not (b, b)
    with pytest.raises(ValueError):
        P.panel_update(a, a[:, :8], a[:16, :8])       # pt not (w, b)
    with pytest.raises(TypeError):
        P.panel_update(a, a[:, :8], a[:, :8], out=a.double())
    after = [f.launches for f in (P.panel_factor, P.panel_tri_inv,
                                  P.panel_trsm, P.panel_update)]
    assert after == before


@pytest.mark.cuda
def test_engine_streamed_solve_at_minicpm_width(cuda):
    """d = 2304 through AnalyticEngine(use_kernel=True): 9 panels, so one
    factor and solve launch the panel kernels 9 / 9 / 8 / 9 times, and the
    weight matches the plain route on the card and the host f64 engine."""
    d, c = 2304, 16
    x, y = _data(7, 4 * d, d, c, torch.float32, cuda)
    g, q = ref.gram_ref(x, y)
    one = torch.tensor(1.0, device=cuda)
    stats = SuffStats(g, q, torch.tensor(float(4 * d), device=cuda), one)
    eng = AnalyticEngine("torch", device=cuda, use_kernel=True)
    counts = lambda: [f.launches for f in (P.panel_factor, P.panel_trsm,  # noqa: E731
                                           P.panel_update, P.panel_tri_inv)]
    before = counts()
    w = eng.solve(stats, target_gamma=0.5)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [9, 9, 8, 9]
    a = g + 0.5 * torch.eye(d, device=cuda)
    l_plain = S.streamed_cholesky(a, use_kernel=False)
    w_plain = S.streamed_cholesky_solve(l_plain, q, use_kernel=False)
    assert _rel(w, w_plain) < 1e-4
    w_host = np.linalg.solve(g.double().cpu().numpy() + 0.5 * np.eye(d),
                             q.double().cpu().numpy())
    assert _rel(w.cpu(), torch.from_numpy(w_host)) < 1e-4
    assert counts() == [n + k for n, k in zip(before, [9, 9, 8, 9])]   # plain launches none


# --- the blocked kernels and the rank update -----------------------------------
#
# Each is held to its plain version (the reference's algorithm in torch) at
# relative 1e-4 of the largest entry, the f32 bar of
# tests/test_distributed_cholesky.py: the same algorithm with sums in
# another order, on systems with condition numbers near 10.

REL = 1e-4


def _blocked_counts():
    return [f.launches for f in (B.blocked_cholesky, B.cholesky_solve,
                                 B.multi_gamma_solve, R.chol_rank_update)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1536), (1, 128), (3, 130), (2, 257)])  # path, path, ragged
def test_blocked_cholesky_matches_plain(cuda, m, d):
    a = torch.stack([_spd_block(d + i, d, cuda) for i in range(m)])
    before = B.blocked_cholesky.launches
    l = ops.blocked_cholesky(a)
    torch.cuda.synchronize()
    assert B.blocked_cholesky.launches == before + 1
    assert l.shape == (m, d, d) and torch.isfinite(l).all()
    assert not torch.triu(l, 1).any()
    assert _rel(l, ref.blocked_cholesky_ref(a)) < REL
    # the upper triangle of the input is not read, and a repeated call
    # gives the same bits
    garbage = a + torch.triu(torch.full_like(a, 7.0), 1)
    assert torch.equal(ops.blocked_cholesky(garbage), l)
    assert torch.equal(ops.blocked_cholesky(a), l)


@pytest.mark.cuda
def test_blocked_cholesky_non_pd_gives_nan_in_that_system_only(cuda):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 200))).to(cuda, torch.float32)
    a = torch.stack([_spd_block(1, 200, cuda), x.T @ x])       # PD, rank 3
    l = ops.blocked_cholesky(a)
    torch.cuda.synchronize()
    assert torch.isfinite(l[0]).all() and torch.isnan(l[1]).any()
    assert torch.isnan(ref.blocked_cholesky_ref(a[1:])).any()
    assert not torch.triu(l, 1).any()
    assert _rel(l[0], ref.blocked_cholesky_ref(a[:1])[0]) < REL
    again = ops.blocked_cholesky(a)        # the same bits, NaNs in the same places
    assert torch.equal(again.isnan(), l.isnan())
    assert torch.equal(again.nan_to_num(), l.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,c", [(1, 1536, 16), (1, 128, 40), (2, 130, 7), (3, 257, 1)])
def test_cholesky_solve_matches_plain(cuda, m, d, c):
    """Against the plain version, the plain twin of its right-looking
    schedule and an f64 solve; the upper triangle of L is not read, and a
    repeated call gives the same bits."""
    rng = np.random.default_rng(d + c)
    a = torch.stack([_spd_block(d + i, d, cuda) for i in range(m)])
    l = ref.blocked_cholesky_ref(a)
    b = torch.from_numpy(rng.standard_normal((m, d, c))).to(cuda, torch.float32)
    before = B.cholesky_solve.launches
    x = ops.cholesky_solve(l, b)
    torch.cuda.synchronize()
    assert B.cholesky_solve.launches == before + 1
    assert x.shape == (m, d, c)
    assert _rel(x, ref.cholesky_solve_ref(l, b)) < REL
    assert _rel(x, ref.solve_right_looking_ref(l, b)) < REL
    want = torch.linalg.solve(a.double(), b.double())
    assert _rel(x, want) < REL
    garbage = l + torch.triu(torch.full_like(l, 7.0), 1)
    assert torch.equal(ops.cholesky_solve(garbage, b), x)
    assert torch.equal(ops.cholesky_solve(l, b), x)


@pytest.mark.cuda
def test_cholesky_solve_f64_at_path_width_matches_numpy(cuda):
    """The f64 instance at the narrow path's (1, 1536, 16) against numpy f64
    at 1e-10, and against its twin."""
    d, c = 1536, 16
    rng = np.random.default_rng(d + 64)
    x = rng.standard_normal((4 * d, d))
    a = x.T @ x / (4 * d)
    b = rng.standard_normal((1, d, c))
    l = torch.from_numpy(np.linalg.cholesky(a))[None].to(cuda)
    bt = torch.from_numpy(b).to(cuda)
    got = ops.cholesky_solve(l, bt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert _rel_x64(got, np.linalg.solve(a, b[0])[None]) < REL64
    assert _rel(got, ref.solve_right_looking_ref(l, bt)) < REL64
    assert torch.equal(ops.cholesky_solve(l, bt), got)


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,n_g", [(2304, 16, 16), (130, 7, 11)])   # path, ragged
def test_multi_gamma_solve_matches_plain(cuda, d, c, n_g):
    rng = np.random.default_rng(d)
    a = _spd_block(d, d, cuda)
    q = torch.from_numpy(rng.standard_normal((d, c))).to(cuda, torch.float32)
    gammas = torch.logspace(-4, 0, n_g, device=cuda) * float(torch.trace(a)) / d
    before = B.multi_gamma_solve.launches
    w = ops.multi_gamma_solve(a, q, gammas)
    torch.cuda.synchronize()
    assert B.multi_gamma_solve.launches == before + 1
    assert w.shape == (n_g, d, c) and torch.isfinite(w).all()
    plain = ref.multi_gamma_solve_ref(a, q, gammas)
    twin = ref.multi_gamma_blocked_ref(a, q, gammas)
    for j in range(n_g):
        assert _rel(w[j], plain[j]) < REL
        assert _rel(w[j], twin[j]) < REL
    assert torch.equal(ops.multi_gamma_solve(a, q, gammas), w)    # the same bits again


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,n_g", [(2304, 16, 16), (130, 7, 11)])   # path, ragged
def test_multi_gamma_solve_f64_matches_plain_and_twin(cuda, d, c, n_g):
    """The f64 instance against its plain version and the plain twin of its
    schedule at 1e-10; C's upper triangle is not read; the same bits again."""
    rng = np.random.default_rng(d + 64)
    a = _spd_block(d, d, cuda).double()
    q = torch.from_numpy(rng.standard_normal((d, c))).to(cuda)
    gammas = torch.logspace(-4, 0, n_g, device=cuda, dtype=torch.float64) * float(
        torch.trace(a)) / d
    w = ops.multi_gamma_solve(a, q, gammas)
    torch.cuda.synchronize()
    assert w.dtype == torch.float64 and torch.isfinite(w).all()
    plain = ref.multi_gamma_solve_ref(a, q, gammas)
    twin = ref.multi_gamma_blocked_ref(a, q, gammas)
    for j in range(n_g):
        assert _rel(w[j], plain[j]) < REL64
        assert _rel(w[j], twin[j]) < REL64
    garbage = a + torch.triu(torch.full_like(a, 7.0), 1)
    assert torch.equal(ops.multi_gamma_solve(garbage, q, gammas), w)
    assert torch.equal(ops.multi_gamma_solve(a, q, gammas), w)


@pytest.mark.cuda
def test_multi_gamma_solve_singular_gamma_gives_nan_in_that_gamma_only(cuda):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 64))).to(cuda, torch.float32)
    q = torch.from_numpy(rng.standard_normal((64, 3))).to(cuda, torch.float32)
    w = ops.multi_gamma_solve(x.T @ x, q, [0.0, 1.0])          # rank 5 at γ = 0
    torch.cuda.synchronize()
    assert not torch.isfinite(w[0]).all() and torch.isfinite(w[1]).all()


# the f64 instances against their plain versions and numpy f64: the
# x64 bar of tests/test_solve_kernels.py
REL64 = 1e-10
RANK_REL = {torch.float32: REL, torch.float64: REL64}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,k", [(2304, 64), (2304, 144), (130, 3)])   # path, budget, ragged
def test_chol_rank_update_matches_plain(cuda, d, k, dtype):
    rng = np.random.default_rng(d + k)
    a = _spd_block(d, d, cuda).to(dtype)
    l = torch.linalg.cholesky(a).contiguous()
    xs = torch.from_numpy(rng.standard_normal((k, d))).to(cuda, dtype)
    xs[k // 2] = 0.0                                  # a zero update row is a no-op
    before = R.chol_rank_update.launches
    out = ops.chol_rank_update(l, xs)
    torch.cuda.synchronize()
    assert R.chol_rank_update.launches == before + 1
    assert out.dtype == dtype
    assert torch.isfinite(out).all() and not torch.triu(out, 1).any()
    assert _rel(out, ref.chol_rank_update_ref(l, xs)) < RANK_REL[dtype]
    assert _rel(out, ref.chol_rank_update_blocked_ref(l, xs)) < RANK_REL[dtype]
    want = torch.linalg.cholesky(a.double() + xs.double().T @ xs.double())
    assert _rel(out, want) < RANK_REL[dtype]
    assert ops.chol_rank_update(l, xs[:0]) is l       # k = 0: no launch
    assert R.chol_rank_update.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_rank_update_in_passes_matches_blocked_twin(cuda, dtype):
    """k = 600 > K_PASS folds in three passes, one call; zero rows inside
    panels and in the last pass."""
    d, k = 300, 600
    rng = np.random.default_rng(k)
    a = _spd_block(d, d, cuda).to(dtype)
    l = torch.linalg.cholesky(a).contiguous()
    xs = torch.from_numpy(rng.standard_normal((k, d))).to(cuda, dtype)
    xs[[3, 4, 5, 590]] = 0.0
    before = R.chol_rank_update.launches
    out = R.chol_rank_update(l, xs)
    torch.cuda.synchronize()
    assert R.chol_rank_update.launches == before + 1 and R.cuda_launches(d, k) == 3 * 20
    twin = ref.chol_rank_update_blocked_ref(l, xs, R.NB, R.K_PASS)
    assert _rel(out, twin) < RANK_REL[dtype]
    assert _rel(out, ref.chol_rank_update_ref(l, xs)) < RANK_REL[dtype]
    want = torch.linalg.cholesky(a.double() + xs.double().T @ xs.double())
    assert _rel(out, want) < RANK_REL[dtype]


@pytest.mark.cuda
def test_chol_rank_update_carries_nan(cuda):
    l = torch.eye(40, device=cuda)
    xs = torch.ones((2, 40), device=cuda)
    xs[1, 7] = float("nan")
    out = ops.chol_rank_update(l, xs)
    torch.cuda.synchronize()
    assert torch.isnan(out).any() and torch.isfinite(out[:7, :7]).all()


@pytest.mark.cuda
def test_blocked_kernels_reject_bad_inputs(cuda):
    a = _spd_block(0, 32, cuda)[None]
    q = torch.ones((32, 2), device=cuda)
    before = _blocked_counts()
    with pytest.raises(TypeError):
        B.blocked_cholesky(a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        B.blocked_cholesky(a.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        B.blocked_cholesky(a.transpose(1, 2))
    with pytest.raises(ValueError):
        B.blocked_cholesky(a[:, :, :31])                 # not square
    with pytest.raises(ValueError):
        B.cholesky_solve(a, q[None, :31])                # b not (m, d, c)
    with pytest.raises(TypeError):
        B.cholesky_solve(a, q[None].double())
    with pytest.raises(ValueError, match="CUDA"):
        B.multi_gamma_solve(a[0], q, torch.ones(2))      # γ on the CPU
    with pytest.raises(TypeError):
        B.multi_gamma_solve(a[0], q, torch.ones(2, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        R.chol_rank_update(a[0].to(torch.bfloat16), q.T.to(torch.bfloat16))
    with pytest.raises(TypeError):
        R.chol_rank_update(a[0].double(), q.T.contiguous())    # two dtypes
    with pytest.raises(ValueError, match="CUDA"):
        R.chol_rank_update(a[0].cpu(), q.T.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        R.chol_rank_update(a[0], q.T)                    # a transposed view
    with pytest.raises(ValueError):
        R.chol_rank_update(a[0], q.T.contiguous()[:, :31])
    assert _blocked_counts() == before


def _rel_x64(a, b):
    """The reference's x64 measure: largest error over max(largest |b|, 1)."""
    a = a.double().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(64, 2), (150, 3)])    # the reference's x64 shapes
def test_blocked_kernels_f64_match_numpy(cuda, d, m):
    """blocked_cholesky and cholesky_solve in f64 against numpy f64 at 1e-10."""
    rng = np.random.default_rng(d)
    mats = []
    for i in range(m):
        x = rng.standard_normal((4 * d, d))
        mats.append(x.T @ x + (0.5 + i) * np.eye(d))
    a = np.stack(mats)
    b = rng.standard_normal((m, d, 7))
    before = _blocked_counts()
    l = ops.blocked_cholesky(torch.from_numpy(a).to(cuda))
    x = ops.cholesky_solve(l, torch.from_numpy(b).to(cuda))
    torch.cuda.synchronize()
    assert [n - o for n, o in zip(_blocked_counts(), before)] == [1, 1, 0, 0]
    assert l.dtype == x.dtype == torch.float64 and not torch.triu(l, 1).any()
    assert _rel_x64(l, np.linalg.cholesky(a)) < REL64
    assert _rel_x64(x, np.linalg.solve(a, b)) < REL64
    assert _rel(l, ref.blocked_cholesky_ref(torch.from_numpy(a).to(cuda))) < REL64


# The redesigned panel_tri_inv (invert_blocked) and blocked_cholesky (a
# panel schedule over all SMs): against the plain twins of their blocked
# arithmetic in kernels.ref and the column-loop plain versions, at REL in
# f32 and REL64 in f64.


@pytest.mark.cuda
@pytest.mark.parametrize("b,dtype", [(256, torch.float32), (200, torch.float32),
                                     (33, torch.float32), (16, torch.float32),
                                     (128, torch.float64)])
def test_panel_tri_inv_matches_blocked_twin_and_plain(cuda, b, dtype):
    rel = REL if dtype == torch.float32 else REL64
    l = ref.factor_tile(_spd_block(b, b, cuda).to(dtype))
    before = P.panel_tri_inv.launches
    z = ops.panel_tri_inv(_inside(l + torch.triu(torch.full_like(l, 7.0), 1)))
    torch.cuda.synchronize()
    assert P.panel_tri_inv.launches == before + 1
    assert z.dtype == dtype and torch.isfinite(z).all() and not torch.triu(z, 1).any()
    assert _rel(z, ref.invert_blocked_ref(l)) < rel
    assert _rel(z, ref.panel_tri_inv_ref(l)) < rel
    assert torch.equal(ops.panel_tri_inv(l), z)          # the same bits again


@pytest.mark.cuda
@pytest.mark.parametrize("b,dtype", [(256, torch.float32), (200, torch.float32),
                                     (33, torch.float32), (16, torch.float32),
                                     (128, torch.float64), (100, torch.float64)])
def test_panel_factor_matches_blocked_twin_and_plain(cuda, b, dtype):
    """The redesigned panel_factor (factor_blocked with its look-ahead,
    then invert_blocked, one launch) against the plain twin of that
    schedule and the column loops, at REL in f32 and REL64 in f64; clean
    lower triangles, the input's upper half never read, the same bits on a
    second call, NaN on a rank-3 block."""
    rel = REL if dtype == torch.float32 else REL64
    x = np.random.default_rng(b).standard_normal((4 * b, b))
    a = torch.from_numpy(x.T @ x / (4 * b)).to(cuda, dtype)
    before = P.panel_factor.launches
    l, z = ops.panel_factor(_inside(a + torch.triu(torch.full_like(a, 7.0), 1)))
    torch.cuda.synchronize()
    assert P.panel_factor.launches == before + 1
    for t in (l, z):
        assert t.dtype == dtype and torch.isfinite(t).all() and not torch.triu(t, 1).any()
    l_twin, z_twin = ref.panel_factor_blocked_ref(a)
    l_ref, z_ref = ref.panel_factor_ref(a)
    assert _rel(l, l_twin) < rel and _rel(z, z_twin) < rel
    assert _rel(l, l_ref) < rel and _rel(z, z_ref) < rel
    l2, z2 = ops.panel_factor(a)                         # no garbage above: the same bits
    assert torch.equal(l2, l) and torch.equal(z2, z)
    assert P.panel_factor.launches == before + 2
    r3 = torch.from_numpy(x[:3].T @ x[:3]).to(cuda, dtype)
    l3, z3 = ops.panel_factor(r3)
    torch.cuda.synchronize()
    assert torch.isnan(l3).any() and torch.isnan(z3).any()
    assert not torch.triu(l3, 1).any() and not torch.triu(z3, 1).any()


@pytest.mark.cuda
def test_blocked_cholesky_f64_at_path_width_matches_numpy(cuda):
    d = 1536
    x = np.random.default_rng(d).standard_normal((4 * d, d))
    a = x.T @ x / (4 * d)
    l = ops.blocked_cholesky(torch.from_numpy(a)[None].to(cuda))
    torch.cuda.synchronize()
    assert l.dtype == torch.float64 and not torch.triu(l, 1).any()
    assert _rel_x64(l[0], np.linalg.cholesky(a)) < REL64


BLOCKED_KERNELS = ("chol_", "solve_inverse_kernel", "forward_", "backward_")


# host seconds a counted call sits inside the profiler's window on each side
PROFILE_PAD_S = 0.02


def _kernel_names(fn, calls: int = 1) -> list:
    """The names of the CUDA kernels torch.profiler records in ``calls``
    synchronised calls of ``fn``, after a warm-up call outside the window.
    The calls sit PROFILE_PAD_S inside the window on each side, behind a
    throwaway kernel: the profiler keeps only the kernels whose card
    timestamps fall in its capture window, and a call right at the window's
    start lost some or all of its kernels (on an H100, 2 of 54 windows that
    opened with a warm-up step lost every kernel; none of 270 padded windows
    lost one; unpadded, short bf16 flash calls lost the window's first
    kernel, or every kernel of three calls)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        torch.ones(1, device="cuda").add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _cuda_kernels(fn, names=BLOCKED_KERNELS) -> int:
    """The kernels (by ``names``) torch.profiler counts in one synchronised
    call of ``fn`` (``_kernel_names``; ``fn`` runs twice)."""
    return sum(1 for n in _kernel_names(fn) if any(k in n for k in names))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1536), (3, 130), (1, 128)])
def test_blocked_cholesky_cuda_launches_match_profiler(cuda, m, d):
    """One wrapper call makes blocked.cuda_launches(d) CUDA launches, as
    torch.profiler counts them."""
    a = torch.stack([_spd_block(d + i, d, cuda) for i in range(m)])
    before = B.blocked_cholesky.launches
    assert _cuda_kernels(lambda: ops.blocked_cholesky(a), ("chol_",)) == B.cuda_launches(d)
    assert B.blocked_cholesky.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,c", [(1, 1536, 16), (3, 130, 7), (1, 128, 40)])
def test_cholesky_solve_cuda_launches_match_profiler(cuda, m, d, c):
    """One wrapper call makes blocked.solve_cuda_launches(d) CUDA launches."""
    l = ref.blocked_cholesky_ref(torch.stack([_spd_block(d + i, d, cuda) for i in range(m)]))
    b = torch.ones((m, d, c), device=cuda)
    before = B.cholesky_solve.launches
    assert _cuda_kernels(lambda: ops.cholesky_solve(l, b)) == B.solve_cuda_launches(d)
    assert B.cholesky_solve.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,n_g", [(2304, 16, 16), (130, 7, 11), (64, 3, 2)])
def test_multi_gamma_solve_cuda_launches_match_profiler(cuda, d, c, n_g):
    """One wrapper call makes blocked.sweep_cuda_launches(d) CUDA launches."""
    a = _spd_block(d, d, cuda)
    q = torch.ones((d, c), device=cuda)
    gammas = torch.linspace(0.1, 1.0, n_g, device=cuda)
    before = B.multi_gamma_solve.launches
    assert _cuda_kernels(lambda: ops.multi_gamma_solve(a, q, gammas)) == B.sweep_cuda_launches(d)
    assert B.multi_gamma_solve.launches == before + 2


@pytest.mark.cuda
def test_multi_gamma_solve_f64_matches_numpy_engine(cuda):
    """The reference's x64 sweep case, (d, C) = (72, 5) at five ridges, one
    multi_gamma_solve launch; then γ = 0 on fewer rows than d, which the
    kernel answers with NaN and the engine reroutes to the eigendecomposition."""
    rng = np.random.default_rng(72)
    d, c = 72, 5
    gammas = [0.0, 0.01, 0.1, 1.0, 10.0]
    eng = AnalyticEngine("torch", dtype=torch.float64, device=cuda, use_kernel=True)
    host = AnalyticEngine("numpy_f64")
    for n in (6 * d, 10):
        x = rng.standard_normal((n, d))
        y = np.eye(c)[rng.integers(0, c, n)]
        sh = host.client_stats(x, y)
        sk = SuffStats(*(eng.backend.asarray(v) for v in sh[:4]))
        before = _blocked_counts()
        ws = eng.solve_multi_gamma(sk, gammas)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_blocked_counts(), before)] == [0, 0, 1, 0]
        for w, w_h in zip(ws, host.solve_multi_gamma(sh, gammas)):
            assert w.dtype == torch.float64 and torch.isfinite(w).all()
            assert _rel_x64(w, w_h) < REL64


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["factor", "solve", "solve_multi_gamma", "rank_update"])
def test_engine_f64_kernel_routes_match_numpy_engine(cuda, call):
    """The f64 device engine on the card, at the cases of
    tests/test_torch_engine.py (d = 16, 40 rows): every route launches its
    kernel and agrees with the numpy_f64 engine at 1e-10."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((40, 16))
    y = np.eye(3)[rng.integers(0, 3, 40)]
    host = AnalyticEngine("numpy_f64")
    eng = AnalyticEngine("torch", dtype=torch.float64, device=cuda, use_kernel=True)
    s_h = host.client_stats(x, y)
    # the host's f64 statistics: the kernel route folds Gram updates in f32
    s = SuffStats(*(eng.backend.asarray(v) for v in s_h[:4]))
    before = _blocked_counts()
    if call == "factor":
        f, f_h = eng.factor(s, target_gamma=0.5), host.factor(s_h, target_gamma=0.5)
        assert _rel_x64(f.handle, f_h.handle.T) < REL64
        got, want = eng.factor_solve(f, s.moment), host.factor_solve(f_h, s_h.moment)
        launched = [1, 1, 0, 0]
    elif call == "solve":
        got, want = eng.solve(s, use_ri=False), host.solve(s_h, use_ri=False)
        launched = [1, 1, 0, 0]
    elif call == "solve_multi_gamma":
        got = torch.stack(eng.solve_multi_gamma(s, [0.1, 1.0]))
        want = np.stack(host.solve_multi_gamma(s_h, [0.1, 1.0]))
        launched = [0, 0, 1, 0]
    else:
        f, f_h = eng.factor(s), host.factor(s_h)
        got = eng.backend.rank_update(f, x[:2]).handle
        want = host.backend.rank_update(f_h, x[:2]).handle.T
        launched = [1, 0, 0, 1]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_blocked_counts(), before)] == launched
    assert got.dtype == torch.float64
    assert _rel_x64(got, want) < REL64


@pytest.mark.cuda
def test_engine_f64_streamed_route_at_2048(cuda):
    """d = 2048 in f64: the streamed schedule at panels of 128 (16 factor,
    16 trsm, 15 update and 16 inverse launches for a factor and its solve),
    against the numpy_f64 engine at 1e-10."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2560, 2048))
    y = np.eye(5)[rng.integers(0, 5, 2560)]
    host = AnalyticEngine("numpy_f64")
    eng = AnalyticEngine("torch", dtype=torch.float64, device=cuda, use_kernel=True)
    s_h = host.client_stats(x, y)
    s = SuffStats(*(eng.backend.asarray(v) for v in s_h[:4]))
    counts = lambda: [f.launches for f in (P.panel_factor, P.panel_trsm,  # noqa: E731
                                           P.panel_update, P.panel_tri_inv)]
    before = counts()
    f = eng.factor(s, target_gamma=0.5)
    w = eng.factor_solve(f, s.moment)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [16, 16, 15, 16]
    f_h = host.factor(s_h, target_gamma=0.5)
    assert not torch.triu(f.handle, 1).any()
    assert _rel_x64(f.handle, f_h.handle.T) < REL64
    assert _rel_x64(w, host.factor_solve(f_h, s_h.moment)) < REL64


@pytest.mark.cuda
def test_engine_narrow_sweep_and_rank_update_on_card(cuda):
    """AnalyticEngine(use_kernel=True) below STREAM_MIN_DIM: one
    blocked_cholesky and one cholesky_solve launch per solve, one
    multi_gamma_solve launch per γ grid, one chol_rank_update launch per
    factor update; each answer agrees with the host f64 engine."""
    rng = np.random.default_rng(21)
    d, c, n = 300, 5, 1200
    x = rng.standard_normal((n, d))
    y = np.eye(c)[rng.integers(0, c, n)]
    eng = AnalyticEngine("torch", device=cuda, use_kernel=True)
    host = AnalyticEngine("numpy_f64")
    s = eng.client_stats(x[:-8], y[:-8])
    s_h = host.client_stats(x[:-8], y[:-8])
    before = _blocked_counts()
    w = eng.solve(s, target_gamma=1.0)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_blocked_counts(), before)] == [1, 1, 0, 0]
    assert _rel(w.cpu(), torch.from_numpy(host.solve(s_h, target_gamma=1.0))) < REL
    gammas = [0.1, 1.0, 10.0]
    ws = eng.solve_multi_gamma(s, gammas)
    assert [a - b for a, b in zip(_blocked_counts(), before)] == [1, 1, 1, 0]
    for w, w_h in zip(ws, host.solve_multi_gamma(s_h, gammas)):
        assert _rel(w.cpu(), torch.from_numpy(w_h)) < REL
    f = eng.factor(s, target_gamma=1.0)
    s2 = eng.merge(s, eng.client_stats(x[-8:], y[-8:]))
    f2 = eng.factor_update(f, s2, x[-8:], target_gamma=1.0)
    assert [a - b for a, b in zip(_blocked_counts(), before)] == [2, 1, 1, 1]
    s2_h = host.merge(s_h, host.client_stats(x[-8:], y[-8:]))
    want = host.solve(s2_h, target_gamma=1.0)
    assert _rel(eng.factor_solve(f2, s2.moment).cpu(), torch.from_numpy(want)) < REL


# --- flash attention ----------------------------------------------------------

ATTN_TOL = {torch.float32: (2e-5, 4e-4)}
# the bf16 instance (the tensor cores: flash_attention.regime) against the
# plain version in f32 on the same bf16 inputs: within this share of the
# plain output's largest |value| (products exact, sums in f32, P and the
# output each rounded once to bf16: 2.0e-3–3.4e-3 of it in the plain twins).
# tests/test_kernels_attention.py's bf16 atol of 0.4 is above every output of
# a softmax average over a few hundred keys, so it could not fail a wrong
# kernel.
ATTN_BF16_REL = 1e-2
# ... and against the plain twin of its own schedule (ref.mha_tile_bf16_ref,
# ref.mha_split_bf16_ref): twice the largest reading on an H100 (3.76e-3),
# up to one bf16 ulp of the largest value (2^-7 of it), by which the kernel
# and the twin may round an output apart (chip_smoke.py's TWIN_BF16_REL)
TWIN_BF16_REL = 8e-3


def _attn_inputs(seed, b, hq, hkv, sq, skv, d, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(device, dtype)
                 for shape in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])


def _bf16_check(out, q, k, v, **kw):
    """A bf16 kernel output against the plain version in f32 on the same
    inputs within ``ATTN_BF16_REL``, and against its schedule's twin within
    ``TWIN_BF16_REL``, of the plain output's largest |value|."""
    want = ref.mha_ref(q.float(), k.float(), v.float(), **kw)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    top = float(want.abs().max())
    assert float((out.float() - want).abs().max()) <= ATTN_BF16_REL * top
    twin = ref.mha_bf16_schedule_ref(q, k, v, sms=FA.sm_count(q.device.index), **kw)
    assert float((out.float() - twin.float()).abs().max()) <= TWIN_BF16_REL * top


def _attn_check(q, k, v, **kw):
    before = FA.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    if q.dtype == torch.bfloat16:
        _bf16_check(out, q, k, v, **kw)
        return
    want = ref.mha_ref(q, k, v, **kw)
    assert out.shape == want.shape and out.dtype == want.dtype
    rtol, atol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)


# the cases of tests/test_kernels_attention.py: (b, hq, hkv, sq, skv, d), kw
ATTN_CASES = [
    ((1, 4, 4, 128, 128, 64), dict(causal=True)),            # MHA
    ((2, 8, 2, 128, 128, 64), dict(causal=True)),            # GQA 4:1
    ((1, 4, 1, 96, 96, 80), dict(causal=True)),              # MQA, ragged seq and head dim
    ((1, 2, 2, 256, 256, 128), dict(causal=True)),
    ((1, 4, 4, 128, 128, 64), dict(causal=False)),
    ((1, 4, 2, 192, 192, 64), dict(causal=True, window=32)),
    ((1, 4, 2, 192, 192, 64), dict(causal=True, window=64)),
    ((1, 4, 2, 192, 192, 64), dict(causal=True, window=100)),
    ((2, 8, 2, 1, 256, 64), dict(causal=True, q_offset=255)),              # decode
    ((1, 4, 4, 1, 300, 64), dict(causal=True, window=128, q_offset=299)),  # decode, window
    ((1, 4, 4, 64, 200, 64), dict(causal=False)),            # cross attention, rectangular
    ((1, 2, 2, 64, 64, 64), dict(causal=True, scale=0.25)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", ATTN_CASES)
def test_flash_attention_matches_plain(cuda, shape, kw, dtype):
    _attn_check(*_attn_inputs(7, *shape, dtype, cuda), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((4, 16, 8, 2048, 2048, 256), dict(window=1024)),         # gemma3_12b prefill, local
    ((4, 16, 8, 2048, 2048, 256), dict()),                    # and global
    ((4, 16, 8, 1, 2064, 256), dict(window=1024, q_offset=2048)),   # its decode step
    ((4, 16, 8, 1, 2064, 256), dict(q_offset=2048)),
    ((64, 36, 36, 32, 32, 64), dict()),                       # minicpm_2b trainer forward
    ((1, 8, 2, 77, 77, 256), dict(window=20)),                # ragged at D = 256
    ((2, 4, 4, 5, 40, 200), dict(q_offset=100, window=50)),   # rows past every key: zeros
])
def test_flash_attention_main_path_shapes(cuda, shape, kw):
    _attn_check(*_attn_inputs(8, *shape, torch.float32, cuda), **kw)


# the bf16 instance at the model paths' shapes: (b, hq, hkv, sq, skv, d), kw
BF16_MODEL_CASES = [
    ((64, 64, 8, 32, 32, 128), dict()),                         # qwen3_32b's run_analytic forward
    ((2, 16, 8, 1024, 1024, 256), dict(window=512)),            # gemma3-like prefill at D 256
    ((1, 8, 4, 300, 300, 256), dict()),                         # D 256, ragged tiles
    ((2, 48, 8, 256, 256, 128), dict(softcap=30.0)),            # grok1's cap: the wgmma tile
    ((4, 48, 8, 1, 520, 128), dict(q_offset=518, softcap=30.0)),  # ... and the mma decode
    ((2, 48, 8, 2, 520, 128), dict(q_offset=517, softcap=30.0, window=64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", BF16_MODEL_CASES)
def test_flash_attention_bf16_model_shapes(cuda, shape, kw):
    """The bf16 instance against the plain version in f32 and its schedule's
    twin; a softcap's q is scaled up so that the logits reach the cap's
    bend."""
    q, k, v = _attn_inputs(14, *shape, torch.bfloat16, cuda)
    if kw.get("softcap"):
        q = (q.float() * 8).to(torch.bfloat16)
    _attn_check(q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((2, 16, 2, 300, 300, 128), dict()),                        # wgmma tile
    ((2, 4, 1, 8, 100, 64), dict(q_offset=92)),                 # 32 rows: the wgmma tile
    ((4, 64, 8, 1, 528, 128), dict(q_offset=526)),              # mma decode, chunks + merge
    ((1, 4, 4, 1, 20, 64), dict(q_offset=19)),                  # mma decode, one chunk
])
def test_bf16_flash_runs_the_tensor_core_kernels(cuda, shape, kw):
    """One bf16 call launches its regime's tensor-core kernel (and the
    merge for several chunks) by name, and no FFMA instance
    (flash_tile_kernel, flash_decode_kernel); the same shape in f32 still
    runs the FFMA kernel."""
    b, hq, hkv, sq, skv, d = shape
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_inputs(15, *shape, dtype, cuda)
        kind = FA.regime(dtype, hq // hkv * sq)
        seen = [n for n in _kernel_names(lambda: FA.flash_attention(q, k, v, **kw), 10)
                if "flash_" in n]
        want = {FA.KERNELS[kind]}
        if _cuda_launches(q, k, **kw) == 2:
            want.add(FA.MERGE_KERNEL)
        assert {w for w in want if any(w in n for n in seen)} == want
        assert all(any(w in n for w in want) for n in seen), seen
        names[dtype] = seen
    assert not any("flash_tile_kernel" in n or "flash_decode_kernel" in n
                   for n in names[torch.bfloat16])


@pytest.mark.cuda
def test_flash_attention_reads_strided_heads(cuda):
    """The head views of models.layers (a transposed (B, S, H, D)) go in
    without a copy and give what their contiguous copies give."""
    rng = np.random.default_rng(9)
    b, s, hq, hkv, d = 2, 70, 8, 4, 128
    x = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(cuda)
         for h in (hq, hkv, hkv)]
    q, k, v = (t.transpose(1, 2) for t in x)
    assert not q.is_contiguous()
    out = FA.flash_attention(q, k, v, window=33)
    want = FA.flash_attention(*(t.contiguous() for t in (q, k, v)), window=33)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    _attn_check(q, k, v, window=33)
    _attn_check(q[:, :, 1:], k, v, q_offset=1)          # an offset view: scalar loads


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs(cuda):
    q, k, v = _attn_inputs(10, 1, 4, 2, 8, 8, 64, torch.float32, cuda)
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(TypeError):
        FA.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        FA.flash_attention(q[:, :3], k, v)                 # 3 query heads over 2 kv heads
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    big = torch.zeros((1, 2, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="softcap"):
        FA.flash_attention(q, k, v, softcap=-30.0)
    assert FA.flash_attention.launches == before


@pytest.mark.cuda
def test_sdpa_on_card_is_the_kernel(cuda):
    """models.layers.sdpa on CUDA tensors goes through the kernel (window <= 0
    meaning none), a logit softcap included: softcap 30 (grok1's) in each of
    the kernel's regimes, against the plain version and, at decode shapes,
    the split-KV twin. q is scaled up so that the logits reach the cap's
    bend; the cap changes the result by far more than the tolerance."""
    from repro_torch.models import layers as L
    q, k, v = _attn_inputs(11, 2, 4, 2, 24, 24, 32, torch.float32, cuda)
    before = FA.flash_attention.launches
    for window, want_window in [(0, None), (None, None), (7, 7)]:
        out = L.sdpa(q, k, v, window=window)
        torch.testing.assert_close(out, ref.mha_ref(q, k, v, window=want_window),
                                   rtol=2e-5, atol=4e-4)
    assert FA.flash_attention.launches == before + 3
    # (b, hq, hkv, sq, skv, d), kw: prefill tile, short tile, split decode (chunks,
    # non-causal, windowed), at grok1's group of 6 and D = 128
    for i, (shape, kw) in enumerate([
            ((1, 6, 1, 80, 80, 128), dict(causal=True)),
            ((2, 6, 1, 5, 40, 128), dict(causal=True, q_offset=35)),
            ((2, 6, 1, 1, 700, 128), dict(causal=True, q_offset=699)),
            ((1, 16, 16, 1, 300, 64), dict(causal=False)),
            ((1, 6, 1, 2, 500, 128), dict(causal=True, window=100, q_offset=498))]):
        q, k, v = _attn_inputs(40 + i, *shape, torch.float32, cuda)
        q = q * 8
        before = FA.flash_attention.launches
        out = L.sdpa(q, k, v, softcap=30.0, window=kw.get("window", 0),
                     q_offset=kw.get("q_offset", 0), causal=kw["causal"])
        torch.cuda.synchronize()
        assert FA.flash_attention.launches == before + 1
        want = ref.mha_ref(q, k, v, softcap=30.0, **kw)
        torch.testing.assert_close(out, want, rtol=2e-5, atol=4e-4)
        if shape[1] // shape[2] * shape[3] <= FA.DECODE_MAX_ROWS:
            twin = ref.mha_split_ref(q, k, v, softcap=30.0, sms=torch.cuda.get_device_properties(
                cuda).multi_processor_count, **kw)
            torch.testing.assert_close(out, twin, rtol=2e-5, atol=4e-4)
        assert float((ref.mha_ref(q, k, v, **kw) - want).abs().max()) > 0.04


# the training path's attention shapes (chip_smoke.py's training phase):
# (B, Hq, Hkv, S, S, D), kw
GRAD_ATTN_CASES = [
    ((4, 36, 36, 256, 256, 64), dict(causal=True)),                  # run_lm's minicpm_2b
    ((1, 16, 8, 512, 512, 256), dict(causal=True, window=128)),      # gemma3_12b-like
    ((1, 48, 8, 256, 256, 128), dict(causal=True, softcap=30.0)),    # grok1's cap
    ((2, 16, 16, 512, 512, 64), dict(causal=False)),                 # seamless's encoder
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", GRAD_ATTN_CASES)
def test_flash_sdpa_under_grad_matches_plain_autograd(cuda, shape, kw):
    """models.layers.sdpa under grad on the card: the flash kernel's forward
    (one launch) inside FlashSDPA, its output and dq, dk, dv against
    autograd of sdpa_plain at rtol 1e-4 / atol 1e-4 of the largest entry."""
    from repro_torch.models import layers as L
    q, k, v = (t.requires_grad_(True) for t in _attn_inputs(60, *shape, torch.float32, cuda))
    g = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(61), device=cuda)
    before = FA.flash_attention.launches
    out = L.sdpa(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert isinstance(out.grad_fn, L.FlashSDPA._backward_cls)
    want = L.sdpa_plain(q, k, v, **kw)
    ref_grads = torch.autograd.grad(want, (q, k, v), g)
    for a, b in zip((out.detach(), *got), (want.detach(), *ref_grads)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_raw_flash_wrapper_raises_under_grad(cuda):
    q, k, v = _attn_inputs(62, 1, 2, 2, 8, 8, 64, torch.float32, cuda)
    before = FA.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k.requires_grad_(True), v)
    with torch.no_grad():
        FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before + 1


@pytest.mark.cuda
def test_full_train_step_on_card_matches_cpu(cuda):
    """launch.steps.make_full_train_step (reduced minicpm_2b, lr 1e-2) on the
    card, two flash launches (the forward of each layer; the backward
    recomputes the plain attention), against the same step on the CPU: the
    loss within rtol 1e-5, each leaf's Δp within 1e-3 of its largest plus
    one f32 spacing of the parameter (each device rounds p − lr·g once)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.inputs import sample_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import tree_leaves

    cfg = get_config("minicpm_2b").reduced()
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    p_gpu = _tree_to(p_cpu, cuda)
    old = [p.clone() for p in tree_leaves(p_cpu)]
    step = STEPS.make_full_train_step(cfg)
    before = FA.flash_attention.launches
    _, loss_gpu = step(p_gpu, sample_batch(cfg, 2, 32, seed=0, device=cuda), 1e-2)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + cfg.num_layers
    _, loss_cpu = step(p_cpu, sample_batch(cfg, 2, 32, seed=0, device="cpu"), 1e-2)
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-5, atol=0)
    for o, a, b in zip(old, tree_leaves(p_gpu), tree_leaves(p_cpu)):
        assert a.is_cuda and not a.requires_grad
        dp, dr = a.cpu().double() - o.double(), b.double() - o.double()
        tol = 1e-3 * float(dr.abs().max()) + torch.from_numpy(
            np.spacing(np.abs(b.numpy()))).double()
        assert bool(((dp - dr).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "grok1_314b", "zamba2_7b",
                                  "xlstm_350m", "seamless_m4t_medium"])
def test_zoo_serve_on_card_matches_cpu(cuda, arch):
    """launch.serve.serve of each other family at 5 layers (two groups and a
    tail for hybrid and xLSTM): the card gives the CPU's tokens and logits
    within rtol 1e-4 / atol 1e-4 of the largest |logit|, every attention
    call the kernel (none for xLSTM)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T

    cfg = get_config(arch).reduced(num_layers=5)
    p_cpu = T.init_params(cfg, seed=3, device="cpu")
    p_gpu = _tree_to(p_cpu, cuda)
    runs = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        seen = []
        before = FA.flash_attention.launches
        toks, _, _ = SV.serve(cfg, 2, 40, 6, seed=3, device=dev, params=params,
                              on_step=lambda i, lg: seen.append(lg.cpu()))
        runs[dev] = (toks, torch.stack(seen, 1), FA.flash_attention.launches - before)
    (tg, lg, ng), (tc, lc, nc) = runs["cuda"], runs["cpu"]
    assert nc == 0 and (ng > 0) == (cfg.arch_type != "xlstm")
    np.testing.assert_array_equal(tg, tc)
    top = float(lc.abs().max())
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4 * top)


@pytest.mark.cuda
def test_reduced_serve_on_card_matches_cpu(cuda):
    """launch.serve.serve of reduced gemma3_12b (a local layer with window 32
    and a global one, GQA, qk-norm, a prompt of twice the window): the card
    (every attention call the kernel, 2 prefill + 2 × 7 decode launches)
    gives the CPU's tokens, and logits within rtol 1e-4 / atol 1e-4 of the
    largest |logit|."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T

    cfg = get_config("gemma3_12b").reduced()
    p_cpu = T.init_params(cfg, seed=3, device="cpu")
    p_gpu = _tree_to(p_cpu, cuda)
    runs = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        seen = []
        before = FA.flash_attention.launches
        toks, _, _ = SV.serve(cfg, 2, 64, 8, seed=3, device=dev, params=params,
                              on_step=lambda i, lg: seen.append(lg.cpu()))
        runs[dev] = (toks, torch.stack(seen, 1), FA.flash_attention.launches - before)
    (tg, lg, ng), (tc, lc, nc) = runs["cuda"], runs["cpu"]
    assert (ng, nc) == (cfg.num_layers * 8, 0)
    np.testing.assert_array_equal(tg, tc)
    top = float(lc.abs().max())
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4 * top)


# --- gram_update's tiles and flash_attention's regimes ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,dtype", [
    (1, 2304, 16, torch.float32),      # N = 1
    (64, 2304, 16, torch.float32),     # the main path's per-batch shape
    (300, 130, 70, torch.float32),     # d not a tile multiple, C above a tile
    (7, 33, 5, torch.float32),         # d below a tile and odd: value-by-value copies
    (100, 200, 37, torch.bfloat16),
    (8000, 128, 40, torch.float32),    # 5 tiles: N split 50 ways, then reduced
    (2048, 384, 128, torch.bfloat16),  # 33 tiles, 8 splits
])
def test_gram_kernel_upper_tiles_are_symmetric_and_match_plain(cuda, n, d, c, dtype):
    """The upper-tile kernel: G exactly symmetric (the mirror is a copy), G
    and Q within the Gram tolerances of the plain version and of the
    schedule's twin, the same bits on a repeated call."""
    x, y = _data(5, n, d, c, dtype, cuda)
    before = G.gram_update.launches
    g, q = G.gram_update(x, y)
    g2, q2 = G.gram_update(x, y)
    torch.cuda.synchronize()
    assert G.gram_update.launches == before + 2
    assert torch.equal(g, g.T)
    assert torch.equal(g, g2) and torch.equal(q, q2)
    rtol, atol = TOL[dtype]
    for g_ref, q_ref in (ref.gram_ref(x, y), ref.gram_upper_ref(x, y)):
        torch.testing.assert_close(g, g_ref, rtol=rtol, atol=atol)
        torch.testing.assert_close(q, q_ref, rtol=rtol, atol=atol)


def _cuda_launches(q, k, **kw):
    """The kernels a flash call launches: two for a decode split into
    several chunks, else one."""
    b, hq, sq, _ = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq // hkv * sq > FA.DECODE_MAX_ROWS:
        return 1
    splits = FA.decode_plan(b, hkv, sq, skv, causal=kw.get("causal", True),
                            window=kw.get("window"), q_offset=kw.get("q_offset", 0),
                            sms=torch.cuda.get_device_properties(q.device).multi_processor_count)[3]
    return 2 if splits > 1 else 1


# each side of each regime's edge: (b, hq, hkv, sq, skv, d), kw
REGIME_CASES = [
    ((2, 8, 1, 2, 300, 128), dict(q_offset=298)),             # 16 rows: split decode
    ((2, 17, 1, 1, 300, 128), dict(q_offset=299)),            # 17 rows: the short tile
    ((2, 4, 1, 8, 100, 64), dict(q_offset=92)),               # 32 rows: the short tile
    ((2, 11, 1, 3, 100, 64), dict(q_offset=97)),              # 33 rows: the prefill tile
    ((1, 4, 4, 1, 20, 64), dict(q_offset=19)),                # Skv below one chunk: one split
    ((1, 4, 4, 1, 3000, 256), dict(q_offset=2999)),           # many splits, D = 256
    ((2, 8, 1, 1, 1, 64), dict(q_offset=0)),                  # a one-key cache
    ((1, 8, 1, 1, 500, 80), dict(window=12, q_offset=499)),   # a group of 8, window in one chunk
    ((2, 4, 4, 1, 40, 64), dict(window=50, q_offset=100)),    # rows past every key: zeros
    ((1, 2, 2, 1, 333, 64), dict(causal=False)),              # the whole cache, 333 keys
    ((64, 36, 36, 32, 32, 64), dict()),                       # the trainer's forward
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", REGIME_CASES)
def test_flash_attention_regimes_match_plain(cuda, shape, kw, dtype):
    q, k, v = _attn_inputs(12, *shape, dtype, cuda)
    want = _cuda_launches(q, k, **kw)
    before = FA.flash_attention.cuda_launches
    _attn_check(q, k, v, **kw)
    assert FA.flash_attention.cuda_launches == before + want
    out = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, FA.flash_attention(q, k, v, **kw))     # the same bits again


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_reads_the_kv_cache_in_place(cuda, dtype):
    """The decode step's operands (models/transformer.py): q a transposed
    (B, 1, Hq, hd) view, k and v one layer of the stacked (L, B, Hkv,
    max_seq, hd) cache, slots past the position not yet written. The kernel
    reads them in place and gives what their contiguous copies give."""
    rng = np.random.default_rng(13)
    layers, b, hq, hkv, max_seq, hd, pos = 3, 4, 16, 8, 600, 256, 517
    cache = {n: torch.zeros((layers, b, hkv, max_seq, hd), device=cuda, dtype=dtype)
             for n in ("k", "v")}
    for n in cache:
        cache[n][:, :, :, :pos + 1] = torch.from_numpy(
            rng.standard_normal((layers, b, hkv, pos + 1, hd)).astype(np.float32)).to(cuda, dtype)
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, hd)).astype(np.float32)).to(
        cuda, dtype).transpose(1, 2)
    for kw in (dict(q_offset=pos), dict(q_offset=pos, window=128)):
        k, v = cache["k"][1], cache["v"][1]
        out = ops.flash_attention(q, k, v, **kw)
        want = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        _attn_check(q, k, v, **kw)


# --- the paper's round: core/streaming, the analytic train step, fl/afl --------

@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c", [(37, 2304, 16), (1000, 200, 37), (5, 64, 3)])
def test_update_state_kernel_on_card_matches_cpu(cuda, n, d, c):
    """streaming.update_state(use_kernel=True) on a card state: one Gram
    launch a batch, the state stays on the card, and it agrees with the same
    folds on the CPU (the kernel's plain version) at the Gram tolerances."""
    from repro_torch.core import streaming as ST

    batches = [_data(s, m, d, c, torch.float32, "cpu") for s, m in ((0, n), (1, 64))]
    states = {}
    for dev in (cuda, torch.device("cpu")):
        s = ST.init_state(d, c, device=dev)
        before = G.gram_update.launches
        for x, y in batches:
            s = ST.update_state(s, x.to(dev), y.to(dev), use_kernel=True)
        states[dev.type] = (s, G.gram_update.launches - before)
    (sg, ng), (sc, nc) = states["cuda"], states["cpu"]
    assert (ng, nc) == (2, 0)
    assert all(a.is_cuda and a.dtype == torch.float32 for a in sg)
    rtol, atol = TOL[torch.float32]
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a.cpu(), b, rtol=rtol, atol=atol)
    w = ST.solve(ST.merge_states(sg, sg), 1.0)
    assert w.is_cuda and torch.isfinite(w).all()


@pytest.mark.cuda
def test_analytic_train_step_on_card_matches_cpu(cuda):
    """launch.steps.make_analytic_train_step (reduced minicpm_2b, use_kernel)
    over three batches, the last ragged: on the card one Gram launch a batch
    and the flash kernel in every layer; the state agrees with the CPU's at
    rtol 1e-4 / atol 1e-4 of the largest entry (f32 forwards in another
    order)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import streaming as ST
    from repro_torch.data import synthetic as D
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as T

    cfg = get_config("minicpm_2b").reduced(num_classes=8)
    ds = D.token_classification(n=180, seq=16, vocab=cfg.vocab_size, num_classes=8,
                                seed=0)
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    step = STEPS.make_analytic_train_step(cfg, use_kernel=True)
    runs = {}
    for dev, params in ((cuda, _tree_to(p_cpu, cuda)), (torch.device("cpu"), p_cpu)):
        s = ST.init_state(cfg.d_model, 8, device=dev)
        g0, f0 = G.gram_update.launches, FA.flash_attention.launches
        for i in range(0, len(ds), 64):
            s = step(params, s, {"tokens": ds.x[i:i + 64], "labels": ds.y[i:i + 64]})
        runs[dev.type] = (s, G.gram_update.launches - g0, FA.flash_attention.launches - f0)
    (sg, gg, fg), (sc, gc, fc) = runs["cuda"], runs["cpu"]
    assert (gg, fg, gc, fc) == (3, cfg.num_layers * 3, 0, 0)
    assert float(sg.count) == float(sc.count) == 180.0
    for a, b in zip(sg, sc):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_run_afl_through_a_backbone_on_card_matches_cpu(cuda):
    """fl.afl.run_afl(backbone_fn=…) with reduced minicpm_2b on the card:
    every forward's attention is the flash kernel, the embeddings agree with
    the CPU's at rtol 1e-4 / atol 1e-4, the accuracy equals the card's own
    joint_ridge (the paper's invariance) and the CPU run's within one test
    sample."""
    from repro_torch.config import FLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic as D
    from repro_torch.fl import afl
    from repro_torch.models import transformer as T

    cfg = get_config("minicpm_2b").reduced(num_classes=8)
    ds = D.token_classification(n=240, seq=16, vocab=cfg.vocab_size, num_classes=8,
                                skew=4.0, seed=0)
    train, test = D.train_test_split(ds, 0.25, seed=0)
    p_cpu = T.init_params(cfg, seed=0, device="cpu")
    fl = FLConfig(num_clients=12, partition="niid2", shards_per_client=2)
    runs = {}
    for dev, params in (("cuda", _tree_to(p_cpu, cuda)), ("cpu", p_cpu)):
        def backbone(tokens, params=params):
            return T.pool(T.forward(params, cfg, {"tokens": tokens}))
        before = FA.flash_attention.launches
        res = afl.run_afl(train, test, fl, backbone_fn=backbone)
        launches = FA.flash_attention.launches - before
        _, acc_joint = afl.joint_ridge(train, test, gamma=0.0, backbone_fn=backbone)
        runs[dev] = (res, launches, acc_joint, afl.embed_with_backbone(backbone, test.x))
    (rg, ng, jg, eg), (rc, nc, jc, ec) = runs["cuda"], runs["cpu"]
    # one forward a batch of 256: the train set's one, the test set's one
    assert (ng, nc) == (cfg.num_layers * 2, 0)
    np.testing.assert_allclose(eg, ec, rtol=1e-4, atol=1e-4)
    assert rg.accuracy == jg and rc.accuracy == jc
    assert abs(rg.accuracy - rc.accuracy) * len(test) <= 1


# --- federation serving: the client on the card, the server on the host --------

@pytest.mark.cuda
@pytest.mark.parametrize("coordinator", ["sync", "async"])
def test_run_analytic_posts_to_a_federation_service(cuda, tmp_path, coordinator):
    """launch.train.run_analytic(server_url=…) with reduced minicpm_2b and
    use_kernel=True: the client folds on the card (one Gram launch a batch,
    the flash kernel in every layer) and posts one report to a port
    FederationService over HTTP; the service's head is bit for bit what an
    in-process AFLServer solves from the report its ledger recorded, and the
    accuracy is that of the same run against an in-process server."""
    from repro_torch.config import FLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic as D
    from repro_torch.fl import (AFLServer, AsyncAFLServer, ClientReport,
                                FederationService, RemoteCoordinator, serve_http)
    from repro_torch.fl.replication import LedgerTailer
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    cfg = get_config("minicpm_2b").reduced(num_classes=8)
    ds = D.token_classification(n=320, seq=16, vocab=cfg.vocab_size, num_classes=8,
                                seed=0)
    tr, te = D.train_test_split(ds, 0.25, seed=0)
    params = T.init_params(cfg, seed=0, device=cuda)
    fl = FLConfig(gamma=1.0)
    local = AFLServer(cfg.d_model, 8, gamma=1.0)
    acc_local, _ = train.run_analytic(cfg, tr, te, fl, 64, use_kernel=True,
                                      device=cuda, params=params, coordinator=local)
    coord = (AFLServer if coordinator == "sync" else AsyncAFLServer)(cfg.d_model, 8,
                                                                      gamma=1.0)
    svc = FederationService(coord, ledger_dir=tmp_path)
    try:
        with serve_http(svc) as srv:
            g0, f0 = G.gram_update.launches, FA.flash_attention.launches
            acc, _ = train.run_analytic(cfg, tr, te, fl, 64, use_kernel=True,
                                        device=cuda, params=params, server_url=srv.url)
            launches = (G.gram_update.launches - g0, FA.flash_attention.launches - f0)
            rc = RemoteCoordinator(srv.url)
            try:
                w_remote = rc.solve()
            finally:
                rc.close()
    finally:
        svc.close()
    forwards = len(tr) // 64 + len(te) // 64
    assert launches == (len(tr) // 64, cfg.num_layers * forwards)
    (record,) = LedgerTailer(tmp_path).poll()
    oracle = AFLServer(cfg.d_model, 8, gamma=1.0)
    oracle.submit(ClientReport.from_bytes(record[2]))
    np.testing.assert_array_equal(w_remote, oracle.solve())
    np.testing.assert_allclose(w_remote, local.solve(), rtol=1e-4,
                               atol=1e-4 * float(np.abs(local.solve()).max()))
    assert acc == acc_local


# --- the sharded coordinator's tile-parallel solve -------------------------------
#
# core.distributed runs one thread a shard; here eight shards share one card,
# so the panel kernels run from eight threads at once on its stream.

SHARDED_COUNTS = {torch.float32: [128, 128, 120, 0], torch.float64: [192, 192, 184, 0]}


def _panel_counts():
    return [f.launches for f in (P.panel_factor, P.panel_trsm, P.panel_update,
                                 P.panel_tri_inv)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tiled_solve_8_shards_on_one_card(cuda, dtype):
    """d = 2304 as 8 row tiles of 288 on cuda:0 through the distributed
    factor: panels of 144 in f32 (16) and 96 in f64 (24), so the kernels
    launch n·P / n·P / n·(P−1) times and panel_tri_inv never; the weight
    matches the plain route on the card (f32: relative 1e-4) and numpy
    (f64: 1e-10), and a second solve gives the same bits."""
    from repro_torch.core import distributed as DD

    d, c, n = 2304, 16, 8
    x, y = _data(11, 4 * d, d, c, torch.float64, cuda)
    g, q = (x.T @ x).to(dtype), (x.T @ y).to(dtype)
    fn = DD.make_tiled_federated_solve(DD.federation_mesh(n, [cuda]), target_gamma=0.5,
                                       distributed_factor=True, dtype=dtype)
    tiles, moments = g.reshape(n, d // n, d), q.reshape(n, d // n, c)
    before = _panel_counts()
    w = fn(tiles, moments)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_panel_counts(), before)] == SHARDED_COUNTS[dtype]
    assert w.dtype == dtype and w.device.type == "cuda" and w.shape == (d, c)
    assert torch.equal(fn(tiles, moments), w)
    assert torch.equal(tiles.reshape(d, d), g)     # each shard factors its own upload
    a = g + 0.5 * torch.eye(d, dtype=dtype, device=cuda)
    if dtype == torch.float32:
        w_plain = S.streamed_cholesky_solve(S.streamed_cholesky(a, use_kernel=False), q,
                                            use_kernel=False)
        assert _rel(w, w_plain) < 1e-4
    else:
        w_np = np.linalg.solve(a.cpu().numpy(), q.cpu().numpy())
        assert _rel(w.cpu(), torch.from_numpy(w_np)) < 1e-10


@pytest.mark.cuda
def test_sharded_coordinator_on_one_card(cuda):
    """ShardedCoordinator(tiled_gram=True, num_shards=8) on cuda:0, padded
    (d = 300 over 8 shards of 40 rows), against the host f64 oracle."""
    from repro_torch.fl import AFLServer, ShardedCoordinator, make_report

    d, c = 300, 6
    rng = np.random.default_rng(3)
    reps = [make_report(k, rng.standard_normal((200, d)),
                        np.eye(c)[rng.integers(0, c, 200)], 1.0) for k in range(4)]
    oracle = AFLServer(d, c, gamma=1.0)
    oracle.submit_many(reps)
    for dtype, bar in ((torch.float32, 1e-3), (torch.float64, 1e-10)):
        coord = ShardedCoordinator(d, c, tiled_gram=True, num_shards=8, devices=[cuda],
                                   dtype=dtype)
        assert coord.mesh == (torch.device("cuda", 0),) * 8
        coord.submit_many(reps)
        w = coord.solve(0.5)
        np.testing.assert_array_equal(coord.solve(0.5), w)
        assert coord.host_fallbacks == 0           # the card's answer, not the host's
        assert np.abs(w - oracle.solve(0.5)).max() < bar * np.abs(oracle.solve(0.5)).max()


@pytest.mark.cuda
def test_failing_shard_on_the_card_raises_without_hanging(cuda):
    """Shard 3 launches panel_factor on a block wider than the kernel
    takes while the others wait in a collective on the card: the caller
    gets that ValueError at once, and the card still works."""
    import time

    from repro_torch.core import distributed as DD

    def body(s):
        col = s.gather(torch.full((4, 4), float(s.index), device=s.device))
        if s.index == 3:
            P.panel_factor(torch.eye(300, device=s.device))
        return s.psum(col.sum())

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="panel width 300"):
        DD.ShardGroup(DD.federation_mesh(8, [cuda])).run(body)
    assert time.perf_counter() - t0 < 10.0
    totals = DD.ShardGroup(DD.federation_mesh(8, [cuda])).run(
        lambda s: s.psum(torch.ones((), device=s.device)))
    assert [float(t) for t in totals] == [8.0] * 8


# --- the dry run against the card ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_static_bytes_and_flops_identity(cuda, kind):
    """A reduced step's prediction (a meta walk, the flash variant) against
    the same step on the card: the static bytes are the tensors', and the
    walk's flops are the card's ``FlopCounterMode`` count (blind to the
    extension kernels) + ``attention_flops`` + the Gram kernel's
    2·N·d·(d + C)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as DR

    cfg = get_config("gemma3_12b").reduced()
    shape = InputShape("t", 48, 3, kind)
    pred = DR.step_cost(cfg, shape, "flash", use_kernel=True)
    fn, args, static = DR.build_step(cfg, shape, "flash", device=cuda, use_kernel=True)
    FA.flash_attention.launches = G.gram_update.launches = 0
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
        torch.cuda.synchronize()
    card = {k: CA.storage_bytes(v, cuda) for k, v in static.items() if k != "cache"}
    if kind == "prefill":
        card["cache"] = CA.storage_bytes(out[1], cuda)
    elif kind == "decode":
        card["cache"] = CA.storage_bytes(static["cache"], cuda)
    assert card == pred["static"]
    gram = 2 * 3 * cfg.d_model * (cfg.d_model + cfg.num_classes) if kind == "train" else 0
    assert pred["cost"].flops == fc.get_total_flops() + int(pred["attn_flops"]) + gram
    assert FA.flash_attention.launches == cfg.num_layers
    assert G.gram_update.launches == (kind == "train")


@pytest.mark.cuda
def test_meta_init_params_next_to_cuda_init(cuda):
    """``init_params(device="meta")``: the CUDA draw's tree, shapes and
    dtypes, and a CUDA draw after it the same bits as before it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import tree_leaves

    cfg = get_config("zamba2_7b").reduced()
    first = tree_leaves(T.init_params(cfg, seed=1, device=cuda))
    meta = tree_leaves(T.init_params(cfg, seed=1, device="meta"))
    again = tree_leaves(T.init_params(cfg, seed=1, device=cuda))
    assert len(first) == len(meta) > 0
    for a, m, b in zip(first, meta, again):
        assert m.is_meta and (m.shape, m.dtype) == (a.shape, a.dtype)
        assert torch.equal(a, b)


# --- precision "f32_x2": the split products -----------------------------------

X2 = "f32_x2"


def _x2_counts():
    """(launches, x2_launches) of each wrapper with a split instance."""
    return [(f.launches, f.x2_launches) for f in (P.panel_trsm, P.panel_update,
                                                  B.blocked_cholesky, B.cholesky_solve,
                                                  B.multi_gamma_solve)]


# the main paths' product shapes, where the split instances gave the plain
# split version's bits on random operands (chip_smoke.py's phase 18 holds
# them so): both sum each output over k in order, one FMA chain
X2_EXACT = {(2304, 256), (2304, 2048, 256), (6144, 5888, 256)}


def _moved(before, which):
    """The counts now, against ``before``: +1 launch and +1 x2 launch for
    the wrappers named by index in ``which``, nothing for the others."""
    return [(n + (i in which), x + (i in which)) for i, (n, x) in enumerate(before)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,b,ld", [(2304, 256, 2304), (1000, 200, 977), (20, 12, 15)])
def test_x2_panel_trsm_matches_plain(cuda, r, b, ld):
    rng = np.random.default_rng(r + b + 2)
    raw = _column_slab(torch.from_numpy(rng.standard_normal((r, b))).to(cuda, torch.float32), ld)
    zinv = torch.from_numpy(np.tril(rng.standard_normal((b, b)))).to(cuda, torch.float32)
    before = _x2_counts()
    out = ops.panel_trsm(raw, zinv, precision=X2)
    torch.cuda.synchronize()
    assert _x2_counts() == _moved(before, {0})
    want = ref.panel_trsm_ref(raw, zinv, precision=X2)
    _assert_product(out, want)
    if (r, b) in X2_EXACT:
        assert torch.equal(out, want)
    assert torch.equal(ops.panel_trsm(raw, zinv, precision=X2), out)


@pytest.mark.cuda
@pytest.mark.parametrize("r,w,b,odd", [(2304, 2048, 256, False), (2304, 256, 256, False),
                                       (6144, 5888, 256, False), (1000, 777, 200, True),
                                       (30, 20, 12, True)])
def test_x2_panel_update_matches_plain_in_place(cuda, r, w, b, odd):
    rng = np.random.default_rng(w + b + 2)
    dev = lambda a: torch.from_numpy(a).to(cuda, torch.float32)  # noqa: E731
    work = dev(rng.standard_normal((r, w + b + odd)))
    lp, pt = dev(rng.standard_normal((r, b))), dev(rng.standard_normal((w, b)))
    if odd:
        lp, pt = _column_slab(lp, b + 1), _column_slab(pt, b + 1)
    trail = work[:, b + odd:]
    orig = trail.clone()
    want = ref.panel_update_ref(trail, lp, pt, precision=X2)
    before = _x2_counts()
    ops.panel_update(trail, lp, pt, out=trail, precision=X2)
    torch.cuda.synchronize()
    assert _x2_counts() == _moved(before, {1})
    _assert_product(trail, want)
    if (r, w, b) in X2_EXACT:
        assert torch.equal(trail, want)
    assert torch.equal(ops.panel_update(orig, lp, pt, precision=X2), trail)


def _spread(rng, shape, lo=-30, hi=30, positive=False):
    """f32 values of both signs (or positive) with exponents spread over
    lo..hi: every product of their halves stays a normal f32."""
    v = rng.uniform(1, 2, shape) * 2.0 ** rng.integers(lo, hi + 1, shape)
    if not positive:
        v *= rng.choice([-1.0, 1.0], shape)
    return v.astype(np.float32)


@pytest.mark.cuda
def test_x2_panel_trsm_at_b1_is_the_plain_bits(cuda):
    """At b = 1 each output is one product of split halves, every one exact,
    so no sum order is left to differ: 2^20 values spanning exponents
    −30…30 must give the plain split's bits (a split contracted into an
    FMA would leave hi more than 12 bits and round the products)."""
    rng = np.random.default_rng(20)
    raw = torch.from_numpy(_spread(rng, (1 << 20, 1))).to(cuda)
    zinv = torch.from_numpy(_spread(rng, (1, 1))).to(cuda)
    got = ops.panel_trsm(raw, zinv, precision=X2)
    assert torch.equal(got, ref.panel_trsm_ref(raw, zinv, precision=X2))


@pytest.mark.cuda
def test_x2_cholesky_solve_at_d1_is_the_plain_bits(cuda):
    """d = 1: z = 1 / l (one IEEE division in both), then y = z·b and
    x = z·y, each a product of halves: the plain split's bits."""
    rng = np.random.default_rng(21)
    l = torch.from_numpy(_spread(rng, (4096, 1, 1), -15, 15, positive=True)).to(cuda)
    b = torch.from_numpy(_spread(rng, (4096, 1, 16))).to(cuda)
    got = ops.cholesky_solve(l, b, precision=X2)
    assert torch.equal(got, ref.solve_right_looking_ref(l, b, precision=X2))
    assert torch.equal(got, ref.cholesky_solve_ref(l, b, precision=X2))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1536), (3, 130), (2, 257)])
def test_x2_blocked_cholesky_matches_plain(cuda, m, d):
    a = torch.stack([_spd_block(d + i, d, cuda) for i in range(m)])
    before = _x2_counts()
    l = ops.blocked_cholesky(a, precision=X2)
    torch.cuda.synchronize()
    assert _x2_counts() == _moved(before, {2})
    assert not torch.triu(l, 1).any() and torch.isfinite(l).all()
    assert _rel(l, ref.blocked_cholesky_ref(a, precision=X2)) < REL
    assert torch.equal(ops.blocked_cholesky(a, precision=X2), l)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,c", [(1, 1536, 16), (2, 130, 7), (3, 257, 1)])
def test_x2_cholesky_solve_matches_plain(cuda, m, d, c):
    rng = np.random.default_rng(d + c + 2)
    a = torch.stack([_spd_block(d + i, d, cuda) for i in range(m)])
    l = ref.blocked_cholesky_ref(a)
    b = torch.from_numpy(rng.standard_normal((m, d, c))).to(cuda, torch.float32)
    before = _x2_counts()
    x = ops.cholesky_solve(l, b, precision=X2)
    torch.cuda.synchronize()
    assert _x2_counts() == _moved(before, {3})
    assert _rel(x, ref.cholesky_solve_ref(l, b, precision=X2)) < REL
    assert _rel(x, ref.solve_right_looking_ref(l, b, precision=X2)) < REL
    assert torch.equal(ops.cholesky_solve(l, b, precision=X2), x)


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,n_g", [(2304, 16, 16), (130, 7, 11)])
def test_x2_multi_gamma_solve_matches_plain(cuda, d, c, n_g):
    rng = np.random.default_rng(d + 2)
    a = _spd_block(d, d, cuda)
    q = torch.from_numpy(rng.standard_normal((d, c))).to(cuda, torch.float32)
    gammas = torch.logspace(-4, 0, n_g, device=cuda) * float(torch.trace(a)) / d
    before = _x2_counts()
    w = ops.multi_gamma_solve(a, q, gammas, precision=X2)
    torch.cuda.synchronize()
    assert _x2_counts() == _moved(before, {4})
    plain = ref.multi_gamma_solve_ref(a, q, gammas, precision=X2)
    twin = ref.multi_gamma_blocked_ref(a, q, gammas, X2)
    for j in range(n_g):
        assert _rel(w[j], plain[j]) < REL
        assert _rel(w[j], twin[j]) < REL
    assert torch.equal(ops.multi_gamma_solve(a, q, gammas, precision=X2), w)


def _one_term_rows(rng, r, b):
    """(r, b) with one nonzero normal entry a row, in a random column."""
    x = np.zeros((r, b))
    x[np.arange(r), rng.integers(0, b, r)] = rng.standard_normal(r)
    return x


def _one_term_system(rng, d, panel=B.PANEL):
    """An SPD system whose blocked factor, solve and sweep have at most one
    nonzero term in every output of every product: a diagonal in [2, 3),
    and for each panel after the first one entry a row in the panel before
    it, in distinct columns, within ±0.5 (chip_smoke.py's twin)."""
    a = np.diag(2 + rng.random(d))
    for o in range(panel, d, panel):
        rows = np.arange(o, min(o + panel, d))
        cols = o - panel + rng.permutation(panel)[:rows.size]
        a[rows, cols] = a[cols, rows] = rng.random(rows.size) - 0.5
    return a


def _split_bits(got, want, native):
    """The split instance gives the plain split's bits; the native one does
    not (so the check tells the two apart)."""
    assert torch.equal(got, want)
    assert (native != want).any()


@pytest.mark.cuda
@pytest.mark.parametrize("r,w,b,ld", [(2304, 2048, 256, 2304), (6144, 5888, 256, 6144),
                                      (1000, 777, 200, 977), (30, 20, 12, 15)])
def test_x2_panel_products_one_term_bits(cuda, r, w, b, ld):
    """Operands with one nonzero term an output (a diagonal zinv, one entry
    a row of lp): no sum order is left to differ, so each product's split
    instance (F32Narrow, F32Mid) gives the plain split's bits at the main
    paths' shapes and at ragged ones."""
    rng = np.random.default_rng(r + w + 3)
    dev = lambda a: torch.from_numpy(a).to(cuda, torch.float32)  # noqa: E731
    raw = _column_slab(dev(rng.standard_normal((r, b))), ld)
    zinv = dev(np.diag(1 + rng.random(b)))
    _split_bits(ops.panel_trsm(raw, zinv, precision=X2),
                ref.panel_trsm_ref(raw, zinv, precision=X2), ops.panel_trsm(raw, zinv))
    trail, pt = dev(rng.standard_normal((r, w))), dev(rng.standard_normal((w, b)))
    lp = _column_slab(dev(_one_term_rows(rng, r, b)), ld)
    _split_bits(ops.panel_update(trail, lp, pt, precision=X2),
                ref.panel_update_ref(trail, lp, pt, precision=X2),
                ops.panel_update(trail, lp, pt))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,c,n_g", [(2, 1536, 16, 1), (1, 2304, 16, 16), (3, 1000, 7, 3),
                                       (2, 257, 1, 2)])
def test_x2_blocked_one_term_bits(cuda, m, d, c, n_g):
    """On ``_one_term_system`` the blocked factor's trsm and trailing update
    (tile_gemm.cuh's split loop) and the substitutions (sub_tile) give the
    plain split's bits, in the factor, the solve and the sweep."""
    rng = np.random.default_rng(d + m)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(cuda, torch.float32)  # noqa: E731
    a = dev(np.stack([_one_term_system(rng, d) for _ in range(m)]))
    _split_bits(ops.blocked_cholesky(a, precision=X2),
                ref.blocked_cholesky_ref(a, precision=X2), ops.blocked_cholesky(a))
    l = ref.blocked_cholesky_ref(a)
    rhs = dev(rng.standard_normal((m, d, c)))
    _split_bits(ops.cholesky_solve(l, rhs, precision=X2),
                ref.cholesky_solve_ref(l, rhs, precision=X2), ops.cholesky_solve(l, rhs))
    gammas = dev(np.logspace(-4, 0, n_g))
    _split_bits(ops.multi_gamma_solve(a[0], rhs[0], gammas, precision=X2),
                ref.multi_gamma_solve_ref(a[0], rhs[0], gammas, precision=X2),
                ops.multi_gamma_solve(a[0], rhs[0], gammas))


def _x2_spd(d, seed=5):
    """The reference's property-test system: XᵀX from 8d normal rows, f64."""
    x = np.random.default_rng(seed).standard_normal((8 * d, d))
    return x.T @ x


@pytest.mark.cuda
def test_x2_streamed_solve_launches_and_bound(cuda):
    """The streamed factor and solve at d = 2304 in f32_x2: the native
    schedule's panel launches, every product through its split instance;
    the plain route's answer; and the reference test's bound against f64:
    x2's error ≤ 4 × native's + 1e-9, and < 1e-4."""
    d, c = 2304, 16
    a64 = _x2_spd(d) + 0.5 * np.eye(d)
    q64 = np.random.default_rng(6).standard_normal((d, c))
    a = torch.from_numpy(a64).to(cuda, torch.float32)
    q = torch.from_numpy(q64).to(cuda, torch.float32)
    panels = (P.panel_factor, P.panel_trsm, P.panel_update, P.panel_tri_inv)
    before = [f.launches for f in panels] + [P.panel_trsm.x2_launches,
                                              P.panel_update.x2_launches]
    x2 = S.streamed_cholesky_solve(S.streamed_cholesky(a, precision=X2), q, precision=X2)
    torch.cuda.synchronize()
    n = d // S.DEFAULT_STREAM_BLOCK
    after = [f.launches for f in panels] + [P.panel_trsm.x2_launches,
                                             P.panel_update.x2_launches]
    assert [u - v for u, v in zip(after, before)] == [n, n, n - 1, n, n, n - 1]
    plain = S.streamed_cholesky_solve(S.streamed_cholesky(a, use_kernel=False, precision=X2),
                                      q, use_kernel=False, precision=X2)
    assert _rel(x2, plain) < REL
    native = S.streamed_cholesky_solve(S.streamed_cholesky(a), q)
    want = torch.from_numpy(np.linalg.solve(a64, q64)).to(cuda)
    err_x2, err_native = _rel(x2, want), _rel(native, want)
    assert err_x2 <= 4 * err_native + 1e-9 and err_x2 < 1e-4


@pytest.mark.cuda
def test_x2_blocked_and_sweep_bound(cuda):
    """The reference test's bound on the blocked factor and solve at
    d = 1536 and on the sweep at d = 2304 (γ = 0.5)."""
    for d, sweep in ((1536, False), (2304, True)):
        a64 = _x2_spd(d)
        q64 = np.random.default_rng(d).standard_normal((d, 5))
        a = torch.from_numpy(a64).to(cuda, torch.float32)
        q = torch.from_numpy(q64).to(cuda, torch.float32)
        g = torch.tensor([0.5], device=cuda)
        want = torch.from_numpy(np.linalg.solve(a64 + 0.5 * np.eye(d), q64)).to(cuda)
        errs = {}
        for prec in ("native", X2):
            if sweep:
                w = ops.multi_gamma_solve(a, q, g, precision=prec)[0]
            else:
                sys = (a + 0.5 * torch.eye(d, device=cuda))[None]
                w = ops.cholesky_solve(ops.blocked_cholesky(sys, precision=prec), q[None],
                                       precision=prec)[0]
            errs[prec] = _rel(w, want)
        assert errs[X2] <= 4 * errs["native"] + 1e-9 and errs[X2] < 1e-4, (d, errs)


@pytest.mark.cuda
def test_x2_refuses_f64_and_unknown_names(cuda):
    """f32_x2 on f64, and an unknown name, raise ValueError before any launch."""
    a = _spd_block(0, 64, cuda)
    before = _x2_counts()
    for t, prec in ((a.double(), X2), (a, "bf16_x3")):
        with pytest.raises(ValueError):
            ops.panel_trsm(t, t, precision=prec)
        with pytest.raises(ValueError):
            ops.panel_update(t, t, t, precision=prec)
        with pytest.raises(ValueError):
            ops.blocked_cholesky(t[None], precision=prec)
        with pytest.raises(ValueError):
            ops.cholesky_solve(t[None], t[None], precision=prec)
        with pytest.raises(ValueError):
            ops.multi_gamma_solve(t, t, torch.ones(1, dtype=t.dtype, device=cuda),
                                  precision=prec)
    assert _x2_counts() == before


@pytest.mark.cuda
def test_native_keyword_is_the_default_bits(cuda):
    a = torch.stack([_spd_block(7, 300, cuda)])
    assert torch.equal(ops.blocked_cholesky(a, precision="native"), ops.blocked_cholesky(a))
    lp = a[0, :, :64].contiguous()
    assert torch.equal(ops.panel_update(a[0], lp, lp, precision="native"),
                       ops.panel_update(a[0], lp, lp))


def _launch_calls(fn) -> int:
    """The CUDA kernel launch calls the host makes in one synchronised call
    of ``fn`` (after a warm-up call), as torch.profiler records them. The
    host side, not the device's: on an H100 the device side lost the first
    kernels of a session now and then, padded or not."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return sum(1 for e in prof.events() if e.device_type != DeviceType.CUDA
               and e.name.startswith("cudaLaunchKernel"))


@pytest.mark.cuda
def test_x2_cuda_launches_match_the_native_schedule(cuda):
    """The split instances run the native schedule: the same CUDA launches
    a call, at d = 1536 and at the sweep's main-path shape."""
    d, c = 1536, 16
    a = _spd_block(d, d, cuda)[None]
    l = ref.blocked_cholesky_ref(a)
    b = torch.ones((1, d, c), device=cuda)
    assert _launch_calls(lambda: ops.blocked_cholesky(a, precision=X2)) == B.cuda_launches(d)
    assert _launch_calls(lambda: ops.cholesky_solve(l, b, precision=X2)) == \
        B.solve_cuda_launches(d)
    for d, n_g in ((1536, 4), (2304, 16)):
        a = _spd_block(d, d, cuda)
        q, gammas = torch.ones((d, c), device=cuda), torch.linspace(0.1, 1.0, n_g, device=cuda)
        assert _launch_calls(lambda: ops.multi_gamma_solve(a, q, gammas, precision=X2)) == \
            B.sweep_cuda_launches(d)


# ------------------------------------------------ the partitioned steps on the card
@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A (1, 1) ('data', 'model') DeviceMesh over NCCL in this process."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_device_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_partitioned_steps_launch_the_kernels_on_a_nccl_mesh(nccl_mesh):
    """Reduced granite's partitioned train step, prefill and decode steps on
    a (1, 1) NCCL mesh: the ``local_map`` regions launch the flash and Gram
    kernels (their wrappers' counts move) and give the plain steps' state,
    logits and tokens."""
    from repro_torch.launch import partitioned as PT

    plan = PT.Plan("granite_moe_3b_a800m", reduced=dict(num_classes=8), batch=4, seq=32,
                   decode=3)
    out = PT.run_steps(nccl_mesh, plan, device="cuda")
    one = PT.one_rank_steps(plan, device="cuda")
    steps = out["steps"]
    assert steps["train"]["gram_launches"] == 1
    assert all(v["flash_launches"] == plan.config().num_layers for v in steps.values())
    g = one["state"]["gram"]
    assert float((out["state"]["gram"] - g).abs().max() / g.abs().max()) < 1e-4
    assert float(out["state"]["count"]) == plan.batch
    for a, b in zip(out["logits"], one["logits"]):
        assert float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max()) < 1e-3
    assert all(torch.equal(a, b) for a, b in zip(out["tokens"], one["tokens"]))


@pytest.mark.cuda
def test_dtensor_to_a_kernel_wrapper_raises(nccl_mesh):
    """A DTensor that reaches a kernel's wrapper raises TypeError before any
    pointer is read: the kernels take each rank's local tensor."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    q = distribute_tensor(torch.zeros(1, 2, 8, 64, device="cuda"), nccl_mesh,
                          [Replicate(), Replicate()])
    x = distribute_tensor(torch.zeros(64, 128, device="cuda"), nccl_mesh,
                          [Replicate(), Replicate()])
    for call in (lambda: FA.flash_attention(q, q, q), lambda: ops.flash_attention(q, q, q),
                 lambda: G.gram_update(x, x), lambda: ops.gram_update(x, x)):
        with pytest.raises(TypeError, match="DTensor"):
            with torch.no_grad():
                call()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm_350m", "zamba2_7b", "seamless_m4t_medium"])
def test_partitioned_family_steps_on_the_card_match_the_cpu(nccl_mesh, arch):
    """One rank of each family's partitioned steps on the card (a (1, 1) NCCL
    mesh: every recurrence through its local region, attention through the
    flash kernel) against the plain steps on the CPU from the same weights:
    the Gram within 1e-4 of its largest entry, the count exact, logits
    within 1e-3 of a row's largest, the same tokens; one Gram launch, flash
    launches where the family attends, the recurrences' carries noted."""
    from repro_torch.launch import partitioned as PT
    from repro_torch.models import transformer as T

    plan = PT.Plan(arch, reduced=dict(num_classes=8), layers=5, batch=4, seq=32, decode=3)
    cfg = plan.config()
    params = T.init_params(cfg, seed=0, device="cpu")
    out = PT.run_steps(nccl_mesh, plan, device="cuda", params=_tree_to(params, "cuda"))
    one = PT.one_rank_steps(plan, device="cpu", params=params)
    steps = out["steps"]
    assert steps["train"]["gram_launches"] == 1
    attends = cfg.arch_type != "xlstm"
    assert all((v["flash_launches"] > 0) == attends for v in steps.values())
    want = {"xlstm": {"mlstm", "slstm"}, "hybrid": {"ssd"}}.get(cfg.arch_type, set())
    assert {name for name, _ in steps["train"]["scans"]} == want
    g = one["state"]["gram"]
    assert float((out["state"]["gram"] - g).abs().max() / g.abs().max()) < 1e-4
    assert float(out["state"]["count"]) == plan.batch
    for a, b in zip(out["logits"], one["logits"]):
        assert float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max()) < 1e-3
    assert all(torch.equal(a, b) for a, b in zip(out["tokens"], one["tokens"]))


@pytest.mark.cuda
def test_recurrence_regions_match_their_plain_loops(nccl_mesh):
    """The mLSTM, sLSTM and Mamba2 mixers (apply from no state and from a
    state, Mamba2's decode step) on DTensors of a (1, 1) NCCL mesh, each
    recurrence in its ``act.local_region``, against the same functions on
    plain CUDA tensors (the plain loop): outputs and states within rtol
    1e-5 / atol 1e-6."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.config import SSMConfig
    from repro_torch.launch import partitioned as PT
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as X

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, heads, b, s = 64, 4, 2, 24
    cfg = SSMConfig(d_state=16, chunk=8, num_heads=4)
    x = torch.randn((b, s, d), generator=gen, device="cuda")

    def dist(tree):
        if isinstance(tree, dict):
            return {k: dist(v) for k, v in tree.items()}
        return distribute_tensor(tree, nccl_mesh, [Replicate(), Replicate()])

    def close(got, want):
        if isinstance(want, dict):
            for k in want:
                close(got[k], want[k])
            return
        assert isinstance(got, DTensor)
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5, atol=1e-6)

    mixers = [(X.mlstm_apply, X.init_mlstm(gen, d, heads, torch.float32, "cuda"), heads),
              (X.slstm_apply, X.init_slstm(gen, d, heads, torch.float32, "cuda"), heads),
              (SSM.mamba_apply, SSM.init_mamba(gen, d, cfg, torch.float32, "cuda"), cfg)]
    with torch.no_grad(), PT.policy(nccl_mesh):
        for apply, p, arg in mixers:
            want, state = apply(p, x[:, :16], arg, return_state=True)
            got, got_state = apply(dist(p), dist(x[:, :16]), arg, return_state=True)
            close(got, want)
            close(got_state, state)
            want, want_state = apply(p, x[:, 16:], arg, init_state=state, return_state=True)
            got, got_state = apply(dist(p), dist(x[:, 16:]), arg, init_state=dist(state),
                                   return_state=True)
            close(got, want)
            close(got_state, want_state)
            if apply is SSM.mamba_apply:
                want, want_state = SSM.mamba_decode(p, x[:, :1], state, cfg)
                got, got_state = SSM.mamba_decode(dist(p), dist(x[:, :1]), dist(state), cfg)
                close(got, want)
                close(got_state, want_state)


# --- the bf16 model path (phase 20 of chip_smoke.py) ------------------------------

BF16_REL = 2e-2     # tests/test_torch_bf16.py's bar: bf16 port against bf16 reference


def _bf16_attn_err(q, k, v, **kw):
    """(max |err| of the kernel, the bar, the plain output in f32, the
    decode's chunk) for bf16 ``q, k, v``; one bf16 launch and no f32 one."""
    by = dict(FA.flash_attention.dtype_launches)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.dtype_launches["bfloat16"] == by["bfloat16"] + 1
    assert FA.flash_attention.dtype_launches["float32"] == by["float32"]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = ref.mha_ref(q.float(), k.float(), v.float(), **kw)
    chunk = FA.decode_plan(q.shape[0], k.shape[1], 1, k.shape[2], causal=True,
                           window=kw["window"], q_offset=kw["q_offset"],
                           sms=FA.sm_count(q.device.index))[2]
    return float((out.float() - want).abs().max()), ATTN_BF16_REL * float(want.abs().max()), \
        want, chunk


@pytest.mark.cuda
def test_bf16_flash_long_window_decode_over_524288_slots(cuda):
    """The bf16 instance at granite_moe_3b_a800m's long_500k decode (Hq 24,
    Hkv 8, one query over 524288 slots, D 64, window 4096) on a stacked (9,
    1, 8, 524288, 64) cache: on layer 8 alone (its first element 2³¹
    elements, 4 GiB, past the buffer's start: a 64-bit base pointer), and
    on layers 0 and 8 as a batch of two, whose batch stride of 2³¹ elements
    (2³² bytes) passes 32 bits in the kernel's own offsets. Each against the
    plain version in f32 within ``ATTN_BF16_REL`` of its largest |value|,
    at the cache's end and at its start; the same bar rejects each planted
    fault: zeros, the band shifted back by one decode chunk, and layer 0's
    keys and values in layer 8's place (an offset wrapped at 32 bits)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    shape = (9, 1, 8, 524288, 64)
    kc = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    k, v = kc[8], vc[8]
    assert k.data_ptr() - kc.data_ptr() == 8 * 8 * 524288 * 64 * 2 >= 2**32
    kb, vb = kc[::8, 0], vc[::8, 0]
    assert kb.shape == (2, 8, 524288, 64) and kb.stride(0) == vb.stride(0) == 2**31
    for q_offset in (524287, 4095):
        kw = dict(window=4096, q_offset=q_offset)
        q = torch.randn((1, 24, 1, 64), generator=gen, device=cuda, dtype=torch.bfloat16)
        err, bar, want, chunk = _bf16_attn_err(q, k, v, **kw)
        assert err <= bar
        wrong = [torch.zeros_like(want),
                 ref.mha_ref(q.float(), kc[0].float(), vc[0].float(), **kw)]
        if q_offset >= chunk:
            wrong.append(ref.mha_ref(q.float(), k.float(), v.float(), window=4096,
                                     q_offset=q_offset - chunk))
        for w in wrong:
            assert float((w - want).abs().max()) > bar
        qb = torch.randn((2, 24, 1, 64), generator=gen, device=cuda, dtype=torch.bfloat16)
        err, bar, want, _ = _bf16_attn_err(qb, kb, vb, **kw)
        assert err <= bar
        layer0 = ref.mha_ref(qb.float(), kc[0, 0].float().expand(2, -1, -1, -1),
                             vc[0, 0].float().expand(2, -1, -1, -1), **kw)
        assert float((layer0[1] - want[1]).abs().max()) > bar
        assert float(want.abs().max()) > bar


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_32b", "granite_moe_3b_a800m"])
def test_bf16_reduced_model_kernel_matches_plain(cuda, arch):
    """Reduced qwen3_32b (qk-norm) and granite_moe_3b_a800m (MoE, GQA at D
    64) at ``dtype="bfloat16"`` on the card: the prefill's and four
    teacher-forced decode steps' logits with the flash kernel's bf16
    instance against plain attention (``layers.sdpa_plain``) on the card,
    within ``BF16_REL`` of a row's largest |logit|; every flash call the
    bf16 instance, every cache tensor and logit bf16. The plain run routes
    each MoE call by the kernel run's expert choices (as phase 19 of
    chip_smoke.py compares its ranks): its router logits are bf16, so a
    rounding apart sends a near-tie token to another expert; every choice
    its own router would make otherwise must be such a near-tie, its k-th
    and (k+1)-th probabilities within ``BF16_REL``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import partitioned as PT
    from repro_torch.launch import steps as ST
    from repro_torch.launch.inputs import sample_batch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_config(arch).reduced(dtype="bfloat16")
    params = T.init_params(cfg, seed=5, device=cuda)
    assert {t.dtype for t in _tree_leaves(params)} == {torch.bfloat16}
    toks = sample_batch(cfg, 2, 40, seed=5, with_labels=False, device=cuda)["tokens"]
    prompt, n = 32, 4

    def run():
        logits, cache = ST.make_prefill_step(cfg, prompt + n)(params, {"tokens": toks[:, :prompt]})
        assert {t.dtype for t in _tree_leaves(cache)} == {torch.bfloat16}
        out = [logits]
        for i in range(n):
            logits, cache = ST.make_serve_step(cfg)(params, cache, toks[:, prompt + i], prompt + i)
            out.append(logits)
        return torch.stack(out, 1)

    by = dict(FA.flash_attention.dtype_launches)
    seen, forced = [], []
    with PT._routing_spy(seen):
        kern = run()
    calls = FA.flash_attention.dtype_launches["bfloat16"] - by["bfloat16"]
    assert calls == cfg.num_layers * (1 + n)
    assert FA.flash_attention.dtype_launches["float32"] == by["float32"]
    sdpa = L.sdpa
    L.sdpa = L.sdpa_plain
    try:
        with PT._routing_spy(forced, iter([top_i for _, top_i, _, _ in seen])):
            plain = run()
    finally:
        L.sdpa = sdpa
    assert FA.flash_attention.dtype_launches["bfloat16"] == by["bfloat16"] + calls
    assert len(forced) == len(seen) == (cfg.num_layers * (1 + n) if cfg.moe else 0)
    for _, top_i, probs, own in forced:
        flipped = (top_i.sort(-1).values != own.sort(-1).values).any(-1)
        if flipped.any():
            k = cfg.moe.top_k
            top = probs[flipped].sort(-1, descending=True).values
            assert float((top[:, k - 1] - top[:, k]).max()) <= BF16_REL
    assert kern.dtype == plain.dtype == torch.bfloat16 and bool(torch.isfinite(kern).all())
    rel = ((kern.double() - plain.double()).abs().amax(-1)
           / plain.double().abs().amax(-1)).max()
    assert float(rel) <= BF16_REL


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]
