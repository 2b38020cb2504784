"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel
has no CPU mode). The file imports nothing of JAX, so it runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels_gram.py: rtol 2e-4 / atol 2e-3
for f32 (sums in another order), 2e-2 / 2e-1 for bf16; the flash-attention
kernel's those of tests/test_kernels_attention.py: rtol 2e-5 / atol 4e-4
for f32, 2e-2 / 0.4 for bf16. The solve kernels' f64 instances are held to
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1536), (3, 130), (1, 128)])
def test_blocked_cholesky_cuda_launches_match_profiler(cuda, m, d):
    """One wrapper call makes blocked.cuda_launches(d) CUDA launches, as
    torch.profiler counts them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.stack([_spd_block(d + i, d, cuda) for i in range(m)])
    ops.blocked_cholesky(a)
    torch.cuda.synchronize()
    before = B.blocked_cholesky.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.blocked_cholesky(a)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and "chol_" in e.name]
    assert B.blocked_cholesky.launches == before + 1
    assert len(kernels) == B.cuda_launches(d)


BLOCKED_KERNELS = ("chol_", "solve_inverse_kernel", "forward_", "backward_")


def _cuda_kernels(fn) -> int:
    """The blocked kernels torch.profiler counts in one synchronised call of
    ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and any(k in e.name for k in BLOCKED_KERNELS))


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

ATTN_TOL = {torch.float32: (2e-5, 4e-4), torch.bfloat16: (2e-2, 0.4)}


def _attn_inputs(seed, b, hq, hkv, sq, skv, d, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(device, dtype)
                 for shape in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)])


def _attn_check(q, k, v, **kw):
    before = FA.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
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
    assert FA.flash_attention.launches == before


@pytest.mark.cuda
def test_sdpa_on_card_is_the_kernel(cuda):
    """models.layers.sdpa on CUDA tensors goes through the kernel (window <= 0
    meaning none) and refuses a logit softcap."""
    from repro_torch.models import layers as L
    q, k, v = _attn_inputs(11, 2, 4, 2, 24, 24, 32, torch.float32, cuda)
    before = FA.flash_attention.launches
    for window, want_window in [(0, None), (None, None), (7, 7)]:
        out = L.sdpa(q, k, v, window=window)
        torch.testing.assert_close(out, ref.mha_ref(q, k, v, window=want_window),
                                   rtol=2e-5, atol=4e-4)
    assert FA.flash_attention.launches == before + 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.sdpa(q, k, v, softcap=30.0)


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
