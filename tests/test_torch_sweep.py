"""The port's blocked factor, solve, γ sweep and rank update against the
reference's, and the engine's kernel route that runs them.

On the CPU ``repro_torch.kernels.solve`` takes each kernel's plain version
(the reference's algorithm in torch); it is held to the Pallas kernel of
``repro.kernels.solve`` run in interpret mode on the same numpy-seeded f32
inputs. The engine's kernel route (``use_kernel=True``) is held in f64 to
the ``numpy_f64`` engine and in f32 to ``AnalyticEngine("jax",
use_kernel=True)``. The CUDA kernels themselves are compared with the
plain versions on the card by tests/test_torch_cuda.py (marked ``cuda``)
and by chip_smoke.py.

Tolerances, each with its reason:
  * against the Pallas kernels, the reference's own f32 bars against
    numpy (tests/test_solve_kernels.py:39-97): rtol 5e-5 for the factor,
    2e-4 for the solve, 2e-3 / atol 2e-4·max for the sweep, 1e-3 /
    atol 5e-4·max for the rank update — the same algorithm in f32 with
    sums in another order, on systems with condition numbers below 100;
  * the engine's kernel route in f64 against ``numpy_f64``: 1e-10, the
    bar the reference holds its kernel solves to under x64;
  * the engine's kernel route in f32 against the reference's kernel
    engine: relative 1e-4 of the largest weight on well-conditioned
    systems (condition numbers below 10); 1e-3 where both fall back to an
    f32 eigendecomposition, whose vectors carry more rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import AnalyticEngine as RefEngine
from repro.kernels import ops as RO
from repro.kernels import solve as RS
from repro_torch.core.engine import AnalyticEngine, SuffStats, TorchBackend, to_numpy
from repro_torch.kernels import blocked as B
from repro_torch.kernels import ops
from repro_torch.kernels import rank_update as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(d, n_mult=4, seed=0, batch=None):
    """The reference tests' SPD systems: XᵀX from n_mult·d normal rows,
    plus (0.5 + i)·I."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(batch or 1):
        x = rng.standard_normal((n_mult * d, d))
        mats.append(x.T @ x + (0.5 + i) * np.eye(d))
    return np.stack(mats) if batch else mats[0]


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(a, b):
    """Largest error relative to the largest entry of ``b``."""
    a = to_numpy(a)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


# --- the four kernels against the Pallas kernels (interpret mode) ---------------


@pytest.mark.parametrize("d,batch", [(32, 1), (48, 3), (130, 2)])
def test_blocked_cholesky_matches_pallas(d, batch):
    a = _spd(d, batch=batch)
    l = ops.blocked_cholesky(_f32(a))
    l_ref = RO.blocked_cholesky(jnp.asarray(a, jnp.float32))
    assert l.shape == (batch, d, d) and l.dtype == torch.float32
    _close(l, l_ref, 5e-5, 5e-5)
    _close(l, np.stack([np.linalg.cholesky(s) for s in a]), 5e-5, 5e-5)
    assert not np.triu(to_numpy(l), 1).any()        # exact-zero upper triangle


@pytest.mark.parametrize("d,c,batch", [(48, 7, 3), (96, 5, 1)])
def test_cholesky_solve_matches_pallas(d, c, batch):
    rng = np.random.default_rng(1)
    a = _spd(d, batch=batch, seed=2)
    b = rng.standard_normal((batch, d, c))
    l = ops.blocked_cholesky(_f32(a))
    x = ops.cholesky_solve(l, _f32(b))
    x_ref = RO.cholesky_solve(RO.blocked_cholesky(jnp.asarray(a, jnp.float32)),
                              jnp.asarray(b, jnp.float32))
    assert x.shape == (batch, d, c)
    _close(x, x_ref, 2e-4, 2e-4)
    _close(x, np.stack([np.linalg.solve(a[i], b[i]) for i in range(batch)]), 2e-4, 2e-4)


@pytest.mark.parametrize("n_gammas", [1, 3, 11])
def test_multi_gamma_solve_matches_pallas(n_gammas):
    d, c = 64, 6
    rng = np.random.default_rng(3)
    a = _spd(d, seed=3)
    q = rng.standard_normal((d, c))
    gammas = np.logspace(-2, 1, n_gammas)
    w = ops.multi_gamma_solve(_f32(a), _f32(q), _f32(gammas))
    w_ref = np.asarray(RO.multi_gamma_solve(jnp.asarray(a, jnp.float32),
                                            jnp.asarray(q, jnp.float32),
                                            jnp.asarray(gammas, jnp.float32)))
    assert w.shape == (n_gammas, d, c)
    for i, g in enumerate(gammas):
        _close(w[i], w_ref[i], 2e-3, 2e-4)
        _close(w[i], np.linalg.solve(a + g * np.eye(d), q), 2e-3, 2e-4)


@pytest.mark.parametrize("d,k", [(32, 2), (48, 5), (130, 3)])
def test_chol_rank_update_matches_pallas(d, k):
    rng = np.random.default_rng(7)
    a = _spd(d, seed=6)
    l = np.linalg.cholesky(a)
    xs = rng.standard_normal((k, d))
    out = ops.chol_rank_update(_f32(l), _f32(xs))
    out_ref = RO.chol_rank_update(jnp.asarray(l, jnp.float32), jnp.asarray(xs, jnp.float32))
    _close(out, out_ref, 1e-3, 5e-4)
    _close(out, np.linalg.cholesky(a + xs.T @ xs), 1e-3, 5e-4)
    assert not np.triu(to_numpy(out), 1).any()


def test_chol_rank_zero_is_identity():
    l = _f32(np.linalg.cholesky(_spd(24, seed=8)))
    assert ops.chol_rank_update(l, torch.zeros((0, 24))) is l
    ref_out = RO.chol_rank_update(jnp.asarray(l.numpy()), jnp.zeros((0, 24), jnp.float32))
    assert np.array_equal(np.asarray(ref_out), l.numpy())


def test_chol_rank_update_zero_row_is_a_no_op():
    """The s_ guard: an all-zero update row changes nothing, in the port
    and in the reference alike."""
    l = np.linalg.cholesky(_spd(40, seed=9)).astype(np.float32)
    out = ops.chol_rank_update(_f32(l), torch.zeros((2, 40)))
    out_ref = RO.chol_rank_update(jnp.asarray(l), jnp.zeros((2, 40), jnp.float32))
    assert np.array_equal(to_numpy(out, np.float32), l)
    assert np.array_equal(np.asarray(out_ref), l)


def test_singular_gamma_gives_nan_in_that_gamma_only():
    rng = np.random.default_rng(4)
    d = 32
    x = rng.standard_normal((5, d))                 # rank 5 < d
    q = rng.standard_normal((d, 3))
    args = (x.T @ x, q, np.array([0.0, 1.0]))
    w = to_numpy(ops.multi_gamma_solve(*map(_f32, args)))
    w_ref = np.asarray(RO.multi_gamma_solve(*(jnp.asarray(v, jnp.float32) for v in args)))
    for got in (w, w_ref):
        assert not np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    _close(w[1], w_ref[1], 2e-3, 2e-4)


def test_non_pd_system_gives_nan_and_a_clean_upper_triangle():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 40))
    a = np.stack([_spd(40, seed=5), x.T @ x])       # PD, then rank 3
    l = to_numpy(ops.blocked_cholesky(_f32(a)))
    assert np.isfinite(l[0]).all() and np.isnan(l[1]).any()
    assert not np.triu(np.nan_to_num(l, nan=1.0), 1).any()


def test_empty_batches_and_grids_return_at_once():
    assert ops.blocked_cholesky(torch.zeros((0, 6, 6))).shape == (0, 6, 6)
    assert RO.blocked_cholesky(jnp.zeros((0, 6, 6))).shape == (0, 6, 6)
    assert ops.cholesky_solve(torch.zeros((0, 6, 6)), torch.zeros((0, 6, 2))).shape == (0, 6, 2)
    assert RO.cholesky_solve(jnp.zeros((0, 6, 6)), jnp.zeros((0, 6, 2))).shape == (0, 6, 2)
    assert ops.multi_gamma_solve(torch.eye(6), torch.ones((6, 2)), []).shape == (0, 6, 2)
    assert RO.multi_gamma_solve(jnp.eye(6), jnp.ones((6, 2)),
                                jnp.zeros((0,))).shape == (0, 6, 2)


def test_constants_and_panel_width_match_reference():
    assert ops.DEFAULT_BLOCK == RS.DEFAULT_BLOCK == B.PANEL
    assert ops.DEFAULT_GAMMA_BLOCK == RS.DEFAULT_GAMMA_BLOCK


def test_blocked_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: only kernels.solve
    dispatches a CPU tensor to the plain version, and no launch is
    counted."""
    a = _f32(_spd(16))[None]
    q = torch.ones((16, 2))
    counts = lambda: [f.launches for f in (B.blocked_cholesky, B.cholesky_solve,  # noqa: E731
                                           B.multi_gamma_solve, R.chol_rank_update)]
    before = counts()
    for call in (lambda: B.blocked_cholesky(a), lambda: B.cholesky_solve(a, q[None]),
                 lambda: B.multi_gamma_solve(a[0], q, torch.ones(2)),
                 lambda: R.chol_rank_update(a[0], q.T.contiguous())):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert counts() == before


# --- the engine's kernel route ---------------------------------------------------

_D, _C = 40, 5


def _stats_pair(rng, n, d=_D, c=_C, dtype=torch.float64):
    """One client's statistics in the reference's numpy_f64 engine and the
    same values in the port's kernel-route engine."""
    x = rng.standard_normal((n, d))
    y = np.eye(c)[rng.integers(0, c, n)]
    ref = RefEngine("numpy_f64", gamma=1.0)
    eng = AnalyticEngine("torch", gamma=1.0, dtype=dtype, device="cpu", use_kernel=True)
    s_ref = ref.client_stats(x, y)
    return ref, s_ref, eng, SuffStats(*(eng.backend.asarray(v) for v in s_ref[:4])), x, y


@pytest.fixture
def counted(monkeypatch):
    """Counts the torch backend's fused sweeps and eigendecompositions, so
    a test can tell which route answered."""
    calls = {"fused_sweep": 0, "eigh": 0, "fused": []}
    sweep, eigh = TorchBackend.fused_sweep, TorchBackend.eigh

    def fused(self, *a):
        calls["fused_sweep"] += 1
        out = sweep(self, *a)
        calls["fused"].append(out)
        return out

    def counted_eigh(self, a):
        calls["eigh"] += 1
        return eigh(self, a)

    monkeypatch.setattr(TorchBackend, "fused_sweep", fused)
    monkeypatch.setattr(TorchBackend, "eigh", counted_eigh)
    return calls


def test_engine_kernel_sweep_matches_numpy_f64(counted):
    ref, s_ref, eng, s, *_ = _stats_pair(np.random.default_rng(20), 300)
    gammas = [0.01, 0.1, 1.0, 10.0]
    ws = eng.solve_multi_gamma(s, gammas)
    assert counted["fused_sweep"] == 1 and counted["eigh"] == 0
    for w, w_ref in zip(ws, ref.solve_multi_gamma(s_ref, gammas)):
        assert _rel(w, w_ref) < 1e-10
    ws = eng.solve_multi_gamma(s, gammas, use_ri=False)       # the no-RI ablation
    for w, w_ref in zip(ws, ref.solve_multi_gamma(s_ref, gammas, use_ri=False)):
        assert _rel(w, w_ref) < 1e-10


def test_engine_kernel_sweep_gamma_zero_rank_deficient_falls_back(counted):
    """γ = 0 on fewer rows than d: the fused sweep gives NaNs and the whole
    grid reroutes to the eigendecomposition, whose pinv answer is the
    numpy_f64 engine's."""
    ref, s_ref, eng, s, *_ = _stats_pair(np.random.default_rng(21), 12, d=24)
    ws = eng.solve_multi_gamma(s, [0.0, 1.0])
    assert counted["fused_sweep"] == 1 and counted["eigh"] == 1
    assert not torch.isfinite(counted["fused"][0][0]).all()
    for w, w_ref in zip(ws, ref.solve_multi_gamma(s_ref, [0.0, 1.0])):
        assert torch.isfinite(w).all() and _rel(w, w_ref) < 1e-10


def test_engine_kernel_sweep_untrustworthy_grid_falls_back(counted):
    """A finite sweep whose weights exceed the pinv bound is not trusted:
    a rank-deficient Gram at a γ far below the pinv cutoff, with a moment
    that reaches its null space, factors without NaN but reroutes."""
    rng = np.random.default_rng(22)
    d = 24
    x = rng.standard_normal((8, d))
    g = x.T @ x
    q = rng.standard_normal((d, 3))
    gamma = 1e-14 * float(np.trace(g))
    ref = RefEngine("numpy_f64", gamma=1.0)
    eng = AnalyticEngine("torch", dtype=torch.float64, device="cpu", use_kernel=True)
    ws = eng.solve_multi_gamma(SuffStats(torch.from_numpy(g), torch.from_numpy(q),
                                         torch.tensor(8.0), torch.tensor(1.0)), [gamma])
    assert counted["fused_sweep"] == 1 and counted["eigh"] == 1
    assert torch.isfinite(counted["fused"][0]).all()              # finite, not trusted
    w_ref, = ref.solve_multi_gamma(SuffStats(g, q, 8.0, 1.0), [gamma])
    assert _rel(ws[0], w_ref) < 1e-10


@pytest.mark.parametrize("grouped", [False, True])
def test_engine_kernel_factor_update_matches_numpy_f64(grouped, monkeypatch):
    """A root (or a list of roots) folds into the kernel route's factor by
    the rank update, not a refactor; the factor and its solve are the
    numpy_f64 engine's."""
    rng = np.random.default_rng(23 + grouped)
    ref, s_ref, eng, s, *_ = _stats_pair(rng, 300)
    f, f_ref = eng.factor(s, target_gamma=0.5), ref.factor(s_ref, target_gamma=0.5)
    xs = [rng.standard_normal((k, _D)) for k in ((2, 1) if grouped else (2,))]
    ys = [np.eye(_C)[rng.integers(0, _C, len(x))] for x in xs]
    for x, y in zip(xs, ys):
        s_ref = ref.merge(s_ref, ref.client_stats(x, y))
    # the merged statistics as the reference has them (the kernel route's
    # Gram folds are f32, as the Gram kernel's are)
    s = SuffStats(*(eng.backend.asarray(v) for v in s_ref[:4]))
    root = xs if grouped else xs[0]
    f2_ref = ref.factor_update(f_ref, s_ref, root, target_gamma=0.5, max_rank=8)
    monkeypatch.setattr(eng, "factor", lambda *a, **k: pytest.fail("refactored"))
    f2 = eng.factor_update(f, s, root, target_gamma=0.5, max_rank=8)
    assert not torch.triu(f2.handle, 1).any()
    assert _rel(f2.handle, f2_ref.handle.T) < 1e-10
    assert _rel(eng.factor_solve(f2, s.moment), ref.factor_solve(f2_ref, s_ref.moment)) < 1e-10


# --- f32: the port's kernel route against the reference's kernel engine ----------


def _f32_pair(rng, n, d=_D, c=_C):
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    ref = RefEngine("jax", gamma=1.0, use_kernel=True)
    eng = AnalyticEngine("torch", gamma=1.0, device="cpu", use_kernel=True)
    s_ref = ref.client_stats(jnp.asarray(x), jnp.asarray(y))
    s = SuffStats(*(torch.from_numpy(np.array(v)) for v in s_ref[:4]))
    return ref, s_ref, eng, s, x, y


@pytest.mark.parametrize("call", ["solve", "factor_solve", "ri_restore", "sweep",
                                  "sweep_fallback", "factor_update",
                                  "factor_update_grouped"])
def test_engine_kernel_route_f32_matches_jax_kernel_engine(call):
    rng = np.random.default_rng(30)
    ref, s_ref, eng, s, x, y = _f32_pair(rng, 300)
    tol = 1e-4
    if call == "solve":
        got, want = eng.solve(s, target_gamma=0.1), ref.solve(s_ref, target_gamma=0.1)
    elif call == "factor_solve":
        f, f_ref = eng.factor(s, target_gamma=0.1), ref.factor(s_ref, target_gamma=0.1)
        assert _rel(f.handle, np.asarray(f_ref.handle[0])) < tol
        got, want = eng.factor_solve(f, s.moment), ref.factor_solve(f_ref, s_ref.moment)
    elif call == "ri_restore":
        c_r = np.array(ref.regularized_gram(s_ref))
        w_r = np.linalg.solve(c_r.astype(np.float64), np.asarray(s_ref.moment, np.float64))
        w_r = w_r.astype(np.float32)
        got = eng.ri_restore(torch.from_numpy(w_r), torch.from_numpy(c_r), 1)
        want = ref.ri_restore(jnp.asarray(w_r), jnp.asarray(c_r), 1)
    elif call in ("sweep", "sweep_fallback"):
        if call == "sweep_fallback":          # N < d: γ = 0 is singular
            ref, s_ref, eng, s, x, y = _f32_pair(rng, 12, d=24)
            tol = 1e-3
        gammas = [0.0, 1.0] if call == "sweep_fallback" else [0.01, 0.1, 1.0, 10.0]
        # rcond above f32 eigenvalue noise, so the pinv truncation is the same
        kw = dict(rcond=1e-4) if call == "sweep_fallback" else {}
        got = torch.stack(eng.solve_multi_gamma(s, gammas, **kw))
        want = np.stack([np.asarray(w) for w in ref.solve_multi_gamma(s_ref, gammas, **kw)])
        assert np.isfinite(want).all()
    else:
        f, f_ref = eng.factor(s, target_gamma=0.1), ref.factor(s_ref, target_gamma=0.1)
        xs = [rng.standard_normal((k, _D)).astype(np.float32) for k in (2, 1)]
        if call == "factor_update":
            xs = xs[:1]
        for xk in xs:
            yk = np.eye(_C, dtype=np.float32)[rng.integers(0, _C, len(xk))]
            s_ref = ref.merge(s_ref, ref.client_stats(jnp.asarray(xk), jnp.asarray(yk)))
        s = SuffStats(*(torch.from_numpy(np.array(v)) for v in s_ref[:4]))
        root = xs if len(xs) > 1 else xs[0]
        f2 = eng.factor_update(f, s, root, target_gamma=0.1, max_rank=8)
        f2_ref = ref.factor_update(f_ref, s_ref, [jnp.asarray(v) for v in xs]
                                   if len(xs) > 1 else jnp.asarray(xs[0]), target_gamma=0.1,
                                   max_rank=8)
        assert _rel(f2.handle, np.asarray(f2_ref.handle[0])) < tol
        got, want = eng.factor_solve(f2, s.moment), ref.factor_solve(f2_ref, s_ref.moment)
    assert torch.isfinite(torch.as_tensor(got)).all()
    assert _rel(got, np.asarray(want)) < tol
