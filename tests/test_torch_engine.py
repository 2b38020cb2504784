"""The port's engine (torch backend, f64, CPU) against the reference's
``numpy_f64`` engine.

Both run the same statistics, made with numpy from a seed. The bar is
the reference's own for engine solves, ≤1e-12: the two differ only in
rounding (LAPACK's Cholesky and triangular solves against torch.linalg's,
on systems with condition numbers ≲1e3).
"""

import numpy as np
import pytest
import torch

from repro.core.engine import AnalyticEngine as RefEngine
from repro.fl.api import AFLClient as RefClient
from repro_torch.core.engine import AnalyticEngine, to_numpy
from repro_torch.fl.api import AFLClient

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(gamma=1.0):
    return (RefEngine("numpy_f64", gamma=gamma),
            AnalyticEngine("torch", gamma=gamma, dtype=torch.float64, device="cpu"))


def _shards(seed, d=16, c=3, sizes=(20, 30, 25), zero_cols=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.standard_normal((n, d))
        if zero_cols:
            x[:, :zero_cols] = 0.0
        out.append((x, np.eye(c)[rng.integers(0, c, n)]))
    return out


def _aggregate(eng, shards):
    stats = None
    for x, y in shards:
        s = eng.client_stats(x, y)
        stats = s if stats is None else eng.merge(stats, s)
    return stats


def _close(a, b):
    np.testing.assert_allclose(to_numpy(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("use_ri,target_gamma", [(True, 0.0), (True, 0.5), (False, 0.0)])
def test_solve_matches_numpy_f64(use_ri, target_gamma):
    ref, eng = _engines()
    shards = _shards(0)
    s_ref, s = _aggregate(ref, shards), _aggregate(eng, shards)
    _close(s.gram, s_ref.gram)
    _close(s.moment, s_ref.moment)
    assert float(s.clients) == s_ref.clients == 3.0
    assert float(s.count) == s_ref.count == 75.0
    _close(eng.solve(s, use_ri=use_ri, target_gamma=target_gamma),
           ref.solve(s_ref, use_ri=use_ri, target_gamma=target_gamma))


def test_factor_and_factor_solve_match():
    ref, eng = _engines()
    shards = _shards(1)
    s_ref, s = _aggregate(ref, shards), _aggregate(eng, shards)
    f_ref, f = ref.factor(s_ref, target_gamma=0.1), eng.factor(s, target_gamma=0.1)
    assert f.updatable and f_ref.updatable
    _close(f.handle, f_ref.handle.T)          # lower L = (upper R)ᵀ
    _close(eng.factor_solve(f, s.moment), ref.factor_solve(f_ref, s_ref.moment))


@pytest.mark.parametrize("zero_cols", [0, 4])
def test_factor_update_with_root_matches(zero_cols):
    """A low-rank arrival folds into the cached factor (rank-k column
    sweep) in both engines, and solves agree with a refactor. Leading
    zero columns in the root leave their sweep steps without work."""
    ref, eng = _engines()
    base = _shards(2, d=32, sizes=(80,))[0]
    x_new, y_new = _shards(3, d=32, sizes=(2,), zero_cols=zero_cols)[0]
    s_ref, s = ref.client_stats(*base), eng.client_stats(*base)
    f_ref, f = ref.factor(s_ref), eng.factor(s)
    s_ref = ref.merge(s_ref, ref.client_stats(x_new, y_new))
    s = eng.merge(s, eng.client_stats(x_new, y_new))
    root = np.linalg.qr(x_new, mode="r")
    # the sweep itself, then the engine call (which would refactor on NaNs)
    _close(f.rank_update(root).handle, f_ref.rank_update(root).handle.T)
    u_ref, u = ref.factor_update(f_ref, s_ref, root), eng.factor_update(f, s, root)
    assert u.updatable and u_ref.updatable
    _close(u.handle, u_ref.handle.T)
    w = eng.factor_solve(u, s.moment)
    _close(w, ref.factor_solve(u_ref, s_ref.moment))
    _close(w, ref.solve(s_ref))


def test_solve_gamma_zero_rank_deficient_takes_pinv():
    """γ=0 on a Gram with exactly-zero rows and columns: Cholesky fails in
    both engines and both answer with the pseudo-inverse."""
    ref, eng = _engines()
    shards = _shards(4, zero_cols=4)
    s_ref, s = _aggregate(ref, shards), _aggregate(eng, shards)
    f_ref, f = ref.factor(s_ref), eng.factor(s)
    assert f.handle is None and f_ref.handle is None and not f.updatable
    w = eng.solve(s)
    _close(w, ref.solve(s_ref))
    assert np.all(to_numpy(w)[:4] == 0.0)


@pytest.mark.parametrize("use_ri", [True, False])
def test_solve_multi_gamma_matches(use_ri):
    ref, eng = _engines()
    shards = _shards(5)
    s_ref, s = _aggregate(ref, shards), _aggregate(eng, shards)
    gammas = [0.0, 0.1, 1.0, 10.0]
    for w, w_ref in zip(eng.solve_multi_gamma(s, gammas, use_ri=use_ri),
                        ref.solve_multi_gamma(s_ref, gammas, use_ri=use_ri)):
        _close(w, w_ref)


def test_solve_multi_gamma_rank_deficient_gamma_zero():
    """N < d at γ=0: the eigen path truncates the null space (pinv
    semantics) in both engines."""
    ref, eng = _engines()
    shards = _shards(6, d=16, sizes=(8,))
    s_ref, s = _aggregate(ref, shards), _aggregate(eng, shards)
    (w,), (w_ref,) = eng.solve_multi_gamma(s, [0.0]), ref.solve_multi_gamma(s_ref, [0.0])
    assert np.isfinite(to_numpy(w)).all()
    _close(w, w_ref)


def test_sweep_solve_with_pending_rank_update_matches():
    ref, eng = _engines()
    shards = _shards(7, d=24, sizes=(60, 40))
    s_ref, s = _aggregate(ref, shards), _aggregate(eng, shards)
    h_ref, h = ref.sweep_factor(s_ref), eng.sweep_factor(s)
    x_new, y_new = _shards(8, d=24, sizes=(3,))[0]
    s_ref = ref.merge(s_ref, ref.client_stats(x_new, y_new))
    s = eng.merge(s, eng.client_stats(x_new, y_new))
    h_ref, h = h_ref.rank_update(x_new), h.rank_update(x_new)
    assert h.rank == h_ref.rank == 3
    gammas = [0.1, 1.0]
    for w, w_ref in zip(eng.sweep_solve(h, s.moment, gammas),
                        ref.sweep_solve(h_ref, s_ref.moment, gammas)):
        _close(w, w_ref)


def test_kahan_update_matches_plain_sum_in_f64():
    _, eng = _engines()
    kahan = AnalyticEngine("torch", dtype=torch.float64, device="cpu", kahan=True)
    (x, y), = _shards(9, sizes=(40,))
    s, sk = eng.init(16, 3), kahan.init(16, 3)
    for i in range(0, 40, 10):
        s = eng.update(s, x[i:i + 10], y[i:i + 10])
        sk = kahan.update(sk, x[i:i + 10], y[i:i + 10])
    _close(sk.gram, to_numpy(s.gram))
    _close(sk.moment, to_numpy(s.moment))


@pytest.mark.parametrize("call", ["factor", "solve", "solve_multi_gamma", "rank_update"])
def test_kernel_path_solves_match_reference(call):
    """use_kernel=True at d = 16 in f64: the factor and solve of a system
    this narrow (blocked_cholesky, cholesky_solve), the γ sweep
    (multi_gamma_solve) and the rank update (chol_rank_update), each in
    its plain version on the CPU, against the numpy_f64 engine at 1e-10,
    the bar the reference holds its kernel solves to under x64. Systems of
    STREAM_MIN_DIM and wider are tests/test_torch_solve.py's."""
    ref, _ = _engines()
    eng = AnalyticEngine("torch", dtype=torch.float64, device="cpu", use_kernel=True)
    (x, y), = _shards(10, sizes=(40,))
    s_ref = ref.client_stats(x, y)
    # the reference's f64 statistics: the kernel route folds Gram updates in f32
    s = s_ref._replace(**{k: eng.backend.asarray(getattr(s_ref, k))
                          for k in ("gram", "moment", "count", "clients")})
    kernel_tol = dict(rtol=1e-10, atol=1e-10)
    if call == "factor":
        f, f_ref = eng.factor(s, target_gamma=0.5), ref.factor(s_ref, target_gamma=0.5)
        np.testing.assert_allclose(to_numpy(f.handle), f_ref.handle.T, **kernel_tol)
        got, want = eng.factor_solve(f, s.moment), ref.factor_solve(f_ref, s_ref.moment)
    elif call == "solve":
        got, want = eng.solve(s, use_ri=False), ref.solve(s_ref, use_ri=False)
    elif call == "solve_multi_gamma":
        got = np.stack([to_numpy(w) for w in eng.solve_multi_gamma(s, [0.1, 1.0])])
        want = np.stack(ref.solve_multi_gamma(s_ref, [0.1, 1.0]))
    else:
        f, f_ref = eng.factor(s), ref.factor(s_ref)
        got = eng.backend.rank_update(f, x[:2]).handle
        want = ref.backend.rank_update(f_ref, x[:2]).handle.T
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **kernel_tol)


def test_torch_backend_needs_explicit_cpu_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnalyticEngine("torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AFLClient(0, backend="torch")


def test_client_report_torch_f64_matches_numpy_client():
    """The port's torch-backend client emits the reference numpy client's
    report (gram, moment, count and QR root) from the same batches."""
    (x, y), = _shards(11, d=16, sizes=(12,))
    ref = RefClient(0, gamma=0.5)
    port = AFLClient(0, gamma=0.5, backend="torch", dtype=torch.float64, device="cpu")
    for i in range(0, 12, 4):
        ref.update(x[i:i + 4], y[i:i + 4])
        port.update(torch.from_numpy(x[i:i + 4]), torch.from_numpy(y[i:i + 4]))
    r_ref, r = ref.report(), port.report()
    _close(r.gram, r_ref.gram)
    _close(r.moment, r_ref.moment)
    assert r.count == r_ref.count == 12.0
    _close(r.root, r_ref.root)
