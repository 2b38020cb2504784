"""``repro_torch.core.analytic`` against ``repro.core.analytic``.

Both are host f64 over a ``numpy_f64`` engine, so every public function is
held to the reference's answer at 1e-12 (relative to the largest entry of
the reference's answer, or absolute below 1). The paper's claims are checked
on the port's own answers as the reference's tests check them: the pairwise
AA recursion equals the sufficient-statistics form, the RI restore gives the
joint solution, the no-RI aggregate carries the Kγ bias, rank-deficient
clients (N_k < d) stay exact, γ = 0 on a rank-deficient system takes the
pinv, and clients with different γ are refused with the reference's error.
Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

from repro.core import analytic as RA
from repro_torch.core import analytic as PA

TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _data(seed, n, d, c):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), np.eye(c)[rng.integers(0, c, n)]


def _split(seed, x, y, k, uneven=True):
    """Rows in k non-empty chunks, as tests/test_core_analytic.py splits."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    perm = rng.permutation(n)
    if uneven:
        cuts = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False))
    else:
        cuts = np.arange(1, k) * (n // k)
    return [(x[p], y[p]) for p in np.split(perm, cuts)]


def _updates(mod, parts, gamma):
    return [mod.local_stage(xi, yi, gamma) for xi, yi in parts]


@pytest.mark.parametrize("n,d,c,gamma", [
    (200, 32, 5, 0.5),
    (100, 16, 4, 0.0),      # full rank: eq (4), the MP solution
    (8, 16, 4, 0.0),        # N < d at γ = 0: the pinv fallback
    (300, 24, 6, 10.0),
])
def test_ridge_solve_matches_reference(n, d, c, gamma):
    x, y = _data(0, n, d, c)
    w = PA.ridge_solve(x, y, gamma)
    _close(w, RA.ridge_solve(x, y, gamma))
    if gamma == 0.0:
        np.testing.assert_allclose(w, np.linalg.pinv(x) @ y, atol=1e-8)
    else:
        np.testing.assert_allclose((x.T @ x + gamma * np.eye(d)) @ w, x.T @ y,
                                   atol=1e-9)


@pytest.mark.parametrize("n,gamma", [(150, 1.0), (10, 0.25)])
def test_local_stage_matches_reference(n, gamma):
    x, y = _data(1, n, 16, 4)
    got, want = PA.local_stage(x, y, gamma), RA.local_stage(x, y, gamma)
    assert isinstance(got, PA.ClientUpdate)
    assert (got.gamma, got.dim) == (want.gamma, want.dim) == (gamma, 16)
    _close(got.weight, want.weight)
    _close(got.gram, want.gram)
    np.testing.assert_allclose(got.gram, x.T @ x + gamma * np.eye(16), atol=1e-12)


def test_aa_merge_two_clients_matches_reference_and_joint():
    x, y = _data(3, 300, 24, 6)
    (xu, yu), (xv, yv) = _split(3, x, y, 2)
    args = (PA.ridge_solve(xu, yu, 0.0), xu.T @ xu,
            PA.ridge_solve(xv, yv, 0.0), xv.T @ xv)
    w, c = PA.aa_merge(*args)
    w_ref, c_ref = RA.aa_merge(*args)
    _close(w, w_ref)
    _close(c, c_ref)
    np.testing.assert_allclose(w, PA.ridge_solve(x, y, 0.0), atol=1e-8)
    np.testing.assert_allclose(c, x.T @ x, atol=1e-8)


@pytest.mark.parametrize("k", [2, 5, 9])
def test_pairwise_equals_sufficient_stats(k):
    x, y = _data(4, 400, 16, 4)
    parts = _split(4, x, y, k)
    ups, ups_ref = _updates(PA, parts, 1.0), _updates(RA, parts, 1.0)
    w_pair, c_pair = PA.aggregate_pairwise(ups)
    w_stat, c_stat = PA.aggregate_sufficient_stats(ups)
    for got, want in [((w_pair, c_pair), RA.aggregate_pairwise(ups_ref)),
                      ((w_stat, c_stat), RA.aggregate_sufficient_stats(ups_ref))]:
        _close(got[0], want[0])
        _close(got[1], want[1])
    np.testing.assert_allclose(w_pair, w_stat, atol=1e-8)
    np.testing.assert_allclose(c_pair, c_stat, atol=1e-8)
    # the AA recursion in another order gives the same aggregate
    w_rev, _ = PA.aggregate_pairwise(ups[::-1])
    np.testing.assert_allclose(w_rev, w_pair, atol=1e-8)


@pytest.mark.parametrize("target_gamma", [0.0, 0.3])
def test_ri_restore_matches_reference(target_gamma):
    x, y = _data(7, 300, 16, 4)
    gamma, k = 2.0, 4
    ups = _updates(PA, _split(7, x, y, k), gamma)
    w_r, c_r = PA.aggregate_sufficient_stats(ups)
    w = PA.ri_restore(w_r, c_r, k, gamma, target_gamma=target_gamma)
    _close(w, RA.ri_restore(w_r, c_r, k, gamma, target_gamma=target_gamma))
    np.testing.assert_allclose(w, PA.ridge_solve(x, y, target_gamma), atol=1e-8)


@pytest.mark.parametrize("gamma", [0.1, 1.0, 10.0, 100.0])
@pytest.mark.parametrize("pairwise", [False, True])
def test_afl_aggregate_with_ri_is_joint(gamma, pairwise):
    x, y = _data(5, 500, 32, 8)
    parts = _split(5, x, y, 10)
    w = PA.afl_aggregate(_updates(PA, parts, gamma), use_ri=True, pairwise=pairwise)
    _close(w, RA.afl_aggregate(_updates(RA, parts, gamma), use_ri=True,
                               pairwise=pairwise))
    np.testing.assert_allclose(w, PA.ridge_solve(x, y, 0.0), atol=1e-7)


@pytest.mark.parametrize("pairwise", [False, True])
def test_afl_aggregate_without_ri_is_biased(pairwise):
    x, y = _data(6, 500, 32, 8)
    parts = _split(6, x, y, 10)
    w = PA.afl_aggregate(_updates(PA, parts, 100.0), use_ri=False, pairwise=pairwise)
    _close(w, RA.afl_aggregate(_updates(RA, parts, 100.0), use_ri=False,
                               pairwise=pairwise))
    assert np.abs(w - PA.ridge_solve(x, y, 0.0)).max() > 1e-3   # the Kγ bias


def test_rank_deficient_clients_stay_exact():
    """Table A.1 regime: 40 clients of 16 rows each at d = 64."""
    x, y = _data(8, 40 * 16, 64, 10)
    parts = _split(8, x, y, 40, uneven=False)
    w = PA.afl_aggregate(_updates(PA, parts, 1.0), use_ri=True)
    _close(w, RA.afl_aggregate(_updates(RA, parts, 1.0), use_ri=True))
    assert np.abs(w - PA.ridge_solve(x, y, 0.0)).max() < 1e-7


def test_mismatched_gamma_raises_the_reference_error():
    x, y = _data(9, 100, 8, 3)
    parts = _split(9, x, y, 2)
    msgs = []
    for mod in (RA, PA):
        ups = [mod.local_stage(*parts[0], 1.0), mod.local_stage(*parts[1], 2.0)]
        with pytest.raises(ValueError) as err:
            mod.afl_aggregate(ups)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_empty_pairwise_raises():
    for mod in (RA, PA):
        with pytest.raises(ValueError, match="no client updates"):
            mod.aggregate_pairwise([])
