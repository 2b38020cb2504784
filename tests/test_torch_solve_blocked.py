"""The schedules of the port's blocked solve and γ sweep, proved on the CPU.

``csrc/blocked.cu``'s ``cholesky_solve`` inverts every diagonal block with
``invert_blocked`` and runs both substitutions right-looking, a panel at a
time over the whole card: y_p = Z_p · r_p, then the rows below take
r −= L_{>p,p} · y_p (and mirrored, backward). Its ``multi_gamma_solve``
runs ``blocked_cholesky``'s panel schedule on C itself for every γ (γ_j
added at the first panel's diagonal load and trailing update, every
inverse kept), then that substitution with Q read by every γ.
``kernels.ref.solve_right_looking_ref`` and ``multi_gamma_blocked_ref``
run the same steps in plain torch. Here they are held, on numpy-seeded
inputs, to the plain versions the CPU route runs
(``ref.cholesky_solve_ref`` / ``ref.multi_gamma_solve_ref``), to numpy in
f64 and to the reference's Pallas ``cholesky_solve`` /
``multi_gamma_solve`` in interpret mode. The CUDA kernels themselves are
held to these twins and to the plain versions on the card by
tests/test_torch_cuda.py (marked ``cuda``) and by chip_smoke.py.

Tolerances, each with its reason:
  * f64: relative 1e-12 of the largest entry: the same products in
    another grouping, on systems with condition numbers near 10;
  * f32: the bars of tests/test_torch_sweep.py against the Pallas kernels,
    the reference's own against numpy (tests/test_solve_kernels.py):
    rtol 2e-4 / atol 2e-4·max for the solve, 2e-3 / 2e-4·max for the
    sweep — the same algorithm in f32 with sums in another order.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro_torch.core.engine import to_numpy
from repro_torch.kernels import blocked as B
from repro_torch.kernels import ops, ref

REL64 = 1e-12
F32_BAR = {"solve": (2e-4, 2e-4), "sweep": (2e-3, 2e-4)}    # (rtol, atol / largest entry)
DTYPES = [torch.float64, torch.float32]
# one entry, ragged below a sub-block, one panel, one past it, two past
# and ragged, three ragged panels; right-hand sides of 1, 7, 16 (the path's)
# and 40 columns; one system or three
WIDTHS = [1, 31, 128, 130, 257, 300]
COLS = [1, 7, 16, 40]
SOLVE_CASES = [(1 + 2 * (i % 2), d, c)
               for i, (d, c) in enumerate(itertools.product(WIDTHS, COLS))]   # (m, d, c)
SWEEP_CASES = [(d, COLS[i % len(COLS)], n_g)
               for i, (d, n_g) in enumerate(itertools.product(WIDTHS, [1, 11, 16]))]
# one case a width for the Pallas kernels, every c and every γ count among them
PALLAS_SOLVE = SOLVE_CASES[::5]
PALLAS_SWEEP = SWEEP_CASES[::3] + [SWEEP_CASES[-1]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(d, seed=0):
    """The reference tests' SPD system: XᵀX from 4d normal rows plus 0.5·I,
    in f64 numpy."""
    x = np.random.default_rng(1000 * seed + d).standard_normal((4 * d, d))
    return x.T @ x + 0.5 * np.eye(d)


def _rel(a, b):
    """Largest error relative to the largest entry of ``b``."""
    a = to_numpy(a).astype(np.float64)
    b = np.asarray(to_numpy(b) if isinstance(b, torch.Tensor) else b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _close(got, want, what):
    """At REL64 in f64, at the f32 bar of ``what`` otherwise."""
    want = np.asarray(to_numpy(want) if isinstance(want, torch.Tensor) else want, np.float64)
    if got.dtype == torch.float64:
        assert _rel(got, want) < REL64
        return
    rtol, atol = F32_BAR[what]
    np.testing.assert_allclose(to_numpy(got).astype(np.float64), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _solve_inputs(m, d, c, seed=0):
    """m factors (f64 numpy) of seeded SPD systems, their systems and
    right-hand sides."""
    a = np.stack([_spd(d, seed + i) for i in range(m)])
    b = np.random.default_rng(seed + d + c).standard_normal((m, d, c))
    return np.linalg.cholesky(a), a, b


def _sweep_inputs(d, c, n_g, seed=0):
    c_mat = _spd(d, seed)
    q = np.random.default_rng(seed + d + c).standard_normal((d, c))
    gammas = np.logspace(-2, 1, n_g)
    return c_mat, q, gammas


def _garbage_above(a):
    """``a`` with 7s above its diagonal: a routine that reads only the lower
    triangle gives the same bits."""
    return a + torch.triu(torch.full_like(a, 7.0), 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,c", SOLVE_CASES)
def test_solve_twin_matches_plain_and_numpy(m, d, c, dtype):
    lo, a, b = _solve_inputs(m, d, c)
    l = torch.from_numpy(lo).to(dtype)
    bt = torch.from_numpy(b).to(dtype)
    x = ref.solve_right_looking_ref(l, bt)
    assert x.dtype == dtype and x.shape == (m, d, c) and torch.isfinite(x).all()
    _close(x, ref.cholesky_solve_ref(l, bt), "solve")
    _close(x, np.linalg.solve(a, b), "solve")
    zs = [ref.invert_blocked_ref(l[..., o:o + B.PANEL, o:o + B.PANEL])
          for o in range(0, d, B.PANEL)]
    assert torch.equal(ref.solve_right_looking_ref(l, bt, zs), x)   # inverses handed in


@pytest.mark.parametrize("m,d,c", PALLAS_SOLVE)
def test_solve_twin_matches_pallas(m, d, c):
    """f32, against the reference's cholesky_solve in interpret mode on the
    same factors."""
    lo, _, b = _solve_inputs(m, d, c, seed=1)
    l32, b32 = lo.astype(np.float32), b.astype(np.float32)
    x = ref.solve_right_looking_ref(torch.from_numpy(l32), torch.from_numpy(b32))
    _close(x, np.asarray(RO.cholesky_solve(jnp.asarray(l32), jnp.asarray(b32))), "solve")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,c,n_g", SWEEP_CASES)
def test_sweep_twin_matches_plain_and_numpy(d, c, n_g, dtype):
    c_mat, q, gammas = _sweep_inputs(d, c, n_g)
    args = [torch.from_numpy(v).to(dtype) for v in (c_mat, q, gammas)]
    w = ref.multi_gamma_blocked_ref(*args)
    assert w.dtype == dtype and w.shape == (n_g, d, c) and torch.isfinite(w).all()
    plain = ref.multi_gamma_solve_ref(*args)
    for j, g in enumerate(gammas):
        _close(w[j], plain[j], "sweep")
        _close(w[j], np.linalg.solve(c_mat + g * np.eye(d), q), "sweep")


@pytest.mark.parametrize("d,c,n_g", PALLAS_SWEEP)
def test_sweep_twin_matches_pallas(d, c, n_g):
    """f32, against the reference's multi_gamma_solve in interpret mode."""
    vals = [v.astype(np.float32) for v in _sweep_inputs(d, c, n_g, seed=2)]
    w = ref.multi_gamma_blocked_ref(*map(torch.from_numpy, vals))
    want = np.asarray(RO.multi_gamma_solve(*map(jnp.asarray, vals)))
    for j in range(n_g):
        _close(w[j], want[j], "sweep")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_twins_do_not_read_the_upper_triangle(d, dtype):
    """A factor (or a C) whose upper triangle holds garbage gives the same
    bits."""
    lo, _, b = _solve_inputs(2, d, 7, seed=3)
    l, bt = torch.from_numpy(lo).to(dtype), torch.from_numpy(b).to(dtype)
    assert torch.equal(ref.solve_right_looking_ref(_garbage_above(l), bt),
                       ref.solve_right_looking_ref(l, bt))
    c_mat, q, gammas = (torch.from_numpy(v).to(dtype) for v in _sweep_inputs(d, 5, 3, seed=3))
    assert torch.equal(ref.multi_gamma_blocked_ref(_garbage_above(c_mat), q, gammas),
                       ref.multi_gamma_blocked_ref(c_mat, q, gammas))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [31, 130, 257])
def test_sweep_twin_singular_gamma_gives_nan_in_that_gamma_only(d, dtype):
    """C with an all-zero row and column (at d // 2, in the last panel but
    one past 128): at γ = 0 the pivot there is exactly zero, so that γ's
    weights carry NaN, as the plain version's do; the other γs stay finite
    and agree with numpy."""
    x = np.random.default_rng(d).standard_normal((4 * d, d))
    x[:, d // 2] = 0.0
    c_mat = x.T @ x
    q = np.random.default_rng(d + 1).standard_normal((d, 3))
    gammas = np.array([1.0, 0.0, 0.5])
    args = [torch.from_numpy(v).to(dtype) for v in (c_mat, q, gammas)]
    for w in (ref.multi_gamma_blocked_ref(*args), ref.multi_gamma_solve_ref(*args)):
        assert torch.isnan(w[1]).any()
        assert torch.isfinite(w[0]).all() and torch.isfinite(w[2]).all()
    w = ref.multi_gamma_blocked_ref(*args)
    for j in (0, 2):
        _close(w[j], np.linalg.solve(c_mat + gammas[j] * np.eye(d), q), "sweep")


@pytest.mark.parametrize("d,solve,sweep", [(1, 3, 3), (128, 3, 3), (129, 7, 10),
                                           (257, 11, 17), (1536, 47, 80), (2304, 71, 122)])
def test_solve_and_sweep_cuda_launches(d, solve, sweep):
    """cholesky_solve: one inverse grid, then two grids a panel each way but
    the last's update, 4·⌈d/128⌉ − 1; multi_gamma_solve: the factor's
    3·⌈d/128⌉ − 2, then the same substitutions."""
    n = -(-d // B.PANEL)
    assert B.solve_cuda_launches(d) == solve == 1 + 2 * (2 * n - 1)
    assert B.sweep_cuda_launches(d) == sweep == B.cuda_launches(d) + solve - 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_routes_stay_the_plain_versions(dtype):
    """On the CPU the solve and the sweep take their plain versions, never
    the twins; the CUDA wrappers refuse CPU tensors and count nothing."""
    lo, _, b = _solve_inputs(2, 130, 7, seed=4)
    l, bt = torch.from_numpy(lo).to(dtype), torch.from_numpy(b).to(dtype)
    assert torch.equal(ops.cholesky_solve(l, bt), ref.cholesky_solve_ref(l, bt))
    c_mat, q, gammas = (torch.from_numpy(v).to(dtype) for v in _sweep_inputs(130, 7, 3))
    assert torch.equal(ops.multi_gamma_solve(c_mat, q, gammas),
                       ref.multi_gamma_solve_ref(c_mat, q, gammas))
    before = (B.cholesky_solve.launches, B.multi_gamma_solve.launches)
    with pytest.raises(ValueError, match="CUDA"):
        B.cholesky_solve(l, bt)
    with pytest.raises(ValueError, match="CUDA"):
        B.multi_gamma_solve(c_mat, q, gammas)
    assert (B.cholesky_solve.launches, B.multi_gamma_solve.launches) == before
