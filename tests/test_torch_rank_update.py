"""The blocked schedule of the port's rank-update kernel, proved on the CPU.

``kernels.ref.chol_rank_update_blocked_ref`` computes ``chol(L Lᵀ + xsᵀ
xs)`` as the CUDA ``chol_rank_update`` (``csrc/rank_update.cu``) does:
passes of at most ``K_PASS`` update rows, panels of ``NB`` columns swept on
their own rows, and each panel's compact-WY transform ``I − V T Vᵀ``
applied to the rows below. Here it is held, on numpy-seeded inputs,
against the sequential column sweep (``chol_rank_update_ref``, the plain
version the CPU route runs), the reference's Pallas ``chol_rank_update``
in interpret mode, and ``numpy.linalg.cholesky(L Lᵀ + xsᵀ xs)``. The CUDA
kernel itself is held to both plain versions on the card by
tests/test_torch_cuda.py (marked ``cuda``) and by chip_smoke.py.

Tolerances, each with its reason:
  * f64, blocked against sequential and against numpy: relative 1e-12 of
    the largest entry: the same reflections in another grouping, on
    factors with condition numbers below 10⁵;
  * f32, blocked against sequential and against numpy: relative 1e-4, the
    card tests' ``REL`` (the f32 bar of tests/test_distributed_cholesky.py);
  * against the Pallas kernel in interpret mode: rtol 1e-3 / atol 5e-4 of
    the largest entry, the reference's own f32 bar for its rank update
    (tests/test_torch_sweep.py, tests/test_solve_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro_torch.core.engine import to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rank_update as R
from repro_torch.kernels import solve as S

REL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """Largest error relative to the largest entry of ``b``."""
    a = to_numpy(a).astype(np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _problem(seed, d, k, zero_rows=()):
    """A lower factor of XᵀX/4d (condition number ≈ 9) and k normal update
    rows, some of them zero; both f64 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4 * d, d))
    a = x.T @ x / (4 * d)
    xs = rng.standard_normal((k, d))
    xs[list(zero_rows)] = 0.0
    return a, np.linalg.cholesky(a), xs


# (d, k, nb, k_pass, zero rows): the engine's shapes with a ragged d, a
# panel width that does not divide d, more rows than one pass, k = 1, and
# zero rows inside a panel
CASES = [
    pytest.param(130, 3, 32, 256, (1,), id="ragged-d130-k3"),
    pytest.param(2305, 144, R.NB, R.K_PASS, (0, 77), id="engine-d2305-k144"),
    pytest.param(100, 20, 7, 6, (3, 4, 5), id="nb7-kpass6-zero-rows"),
    pytest.param(200, 300, R.NB, R.K_PASS, (10, 299), id="two-passes-k300"),
    pytest.param(64, 1, R.NB, R.K_PASS, (), id="k1"),
    pytest.param(45, 50, 16, 24, tuple(range(0, 50, 3)), id="k-larger-than-nb"),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,k,nb,k_pass,zero_rows", CASES)
def test_blocked_twin_matches_sequential_sweep_and_numpy(d, k, nb, k_pass, zero_rows,
                                                         dtype):
    a, l, xs = _problem(d + k, d, k, zero_rows)
    lt, xt = torch.from_numpy(l).to(dtype), torch.from_numpy(xs).to(dtype)
    got = ref.chol_rank_update_blocked_ref(lt, xt, nb, k_pass)
    assert got.dtype == dtype and got.shape == (d, d)
    assert not torch.triu(got, 1).any() and torch.isfinite(got).all()
    assert _rel(got, ref.chol_rank_update_ref(lt, xt)) < REL[dtype]
    assert _rel(got, np.linalg.cholesky(a + xs.T @ xs)) < REL[dtype]


@pytest.mark.parametrize("d,k,nb", [(32, 2, 32), (48, 5, 32), (130, 3, 32), (130, 40, 16)])
def test_blocked_twin_matches_pallas(d, k, nb):
    """f32, against the reference's kernel run in interpret mode."""
    _, l, xs = _problem(7 * d + k, d, k, zero_rows=(k // 2,))
    got = ref.chol_rank_update_blocked_ref(torch.from_numpy(l).float(),
                                           torch.from_numpy(xs).float(), nb)
    want = np.asarray(RO.chol_rank_update(jnp.asarray(l, jnp.float32),
                                          jnp.asarray(xs, jnp.float32)), np.float64)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-3,
                               atol=5e-4 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_blocked_twin_zero_rows_are_a_no_op(dtype):
    """The s_ guard holds in both steps: all-zero update rows change
    nothing, bit for bit, in the panels and in the rows below them."""
    _, l, _ = _problem(3, 70, 1)
    lt = torch.from_numpy(l).to(dtype)
    got = ref.chol_rank_update_blocked_ref(lt, torch.zeros((5, 70), dtype=dtype), 32, 2)
    assert torch.equal(got, lt)


def test_blocked_twin_carries_nan():
    """A non-finite update entry comes out as NaN below its row, as the
    sequential sweep gives it; the rows above stay finite."""
    l = torch.eye(70, dtype=torch.float64)
    xs = torch.ones((2, 70), dtype=torch.float64)
    xs[1, 7] = float("nan")
    for out in (ref.chol_rank_update_blocked_ref(l, xs),
                ref.chol_rank_update_ref(l, xs)):
        assert torch.isnan(out[7:]).any() and torch.isnan(out[40:]).any()
        assert torch.isfinite(out[:7]).all()


def test_blocked_twin_k0_is_identity():
    l = torch.eye(5)
    assert ref.chol_rank_update_blocked_ref(l, torch.zeros((0, 5))) is l


def test_kernel_constants_and_launch_count():
    """One pass covers the engine's d//16 budget at d = 2304; a call at
    (2304, 64) makes one transpose and 72 panel and 71 trailing launches."""
    assert R.K_PASS >= 2304 // 16
    assert R.cuda_launches(2304, 64) == 1 + 72 + 71
    assert R.cuda_launches(2304, 300) == 2 * (1 + 72 + 71)
    assert R.cuda_launches(130, 3) == 1 + 5 + 4


def test_rank_update_wrapper_refuses_cpu_and_other_dtypes():
    """The CUDA wrapper never computes on the CPU (kernels.solve sends CPU
    tensors to the plain version), and takes f32 or f64 of one dtype."""
    before = R.chol_rank_update.launches
    l = torch.eye(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        R.chol_rank_update(l, torch.ones((2, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        R.chol_rank_update(l.bfloat16(), torch.ones((2, 8), dtype=torch.bfloat16))
    assert R.chol_rank_update.launches == before
    # the CPU route is the sequential plain version, in the input's dtype
    out = ops.chol_rank_update(l, torch.ones((2, 8), dtype=torch.float64))
    assert out.dtype == torch.float64
    assert _rel(out, np.linalg.cholesky(np.eye(8) + 2.0)) < 1e-14


def test_stream_block_is_dtype_aware():
    """f64 systems stream at panels of 128, the widest packed f64 triangle
    the panel kernel holds on one SM; f32 at DEFAULT_STREAM_BLOCK."""
    from repro_torch.kernels import panel as P

    assert S.stream_block(torch.float32) == S.DEFAULT_STREAM_BLOCK == P.MAX_PANEL[torch.float32]
    assert S.stream_block(torch.float64) == S.STREAM_BLOCK_F64 == P.MAX_PANEL[torch.float64]
    a = torch.from_numpy(_problem(9, 300, 1)[0])
    l64 = S.streamed_cholesky(a)
    assert _rel(l64, np.linalg.cholesky(a.numpy())) < 1e-12
    assert _rel(S.streamed_cholesky_solve(l64, a[:, :3]), np.eye(300)[:, :3]) < 1e-12
