"""The blocked micro-routines of the port's diagonal blocks, proved on the CPU.

``csrc/tri_blocked.cuh`` factors and inverts one diagonal block in
32-wide sub-blocks: ``invert_blocked`` (the warp-level inverse of each
sub-block, then merges Z21 = −Z22 · L21 · Z11 level by level) carries the
CUDA ``panel_tri_inv`` and the inverse of ``blocked_cholesky``'s diagonal
step, ``factor_blocked`` (a warp-level factor of each diagonal sub-block,
the rows below by forward substitution, a rank-32 update) its factor.
``kernels.ref.invert_blocked_ref`` and ``factor_blocked_ref`` run the same
sub-blocks, padding and merge levels in plain torch. Here they are held, on
numpy-seeded inputs, to the sequential column loops the CPU route runs
(``ref.tri_inv_tile`` / ``ref.factor_tile``), to numpy in f64 and to the
reference's Pallas ``panel_tri_inv`` / ``panel_factor`` in interpret mode.
The CUDA kernels themselves are held to these twins and to the plain
versions on the card by tests/test_torch_cuda.py (marked ``cuda``) and by
chip_smoke.py.

Tolerances, each with its reason:
  * f64: relative 1e-12 of the largest entry: the same substitutions in
    another grouping, on blocks with condition numbers near 9;
  * f32: relative 1e-5 of the largest entry, the bar of
    tests/test_torch_solve.py for the panel functions against the Pallas
    kernels (the same algorithm in f32, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import solve as RS
from repro_torch.core.engine import to_numpy
from repro_torch.kernels import blocked as B
from repro_torch.kernels import ops, ref
from repro_torch.kernels import panel as P

REL = {torch.float64: 1e-12, torch.float32: 1e-5}
# one and two sub-blocks ragged, exact, one past; the blocked factor's
# width and one ragged past it; panel_tri_inv's ragged and full widths
WIDTHS = [1, 31, 32, 33, 128, 130, 200, 256]
DTYPES = [torch.float64, torch.float32]


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
    b = np.asarray(to_numpy(b) if isinstance(b, torch.Tensor) else b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _spd(b, seed=0):
    """An SPD (b, b) block XᵀX / 4b from 4b normal rows (condition number
    ≈ 9) in f64 numpy."""
    x = np.random.default_rng(1000 * seed + b).standard_normal((4 * b, b))
    return x.T @ x / (4 * b)


def _garbage_above(a):
    """``a`` with 7s above its diagonal: a routine that reads only the lower
    triangle gives the same bits."""
    return a + torch.triu(torch.full_like(a, 7.0), 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", WIDTHS)
def test_invert_blocked_twin_matches_column_loop_and_numpy(b, dtype):
    lo = np.linalg.cholesky(_spd(b))
    l = torch.from_numpy(lo).to(dtype)
    z = ref.invert_blocked_ref(l)
    assert z.dtype == dtype and z.shape == (b, b)
    assert torch.isfinite(z).all() and not torch.triu(z, 1).any()
    assert _rel(z, ref.tri_inv_tile(l)) < REL[dtype]
    assert _rel(z, np.linalg.inv(lo)) < REL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", WIDTHS)
def test_factor_blocked_twin_matches_column_loop_and_numpy(b, dtype):
    a = _spd(b)
    at = torch.from_numpy(a).to(dtype)
    l = ref.factor_blocked_ref(at)
    assert l.dtype == dtype and l.shape == (b, b)
    assert torch.isfinite(l).all() and not torch.triu(l, 1).any()
    assert _rel(l, ref.factor_tile(at)) < REL[dtype]
    assert _rel(l, np.linalg.cholesky(a)) < REL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", WIDTHS)
def test_twins_do_not_read_the_upper_triangle(b, dtype):
    a = torch.from_numpy(_spd(b, seed=1)).to(dtype)
    l = ref.factor_blocked_ref(a)
    assert torch.equal(ref.factor_blocked_ref(_garbage_above(a)), l)
    assert torch.equal(ref.invert_blocked_ref(_garbage_above(l)), ref.invert_blocked_ref(l))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [33, 128, 256])
def test_twins_give_nan_on_a_block_that_is_not_positive_definite(b, dtype):
    """A rank-3 block: NaN in the factor (sqrt of a negative pivot), as the
    column loop gives it, carried into the inverse; the upper triangles
    stay exact zeros."""
    x = np.random.default_rng(b).standard_normal((3, b))
    a = torch.from_numpy(x.T @ x).to(dtype)
    l = ref.factor_blocked_ref(a)
    assert torch.isnan(l).any() and torch.isnan(ref.factor_tile(a)).any()
    z = ref.invert_blocked_ref(l)
    assert torch.isnan(z).any()
    assert not torch.triu(l, 1).any() and not torch.triu(z, 1).any()


@pytest.mark.parametrize("b", [32, 33, 64, 130, 200, 256])
def test_twins_match_pallas_panel_kernels(b):
    """f32, against the reference's panel_factor and panel_tri_inv run in
    interpret mode on the same block."""
    a = _spd(b, seed=2).astype(np.float32)
    l_ref, z_ref = RS.panel_factor(jnp.asarray(a), interpret=True)
    l = ref.factor_blocked_ref(torch.from_numpy(a))
    assert _rel(l, np.asarray(l_ref)) < REL[torch.float32]
    lf = np.array(l_ref, np.float32)
    z = ref.invert_blocked_ref(torch.from_numpy(lf))
    assert _rel(z, np.asarray(z_ref)) < REL[torch.float32]
    z_tri = RS.panel_tri_inv(jnp.asarray(lf), interpret=True)
    assert _rel(z, np.asarray(z_tri)) < REL[torch.float32]


@pytest.mark.parametrize("b,dtype", [(256, torch.float32), (128, torch.float64)])
def test_panel_factor_twin_matches_column_loops_and_numpy(b, dtype):
    """The CUDA panel_factor's schedule (the blocked factor, then the
    blocked inverse of it) at the streamed path's widths: the f32 panel of
    256 and the f64 panel of 128."""
    a = _spd(b, seed=3)
    at = torch.from_numpy(a).to(dtype)
    l, z = ref.panel_factor_blocked_ref(at)
    assert l.dtype == z.dtype == dtype and l.shape == z.shape == (b, b)
    for t in (l, z):
        assert torch.isfinite(t).all() and not torch.triu(t, 1).any()
    l_ref, z_ref = ref.panel_factor_ref(at)
    assert _rel(l, l_ref) < REL[dtype] and _rel(z, z_ref) < REL[dtype]
    lo = np.linalg.cholesky(a)
    assert _rel(l, lo) < REL[dtype] and _rel(z, np.linalg.inv(lo)) < REL[dtype]
    assert torch.equal(ref.panel_factor_blocked_ref(_garbage_above(at))[1], z)


@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_factor_twin_gives_nan_on_a_block_that_is_not_positive_definite(dtype):
    """A rank-3 block: NaN in L and in Z, as the column loops give it; the
    upper triangles stay exact zeros."""
    b = 256 if dtype == torch.float32 else 128
    x = np.random.default_rng(b + 1).standard_normal((3, b))
    a = torch.from_numpy(x.T @ x).to(dtype)
    l, z = ref.panel_factor_blocked_ref(a)
    assert torch.isnan(l).any() and torch.isnan(z).any()
    assert torch.isnan(ref.panel_factor_ref(a)[0]).any()
    assert not torch.triu(l, 1).any() and not torch.triu(z, 1).any()


@pytest.mark.parametrize("d,launches", [(1, 1), (128, 1), (129, 4), (130, 4), (257, 7),
                                        (1536, 34), (2047, 46)])
def test_blocked_cholesky_cuda_launches(d, launches):
    """One diagonal kernel a panel of 128, and a trsm and a trailing update
    for every panel but the last: 3·⌈d/128⌉ − 2, at most 3·⌈d/128⌉."""
    assert B.cuda_launches(d) == launches <= 3 * -(-d // B.PANEL)


def test_widths_the_kernels_take():
    """panel_tri_inv keeps its widths (the streamed schedule's panels), and
    the blocked factor's panels are four sub-blocks."""
    assert P.MAX_PANEL == {torch.float32: 256, torch.float64: 128}
    assert B.PANEL == ref.BLOCK == 4 * ref.SUB


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_routes_stay_the_column_loops(dtype):
    """On the CPU panel_tri_inv and blocked_cholesky take their plain
    versions (the column loops); the CUDA wrappers refuse CPU tensors and
    count nothing."""
    a = torch.from_numpy(_spd(130)).to(dtype)
    l = ops.blocked_cholesky(a[None])[0]
    assert torch.equal(l, ref.blocked_cholesky_ref(a[None])[0])
    assert torch.equal(ops.panel_tri_inv(l[:128, :128]), ref.tri_inv_tile(l[:128, :128]))
    before = (B.blocked_cholesky.launches, P.panel_tri_inv.launches)
    with pytest.raises(ValueError, match="CUDA"):
        B.blocked_cholesky(a[None])
    with pytest.raises(ValueError, match="CUDA"):
        P.panel_tri_inv(l[:128, :128])
    assert (B.blocked_cholesky.launches, P.panel_tri_inv.launches) == before
