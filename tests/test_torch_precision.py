"""The solve's ``precision="f32_x2"`` on the port, held to the reference.

The reference's ``precision="f32_x2"`` (``src/repro/kernels/solve.py``:
``_split``, ``_make_mm``, ``_make_mm2``) splits each operand of the trsm,
trailing-update and substitution products into exact 12-bit halves (a
Dekker split at 4097) and sums three products of halves,
``hh + (hl + lh)``; the diagonal blocks stay native. The port takes the
same keyword on ``kernels.solve``'s entry points and schedules and on
``kernels.ops``' panel products; on CPU tensors they run the plain
versions in ``kernels.ref`` (``split_ref``, ``mm_x2``), which are also
what the CUDA split instances are held to on the card
(tests/test_torch_cuda.py, marked ``cuda``, and chip_smoke.py).

Here, on numpy-seeded inputs, each function's f32_x2 result is held to
the reference's f32_x2 in interpret mode at max |Δ| / max |ref| ≤ 1e-5
(the same split products in another sum order, f32, systems with
condition numbers near 10); the reference test's property
(tests/test_solve_kernels.py: x2's error ≤ 4 × native's + 1e-9 and
< 1e-4 against f64) is reproduced on the port; the split is exact, bit
for bit; f32_x2 on f64 and an unknown name raise ``ValueError`` (the
reference takes both); and ``"native"`` is the default's bits, which
f32_x2's differ from. Where no sum order is left to differ (the panel
products at b = 1, the solve on a factor with one nonzero term in every
output of every product), the port's f32_x2 is the reference's, bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as RO
from repro.kernels import solve as RS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import solve as S

X2 = "f32_x2"
REL = 1e-5
BLOCKED_D = [96, 200]          # one panel; two, the second ragged (the reference pads)
STREAM = [(96, 32), (200, 32)]  # (d, block): three panels; seven, padded to 224


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(d, n_mult=4, seed=0):
    """The reference tests' SPD system: XᵀX from n_mult·d normal rows plus
    0.5·I, f64 numpy."""
    x = np.random.default_rng(1000 * seed + d).standard_normal((n_mult * d, d))
    return x.T @ x + 0.5 * np.eye(d)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _rel(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _check(got, want):
    assert got.dtype == torch.float32 and tuple(got.shape) == np.shape(want)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= REL


# --- each function against the reference's f32_x2 ------------------------------

@pytest.mark.parametrize("d", BLOCKED_D)
@pytest.mark.parametrize("m", [1, 2])
def test_blocked_cholesky(d, m):
    a = np.stack([_spd(d, seed=i) for i in range(m)]).astype(np.float32)
    want = np.asarray(RO.blocked_cholesky(_j(a), precision=X2))
    _check(S.blocked_cholesky(_t(a), precision=X2), want)


def _solve_inputs(d, c, m=2, seed=1):
    a = np.stack([_spd(d, seed=seed + i) for i in range(m)])
    return np.linalg.cholesky(a).astype(np.float32), _normal(seed + d, m, d, c)


@pytest.mark.parametrize("d", BLOCKED_D)
@pytest.mark.parametrize("c", [1, 16])
def test_cholesky_solve(d, c):
    l, b = _solve_inputs(d, c)
    want = np.asarray(RO.cholesky_solve(_j(l), _j(b), precision=X2))
    _check(S.cholesky_solve(_t(l), _t(b), precision=X2), want)


@pytest.mark.parametrize("d", BLOCKED_D)
@pytest.mark.parametrize("c", [1, 16])
def test_cholesky_solve_twin(d, c):
    """The plain twin of the CUDA substitution's right-looking schedule
    (what the card's split instance is held to)."""
    l, b = _solve_inputs(d, c)
    want = np.asarray(RO.cholesky_solve(_j(l), _j(b), precision=X2))
    _check(ref.solve_right_looking_ref(_t(l), _t(b), precision=X2), want)


def _one_term_factor(d, seed=8):
    """A lower factor with at most one nonzero term in every output of
    every substitution product: diagonal blocks diagonal, and below each
    one entry a row of the next panel, in distinct columns
    (tests/test_torch_cuda.py's ``_one_term_system``, factored)."""
    rng = np.random.default_rng(seed + d)
    a = np.diag(2 + rng.random(d))
    for o in range(128, d, 128):
        rows = np.arange(o, min(o + 128, d))
        cols = o - 128 + rng.permutation(128)[:rows.size]
        a[rows, cols] = a[cols, rows] = rng.random(rows.size) - 0.5
    return np.linalg.cholesky(a).astype(np.float32), rng


@pytest.mark.parametrize("d", BLOCKED_D + [300])
def test_cholesky_solve_one_term_bits(d):
    """No sum order is left to differ: the port's split substitutions give
    the reference's f32_x2 bits, and other bits than native."""
    l, rng = _one_term_factor(d)
    b = rng.standard_normal((1, d, 5)).astype(np.float32)
    got = S.cholesky_solve(_t(l)[None], _t(b), precision=X2)
    want = np.asarray(RO.cholesky_solve(_j(l)[None], _j(b), precision=X2))
    assert np.array_equal(got.numpy(), want)
    assert not torch.equal(got, S.cholesky_solve(_t(l)[None], _t(b)))


def _sweep_inputs(d, c, n_g, seed=3):
    gammas = np.logspace(-2, 1, n_g).astype(np.float32)
    return _spd(d, seed=seed).astype(np.float32), _normal(seed + d, d, c), gammas


@pytest.mark.parametrize("d", BLOCKED_D)
@pytest.mark.parametrize("n_g", [1, 11])
def test_multi_gamma_solve(d, n_g):
    c_mat, q, gammas = _sweep_inputs(d, 6, n_g)
    want = np.asarray(RO.multi_gamma_solve(_j(c_mat), _j(q), _j(gammas), precision=X2))
    _check(S.multi_gamma_solve(_t(c_mat), _t(q), _t(gammas), precision=X2), want)


@pytest.mark.parametrize("d", BLOCKED_D)
@pytest.mark.parametrize("n_g", [1, 11])
def test_multi_gamma_solve_twin(d, n_g):
    """The plain twin of the CUDA sweep's schedule (γ added at the first
    panel, the trailing diagonal written (a + γ) − v)."""
    c_mat, q, gammas = _sweep_inputs(d, 6, n_g)
    want = np.asarray(RO.multi_gamma_solve(_j(c_mat), _j(q), _j(gammas), precision=X2))
    _check(ref.multi_gamma_blocked_ref(_t(c_mat), _t(q), _t(gammas), X2), want)


@pytest.mark.parametrize("r,b", [(192, 32), (200, 40), (64, 1)])
def test_panel_trsm(r, b):
    raw = _normal(r + b, r, b)
    zinv = np.tril(_normal(r + b + 1, b, b))
    want = np.asarray(RS.panel_trsm(_j(raw), _j(zinv), precision=X2, interpret=True))
    got = ops.panel_trsm(_t(raw), _t(zinv), precision=X2)
    _check(got, want)
    if b == 1:          # one exact product of halves an output: the same bits
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("r,w,b", [(192, 160, 32), (200, 72, 40), (64, 48, 1)])
def test_panel_update(r, w, b):
    trail, lp, pt = _normal(r + w, r, w), _normal(r + b, r, b), _normal(w + b, w, b)
    want = np.asarray(RS.panel_update(_j(trail), _j(lp), _j(pt), precision=X2,
                                      interpret=True))
    got = ops.panel_update(_t(trail), _t(lp), _t(pt), precision=X2)
    _check(got, want)
    into = _t(trail)                                   # in place, as the schedule does
    ops.panel_update(into, _t(lp), _t(pt), out=into, precision=X2)
    _check(into, want)
    if b == 1:          # trail − (hh + (hl + lh)) of exact products: the same bits
        assert np.array_equal(got.numpy(), want) and torch.equal(into, got)


@pytest.mark.parametrize("d,block", STREAM)
def test_streamed_cholesky(d, block):
    a = _spd(d, seed=4).astype(np.float32)
    want = np.asarray(RO.streamed_cholesky(_j(a), block=block, precision=X2))
    _check(S.streamed_cholesky(_t(a), block=block, precision=X2), want)


@pytest.mark.parametrize("d,block", STREAM)
def test_streamed_cholesky_solve(d, block):
    a = _spd(d, seed=5)
    l = np.linalg.cholesky(a).astype(np.float32)
    b = _normal(d, d, 16)
    want = np.asarray(RO.streamed_cholesky_solve(_j(l), _j(b), block=block, precision=X2))
    _check(S.streamed_cholesky_solve(_t(l), _t(b), block=block, precision=X2), want)


def _one_shard(block):
    return dict(shard=0, n_shards=1, gather=lambda v: v[None], block=block)


@pytest.mark.parametrize("d,block", [(96, 32), (128, 64)])
def test_tile_schedules_at_one_shard(d, block):
    """``tile_cholesky_factor`` and ``tile_cholesky_solve`` with one shard's
    collectives: the factor, its inverse diagonal blocks and the solve."""
    a = _spd(d, seed=6).astype(np.float32)
    q = _normal(d + 1, d, 5)
    work, zs = S.tile_cholesky_factor(_t(a), precision=X2, **_one_shard(block))
    work_r, zs_r = RS.tile_cholesky_factor(_j(a), precision=X2, interpret=True,
                                           **_one_shard(block))
    _check(work, np.asarray(work_r))
    for z, z_r in zip(zs, zs_r):
        _check(z, np.asarray(z_r))
    x = S.tile_cholesky_solve(work, _t(q), zs, psum=lambda v: v, precision=X2,
                              **_one_shard(block))
    x_r = RS.tile_cholesky_solve(work_r, _j(q), zs_r, psum=lambda v: v, precision=X2,
                                 interpret=True, **_one_shard(block))
    _check(x, np.asarray(x_r))


# --- the reference test's property, on the port ---------------------------------

def _errs(d, solve):
    """``solve(C, Q, γ, precision)`` → W at native and f32_x2, each as
    max |W − W64| / max |W64| against the f64 solve; the reference's
    system (n_mult = 8, seed 5) at γ = 0.5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8 * d, d))
    a = x.T @ x
    q = rng.standard_normal((d, 5))
    want = np.linalg.solve(a + 0.5 * np.eye(d), q)
    return {p: _rel(solve(_t(a), _t(q), 0.5, p), want) for p in ("native", X2)}


def _blocked(c, q, g, p):
    sys = (c + g * torch.eye(c.shape[0]))[None]
    return S.cholesky_solve(S.blocked_cholesky(sys, precision=p), q[None], precision=p)[0]


def _streamed(c, q, g, p):
    sys = c + g * torch.eye(c.shape[0])
    return S.streamed_cholesky_solve(S.streamed_cholesky(sys, block=32, precision=p), q,
                                     block=32, precision=p)


SOLVERS = {"sweep": lambda c, q, g, p: S.multi_gamma_solve(c, q, [g], precision=p)[0],
           "blocked": _blocked, "streamed": _streamed}


@pytest.mark.parametrize("d", [96, 200])
@pytest.mark.parametrize("route", sorted(SOLVERS))
def test_x2_stays_within_f32(route, d):
    """tests/test_solve_kernels.py's bound: on exact-f32 arithmetic the
    split is about neutral, no worse than 4 × native + 1e-9, below 1e-4."""
    errs = _errs(d, SOLVERS[route])
    assert errs[X2] <= 4 * errs["native"] + 1e-9
    assert errs[X2] < 1e-4


# --- the split -------------------------------------------------------------------

def _sig_bits(v: np.ndarray) -> np.ndarray:
    """Significant bits of each f32 value: from its leading to its last one
    bit (0 for zero)."""
    mant = np.abs(np.frexp(v.astype(np.float64))[0]) * 2.0 ** 24   # f32: 24-bit significands
    out = []
    for m in mant.astype(np.int64).tolist():
        out.append(0 if m == 0 else m.bit_length() - ((m & -m).bit_length() - 1))
    return np.array(out)


def _assert_exact_split(values: np.ndarray):
    a = torch.from_numpy(values.astype(np.float32))
    hi, lo = ref.split_ref(a)
    assert torch.equal(hi + lo, a)                       # the sum is exact, bit for bit
    assert (_sig_bits(hi.numpy()) <= 12).all()
    assert (_sig_bits(lo.numpy()) <= 12).all()
    # a product of halves is exact where it stays a normal f32: the f32
    # product equals the f64 one
    h64, l64 = hi.numpy().astype(np.float64), lo.numpy().astype(np.float64)
    for got, want in ((hi * hi, h64 * h64), (hi * lo, h64 * l64)):
        normal = (np.abs(want) >= TINY) & (np.abs(want) < 2.0 ** 127)
        assert np.array_equal(got.numpy()[normal].astype(np.float64), want[normal])


TINY = np.finfo(np.float32).tiny
EDGES = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** 20, -(2.0 ** -20), 3.0, 1 / 3, -np.pi,
                  1 + 2.0 ** -23, 2 - 2.0 ** -23, 4097.0, 1 / 4097, TINY, -TINY,
                  TINY / 2, 2.0 ** -149, -(2.0 ** -140) * 3, 1e30, -1e34], np.float64)


def test_split_edge_values():
    """Zero, signs, powers of two, full-mantissa values, subnormals and
    large magnitudes (below the overflow of a·4097)."""
    _assert_exact_split(EDGES)


def test_split_seeded_spread():
    rng = np.random.default_rng(7)
    v = rng.uniform(1, 2, 1 << 16) * 2.0 ** rng.integers(-140, 110, 1 << 16)
    _assert_exact_split(v * rng.choice([-1.0, 1.0], v.shape))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.floats(min_value=-(2.0 ** 113), max_value=2.0 ** 113, width=32,
                          allow_nan=False, allow_infinity=False, allow_subnormal=True),
                min_size=1, max_size=64))
def test_split_is_exact(values):
    """Any f32 up to 2^113 in magnitude (a·4097 overflows past about 2^115)."""
    _assert_exact_split(np.array(values, np.float64))


def test_mm_x2_is_the_three_products():
    """``hh + (hl + lh)``: at k = 1 every product of halves is exact, so
    the result is that sum's rounding, computed here by hand."""
    a, b = _t(_normal(8, 33, 1)), _t(_normal(9, 1, 7))
    (ah, al), (bh, bl) = ref.split_ref(a), ref.split_ref(b)
    want = ah * bh + (ah * bl + al * bh)
    assert torch.equal(ref.mm_x2(a, b), want)


# --- the contract ------------------------------------------------------------------

CONTRACT_D = 136       # two panels of the blocked path: its factor has split products


def _calls():
    """Every function with the keyword, as name → call(dtype, **kw), the
    keyword passed on only when given."""
    def sys(dt):
        return torch.from_numpy(_spd(CONTRACT_D)).to(dt)

    def factor(dt):
        return torch.linalg.cholesky(sys(dt))

    def rhs(dt):
        return torch.from_numpy(_normal(40, CONTRACT_D, 3)).to(dt)

    return {
        "blocked_cholesky": lambda dt, **kw: S.blocked_cholesky(sys(dt)[None], **kw),
        "cholesky_solve": lambda dt, **kw: S.cholesky_solve(factor(dt)[None], rhs(dt)[None],
                                                            **kw),
        "multi_gamma_solve": lambda dt, **kw: S.multi_gamma_solve(sys(dt), rhs(dt), [0.5, 1.0],
                                                                  **kw),
        "panel_trsm": lambda dt, **kw: ops.panel_trsm(sys(dt), factor(dt), **kw),
        "panel_update": lambda dt, **kw: ops.panel_update(sys(dt), factor(dt), sys(dt), **kw),
        "streamed_cholesky": lambda dt, **kw: S.streamed_cholesky(sys(dt), block=16, **kw),
        "streamed_cholesky_solve": lambda dt, **kw: S.streamed_cholesky_solve(
            factor(dt), rhs(dt), block=16, **kw),
        "tile_cholesky_factor": lambda dt, **kw: S.tile_cholesky_factor(
            sys(dt), **_one_shard(8), **kw)[0],
        "tile_cholesky_solve": lambda dt, **kw: S.tile_cholesky_solve(
            factor(dt), rhs(dt), psum=lambda v: v, **_one_shard(8), **kw),
        "blocked_cholesky_ref": lambda dt, **kw: ref.blocked_cholesky_ref(sys(dt)[None], **kw),
        "cholesky_solve_ref": lambda dt, **kw: ref.cholesky_solve_ref(
            factor(dt)[None], rhs(dt)[None], **kw),
        "multi_gamma_solve_ref": lambda dt, **kw: ref.multi_gamma_solve_ref(
            sys(dt), rhs(dt), torch.tensor([0.5], dtype=dt), **kw),
    }


CALLS = sorted(_calls())


@pytest.mark.parametrize("name", CALLS)
def test_f32_x2_refuses_f64(name):
    with pytest.raises(ValueError, match="float32 only"):
        _calls()[name](torch.float64, precision=X2)


@pytest.mark.parametrize("name", CALLS)
def test_unknown_precision_is_refused(name):
    with pytest.raises(ValueError, match="precision must be one of"):
        _calls()[name](torch.float32, precision="f64_x1")


@pytest.mark.parametrize("name", CALLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_native_is_the_default(name, dtype):
    """``precision="native"`` gives the bits of a call without the keyword;
    on f32, f32_x2 gives an answer within f32's reach of it, and other
    bits (a keyword dropped on the way would give the same)."""
    call = _calls()[name]
    got = call(dtype, precision="native")
    assert torch.equal(got, call(dtype))
    if dtype == torch.float32:
        x2 = call(dtype, precision=X2)
        assert x2.shape == got.shape and torch.isfinite(x2).all()
        assert _rel(x2, got.numpy()) < 1e-4
        assert not torch.equal(x2, got)


def test_precisions_are_the_references():
    assert ref.PRECISIONS == ("native", "f32_x2")
    assert ref.SPLIT == RS._SPLIT == 2.0 ** 12 + 1
