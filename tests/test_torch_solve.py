"""The port's streamed panel Cholesky against the reference's.

On the CPU ``repro_torch.kernels.ops`` takes the panel kernels' plain
versions (the reference's column loops and matrix products); they are held
to ``repro.kernels.solve`` run in interpret mode on the same numpy-seeded
f32 inputs, and the engine's kernel route to the ``numpy_f64`` engine. The
CUDA kernels themselves are compared with the plain versions on the card
by tests/test_torch_cuda.py (marked ``cuda``) and by chip_smoke.py.

Tolerances, each with its reason:
  * panel functions against the Pallas kernels: relative 1e-5 of the
    largest entry — the same algorithm in f32, with sums in another order,
    on blocks with condition numbers near 10;
  * the streamed factor and solve against numpy in f64, and against the
    reference: relative 1e-4, the bar of tests/test_distributed_cholesky.py
    for f32 (condition numbers up to ~100 there);
  * the engine's kernel route in f64 against the ``numpy_f64`` engine:
    1e-10, the bar the reference holds its kernel solves to under x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import AnalyticEngine as RefEngine
from repro.kernels import solve as RS
from repro_torch.core.engine import AnalyticEngine, SuffStats, to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import panel as P
from repro_torch.kernels import solve as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, d, ridge=0.5):
    x = rng.standard_normal((d + 32, d)).astype(np.float32)
    a = x.T @ x
    a[np.arange(d), np.arange(d)] += np.float32(ridge)
    return a


def _block(seed, b):
    """An SPD (b, b) f32 block from 4b normal rows (condition number ≈ 9)."""
    x = np.random.default_rng(seed).standard_normal((4 * b, b))
    return (x.T @ x / (4 * b)).astype(np.float32)


def _rel(a, b):
    """Largest error relative to the largest entry of ``b``."""
    a = to_numpy(a)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("b", [16, 64])
def test_panel_factor_and_tri_inv_match_reference(b):
    a = _block(b, b)
    l_ref, z_ref = RS.panel_factor(jnp.asarray(a), interpret=True)
    l, z = ops.panel_factor(torch.from_numpy(a))
    assert _rel(l, l_ref) < 1e-5 and _rel(z, z_ref) < 1e-5
    assert not np.triu(to_numpy(l), 1).any() and not np.triu(to_numpy(z), 1).any()
    # the upper triangle of the input is not read by either
    garbage = to_numpy(l, np.float32) + np.triu(np.full((b, b), 7.0, np.float32), 1)
    z2_ref = RS.panel_tri_inv(jnp.asarray(garbage), interpret=True)
    z2 = ops.panel_tri_inv(torch.from_numpy(garbage))
    assert _rel(z2, z2_ref) < 1e-5 and _rel(z2, z) == 0.0


@pytest.mark.parametrize("r", [64, 130])
@pytest.mark.parametrize("b", [16, 64])
def test_panel_trsm_and_update_match_reference(r, b):
    rng = np.random.default_rng(r * b)
    raw = rng.standard_normal((r, b)).astype(np.float32)
    zinv = np.tril(rng.standard_normal((b, b))).astype(np.float32)
    w = r - b // 2
    trail = rng.standard_normal((r, w)).astype(np.float32)
    pt = rng.standard_normal((w, b)).astype(np.float32)
    got = ops.panel_trsm(torch.from_numpy(raw), torch.from_numpy(zinv))
    want = RS.panel_trsm(jnp.asarray(raw), jnp.asarray(zinv), interpret=True)
    assert _rel(got, want) < 1e-5
    got = ops.panel_update(torch.from_numpy(trail), torch.from_numpy(raw),
                           torch.from_numpy(pt))
    want = RS.panel_update(jnp.asarray(trail), jnp.asarray(raw), jnp.asarray(pt),
                           interpret=True)
    assert _rel(got, want) < 1e-5
    # into a slab of a larger matrix, in place, as the schedule calls it
    work = torch.zeros((r, w + 3))
    work[:, 3:] = torch.from_numpy(trail)
    out = ops.panel_update(work[:, 3:], torch.from_numpy(raw), torch.from_numpy(pt),
                           out=work[:, 3:])
    assert out.data_ptr() == work[:, 3:].data_ptr()
    assert _rel(work[:, 3:], want) < 1e-5 and not work[:, :3].any()


def test_panel_width_matches_reference():
    for rows in (8, 24, 130, 256, 878, 880, 1024):
        for cap in (64, 256):
            assert S.panel_width(rows, cap) == RS.panel_width(rows, cap)


def test_constants_match_reference():
    assert S.STREAM_MIN_DIM == RS.STREAM_MIN_DIM == ops.STREAM_MIN_DIM
    assert S.DEFAULT_STREAM_BLOCK == RS.DEFAULT_STREAM_BLOCK
    assert S.DEFAULT_UPDATE_BLOCK == RS.DEFAULT_UPDATE_BLOCK


@pytest.mark.parametrize("d", [64, 130, 256])
def test_streamed_factor_and_solve_parity(d):
    # d = 130 exercises the identity-tail padding (panel count not exact)
    rng = np.random.default_rng(d)
    a = _spd(rng, d)
    b = rng.standard_normal((d, 7)).astype(np.float32)
    l = ops.streamed_cholesky(torch.from_numpy(a), block=64)
    assert l.shape == (d, d) and l.dtype == torch.float32
    assert _rel(l, np.linalg.cholesky(a.astype(np.float64))) < 1e-4
    assert not np.triu(to_numpy(l), 1).any()      # clean lower factor
    l_ref = RS.streamed_cholesky(jnp.asarray(a), block=64, interpret=True)
    assert _rel(l, l_ref) < 1e-4
    x = ops.streamed_cholesky_solve(l, torch.from_numpy(b), block=64)
    assert x.shape == (d, 7)
    assert _rel(x, np.linalg.solve(a.astype(np.float64), b.astype(np.float64))) < 1e-4
    x_ref = RS.streamed_cholesky_solve(l_ref, jnp.asarray(b), block=64, interpret=True)
    assert _rel(x, x_ref) < 1e-4
    # the plain route (use_kernel=False) is the same arithmetic on the CPU
    l_plain = S.streamed_cholesky(torch.from_numpy(a), block=64, use_kernel=False)
    assert torch.equal(l, l_plain)


def test_tile_schedule_leaves_its_input_alone():
    a = torch.from_numpy(_spd(np.random.default_rng(3), 128))
    before = a.clone()
    work, zs = S.tile_cholesky_factor(a, shard=0, n_shards=1,
                                      gather=lambda v: v[None], block=32)
    assert torch.equal(a, before) and len(zs) == 4
    x = S.tile_cholesky_solve(work, torch.eye(128), zs, shard=0, n_shards=1,
                              gather=lambda v: v[None], psum=lambda v: v, block=32)
    # zs handed in: the solve recomputes no inverse and gives A⁻¹
    assert _rel(x, np.linalg.inv(a.double().numpy())) < 1e-4


def test_rank_deficient_system_gives_nan():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64)).astype(np.float32)      # rank 3
    a = x.T @ x
    l = ops.streamed_cholesky(torch.from_numpy(a), block=16)
    l_ref = RS.streamed_cholesky(jnp.asarray(a), block=16, interpret=True)
    assert not np.isfinite(to_numpy(l)).all()
    assert not np.isfinite(np.asarray(l_ref)).all()
    w = ops.streamed_cholesky_solve(l, torch.ones((64, 2)), block=16)
    assert not np.isfinite(to_numpy(w)).all()


# --- the engine's kernel route (STREAM_MIN_DIM and up) --------------------------

_D = 2048


@pytest.fixture(scope="module")
def wide_stats():
    """One client's statistics at d = 2048 (2560 rows), in both engines.
    The port's copy is the reference's f64 statistics: its kernel route
    folds Gram updates in f32, as the Gram kernel does."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2560, _D))
    y = np.eye(5)[rng.integers(0, 5, 2560)]
    ref = RefEngine("numpy_f64", gamma=1.0)
    eng = AnalyticEngine("torch", gamma=1.0, dtype=torch.float64, device="cpu",
                         use_kernel=True)
    s_ref = ref.client_stats(x, y)
    s = SuffStats(*(eng.backend.asarray(v) for v in s_ref[:4]))
    return ref, s_ref, eng, s


def test_engine_kernel_route_factor_and_solve_at_stream_width(wide_stats):
    ref, s_ref, eng, s = wide_stats
    f_ref, f = ref.factor(s_ref, target_gamma=0.5), eng.factor(s, target_gamma=0.5)
    assert f.handle.shape == (_D, _D)
    assert not torch.triu(f.handle, 1).any()
    assert _rel(f.handle, f_ref.handle.T) < 1e-10      # lower L = (upper R)ᵀ
    w = eng.factor_solve(f, s.moment)
    assert _rel(w, ref.factor_solve(f_ref, s_ref.moment)) < 1e-10
    assert _rel(eng.solve(s, use_ri=False), ref.solve(s_ref, use_ri=False)) < 1e-10


def test_engine_kernel_route_ri_restore_at_stream_width(wide_stats):
    ref, s_ref, eng, s = wide_stats
    c_r = ref.regularized_gram(s_ref)
    w_r = np.linalg.solve(c_r, s_ref.moment)
    want = ref.ri_restore(w_r, c_r, 1)
    got = eng.ri_restore(torch.from_numpy(w_r), torch.from_numpy(c_r), 1)
    assert _rel(got, want) < 1e-10


def test_engine_kernel_route_is_the_streamed_schedule(wide_stats, monkeypatch):
    """At d ≥ STREAM_MIN_DIM the kernel route runs the panel functions:
    in f64 16 panels of STREAM_BLOCK_F64 = 128 (the widest f64 panel the
    kernel holds), so 16 factors, 16 trsm, 15 updates and 16 inverses."""
    _, _, eng, s = wide_stats
    calls = {n: 0 for n in ("panel_factor", "panel_trsm", "panel_update",
                            "panel_tri_inv")}
    plain = S.panels(s.gram.device)           # CPU tensors: the plain versions
    for name in calls:
        fn = getattr(plain, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(plain, name, counted)
    eng.solve(s, target_gamma=1.0)
    assert s.gram.dtype == torch.float64 and S.stream_block(torch.float64) == 128
    assert calls == {"panel_factor": 16, "panel_trsm": 16, "panel_update": 15,
                     "panel_tri_inv": 16}


def test_engine_kernel_route_non_pd_gives_nan_without_fallback():
    """γ = 0 on fewer rows than d: the kernel route returns NaNs (the
    reference's kernel route does too), with no pinv fallback."""
    rng = np.random.default_rng(13)
    eng = AnalyticEngine("torch", gamma=1.0, dtype=torch.float32, device="cpu",
                         use_kernel=True)
    s = eng.client_stats(rng.standard_normal((40, _D)), np.eye(3)[rng.integers(0, 3, 40)])
    f = eng.factor(s, target_gamma=0.0)
    assert f.handle is not None and not torch.isfinite(f.handle).all()
    assert not torch.isfinite(eng.factor_solve(f, s.moment)).all()


@pytest.mark.parametrize("call", ["factor", "factor_solve", "solve", "ri_restore"])
def test_engine_kernel_route_below_stream_width_matches_numpy(call):
    """Below STREAM_MIN_DIM the kernel route takes blocked_cholesky and
    cholesky_solve, as the reference does (d = 300: two panels of 128 and
    a ragged one), and agrees with the numpy_f64 engine at 1e-10 in f64."""
    rng = np.random.default_rng(14)
    d = 300
    x = rng.standard_normal((400, d))
    y = np.eye(2)[rng.integers(0, 2, 400)]
    ref = RefEngine("numpy_f64", gamma=1.0)
    eng = AnalyticEngine("torch", gamma=1.0, dtype=torch.float64, device="cpu",
                         use_kernel=True)
    s_ref = ref.client_stats(x, y)
    s = SuffStats(*(eng.backend.asarray(v) for v in s_ref[:4]))
    if call == "factor":
        f, f_ref = eng.factor(s), ref.factor(s_ref)
        assert not torch.triu(f.handle, 1).any()
        got, want = f.handle, f_ref.handle.T
    elif call == "factor_solve":
        f, f_ref = eng.factor(s, target_gamma=1.0), ref.factor(s_ref, target_gamma=1.0)
        got, want = eng.factor_solve(f, s.moment), ref.factor_solve(f_ref, s_ref.moment)
    elif call == "solve":
        got, want = eng.solve(s), ref.solve(s_ref)
    else:
        c_r = ref.regularized_gram(s_ref)
        w_r = np.linalg.solve(c_r, s_ref.moment)
        got = eng.ri_restore(torch.from_numpy(w_r), torch.from_numpy(c_r), 1)
        want = ref.ri_restore(w_r, c_r, 1)
    assert _rel(got, want) < 1e-10


def test_panel_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: only ops dispatches a
    CPU tensor to the plain version, and no launch is counted."""
    a = torch.from_numpy(_block(1, 16))
    before = [f.launches for f in (P.panel_factor, P.panel_tri_inv,
                                   P.panel_trsm, P.panel_update)]
    for call in (lambda: P.panel_factor(a), lambda: P.panel_tri_inv(a),
                 lambda: P.panel_trsm(a, a), lambda: P.panel_update(a, a, a)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [f.launches for f in (P.panel_factor, P.panel_tri_inv,
                                 P.panel_trsm, P.panel_update)] == before
