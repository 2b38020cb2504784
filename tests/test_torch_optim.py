"""``repro_torch.optim`` against the reference's ``repro.optim``.

The updates run over a nested dict/list tree (the port's params layout)
from the same numpy draws; the reference maps the same tree with
``jax.tree.map``. Both compute ``p − (lr·g)`` and ``β·v + g`` in f32, one
rounding per operation, so the results are equal bit for bit. The
schedules compute in f32 in both packages and are held within 1 f32 ulp at
every step in [0, total + 5] (the warmup's end, the stable end and
``total`` among them). WSD's ``sqrt`` is correctly rounded in both. The
cosine's ``cos`` is not: XLA's and torch's f32 ``cos`` differ by 1 ulp at
about 5% of arguments, and ``1 + cos`` near t = 1 cancels, so the cosine
schedule is held within 1 ulp of its value plus that one ulp of ``cos``
carried through ``base_lr·(1 − floor)·½·(1 + cos)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro_torch import optim as O


def _trees(seed):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    p = {"embed": draw(7, 5), "layers": [{"w": draw(5, 5), "n": {"scale": draw(5)}}
                                         for _ in range(3)], "head": draw(5, 2)}
    g = {"embed": draw(7, 5), "layers": [{"w": draw(5, 5), "n": {"scale": draw(5)}}
                                         for _ in range(3)], "head": draw(5, 2)}
    return p, g


def _torch(tree):
    return O.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _equal(got, want):
    """Every leaf of ``got`` equals the leaf at its place in ``want``."""

    def check(a, b):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return True

    assert O.tree_leaves(O.tree_map(check, got, want)) == [True] * 8


def test_tree_map_keeps_the_layout():
    p, g = _trees(0)
    out = O.tree_map(lambda a, b: a.shape == b.shape, p, g)
    assert isinstance(out["layers"], list) and out["layers"][2]["n"]["scale"] is True
    assert sorted(a.shape for a in O.tree_leaves(p)) == sorted(
        a.shape for a in jax.tree.leaves(p))


@pytest.mark.parametrize("lr", [0.05, 1e-3])
def test_sgd_matches_reference(lr):
    p, g = _trees(1)
    want = RO.sgd(lr)(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g))
    params = _torch(p)
    out = O.sgd(lr)(params, _torch(g))
    assert out is params                      # updated in place
    _equal(params, want)
    # a schedule's lr_t in place of the default
    want2 = RO.sgd(lr)(want, jax.tree.map(jnp.asarray, g), lr_t=jnp.float32(0.3))
    _equal(O.sgd(lr)(params, _torch(g), lr_t=0.3), want2)


def test_momentum_sgd_matches_reference():
    p, g = _trees(2)
    _, g2 = _trees(3)
    r_init, r_update = RO.momentum_sgd(0.1, beta=0.9)
    init, update = O.momentum_sgd(0.1, beta=0.9)
    rp = jax.tree.map(jnp.asarray, p)
    rv = r_init(rp)
    params = _torch(p)
    vel = init(params)
    assert all(float(v.abs().max()) == 0 for v in O.tree_leaves(vel))
    for grads in (g, g2, g):
        rp, rv = r_update(rp, jax.tree.map(jnp.asarray, grads), rv)
        params, vel = update(params, _torch(grads), vel)
        _equal(params, rp)
        _equal(vel, rv)


def _ulps(got: float, want) -> float:
    want = np.float32(want)
    return abs(np.float32(got) - want) / np.spacing(np.abs(want)) if want else abs(got)


@pytest.mark.parametrize("base_lr,warmup,total,decay_frac,floor", [
    (3e-3, 5, 50, 0.1, 0.0),       # run_lm's at --steps 50
    (0.1, 20, 200, 0.1, 0.0),      # examples/train_100m.py's
    (1e-2, 1, 8, 0.25, 0.1),       # a floor, a decay over two steps
    (0.5, 0, 3, 0.1, 0.0),         # warmup 0, one decay step
])
def test_wsd_schedule_matches_reference(base_lr, warmup, total, decay_frac, floor):
    want = RO.wsd_schedule(base_lr, warmup, total, decay_frac, floor)
    got = O.wsd_schedule(base_lr, warmup, total, decay_frac, floor)
    stable_end = total - max(int(total * decay_frac), 1)
    steps = range(total + 6)
    assert {warmup, stable_end, total} <= set(steps)
    for s in steps:
        v = got(s)
        assert isinstance(v, float)
        assert _ulps(v, want(s)) <= 1, (s, v, float(want(s)))
    assert got(stable_end - 1) == pytest.approx(base_lr, rel=1e-6)
    assert got(total) == pytest.approx(base_lr * floor, abs=1e-9)


@pytest.mark.parametrize("base_lr,warmup,total,floor_frac", [
    (3e-3, 5, 50, 0.1),
    (0.1, 0, 10, 0.0),
    (1e-2, 7, 7, 0.2),             # no cosine span: max(total - warmup, 1)
])
def test_cosine_schedule_matches_reference(base_lr, warmup, total, floor_frac):
    want = RO.cosine_schedule(base_lr, warmup, total, floor_frac)
    got = O.cosine_schedule(base_lr, warmup, total, floor_frac)
    for s in range(total + 6):
        v, w = got(s), np.float32(want(s))
        assert isinstance(v, float)
        t = np.clip((np.float32(s) - warmup) / np.float32(max(total - warmup, 1)), 0, 1)
        cos = np.cos(np.float32(np.pi) * t)
        tol = np.spacing(np.abs(w)) + base_lr * (1 - floor_frac) * 0.5 * np.spacing(
            np.abs(cos))
        assert abs(np.float32(v) - w) <= tol, (s, v, float(w))
    assert got(total + 5) == pytest.approx(base_lr * floor_frac, rel=1e-6, abs=1e-12)
