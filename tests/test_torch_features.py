"""``repro_torch.core.features`` against ``repro.core.features``.

The maps' ``w`` and ``b`` come from numpy ``default_rng(seed)`` in both
packages, so they are equal bit for bit. Applied to a numpy f64 array the
two agree to 1e-12; applied to an f32 CPU tensor the port agrees with the
reference applied to a ``jnp`` f32 array at rtol 1e-5 (f32 products summed
in another order; atol 1e-5 for outputs that cross zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as RF
from repro_torch.core import features as PF

MAPS = [
    ("rff_map", dict(d_in=8, d_out=64, lengthscale=0.7, seed=1)),
    ("rff_map", dict(d_in=32, d_out=256, seed=0)),
    ("relu_map", dict(d_in=8, d_out=64, seed=2)),
    ("relu_map", dict(d_in=32, d_out=256, seed=5)),
    ("identity_map", dict(d_in=16)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, kw):
    return getattr(RF, name)(**kw), getattr(PF, name)(**kw)


def _x(d, dtype=np.float64, seed=0):
    return np.random.default_rng(seed).standard_normal((50, d)).astype(dtype)


@pytest.mark.parametrize("name,kw", MAPS)
def test_draws_equal_reference_bit_for_bit(name, kw):
    ref, port = _pair(name, kw)
    assert (port.kind, port.d_in, port.d_out, port.scale) == \
        (ref.kind, ref.d_in, ref.d_out, ref.scale)
    np.testing.assert_array_equal(port.w, ref.w)
    if ref.b is None:
        assert port.b is None
    else:
        np.testing.assert_array_equal(port.b, ref.b)


@pytest.mark.parametrize("name,kw", MAPS)
def test_numpy_f64_matches_reference(name, kw):
    ref, port = _pair(name, kw)
    x = _x(kw["d_in"])
    out = port(x)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    assert out.shape == (50, port.d_out)
    np.testing.assert_allclose(out, ref(x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,kw", MAPS)
def test_f32_tensor_matches_reference_jnp(name, kw):
    ref, port = _pair(name, kw)
    x = _x(kw["d_in"], np.float32, seed=3)
    out = port(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    want = np.asarray(ref(jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tensor_keeps_its_dtype_and_leading_dims():
    phi = PF.rff_map(4, 16, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 4)))
    out = phi(x)
    assert out.dtype == torch.float64 and out.shape == (2, 3, 16)
    np.testing.assert_allclose(out.numpy(), phi(x.numpy()), rtol=1e-12, atol=1e-12)
