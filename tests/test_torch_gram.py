"""The port's Gram kernel module against the reference Pallas kernel.

On the CPU ``repro_torch.kernels.ops.gram_update`` takes the plain version;
it is held to ``repro.kernels.gram.gram_update`` run in interpret mode, at
the shapes, dtypes and tolerances of tests/test_kernels_gram.py, and so is
``ref.gram_upper_ref``, the plain twin of the CUDA kernel's schedule. The CUDA
kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py (marked ``cuda``, skipped without a GPU) and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import gram_update as ref_gram_update
from repro_torch.kernels import gram as G
from repro_torch.kernels import ops, ref

SHAPES = [
    (64, 32, 10),        # tiny, everything padded in the reference
    (512, 128, 100),     # exact block multiples
    (1000, 200, 37),     # ragged everywhere
    (2048, 384, 128),    # multi-tile d
    (8, 256, 5),         # n smaller than a block
]
# f32: reduction-order differences on long N sweeps; bf16: inputs agree
# bit for bit (both round to nearest even), products are exact in f32.
TOL = {"float32": (2e-4, 2e-3), "bfloat16": (2e-2, 2e-1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n, d, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return x, y


def _both(x, y, dtype):
    xj = jnp.asarray(x, getattr(jnp, dtype))
    yj = jnp.asarray(y, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    return (xj, yj), (xt, yt)


@pytest.mark.parametrize("n,d,c", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gram_matches_reference_kernel(n, d, c, dtype):
    (xj, yj), (xt, yt) = _both(*_data(0, n, d, c), dtype)
    g_ref, q_ref = ref_gram_update(xj, yj, interpret=True)
    g, q = ops.gram_update(xt, yt)
    assert g.dtype == q.dtype == torch.float32
    assert g.shape == (d, d) and q.shape == (d, c)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=rtol, atol=atol)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=rtol, atol=atol)


def test_gram_symmetry_and_psd():
    x, y = _data(2, 256, 64, 8)
    g, _ = ops.gram_update(torch.from_numpy(x), torch.from_numpy(y))
    g = g.numpy()
    np.testing.assert_allclose(g, g.T, atol=1e-5)
    assert np.linalg.eigvalsh(g).min() > -1e-3


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: only ops dispatches a CPU
    tensor to the plain version, and no launch is counted."""
    x, y = _data(3, 16, 8, 3)
    before = G.gram_update.launches
    with pytest.raises(ValueError, match="CUDA"):
        G.gram_update(torch.from_numpy(x), torch.from_numpy(y))
    assert G.gram_update.launches == before


# the upper-tile schedule's twin at ragged d: below one tile, one tile, not
# a tile multiple, C above a tile, d = 1
TWIN_SHAPES = [
    (50, 40, 5),         # d below one tile
    (20, 64, 64),        # exactly one tile of G and of Q
    (300, 200, 37),      # d not a tile multiple, C ragged
    (64, 130, 70),       # C above a tile
    (8, 1, 3),           # d = 1
]


@pytest.mark.parametrize("d", [1, 33, 64, 65, 200, 300])
def test_upper_tiles_cover_the_upper_triangle_once(d):
    seen = np.zeros((d, d), dtype=int)
    bm, bn = G.TILE
    for i0, j0 in G.upper_tiles(d):
        assert i0 % bm == 0 and j0 % bn == 0 and j0 >= i0
        block = seen[i0:i0 + bm, j0:j0 + bn]
        r = np.arange(i0, i0 + block.shape[0])[:, None]
        c = np.arange(j0, j0 + block.shape[1])[None, :]
        block += c >= r
    np.testing.assert_array_equal(seen, np.triu(np.ones((d, d), dtype=int)))


@pytest.mark.parametrize("n,d,c", TWIN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upper_tile_twin_matches_reference_kernel(n, d, c, dtype):
    """``ref.gram_upper_ref`` (the kernel's schedule: upper tiles, each
    mirrored) against the Pallas kernel in interpret mode, exactly
    symmetric."""
    (xj, yj), (xt, yt) = _both(*_data(4, n, d, c), dtype)
    g_ref, q_ref = ref_gram_update(xj, yj, interpret=True)
    g, q = ref.gram_upper_ref(xt, yt)
    assert g.dtype == q.dtype == torch.float32
    assert torch.equal(g, g.T)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=rtol, atol=atol)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,d,c", [
    (64, 2304, 16), (8192, 2304, 16),   # the main path's shapes: one split
    (1000, 200, 37), (2048, 384, 128), (8000, 128, 40), (7, 33, 5), (0, 1, 1),
])
def test_split_rows_split_n_only_where_the_tiles_cannot_fill_the_card(n, d, c):
    """One block a tile sums all N unless the tiles are fewer than twice the
    SMs; then N goes to whole 16-row steps of at least SPLIT_MIN_ROWS rows,
    at most about 2·SMs blocks in all."""
    sms = 132
    rows = G.split_rows(n, d, c, sms)
    splits = -(-n // rows) if n > rows else 1
    if G.blocks(d, c) >= 2 * sms or n <= G.SPLIT_MIN_ROWS:
        assert splits == 1
        return
    assert rows % 16 == 0 and rows >= G.SPLIT_MIN_ROWS
    assert (splits - 1) * rows < n <= splits * rows
    assert splits > 1 and (splits - 1) * G.blocks(d, c) < 2 * sms
