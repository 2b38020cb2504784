"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel
has no CPU mode). The file imports nothing of JAX, so it runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels_gram.py: rtol 2e-4 / atol 2e-3
for f32 (sums in another order), 2e-2 / 2e-1 for bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import AnalyticEngine
from repro_torch.kernels import gram as G
from repro_torch.kernels import ops, ref

TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (2e-2, 2e-1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _data(seed, n, d, c, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    y = torch.from_numpy(np.eye(c, dtype=np.float32)[rng.integers(0, c, n)])
    return x.to(device, dtype), y.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,dtype", [
    (64, 2304, 16, torch.float32),     # the main path's per-batch shape
    (1000, 200, 37, torch.float32),    # ragged everywhere
    (8, 256, 5, torch.float32),        # fewer rows than one staged step
    (2048, 384, 128, torch.bfloat16),
])
def test_gram_kernel_matches_plain(cuda, n, d, c, dtype):
    x, y = _data(0, n, d, c, dtype, cuda)
    before = G.gram_update.launches
    g, q = ops.gram_update(x, y)
    torch.cuda.synchronize()
    assert G.gram_update.launches == before + 1
    g_ref, q_ref = ref.gram_ref(x, y)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(g, g_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(q, q_ref, rtol=rtol, atol=atol)
    assert torch.equal(g, g.T)   # one FMA chain for G[i,j] and G[j,i]


@pytest.mark.cuda
def test_gram_kernel_rejects_bad_inputs(cuda):
    x, y = _data(1, 32, 16, 3, torch.float32, cuda)
    with pytest.raises(TypeError):
        G.gram_update(x.double(), y.double())
    with pytest.raises(ValueError, match="contiguous"):
        G.gram_update(x.T.contiguous().T, y)
    with pytest.raises(ValueError):
        G.gram_update(x, y[:-1])


@pytest.mark.cuda
def test_engine_kernel_path_matches_plain_path(cuda):
    """The torch backend with use_kernel folds the same statistics as
    without it, batch after batch."""
    eng_k = AnalyticEngine("torch", device=cuda, use_kernel=True)
    eng_p = AnalyticEngine("torch", device=cuda)
    s_k, s_p = eng_k.init(96, 4), eng_p.init(96, 4)
    before = G.gram_update.launches
    for seed in range(3):
        x, y = _data(seed, 50, 96, 4, torch.float32, cuda)
        s_k, s_p = eng_k.update(s_k, x, y), eng_p.update(s_p, x, y)
    assert G.gram_update.launches == before + 3
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(s_k.gram, s_p.gram, rtol=rtol, atol=atol)
    torch.testing.assert_close(s_k.moment, s_p.moment, rtol=rtol, atol=atol)
