"""The port's attention against the reference, on the CPU.

``kernels.ref.mha_ref`` (the flash kernel's plain version) and
``kernels.ops.flash_attention`` on CPU tensors against the JAX package's
``mha_ref`` and its Pallas kernel in interpret mode (``block_q=64,
block_k=64``, as tests/test_kernels_attention.py runs it), over every case
of that file, with its tolerances: rtol 2e-5 / atol 4e-4 in f32, 2e-2 /
0.4 in bf16 (both packages round the f32 result to bf16, so an output may
land one bf16 step apart). ``kernels.ref.mha_split_ref``, the plain twin of
the CUDA kernel's split-KV decode, is held to the same at decode shapes.
Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

TOL = {"float32": (2e-5, 4e-4), "bfloat16": (2e-2, 0.4)}

# tests/test_kernels_attention.py's cases: (b, hq, hkv, sq, skv, d), kw
CAUSAL_SHAPES = [
    (1, 4, 4, 128, 128, 64),    # MHA
    (2, 8, 2, 128, 128, 64),    # GQA 4:1
    (1, 4, 1, 96, 96, 80),      # MQA, ragged seq + ragged head dim
    (1, 2, 2, 256, 256, 128),
]
CASES = [(shape, dict(causal=True), dtype)
         for shape in CAUSAL_SHAPES for dtype in ("float32", "bfloat16")] + [
    ((1, 4, 4, 128, 128, 64), dict(causal=False), "float32"),
    ((1, 4, 2, 192, 192, 64), dict(causal=True, window=32), "float32"),
    ((1, 4, 2, 192, 192, 64), dict(causal=True, window=64), "float32"),
    ((1, 4, 2, 192, 192, 64), dict(causal=True, window=100), "float32"),
    ((2, 8, 2, 1, 256, 64), dict(causal=True, q_offset=255), "float32"),
    ((1, 4, 4, 1, 300, 64), dict(causal=True, window=128, q_offset=299), "float32"),
    ((1, 4, 4, 64, 200, 64), dict(causal=False), "float32"),
    ((1, 2, 2, 64, 64, 64), dict(causal=True, scale=0.25), "float32"),
]


def _ids(case):
    shape, kw, dtype = case
    return "-".join([dtype, "x".join(map(str, shape))] + [f"{k}={v}" for k, v in kw.items()])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype):
    """The same values for both packages: numpy f32, then each package's
    dtype (bf16 rounds to nearest even in both)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)]]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_port_attention_matches_reference_and_pallas(case):
    shape, kw, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), *shape, dtype)
    want_ref = jref.mha_ref(jq, jk, jv, **kw)
    want_pallas = pallas_flash(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw)
    before = FA.flash_attention.launches
    got_ref = ref.mha_ref(q, k, v, **kw)
    got_ops = ops.flash_attention(q, k, v, **kw)
    assert FA.flash_attention.launches == before       # a CPU tensor never reaches the kernel
    b, hq, _, sq, _, d = shape
    assert got_ops.shape == got_ref.shape == (b, hq, sq, d)
    assert got_ops.dtype == got_ref.dtype == getattr(torch, dtype)
    rtol, atol = TOL[dtype]
    for got in (got_ref, got_ops):
        for want in (want_ref, want_pallas):
            np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_mha_ref_fully_masked_rows_are_zero():
    """Rows whose window ends before the first key see nothing: zeros, as
    the reference's NaN-to-zero gives."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 2, 1, 4, 10, 8, "float32")
    kw = dict(causal=True, window=3, q_offset=20)
    out = ref.mha_ref(q, k, v, **kw)
    assert torch.equal(out, torch.zeros_like(out))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jref.mha_ref(jq, jk, jv, **kw)))


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=0),
    dict(causal=True, window=7, q_offset=5),
    dict(causal=False),
])
def test_sdpa_on_cpu_stays_plain(kw, monkeypatch):
    """models.layers.sdpa on CPU tensors is the plain direct/chunked code:
    the kernel wrapper is never called, and it agrees with mha_ref (window
    <= 0 meaning none)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in [(2, 4, 9, 16), (2, 2, 14, 16), (2, 2, 14, 16)])
    before = FA.flash_attention.launches

    def kernel_called(*args, **kwargs):
        raise AssertionError("sdpa reached the kernel wrapper with CPU tensors")

    with monkeypatch.context() as m:
        m.setattr(FA, "flash_attention", kernel_called)
        out = L.sdpa(q, k, v, **kw)
    assert FA.flash_attention.launches == before
    want_kw = dict(kw, window=kw.get("window") or None)
    np.testing.assert_allclose(out.numpy(), ref.mha_ref(q, k, v, **want_kw).numpy(),
                               rtol=2e-5, atol=4e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    (_, _, _), (q, k, v) = _inputs(2, 1, 2, 2, 4, 4, 8, "float32")
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before


# the split-KV decode's twin (group · Sq <= 16): (b, hq, hkv, sq, skv, d), kw,
# dtype, sms (the SM count decode_plan cuts the band for)
SPLIT_CASES = [
    ((1, 2, 1, 1, 2064, 64), dict(window=1000, q_offset=2048), "float32", 132),  # 32 chunks, the last short
    ((2, 8, 2, 1, 256, 64), dict(q_offset=255), "float32", 132),       # 8 chunks
    ((1, 2, 2, 1, 90, 64), dict(causal=False), "float32", 132),        # no causal mask: the whole cache
    ((1, 4, 4, 1, 1, 64), dict(q_offset=0), "float32", 132),           # a one-key cache
    ((1, 4, 2, 4, 300, 64), dict(window=10, q_offset=296), "float32", 132),  # window inside one chunk
    ((2, 4, 4, 1, 40, 64), dict(window=50, q_offset=100), "float32", 132),   # rows past every key
    ((1, 2, 1, 8, 200, 64), dict(window=70, q_offset=192), "float32", 16),   # rows at 8 positions
    ((1, 8, 1, 1, 100, 80), dict(q_offset=99), "float32", 132),        # a GQA group of 8, ragged D
    ((1, 4, 1, 4, 130, 64), dict(q_offset=126), "float32", 132),       # 16 rows, the regime's edge
    ((1, 4, 2, 1, 300, 64), dict(window=128, q_offset=299), "bfloat16", 132),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: _ids(c[:3]))
def test_split_kv_twin_matches_reference_and_pallas(case):
    """``ref.mha_split_ref`` (the CUDA decode's chunks, partials and merge,
    cut by the wrapper's own ``decode_plan``) against ``mha_ref`` of both
    packages and the Pallas kernel in interpret mode."""
    shape, kw, dtype, sms = case
    b, hq, hkv, sq, skv, d = shape
    assert hq // hkv * sq <= FA.DECODE_MAX_ROWS
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape) + 1, *shape, dtype)
    want_ref = jref.mha_ref(jq, jk, jv, **kw)
    want_pallas = pallas_flash(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw)
    got = ref.mha_split_ref(q, k, v, sms=sms, **kw)
    assert got.shape == (b, hq, sq, d) and got.dtype == getattr(torch, dtype)
    rtol, atol = TOL[dtype]
    for want in (want_ref, want_pallas, ref.mha_ref(q, k, v, **kw)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: _ids(c[:3]))
def test_decode_plan_cuts_the_visible_band(case):
    """The chunks cover exactly the keys some row sees, in multiples of the
    warp step, and fill each SM at least SPLIT_BLOCKS_PER_SM times where
    the band is long enough."""
    (b, hq, hkv, sq, skv, d), kw, _, sms = case
    causal = kw.get("causal", True)
    window, q_offset = kw.get("window"), kw.get("q_offset", 0)
    lo, hi, chunk, splits = FA.decode_plan(b, hkv, sq, skv, causal=causal, window=window,
                                           q_offset=q_offset, sms=sms)
    seen = ref.attention_mask(sq, skv, causal=causal, window=window,
                              q_offset=q_offset).any(0).nonzero()
    if len(seen) == 0:
        assert splits == 1 and hi <= lo
        return
    assert (lo, hi) == (int(seen[0]), int(seen[-1]) + 1)
    assert chunk % FA.SPLIT_STEP == 0 and chunk >= FA.SPLIT_MIN_CHUNK
    assert (splits - 1) * chunk < hi - lo <= splits * chunk
    if hi - lo >= FA.SPLIT_BLOCKS_PER_SM * sms * FA.SPLIT_MIN_CHUNK:
        assert splits * b * hkv >= FA.SPLIT_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("kw", [dict(window=1024, q_offset=2048), dict(q_offset=2048)],
                         ids=["local", "global"])
def test_decode_plan_fills_an_h100_at_the_serve_step(kw):
    """gemma3_12b's decode step (B 4, Hkv 8, a 2064-slot cache) on 132 SMs:
    at least two blocks an SM."""
    lo, hi, chunk, splits = FA.decode_plan(4, 8, 1, 2064, causal=True, q_offset=2048,
                                           window=kw.get("window"), sms=132)
    assert splits * 4 * 8 >= 2 * 132
    assert hi == 2049 and lo == (1025 if "window" in kw else 0)
