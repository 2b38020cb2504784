"""The port's dense backbone against the reference, on the same weights.

The reference's parameters from ``T.init_params(jax.random.key(0), cfg)``
cross over as numpy through ``params_from_jax``; inputs are made with numpy
from a seed. Tolerances: rtol 1e-4 / atol 1e-5 for whole forward passes
(f32 with sums in another order, through two layers and a final norm),
rtol 1e-5 / atol 1e-6 for a single building block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def minicpm():
    cfg_ref = ref_config("minicpm_2b").reduced(num_classes=8)
    cfg = get_config("minicpm_2b").reduced(num_classes=8)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    return cfg_ref, cfg, p_ref, params


@pytest.mark.parametrize("b,s", [
    (4, 16),       # the slice's shape: direct attention
    (1, 2056),     # 2056² > 2²²: the chunked online-softmax attention
])
def test_pooled_embeddings_match_reference(minicpm, b, s):
    cfg_ref, cfg, p_ref, params = minicpm
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ref = RT.pool(RT.forward(p_ref, cfg_ref, {"tokens": jnp.asarray(toks)}))
    out = T.pool(T.forward(params, cfg, {"tokens": torch.from_numpy(toks)}))
    assert out.shape == (b, cfg.d_model) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_lm_logits_match_reference(minicpm):
    cfg_ref, cfg, p_ref, params = minicpm
    h = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        T.lm_logits(params, cfg, torch.from_numpy(h)).numpy(),
        np.asarray(RT.lm_logits(p_ref, cfg_ref, jnp.asarray(h))), **BLOCK_TOL)


def test_converted_params_keep_layout(minicpm):
    _, cfg, p_ref, params = minicpm
    assert len(params["layers"]) == cfg.num_layers
    for i, lp in enumerate(params["layers"]):
        wq = np.asarray(p_ref["layers"]["attn"]["wq"][i])
        assert lp["attn"]["wq"].shape == wq.shape == (cfg.d_model, cfg.num_heads * 32)
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(), wq)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=5, softcap=30.0),
    dict(causal=False, q_offset=3),
])
def test_sdpa_direct_gqa_matches(kw):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 12, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    ref = RL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = L.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BLOCK_TOL)


def test_sdpa_chunked_window_gqa_matches():
    """sq·skv > 2²² with a ragged last chunk, GQA and a sliding window."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 2, 2100, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1, 2100, 8)).astype(np.float32)
    v = rng.standard_normal((1, 1, 2100, 8)).astype(np.float32)
    ref = RL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=300)
    out = L.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=300)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BLOCK_TOL)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_matches(kind):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 7, 32)) * 3).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    ref = RL.norm_apply({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), 1e-6, kind)
    out = L.norm_apply({k: torch.from_numpy(a) for k, a in p.items()},
                       torch.from_numpy(x), 1e-6, kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BLOCK_TOL)


def test_rope_matches():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 40, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BLOCK_TOL)


@pytest.mark.parametrize("activation", ["swiglu", "relu2", "gelu"])
def test_mlp_matches(activation):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = {n: (rng.standard_normal(s) / 4).astype(np.float32)
         for n, s in [("w_up", (16, 24)), ("w_gate", (16, 24)), ("w_down", (24, 16))]}
    ref = RL.mlp_apply({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), activation)
    out = L.mlp_apply({k: torch.from_numpy(a) for k, a in p.items()},
                      torch.from_numpy(x), activation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BLOCK_TOL)


def test_init_params_is_seeded_and_dense_only():
    cfg = get_config("minicpm_2b").reduced(num_layers=1)
    a = T.init_params(cfg, seed=3, device="cpu")
    b = T.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["layers"][0]["mlp"]["w_gate"], b["layers"][0]["mlp"]["w_gate"])
    assert a["embed"].dtype == torch.float32 and "lm_head" not in a    # tied
    for arch in ["granite_moe_3b_a800m", "zamba2_7b", "xlstm_350m", "seamless_m4t_medium"]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.init_params(get_config(arch).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.forward(a, dataclasses.replace(cfg, arch_type="moe"),
                  {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
