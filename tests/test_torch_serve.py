"""The port's serving path against the reference, on the CPU.

Reduced gemma3_12b (2 layers: one local with window 32, one global; 4
query / 2 kv heads; qk-norm; tied embeddings) on the reference's weights
(``params_from_jax``): ``prefill``, ``decode_step`` and ``init_cache``
against ``make_prefill_step`` / ``make_serve_step`` of the JAX package;
the three scenarios of tests/test_ring_cache.py; ``sample_batch`` and
``serve``. Logits are held at rtol 1e-4 / atol 1e-4·max|logit| (f32 with
sums in another order through two layers and a final norm), caches at
rtol 1e-4 / atol 1e-5, tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as RefModelConfig
from repro.configs.registry import get_config as ref_config
from repro.launch import serve as RS
from repro.launch import steps as RST
from repro.launch.inputs import sample_batch as ref_sample_batch
from repro.models import transformer as RT
from repro_torch.config import INPUT_SHAPES, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as S
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax

PROMPT, GEN = 48, 8          # the prompt is longer than the local layer's window of 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gemma():
    cfg_ref = ref_config("gemma3_12b").reduced()
    cfg = get_config("gemma3_12b").reduced()
    assert (cfg.window, cfg.global_every, cfg.num_heads, cfg.num_kv_heads, cfg.qk_norm) == \
        (32, 2, 4, 2, True)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    return cfg_ref, cfg, p_ref, params


def _close(got, want, rtol=1e-4, rel_atol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_prefill_matches_reference(gemma):
    cfg_ref, cfg, p_ref, params = gemma
    toks = _tokens(0, 2, PROMPT, cfg.vocab_size)
    logits_ref, cache_ref = jax.jit(RST.make_prefill_step(cfg_ref, PROMPT + GEN))(
        p_ref, {"tokens": jnp.asarray(toks)})
    logits, cache = ST.make_prefill_step(cfg, PROMPT + GEN)(
        params, {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (2, cfg.vocab_size)
    _close(logits, logits_ref)
    for name in ("k", "v"):
        assert cache[name].shape == (2, 2, cfg.num_kv_heads, PROMPT + GEN, 32)
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cache_ref[name]),
                                   rtol=1e-4, atol=1e-5)
        assert not cache[name][:, :, :, PROMPT:].any()      # unwritten slots stay zero


def test_teacher_forced_decode_and_greedy_tokens_match_reference(gemma):
    cfg_ref, cfg, p_ref, params = gemma
    toks = _tokens(1, 2, PROMPT + GEN, cfg.vocab_size)
    prefill_ref = jax.jit(RST.make_prefill_step(cfg_ref, PROMPT + GEN))
    decode_ref = jax.jit(RST.make_serve_step(cfg_ref))
    prefill, decode = ST.make_prefill_step(cfg, PROMPT + GEN), ST.make_serve_step(cfg)
    # teacher-forced: both packages fed the same tokens, logits compared per step
    lr, cr = prefill_ref(p_ref, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    lt, ct = prefill(params, {"tokens": torch.from_numpy(toks[:, :PROMPT])})
    for pos in range(PROMPT, PROMPT + GEN):
        lr, cr = decode_ref(p_ref, cr, jnp.asarray(toks[:, pos]), jnp.asarray(pos, jnp.int32))
        lt, ct = decode(params, ct, torch.from_numpy(toks[:, pos]), pos)
        _close(lt, lr)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cr[name]), rtol=1e-4, atol=1e-5)
    # greedy: each package decodes its own argmax
    lr, cr = prefill_ref(p_ref, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    lt, ct = prefill(params, {"tokens": torch.from_numpy(toks[:, :PROMPT])})
    got, want = [lt.argmax(-1)], [np.asarray(jnp.argmax(lr, -1))]
    for pos in range(PROMPT, PROMPT + GEN - 1):
        lr, cr = decode_ref(p_ref, cr, jnp.asarray(want[-1], jnp.int32),
                            jnp.asarray(pos, jnp.int32))
        lt, ct = decode(params, ct, got[-1], pos)
        want.append(np.asarray(jnp.argmax(lr, -1)))
        got.append(lt.argmax(-1))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), np.stack(want, 1))


def test_decode_from_a_reference_prefill(gemma):
    """cache_from_jax carries the reference's prefill cache over; the port
    decodes from it as the reference does."""
    cfg_ref, cfg, p_ref, params = gemma
    toks = _tokens(2, 3, PROMPT + 2, cfg.vocab_size)
    _, cr = jax.jit(RST.make_prefill_step(cfg_ref, PROMPT + 4))(
        p_ref, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    cache = cache_from_jax(jax.tree.map(np.asarray, cr), cfg, device="cpu")
    decode_ref, decode = jax.jit(RST.make_serve_step(cfg_ref)), ST.make_serve_step(cfg)
    for pos in (PROMPT, PROMPT + 1):
        lr, cr = decode_ref(p_ref, cr, jnp.asarray(toks[:, pos]), jnp.asarray(pos, jnp.int32))
        lt, cache = decode(params, cache, torch.from_numpy(toks[:, pos]), pos)
        _close(lt, lr)
    with pytest.raises(ValueError, match="shape"):
        cache_from_jax({"k": np.zeros((1, 1, 2, 4, 32)), "v": np.zeros((1, 1, 2, 4, 32))},
                       cfg, device="cpu")


def test_init_cache_and_other_families(gemma):
    _, cfg, params, _ = gemma
    cache = T.init_cache(cfg, 3, 20, device="cpu")
    for name in ("k", "v"):
        assert cache[name].shape == (cfg.num_layers, 3, cfg.num_kv_heads, 20, 32)
        assert cache[name].dtype == torch.float32 and not cache[name].any()
    np.testing.assert_array_equal(
        cache["k"].numpy(), np.asarray(RT.init_cache(ref_config("gemma3_12b").reduced(), 3, 20)["k"]))
    moe = get_config("granite_moe_3b_a800m").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_cache(moe, 1, 4, device="cpu")
    fake = dataclasses.replace(cfg, arch_type="hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.prefill({}, fake, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.decode_step({}, fake, torch.zeros(1, dtype=torch.int32), {}, 4)


# --- tests/test_ring_cache.py's scenarios, in the port and the reference --------

RING = dict(name="ring-test", arch_type="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=128, window=8, num_classes=4, source="test")


def _ring_cfgs(**over):
    return (dataclasses.replace(RefModelConfig(**RING), **over),
            dataclasses.replace(ModelConfig(**RING), **over))


def _decode_ref(cfg, params, prompt, total_len, cache_len):
    prefill = jax.jit(RST.make_prefill_step(cfg, cache_len))
    decode = jax.jit(RST.make_serve_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)})
    outs = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for pos in range(prompt.shape[1], total_len):
        logits, cache = decode(params, cache, tok, jnp.asarray(pos, jnp.int32))
        outs.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(outs)


def _decode_port(cfg, params, prompt, total_len, cache_len):
    prefill, decode = ST.make_prefill_step(cfg, cache_len), ST.make_serve_step(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(np.asarray(prompt))})
    outs = [logits]
    tok = logits.argmax(-1)
    for pos in range(prompt.shape[1], total_len):
        logits, cache = decode(params, cache, tok, pos)
        outs.append(logits)
        tok = logits.argmax(-1)
    return torch.stack(outs).numpy()


@pytest.mark.parametrize("seed,batch,prompt_len,total,cache_lens", [
    (0, 2, 4, 24, (24, 8)),     # decode well past the window: ring (window slots) == full
    (1, 1, 2, 7, (32, 8)),      # pos < window: causality masks the unwritten slots
])
def test_ring_cache_matches_reference(seed, batch, prompt_len, total, cache_lens):
    cfg_ref, cfg = _ring_cfgs()
    p_ref = RT.init_params(jax.random.key(seed), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    prompt = np.array(ref_sample_batch(cfg_ref, batch, prompt_len, seed=seed + 1,
                                         with_labels=False)["tokens"])
    full_len, ring_len = cache_lens
    ring = _decode_port(cfg, params, prompt, total, ring_len)
    full = _decode_port(cfg, params, prompt, total, full_len)
    np.testing.assert_allclose(ring, full, rtol=2e-4, atol=2e-4)
    _close(ring, _decode_ref(cfg_ref, p_ref, prompt, total, ring_len))


def test_decode_matches_forward_logits_and_reference():
    """Teacher-forced decode == the full forward at every position (no
    window), in the port, and equal to the reference's decode."""
    cfg_ref, cfg = _ring_cfgs(window=0)
    p_ref = RT.init_params(jax.random.key(2), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    toks = np.array(ref_sample_batch(cfg_ref, 2, 10, seed=3, with_labels=False)["tokens"])
    prefill, decode = ST.make_prefill_step(cfg, 16), ST.make_serve_step(cfg)
    prefill_ref, decode_ref = (jax.jit(RST.make_prefill_step(cfg_ref, 16)),
                               jax.jit(RST.make_serve_step(cfg_ref)))
    logits, cache = prefill(params, {"tokens": torch.from_numpy(toks[:, :4])})
    lr, cr = prefill_ref(p_ref, {"tokens": jnp.asarray(toks[:, :4])})
    got, want = [logits], [np.asarray(lr)]
    for pos in range(4, 10):
        logits, cache = decode(params, cache, torch.from_numpy(toks[:, pos]), pos)
        lr, cr = decode_ref(p_ref, cr, jnp.asarray(toks[:, pos]), jnp.asarray(pos, jnp.int32))
        got.append(logits)
        want.append(np.asarray(lr))
    hidden = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    all_logits = T.lm_logits(params, cfg, hidden).numpy()
    for i, p in enumerate(range(3, 10)):
        np.testing.assert_allclose(got[i].numpy(), all_logits[:, p], rtol=2e-4, atol=2e-4)
        _close(got[i], want[i])


# --- inputs, serve ------------------------------------------------------------------

@pytest.mark.parametrize("arch,with_labels", [
    ("gemma3_12b", True), ("gemma3_12b", False),
    ("llava_next_mistral_7b", True),     # prefix_embeds
    ("seamless_m4t_medium", True),       # enc_feats
])
def test_sample_batch_equals_reference(arch, with_labels):
    cfg_ref, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    want = ref_sample_batch(cfg_ref, 3, 40, seed=5, with_labels=with_labels)
    got = sample_batch(cfg, 3, 40, seed=5, with_labels=with_labels, device="cpu")
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert got[name].dtype == {"int32": torch.int32, "float32": torch.float32}[str(a.dtype)]
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(a))


def test_input_shapes_match_reference():
    from repro.config import INPUT_SHAPES as REF_SHAPES
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


def test_serve_matches_reference_tokens(gemma):
    """The whole serve loop on the reference's weights: the tokens are the
    reference serve's, and on_step sees each step's logits."""
    cfg_ref, cfg, _, _ = gemma
    want, _, _ = RS.serve(cfg_ref, 2, 40, 6, seed=0)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    seen = []
    got, prefill_s, decode_s = S.serve(cfg, 2, 40, 6, seed=0, device="cpu", params=params,
                                       on_step=lambda i, lg: seen.append((i, lg.argmax(-1))))
    assert got.shape == (2, 46) and prefill_s > 0 and decode_s > 0
    np.testing.assert_array_equal(got, want)
    assert [i for i, _ in seen] == list(range(6))
    np.testing.assert_array_equal(torch.stack([t for _, t in seen], 1).numpy(), got[:, 40:])


def test_serve_cli(capsys):
    S.main(["--arch", "gemma3_12b", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "tok/s" in out and "reduced=True" in out
    with pytest.raises(SystemExit, match="Queue 1 item 7"):
        S.main(["--federation"])
