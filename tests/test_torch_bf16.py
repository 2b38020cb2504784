"""The model path at ``dtype="bfloat16"``, the reference's target dtype
(``repro.launch.dryrun`` moves every config there), against the
reference's own bf16 on the CPU.

Every family at ``reduced(dtype="bfloat16")`` (2 layers; granite's MoE,
zamba2's group, xLSTM's mLSTM and sLSTM, seamless's ``enc_feats``,
llava's ``prefix_embeds``, nemotron's LayerNorm and relu²) on the
reference's ``T.init_params(jax.random.key(0), cfg)`` in bf16, carried by
``params_from_jax`` bit for bit, on a numpy-seeded batch of 2 × 16 tokens.

Bit equality is not the bar: XLA fuses bf16 elementwise chains and rounds
once, torch rounds after every op. The bars, each from this file's own
readings on the CPU (``python tests/test_torch_bf16.py`` prints them):

  * pooled embeddings and last-position logits within ``REL`` = 2e-2 of
    the reference's largest |value| (read: 3.2e-3 to 7.9e-3 pooled, 4.7e-3
    to 1.39e-2 logits);
  * the port's distance to the reference's f32 forward on the same
    weights at most ``F32_RATIO`` = 1.5 × the reference bf16's own
    (read: 0.57 to 1.32 ×);
  * each decode step's logits against a teacher-forced forward at most
    ``DECODE_RATIO`` = 2 × the reference's gap, of a row's largest |logit|
    (read: 0 in both packages at this size: the bf16 rounding of each
    op absorbs the sums' other orders);
  * the analytic train step folds the pooled bf16 features as f32, so its
    state equals the reference's fold of the same features at
    tests/test_torch_streaming.py's f32 tolerances (rtol 2e-4, atol 2e-3),
    (read: the Gram's bits), and the reference's whole step within
    ``STEP_REL`` = 4e-2 of the largest entry, twice ``REL`` since the Gram
    is quadratic in the features (read: 5.0e-3 to 1.53e-2).

``python tests/test_torch_bf16.py --card`` prints the reference's readings
of ``chip_smoke.py`` phase 20's checks, whose bars are twice them:
reduced qwen3_32b in bf16 at the card's depths and traffic (batch 4,
prompt 512, 16 new tokens).
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_config as ref_config
from repro.core import streaming as RS
from repro.launch import steps as RST
from repro.launch.inputs import sample_batch as ref_sample_batch
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.core import streaming as PS
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.optim import tree_leaves

ARCHS = ["minicpm_2b", "qwen3_32b", "gemma3_12b", "granite_moe_3b_a800m", "zamba2_7b",
         "xlstm_350m", "seamless_m4t_medium", "llava_next_mistral_7b", "nemotron4_15b"]
B, S, PROMPT = 2, 16, 12
REL = 2e-2
F32_RATIO = 1.5
DECODE_RATIO = 2.0
RTOL, ATOL = 2e-4, 2e-3
STEP_REL = 4e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _rel(a, b) -> float:
    """Largest |a − b| over the largest |b|."""
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rel_rows(a, b) -> float:
    """Largest |a − b| of a row over that row's largest |b|."""
    a, b = _f32(a), _f32(b)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


@functools.cache
def _model(arch):
    """(reference config, port config, reference bf16 params, the port's
    copy, reference batch, port batch): the batches the same numbers."""
    rc = ref_config(arch).reduced(dtype="bfloat16")
    pc = get_config(arch).reduced(dtype="bfloat16")
    p_ref = RT.init_params(jax.random.key(0), rc)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), pc, device="cpu")
    br = ref_sample_batch(rc, B, S, seed=1)
    bt = sample_batch(pc, B, S, seed=1, device="cpu")
    return rc, pc, p_ref, params, br, bt


def _prompt(batch, n):
    return {k: v[:, :n] if k == "tokens" else v for k, v in batch.items() if k != "labels"}


@functools.cache
def readings(arch) -> dict:
    """The port's and the reference's bf16 forward, f32 forward and decode
    on the same weights and batch, as the distances the tests hold."""
    rc, pc, p_ref, params, br, bt = _model(arch)
    rc32 = dataclasses.replace(rc, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p_ref)
    fwd = {k: v for k, v in br.items() if k != "labels"}
    h_ref, h32 = RT.forward(p_ref, rc, fwd), RT.forward(p32, rc32, fwd)
    with torch.no_grad():
        h = T.forward(params, pc, {k: v for k, v in bt.items() if k != "labels"})
    lg_ref, lg32 = RT.lm_logits(p_ref, rc, h_ref), RT.lm_logits(p32, rc32, h32)
    lg = T.lm_logits(params, pc, h)
    pool, pool_ref, pool32 = T.pool(h), RT.pool(h_ref), RT.pool(h32)
    out = dict(hidden_dtype=h.dtype, pool_dtype=pool.dtype, logit_dtype=lg.dtype,
               pool=_rel(pool, pool_ref), logits=_rel(lg[:, -1], lg_ref[:, -1]),
               pool_f32=_rel(pool, pool32), pool_ref_f32=_rel(pool_ref, pool32),
               logits_f32=_rel(lg[:, -1], lg32[:, -1]),
               logits_ref_f32=_rel(lg_ref[:, -1], lg32[:, -1]))
    # decode from a prompt of PROMPT − prefix tokens, teacher-forced
    off = pc.prefix_tokens
    n = PROMPT - off
    _, c_ref = RT.prefill(p_ref, rc, _prompt(br, n), S)
    _, cache = T.prefill(params, pc, _prompt(bt, n), S)
    out["cache_dtypes"] = ({k: np.asarray(v).dtype.name for k, v in _flat(c_ref)},
                           {k: str(v.dtype).removeprefix("torch.") for k, v in _flat(cache)})
    out["cache_bits"] = _cache_bits(c_ref, pc, n + off, S)
    gap, gap_ref = 0.0, 0.0
    for i in range(S - PROMPT):
        pos = PROMPT + i
        tok = np.array(br["tokens"][:, pos - off])
        h1, c_ref = RT.decode_step(p_ref, rc, jnp.asarray(tok), c_ref, pos)
        h2, cache = T.decode_step(params, pc, torch.from_numpy(tok), cache, pos)
        gap_ref = max(gap_ref, _rel_rows(RT.lm_logits(p_ref, rc, h1)[:, 0], lg_ref[:, pos]))
        gap = max(gap, _rel_rows(T.lm_logits(params, pc, h2)[:, 0], lg[:, pos]))
    out.update(decode=gap, decode_ref=gap_ref)
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def _cache_bits(c_ref, pc, s, max_seq) -> bool:
    """``cache_from_jax`` of the reference's bf16 prefill cache keeps its
    dtypes and bits."""
    c_np = jax.tree.map(np.asarray, c_ref)
    mem = c_np["xk"].shape[3] if "xk" in c_np else None     # the encoder memory's length
    got = dict(_flat(cache_from_jax(c_np, pc, B, max_seq, device="cpu", mem_len=mem)))
    for path, want in _flat(c_np):
        t = got[path]
        if want.dtype.name == "bfloat16":
            if t.dtype != torch.bfloat16 or not np.array_equal(
                    t.view(torch.int16).numpy(), want.view(np.int16)):
                return False
        elif not np.array_equal(t.numpy(), want):
            return False
    return True


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_bf16_bits(arch):
    """Every bf16 leaf crosses as ``torch.bfloat16`` with its bits, never
    widened, and the others (zamba2's f32 SSM parameters) as they are; the
    reference's bf16 prefill cache too (``cache_from_jax``),
    its f32 recurrent states as they are."""
    _, pc, p_ref, params, _, _ = _model(arch)
    layout = T.stacked_layout(pc)
    pairs = [pair for name, sub in jax.tree.map(np.asarray, p_ref).items()
             for pair in _pairs(sub, params[name], len(layout.get(name, ())))]
    assert len(pairs) == len(tree_leaves(params))
    assert "bfloat16" in {a.dtype.name for a, _ in pairs}
    for a, t in pairs:
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert readings(arch)["cache_bits"]


def _pairs(ref, port, depth):
    """(reference leaf, port leaf) pairs of one top-level entry, its first
    ``depth`` dims (the reference's stacking) walked as the port's lists."""
    if depth:
        for i, sub in enumerate(port):
            yield from _pairs(jax.tree.map(lambda a: a[i], ref), sub, depth - 1)
    elif isinstance(ref, dict):
        for k in ref:
            yield from _pairs(ref[k], port[k], 0)
    else:
        yield ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    """Hidden states, pooled embeddings and logits stay bf16, as the
    reference's do; the pooled embeddings and last-position logits lie
    within ``REL`` of the reference's largest |value|."""
    r = readings(arch)
    assert r["hidden_dtype"] == r["pool_dtype"] == r["logit_dtype"] == torch.bfloat16
    assert r["pool"] <= REL, r
    assert r["logits"] <= REL, r


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_error_is_the_references_own(arch):
    """The port's bf16 lies from the reference's f32 forward (on the same
    weights) at most ``F32_RATIO`` × as far as the reference's bf16 does."""
    r = readings(arch)
    assert r["pool_f32"] <= F32_RATIO * r["pool_ref_f32"], r
    assert r["logits_f32"] <= F32_RATIO * r["logits_ref_f32"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_teacher_forced(arch):
    """Prefill then four decode steps: the caches are made at the
    reference's dtypes (KV slots and conv states bf16, recurrent states
    f32), and each step's logits lie from a teacher-forced forward at most
    ``DECODE_RATIO`` × the reference's own gap."""
    r = readings(arch)
    ref_dtypes, dtypes = r["cache_dtypes"]
    assert dtypes == ref_dtypes and "bfloat16" in set(dtypes.values()) | {
        "bfloat16" if arch == "xlstm_350m" else "none"}
    assert r["decode"] <= DECODE_RATIO * r["decode_ref"], r


@functools.cache
def _steps(arch):
    """The port's analytic train step on the bf16 model, its pooled bf16
    features, the reference's fold of those features, and the
    reference's whole step."""
    rc, pc, p_ref, params, br, bt = _model(arch)
    state = ST.make_analytic_train_step(pc)(params, PS.init_state(pc.d_model, pc.num_classes,
                                                                  device="cpu"), bt)
    with torch.no_grad():
        emb = T.pool(T.forward(params, pc, bt))
    y = np.eye(rc.num_classes, dtype=np.float32)[np.asarray(br["labels"])]
    x = jnp.asarray(emb.view(torch.int16).numpy().view(jnp.bfloat16))
    fold = RS.update_state(RS.init_state(rc.d_model, rc.num_classes), x, jnp.asarray(y))
    whole = RST.make_analytic_train_step(rc)(p_ref, RS.init_state(rc.d_model, rc.num_classes),
                                             br)
    return state, emb, fold, whole


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_analytic_train_step(arch):
    """``make_analytic_train_step`` on a bf16 model: the state is f32 (the
    one-hot targets f32, the pooled bf16 features cast to the engine's
    f32 before the fold, as the reference's engine casts them); it equals
    the reference's fold of the same features at the f32 tolerances, and
    the reference's whole step within ``STEP_REL``."""
    state, emb, fold, whole = _steps(arch)
    assert all(t.dtype == torch.float32 for t in state)
    assert emb.dtype == torch.bfloat16
    for a, b in zip(state, fold):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    assert _rel(state.gram, whole.gram) <= STEP_REL
    assert _rel(state.moment, whole.moment) <= STEP_REL
    assert float(state.count) == float(whole.count) == B


def test_bf16_onehot_targets_are_f32():
    """The step's targets are f32 one-hots whatever the model's dtype, as
    the reference's (``launch/steps.py``); the fold of bf16 features into
    an f32 state widens them exactly."""
    x = torch.randn(5, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y = F.one_hot(torch.tensor([0, 1, 2, 1, 0]), 3).to(torch.float32)
    st = PS.update_state(PS.init_state(8, 3, device="cpu"), x, y)
    xf = x.to(torch.float32)
    torch.testing.assert_close(st.gram, xf.T @ xf, rtol=0, atol=0)
    torch.testing.assert_close(st.moment, xf.T @ y, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "seamless_m4t_medium"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_bf16_dry_run_step_runs_at_its_prediction(arch, kind):
    """The dry run's step of a bf16 config built on a device (here the
    CPU; phase 20 of chip_smoke.py does it on the card): the batch's
    modality stub at the param dtype, the step's outputs bf16 (the train
    step's state f32), and its static bytes those the walk predicts."""
    from repro_torch.config import InputShape
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as DR

    cfg = get_config(arch).reduced(dtype="bfloat16")
    # 32 tokens, seamless's reduced encoder_seq: the walk sizes the
    # cross-attention cache by encoder_seq, the prefill by its memory
    shape = InputShape(kind, 32, 2, kind)
    fn, args, static = DR.build_step(cfg, shape, "flash", device="cpu")
    stub = "prefix_embeds" if cfg.prefix_tokens else "enc_feats"
    if kind != "decode":
        assert static["batch"][stub].dtype == torch.bfloat16
    out = fn(*args)
    if kind == "train":
        assert all(t.dtype == torch.float32 for t in out) and float(out.count) == 2
    else:
        assert out[0].dtype == torch.bfloat16
        static = dict(static, cache=out[1] if kind == "prefill" else static["cache"])
        assert {t.dtype for t in tree_leaves(static["cache"])} == {torch.bfloat16}
    got = {k: CA.storage_bytes(v, "cpu") for k, v in static.items()}
    assert got == DR.step_cost(cfg, shape, "flash")["static"]


def card_readings(layers: int, prompt: int = 512, gen: int = 16, batch: int = 4) -> dict:
    """The reference's readings of ``chip_smoke.py`` phase 20's checks on
    reduced qwen3_32b in bf16 at ``layers`` layers: (a) the prefill's
    last-position logits with the Pallas flash kernel (interpret mode) as
    its attention against the plain ``sdpa``; (b) each decode step's
    logits against a teacher-forced forward; (c) the pooled embeddings at
    bf16 against f32 on the same weights; (a) and (b) of a row's largest
    |logit|, (c) of the largest |value|."""
    from repro.kernels import ops as KO
    from repro.models import layers as RL

    rc = ref_config("qwen3_32b").reduced(dtype="bfloat16", num_layers=layers)
    p = RT.init_params(jax.random.key(0), rc)
    b = ref_sample_batch(rc, batch, prompt + gen, seed=0, with_labels=False)
    rc32 = dataclasses.replace(rc, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    pooled = _rel(RT.pool(RT.forward(p, rc, b)), RT.pool(RT.forward(p32, rc32, b)))
    lf = RT.lm_logits(p, rc, RT.forward(p, rc, b))
    first = {"tokens": b["tokens"][:, :prompt]}
    h, cache = RT.prefill(p, rc, first, prompt + gen)
    plain = RT.lm_logits(p, rc, h[:, -1:])[:, 0]
    gaps = [_rel_rows(plain, lf[:, prompt - 1])]
    for i in range(gen - 1):
        h1, cache = RT.decode_step(p, rc, b["tokens"][:, prompt + i], cache, prompt + i)
        gaps.append(_rel_rows(RT.lm_logits(p, rc, h1)[:, 0], lf[:, prompt + i]))

    def kernel(q, k, v, *, causal=True, window=None, q_offset=0, softcap=0.0, **_):
        assert not softcap and isinstance(q_offset, int) and q_offset == 0
        return KO.flash_attention(q, k, v, causal=causal)

    sdpa, RL.sdpa = RL.sdpa, kernel
    try:
        kern = RT.lm_logits(p, rc, RT.prefill(p, rc, first, prompt + gen)[0][:, -1:])[:, 0]
    finally:
        RL.sdpa = sdpa
    return dict(layers=layers, prefill_kernel_vs_plain=_rel_rows(kern, plain),
                decode_vs_teacher_forced=max(gaps), pooled_bf16_vs_f32=pooled)


if __name__ == "__main__":
    torch.set_num_threads(1)
    if "--card" in sys.argv:
        for n in (64, 8):
            print(card_readings(n))
    else:
        keys = ("pool", "logits", "pool_f32", "pool_ref_f32", "logits_f32", "logits_ref_f32",
                "decode", "decode_ref")
        print("arch " + " ".join(keys) + " step_gram step_moment fold_gram")
        for arch in ARCHS:
            r = readings(arch)
            state, _, fold, whole = _steps(arch)
            print(arch, " ".join(f"{r[k]:.3e}" for k in keys),
                  f"{_rel(state.gram, whole.gram):.3e} {_rel(state.moment, whole.moment):.3e} "
                  f"{_rel(state.gram, fold.gram):.3e}")
