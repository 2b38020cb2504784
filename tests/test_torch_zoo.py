"""The rest of the backbone zoo against the reference, on the same weights.

Reduced granite_moe_3b_a800m and grok1_314b (``moe``: 4 experts top-2;
grok1 with its logit softcap of 30), zamba2_7b (``hybrid``), xlstm_350m
(``xlstm``) and seamless_m4t_medium (``encdec``), each at 5 layers so that
the hybrid and xLSTM stacks have two groups and a tail (``reduced()``'s 2
layers with a cadence of 2 would have no tail), on the reference's
``T.init_params(jax.random.key(0), cfg)`` carried over by
``params_from_jax``: ``forward``, ``prefill``, three teacher-forced
``decode_step``\\ s with their caches, decoding from the reference's own
prefill cache (``cache_from_jax``), ``init_cache``, ``serve()``'s greedy
tokens, and ``run_analytic`` for granite and xlstm (the paper's Table 4
backbones besides the dense one). Tolerances as the dense family's
(tests/test_torch_backbone.py, tests/test_torch_serve.py): hidden states
rtol 1e-4 / atol 1e-5, logits rtol 1e-4 / atol 1e-4·max|logit|, caches
and states rtol 1e-4 / atol 1e-5, tokens and accuracies exactly. The one
exception is xLSTM's f32 hidden states, held like logits, at rtol 1e-4 /
atol 1e-4·max|h|. The two packages compute the same function: in f64
their forward, prefill and decode agree to 1e-10 (measured 5e-14 at
|h| <= 3.5), which ``test_xlstm_in_f64_is_the_reference`` holds. In f32
the five layers of exponentially gated recurrences amplify the rounding
of the projections: this CPU's f32 GEMM (numpy's and torch's) rounds
1.5-2x more than XLA's at these widths, so over eight inputs the port's
f32 hidden states lie 2e-5 to 1.6e-4 from f64 and the reference's 2e-5
to 8e-5; with the port's matmuls in f64 its drift falls to 5e-6-2e-5.
Entries near zero then differ by more than an absolute 1e-5, while the
states and logits meet the dense bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs.registry import get_config as ref_config
from repro.data import synthetic as RD
from repro.launch import mesh as RM
from repro.launch import serve as RS
from repro.launch import steps as RST
from repro.launch import train as RTrain
from repro.launch.inputs import sample_batch as ref_sample_batch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro_torch.config import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic as D
from repro_torch.launch import serve as S
from repro_torch.launch import steps as ST
from repro_torch.launch import train as PTrain
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import layers as PL
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as PX
from repro_torch.models.convert import cache_from_jax, params_from_jax
from torch_f64 import read_f64

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["granite_moe_3b_a800m", "grok1_314b", "zamba2_7b", "xlstm_350m",
         "seamless_m4t_medium"]
LAYERS = 5
B, PROMPT, GEN = 2, 24, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg_ref = ref_config(arch).reduced(num_layers=LAYERS)
        cfg = get_config(arch).reduced(num_layers=LAYERS)
        p_ref = RT.init_params(jax.random.key(0), cfg_ref)
        params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
        _MODELS[arch] = (cfg_ref, cfg, p_ref, params)
    return _MODELS[arch]


def _close(got, want, rtol=1e-4, rel_atol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


def _tree_close(got, want, **tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_close(got[k], want[k], **tol)
        return
    assert tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _batches(cfg_ref, cfg, seq, seed):
    br = ref_sample_batch(cfg_ref, B, seq, seed=seed, with_labels=False)
    bt = sample_batch(cfg, B, seq, seed=seed, with_labels=False, device="cpu")
    return br, bt


def test_the_depths_reach_groups_and_tails():
    assert T._hybrid_split(get_config("zamba2_7b").reduced(num_layers=LAYERS)) == (2, 2, 1)
    assert T._xlstm_split(get_config("xlstm_350m").reduced(num_layers=LAYERS)) == (2, 2, 1)
    _, _, _, params = _model("zamba2_7b")
    assert [len(g) for g in params["mamba_groups"]] == [1, 1] and len(params["mamba_tail"]) == 1
    _, _, _, params = _model("xlstm_350m")
    assert len(params["slstm"]) == 2 and len(params["mlstm_tail"]) == 1
    cfg = get_config("grok1_314b").reduced(num_layers=LAYERS)
    assert cfg.logit_softcap == 30.0 and cfg.moe.top_k == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_layout(arch):
    """Stacked trees become lists of layer dicts; every leaf is the
    reference's array; a tree of another config is refused."""
    cfg_ref, cfg, p_ref, params = _model(arch)
    flat_ref = jax.tree.leaves(p_ref)
    flat = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            flat.append(t)

    walk(params)
    assert sum(a.numel() for a in flat) == sum(a.size for a in flat_ref)
    if "layers" in params:
        assert len(params["layers"]) == cfg.num_layers
        np.testing.assert_array_equal(params["layers"][-1]["ln1"]["scale"].numpy(),
                                      np.asarray(p_ref["layers"]["ln1"]["scale"][-1]))
    other = ref_config(arch).reduced(num_layers=LAYERS + 1)
    with pytest.raises(ValueError, match="expected"):
        params_from_jax(jax.tree.map(np.asarray, p_ref), get_config(arch).reduced(
            num_layers=other.num_layers), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg_ref, cfg, p_ref, params = _model(arch)
    br, bt = _batches(cfg_ref, cfg, PROMPT, seed=3)
    want = RT.forward(p_ref, cfg_ref, br)
    got = T.forward(params, cfg, bt)
    assert got.shape == (B, PROMPT, cfg.d_model) and got.dtype == torch.float32
    for a, b in [(got, want), (T.pool(got), RT.pool(want))]:
        if cfg.arch_type == "xlstm":
            _close(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill, then three teacher-forced decode steps: logits and the whole
    cache (KV slots, conv and SSD states, mLSTM / sLSTM states, the
    cross-attention's memory) against the reference's at each step; then
    the port decodes from the reference's own prefill cache."""
    cfg_ref, cfg, p_ref, params = _model(arch)
    br, bt = _batches(cfg_ref, cfg, PROMPT, seed=4)
    nxt = np.random.default_rng(5).integers(0, cfg.vocab_size, (GEN, B)).astype(np.int32)
    prefill_ref = jax.jit(RST.make_prefill_step(cfg_ref, PROMPT + GEN))
    decode_ref = jax.jit(RST.make_serve_step(cfg_ref))
    lr, cr = prefill_ref(p_ref, br)
    lt, ct = ST.make_prefill_step(cfg, PROMPT + GEN)(params, bt)
    _close(lt, lr)
    _tree_close(ct, jax.tree.map(np.asarray, cr), **CACHE_TOL)
    mem = np.shape(br["enc_feats"])[1] if "enc_feats" in br else None
    carried = cache_from_jax(jax.tree.map(np.asarray, cr), cfg, B, PROMPT + GEN, device="cpu",
                             mem_len=mem)
    decode = ST.make_serve_step(cfg)
    for i in range(GEN):
        pos = PROMPT + i
        lr, cr = decode_ref(p_ref, cr, jnp.asarray(nxt[i]), jnp.asarray(pos, jnp.int32))
        lt, ct = decode(params, ct, torch.from_numpy(nxt[i]), pos)
        _close(lt, lr)
        _tree_close(ct, jax.tree.map(np.asarray, cr), **CACHE_TOL)
        if i == 0:
            lc, carried = decode(params, carried, torch.from_numpy(nxt[i]), pos)
            _close(lc, lr)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg_ref, cfg, _, _ = _model(arch)
    want = jax.tree.map(np.asarray, RT.init_cache(cfg_ref, 3, 20))
    got = T.init_cache(cfg, 3, 20, device="cpu")
    _tree_close(got, want, rtol=0, atol=0)
    _tree_close(cache_from_jax(want, cfg, 3, 20, device="cpu"), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape|keys"):
        bad = jax.tree.map(lambda a: a[..., :1], want)
        cache_from_jax(bad, cfg, 3, 20, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_tokens(arch):
    """The whole serve loop on the reference's weights: greedy tokens equal
    the reference serve's."""
    cfg_ref, cfg, _, params = _model(arch)
    want, _, _ = RS.serve(cfg_ref, B, PROMPT, 4, seed=0)
    got, prefill_s, decode_s = S.serve(cfg, B, PROMPT, 4, seed=0, device="cpu",
                                       params=params)
    assert got.shape == (B, PROMPT + 4) and prefill_s > 0 and decode_s > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "xlstm_350m"])
def test_run_analytic_matches_reference(arch):
    """Table 4's backbones: reduced run_analytic in both packages on one
    set of weights, equal accuracy."""
    classes = 8
    cfg_ref = ref_config(arch).reduced(num_layers=LAYERS, num_classes=classes)
    cfg = get_config(arch).reduced(num_layers=LAYERS, num_classes=classes)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    ds = D.token_classification(n=192, seq=12, vocab=cfg.vocab_size, num_classes=classes,
                                seed=0)
    ds_ref = RD.token_classification(n=192, seq=12, vocab=cfg.vocab_size,
                                     num_classes=classes, seed=0)
    np.testing.assert_array_equal(ds.x, ds_ref.x)
    train, test = D.train_test_split(ds, 0.25, seed=0)
    acc_ref, _ = RTrain.run_analytic(cfg_ref, RM.make_host_mesh(), train, test,
                                     RefFLConfig(gamma=1.0), 48, use_kernel=True)
    acc, train_s = PTrain.run_analytic(cfg, train, test, FLConfig(gamma=1.0), 48,
                                       use_kernel=True, device="cpu", params=params)
    assert acc == acc_ref and train_s > 0


F64_TOL = dict(rtol=1e-10, atol=1e-10)


def test_xlstm_in_f64_is_the_reference(monkeypatch):
    """xLSTM at 5 layers in f64: the port's forward, prefill and three
    decode steps (hidden states and every state of the cache) equal the
    reference's to 1e-10, and each decode step equals the port's own
    teacher-forced forward at its position, so the f32 differences above
    are rounding, not another function."""
    read_f64(monkeypatch, [(RT, "jnp"), (RL, "jnp"), (RX, "jnp"),
                           (T, "torch"), (PL, "torch"), (PX, "torch")])
    cfg_ref, cfg, p_ref, _ = _model("xlstm_350m")
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), p_ref)
    params = params_from_jax(p64, cfg, device="cpu")
    br, bt = _batches(cfg_ref, cfg, PROMPT + GEN, seed=3)
    with jax.enable_x64(True):
        pr = jax.tree.map(jnp.asarray, p64)
        want = np.asarray(RT.forward(pr, cfg_ref, br))
        got = T.forward(params, cfg, bt)
        assert got.dtype == torch.float64 and want.dtype == np.float64
        np.testing.assert_allclose(got.numpy(), want, **F64_TOL)
        hr, cr = RT.prefill(pr, cfg_ref, {"tokens": br["tokens"][:, :PROMPT]}, PROMPT + GEN)
        ht, ct = T.prefill(params, cfg, {"tokens": bt["tokens"][:, :PROMPT]}, PROMPT + GEN)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hr), **F64_TOL)
        _tree_close(ct, jax.tree.map(np.asarray, cr), **F64_TOL)
        for i in range(GEN):
            pos = PROMPT + i
            tok = np.array(br["tokens"])[:, pos]
            hr, cr = RT.decode_step(pr, cfg_ref, jnp.asarray(tok), cr, pos)
            ht, ct = T.decode_step(params, cfg, torch.from_numpy(tok), ct, pos)
            np.testing.assert_allclose(ht.numpy(), np.asarray(hr), **F64_TOL)
            _tree_close(ct, jax.tree.map(np.asarray, cr), **F64_TOL)
            np.testing.assert_allclose(ht[:, 0].numpy(), got[:, pos].numpy(), **F64_TOL)
