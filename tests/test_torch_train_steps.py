"""The gradient steps, ``run_gradient`` / ``run_lm`` and ``FlashSDPA``
against the reference.

Every model runs on the reference's ``T.init_params(jax.random.key(0),
cfg)`` carried over by ``params_from_jax``, on the same
``sample_batch`` draws. Tolerances:

* ``head_loss``, its gradient and ``head_sgd_step``: rtol 1e-6 / atol
  1e-6 of the largest entry (f32 sums of 8 products in another order);
* ``make_fedavg_train_step`` on reduced minicpm_2b from a zero head (so
  the new head is ``−lr·∇`` with nothing to cancel): rtol 1e-4 / atol
  1e-4 of the largest entry, the backbone's embedding bar;
* ``make_full_train_step``, one step at lr 1e-2, every arch at
  ``.reduced()``: the loss within rtol 1e-5, and each leaf's Δp within
  1e-4·max|Δp| plus one f32 spacing of the parameter. The gradients agree
  to about 3e-6 of each leaf's largest; what lies above 1e-4·max|Δp| is
  the rounding of ``p − lr·g`` to f32, which each package does once: one
  spacing of ``p``, at most (about 1.5e-8 at |p| ≈ 0.1, where lr·g is
  1e-4 or less);
* in f64 (both packages' modules seen with ``float32`` read as
  ``float64``, under ``jax.enable_x64``), dense and xLSTM: loss and each
  leaf's Δp within 1e-10 relative, nothing added;
* ``run_lm``'s first 4 losses rtol 1e-5; ``run_gradient``'s accuracy
  equal and its head (the same loop, 2 rounds) within rtol 1e-4 / atol
  1e-4 of the largest entry;
* ``FlashSDPA`` on the CPU (its forward there is ``sdpa_plain``): output
  and gradients equal to autograd of ``sdpa_plain``, and
  ``torch.autograd.gradcheck`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as ref_config
from repro.data import synthetic as RD
from repro.launch import mesh as RM
from repro.launch import steps as RST
from repro.launch import train as RTrain
from repro.launch.inputs import sample_batch as ref_sample_batch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro_torch.config import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic as D
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import steps as ST
from repro_torch.launch import train as PTrain
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import layers as PL
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as PX
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import tree_leaves, tree_map
from torch_f64 import read_f64

LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, **over):
    cfg_ref = ref_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    return cfg_ref, cfg, p_ref, params


# ------------------------------------------------------------------ the head
def _head_inputs(seed=0, b=8, d=16, c=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, c)).astype(np.float32) * 0.1,
            rng.standard_normal((b, d)).astype(np.float32),
            rng.integers(0, c, b).astype(np.int32))


def test_head_loss_and_its_gradient_match_jax():
    head, emb, labels = _head_inputs()
    want = RST.head_loss(jnp.asarray(head), jnp.asarray(emb), jnp.asarray(labels))
    g_want = jax.grad(RST.head_loss)(jnp.asarray(head), jnp.asarray(emb), jnp.asarray(labels))
    h = torch.from_numpy(head).requires_grad_(True)
    got = ST.head_loss(h, torch.from_numpy(emb), torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, h)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-6, atol=1e-6 * np.abs(g_want).max())


@pytest.mark.parametrize("lr", [0.05, 0.5])
def test_head_sgd_step_matches_jax(lr):
    head, emb, labels = _head_inputs(1)
    want = RST.head_sgd_step(jnp.asarray(head), jnp.asarray(emb), jnp.asarray(labels), lr)
    h = torch.from_numpy(head)
    got = ST.head_sgd_step(h, torch.from_numpy(emb), labels, lr)
    assert not got.requires_grad and torch.equal(h, torch.from_numpy(head))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():          # the step takes its own gradient
        again = ST.head_sgd_step(h, torch.from_numpy(emb), labels, lr)
    assert torch.equal(again, got)


def test_fedavg_train_step_matches_reference():
    cfg_ref, cfg, p_ref, params = _model("minicpm_2b", num_classes=8)
    br = ref_sample_batch(cfg_ref, 4, 12, seed=5)
    bt = sample_batch(cfg, 4, 12, seed=5, device="cpu")
    head_ref, loss_ref = RST.make_fedavg_train_step(cfg_ref)(
        p_ref, jnp.zeros((cfg.d_model, 8), jnp.float32), br)
    head, loss = ST.make_fedavg_train_step(cfg)(
        params, torch.zeros((cfg.d_model, 8)), bt)
    assert not head.requires_grad
    assert all(not p.requires_grad for p in tree_leaves(params))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    want = np.asarray(head_ref)
    np.testing.assert_allclose(head.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------- full step
def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{pre}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{pre}[{i}]")]
    return [pre]


def _check_step(old, new, new_ref, rel, spacing):
    """Each leaf's Δp = new − old against the reference's Δp: within
    ``rel``·max|Δp_ref|, plus one spacing of the parameter if ``spacing``."""
    for path, o, a, b in zip(_paths(old), tree_leaves(old), tree_leaves(new),
                             tree_leaves(new_ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        dp, dr = a.double() - o.double(), b.double() - o.double()
        tol = rel * float(dr.abs().max())
        if spacing:
            tol = tol + torch.from_numpy(np.spacing(np.abs(a.numpy()))).double()
        err = (dp - dr).abs()
        assert bool((err <= tol).all()), (
            f"{path}: Δp off by {float(err.max()):.3e}, max|Δp| {float(dr.abs().max()):.3e}")


def _full_step_pair(cfg_ref, cfg, p_ref, params, seed=0):
    br = ref_sample_batch(cfg_ref, 2, 16, seed=seed)
    bt = sample_batch(cfg, 2, 16, seed=seed, device=params["embed"].device)
    new_ref, loss_ref = RST.make_full_train_step(cfg_ref)(p_ref, br, LR)
    old = tree_map(torch.clone, params)
    out, loss = ST.make_full_train_step(cfg)(params, bt, LR)
    return old, out, loss, new_ref, loss_ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_train_step_matches_reference(arch):
    cfg_ref, cfg, p_ref, params = _model(arch)
    old, out, loss, new_ref, loss_ref = _full_step_pair(cfg_ref, cfg, p_ref, params)
    assert out is params                       # updated in place
    assert loss.dim() == 0 and not loss.requires_grad
    assert all(not p.requires_grad for p in tree_leaves(params))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    new_ref = params_from_jax(jax.tree.map(np.asarray, new_ref), cfg, device="cpu")
    assert any(not torch.equal(a, o) for a, o in zip(tree_leaves(params), tree_leaves(old)))
    _check_step(old, params, new_ref, 1e-4, spacing=True)


@pytest.mark.parametrize("arch", ["minicpm_2b", "xlstm_350m"])
def test_full_train_step_in_f64_is_the_reference(arch, monkeypatch):
    read_f64(monkeypatch, [(RT, "jnp"), (RL, "jnp"), (RX, "jnp"), (RST, "jnp"),
                           (T, "torch"), (PL, "torch"), (PX, "torch"), (ST, "torch")])
    cfg_ref, cfg, p_ref, _ = _model(arch, num_layers=3)
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), p_ref)
    params = params_from_jax(p64, cfg, device="cpu")
    with jax.enable_x64(True):
        old, _, loss, new_ref, loss_ref = _full_step_pair(
            cfg_ref, cfg, jax.tree.map(jnp.asarray, p64), params, seed=1)
        assert loss.dtype == torch.float64 and loss_ref.dtype == jnp.float64
        new_ref = params_from_jax(jax.tree.map(np.asarray, new_ref), cfg, device="cpu")
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-10)
    assert all(p.dtype == torch.float64 for p in tree_leaves(params))
    _check_step(old, params, new_ref, 1e-10, spacing=False)


# ----------------------------------------------------------- the launchers
def test_run_lm_losses_match_reference():
    cfg_ref, cfg, _, params = _model("minicpm_2b")
    want = RTrain.run_lm(cfg_ref, RM.make_host_mesh(), 4, 2, 16)
    got = PTrain.run_lm(cfg, 4, 2, 16, device="cpu", params=params)
    assert len(got) == 4 and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_run_gradient_matches_reference():
    classes, batch, rounds = 8, 32, 2
    cfg_ref, cfg, p_ref, params = _model("minicpm_2b", num_classes=classes)
    ds = D.token_classification(n=128, seq=8, vocab=cfg.vocab_size, num_classes=classes,
                                seed=0)
    train, test = D.train_test_split(ds, 0.25, seed=0)
    acc_ref, _ = RTrain.run_gradient(cfg_ref, RM.make_host_mesh(), train, test,
                                     RefFLConfig(), batch, rounds)
    acc, train_s = PTrain.run_gradient(cfg, train, test, FLConfig(), batch, rounds,
                                       device="cpu", params=params)
    assert acc == acc_ref and train_s > 0
    # the head, as each run_gradient computes it
    embed_ref = RTrain._embed_fn(p_ref, cfg_ref, RM.make_host_mesh())
    h_ref = jnp.zeros((cfg.d_model, classes), jnp.float32)
    h = torch.zeros((cfg.d_model, classes))
    for _ in range(rounds):
        for toks, labels in PTrain._batches(train, batch):
            h_ref = RST.head_sgd_step(h_ref, embed_ref(p_ref, jnp.asarray(toks)),
                                      jnp.asarray(labels), 0.05)
            h = ST.head_sgd_step(h, PTrain.embed(params, cfg, toks), labels, 0.05)
    want = np.asarray(h_ref)
    np.testing.assert_allclose(h.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------- FlashSDPA
ATTN_CASES = [
    # (Hq, Hkv, Sq, Skv, kw)
    (2, 2, 6, 6, dict(causal=True)),
    (4, 2, 6, 6, dict(causal=True)),                       # GQA
    (4, 1, 7, 7, dict(causal=True, window=3)),             # MQA, a window
    (2, 2, 5, 5, dict(causal=True, softcap=2.0)),          # logit softcap
    (2, 2, 3, 8, dict(causal=True, q_offset=5)),           # q_offset (a cache)
    (4, 2, 3, 8, dict(causal=True, window=4, q_offset=5, softcap=3.0)),
    (2, 2, 4, 9, dict(causal=False)),                      # cross-attention
]


def _qkv(hq, hkv, sq, skv, dtype, seed=0, d=8):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype).requires_grad_(True)
            for s in [(2, hq, sq, d), (2, hkv, skv, d), (2, hkv, skv, d)]]


def _apply(q, k, v, kw):
    return PL.FlashSDPA.apply(q, k, v, kw.get("causal", True), kw.get("window"),
                              kw.get("q_offset", 0), kw.get("softcap", 0.0))


@pytest.mark.parametrize("hq,hkv,sq,skv,kw", ATTN_CASES)
def test_flash_sdpa_matches_autograd_of_plain(hq, hkv, sq, skv, kw):
    q, k, v = _qkv(hq, hkv, sq, skv, torch.float32)
    out = _apply(q, k, v, kw)
    want = PL.sdpa_plain(q, k, v, **kw)
    assert out.grad_fn is not None and torch.equal(out, want)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape)).float()
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(want, (q, k, v), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # only the inputs that need a gradient get one
    q2 = q.detach()
    (gk,) = torch.autograd.grad(_apply(q2, k, v, kw), (k,), g)
    torch.testing.assert_close(gk, ref[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hq,hkv,sq,skv,kw", ATTN_CASES)
def test_flash_sdpa_gradcheck_f64(hq, hkv, sq, skv, kw):
    q, k, v = _qkv(hq, hkv, sq, skv, torch.float64, seed=2, d=4)
    assert torch.autograd.gradcheck(lambda a, b, c: _apply(a, b, c, kw), (q, k, v))


def test_sdpa_on_the_cpu_is_plain_and_differentiable():
    q, k, v = _qkv(4, 2, 6, 6, torch.float32)
    out = PL.sdpa(q, k, v, causal=True, window=4)
    assert torch.equal(out, PL.sdpa_plain(q, k, v, causal=True, window=4))
    assert out.grad_fn is not None
    torch.autograd.grad(out.sum(), (q, k, v))


def test_raw_flash_wrapper_refuses_inputs_that_require_grad():
    """The kernel has no backward: the wrapper raises under grad before it
    looks at the device, so this holds on the CPU too."""
    q, k, v = _qkv(2, 2, 4, 4, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, v)        # past the grad check: a CPU tensor
