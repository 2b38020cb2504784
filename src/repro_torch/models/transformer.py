"""Backbone assembly: the dense family.

The port of the dense path of ``repro.models.transformer``. The reference
stacks every layer's parameters on a leading axis and scans over them; here
``params["layers"]`` is a list with one dict per layer and the forward pass
is a Python loop. Other families (``moe``, ``hybrid``, ``xlstm``,
``encdec``) are not ported yet and raise ``NotImplementedError``.

Public entry points:
  init_params(cfg, seed, device)         → param dict (random, seeded)
  forward(params, cfg, batch)            → final hidden states (B, S, D)
  pool(hidden)                           → (B, D) embedding for the AFL head
  lm_logits(params, cfg, hidden)         → (B, S, vocab)
  init_cache(cfg, batch, max_seq)        → KV cache {"k", "v"}: (L, B, Hkv, max_seq, hd)
  prefill(params, cfg, batch, max_seq)   → (hidden, cache)
  decode_step(params, cfg, tok, cache, pos) → (hidden (B, 1, D), cache)

The cache is written in place: ``decode_step`` updates the one slot of
each layer it writes and returns the same tensors (the reference's arrays
are immutable and its decode returns new ones).

``batch`` is a dict: tokens (B, S) integer and, for VLM archs, the modality
stub prefix_embeds (B, P, D), consumed as prefix tokens.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

_NOT_PORTED = ("arch_type {!r} is not ported to torch yet (ROADMAP Queue 1, "
               "item 8: the rest of the backbone zoo); only 'dense' runs")


# ------------------------------------------------------------ per-layer meta
def layer_meta(cfg: ModelConfig, n_layers: int):
    """(window, theta) per layer.

    window==0 encodes "full attention" (sdpa maps <=0 to unbounded).
    """
    idx = np.arange(n_layers)
    if cfg.window and cfg.global_every:
        is_global = (idx % cfg.global_every) == (cfg.global_every - 1)
    elif cfg.window:
        is_global = np.zeros(n_layers, bool)
    else:
        is_global = np.ones(n_layers, bool)
    window = np.where(is_global, 0, cfg.window).astype(np.int32)
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    theta = np.where(is_global, theta_g, cfg.rope_theta).astype(np.float32)
    return window, theta


def _attn_dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm,
    )


# ---------------------------------------------------------------- dense block
def _init_block(gen, cfg: ModelConfig, device):
    dt = cfg.param_dtype
    with_bias = cfg.norm == "layer"
    p = {
        "ln1": L.init_norm(cfg.d_model, dt, device, with_bias),
        "attn": L.init_attention(gen, _attn_dims(cfg), dt, device),
        "ln2": L.init_norm(cfg.d_model, dt, device, with_bias),
    }
    if cfg.d_ff:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                              device)
    return p


def _block_ffn(p, cfg: ModelConfig, x):
    h = L.norm_apply(p["ln2"], x, cfg.norm_eps, cfg.norm)
    if cfg.d_ff:
        out = L.mlp_apply(p["mlp"], h, cfg.activation)
    else:
        out = torch.zeros_like(x)
    return x + out


def _block_fwd(p, cfg: ModelConfig, x, positions, window, theta, *, causal=True,
               kv_cache=None, pos=None):
    """One attention block. Returns (x, (k, v)): this block's keys and values
    without a cache, else the cache ``(ck, cv)`` (B, Hkv, clen, hd) after
    this block's keys and values were written into it in place.

    Ring semantics, as the reference's: the tokens go to slot ``pos %
    clen`` (the start clamped so that they fit, as ``dynamic_update_slice``
    does), keys stored rope'd at their absolute positions. When the cache
    is no longer than the window, the ring itself keeps exactly the last
    ``clen`` positions, so the window mask is turned off and causality
    (slot <= pos) masks the slots not yet written.
    """
    dims = _attn_dims(cfg)
    h = L.norm_apply(p["ln1"], x, cfg.norm_eps, cfg.norm)
    q, k, v = L.qkv_project(p["attn"], dims, h, positions, theta, cfg.norm_eps)
    if kv_cache is None:
        attn = L.sdpa(q, k, v, causal=causal, window=window,
                      softcap=cfg.logit_softcap)
        new_kv = (k, v)
    else:
        ck, cv = kv_cache
        clen, s = ck.shape[2], k.shape[2]
        slot = min(int(pos) % clen, clen - s)
        win = 0 if 0 < window and clen <= window else window
        ck[:, :, slot:slot + s] = k
        cv[:, :, slot:slot + s] = v
        attn = L.sdpa(q, ck, cv, causal=True, window=win, q_offset=int(pos),
                      softcap=cfg.logit_softcap)
        new_kv = (ck, cv)
    x = x + L.attn_out(p["attn"], attn)
    return _block_ffn(p, cfg, x), new_kv


# ------------------------------------------------------------ embedding etc.
def _init_common(gen, cfg: ModelConfig, device):
    dt = cfg.param_dtype
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=device)
    p = {
        "embed": embed.mul_(0.02).to(dt),
        "final_norm": L.init_norm(cfg.d_model, dt, device, cfg.norm == "layer"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    if cfg.prefix_tokens:
        p["mm_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model, dt, device)
    return p


def embed_inputs(params: Params, cfg: ModelConfig, batch):
    """tokens (+ optional VLM prefix) → (x (B,S,D), positions (B,S))."""
    emb = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device).long()
    x = emb[tokens]
    if cfg.prefix_tokens:
        prefix = torch.as_tensor(batch["prefix_embeds"], device=emb.device)
        x = torch.cat([prefix.to(x.dtype) @ params["mm_proj"], x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions


def pool(hidden: torch.Tensor) -> torch.Tensor:
    """Sequence-mean embedding for the AFL analytic head."""
    return hidden.mean(dim=1)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ table


# =====================================================================
# family: dense (uniform stack)
# =====================================================================
def _init_dense(gen, cfg: ModelConfig, device):
    p = _init_common(gen, cfg, device)
    p["layers"] = [_init_block(gen, cfg, device) for _ in range(cfg.num_layers)]
    return p


def _dense_forward(params, cfg, x, positions, causal=True):
    window, theta = layer_meta(cfg, cfg.num_layers)
    for lp, w, th in zip(params["layers"], window, theta):
        x, _ = _block_fwd(lp, cfg, x, positions, int(w), float(th), causal=causal)
    return L.norm_apply(params["final_norm"], x, cfg.norm_eps, cfg.norm)


def _dense_cache(cfg, batch, max_seq, dtype, device):
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, hk, max_seq, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _dense_prefill(params, cfg, x, positions, max_seq):
    """The forward pass over the prompt, each layer's keys and values
    written to slots [0, S) of a zeroed cache of ``max_seq`` slots."""
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_seq}")
    window, theta = layer_meta(cfg, cfg.num_layers)
    cache = _dense_cache(cfg, b, max_seq, x.dtype, x.device)
    for i, (lp, w, th) in enumerate(zip(params["layers"], window, theta)):
        x, (k, v) = _block_fwd(lp, cfg, x, positions, int(w), float(th))
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    return L.norm_apply(params["final_norm"], x, cfg.norm_eps, cfg.norm), cache


def _dense_decode(params, cfg, x, cache, pos):
    """One-token decode: each layer writes its key and value into its slice
    of the stacked cache (slot ``pos % max_seq``) and attends over it."""
    window, theta = layer_meta(cfg, cfg.num_layers)
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32, device=x.device)
    for i, (lp, w, th) in enumerate(zip(params["layers"], window, theta)):
        x, _ = _block_fwd(lp, cfg, x, positions, int(w), float(th),
                          kv_cache=(cache["k"][i], cache["v"][i]), pos=pos)
    return L.norm_apply(params["final_norm"], x, cfg.norm_eps, cfg.norm), cache


# =====================================================================
# public dispatch
# =====================================================================
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters drawn on ``device`` (CUDA unless named) from a
    ``torch.Generator`` seeded with ``seed``. They are not the reference's
    ``jax.random`` draws; ``models.convert.params_from_jax`` carries those
    over when both packages must run on the same weights."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(_NOT_PORTED.format(cfg.arch_type))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init_dense(gen, cfg, dev)


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.arch_type != "dense":
        raise NotImplementedError(_NOT_PORTED.format(cfg.arch_type))
    x, positions = embed_inputs(params, cfg, batch)
    return _dense_forward(params, cfg, x, positions)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None):
    """A zeroed KV cache {"k", "v"}, each (L, B, Hkv, max_seq, hd), on
    ``device`` (CUDA unless named)."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(_NOT_PORTED.format(cfg.arch_type))
    return _dense_cache(cfg, batch, max_seq, dtype or cfg.param_dtype,
                        resolve_device(device))


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, max_seq: int):
    """The prompt's forward pass → (final hidden (B, S, D), cache with the
    prompt in slots [0, S) of ``max_seq``)."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(_NOT_PORTED.format(cfg.arch_type))
    x, positions = embed_inputs(params, cfg, batch)
    return _dense_prefill(params, cfg, x, positions, max_seq)


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) integer, at position ``pos``. → (hidden (B, 1, D), cache),
    the cache updated in place."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(_NOT_PORTED.format(cfg.arch_type))
    emb = params["embed"]
    x = emb[torch.as_tensor(token, device=emb.device).long()[:, None]]
    return _dense_decode(params, cfg, x, cache, pos)
