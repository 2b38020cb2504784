"""Backbone assembly for every architecture family.

The port of ``repro.models.transformer``: ``dense`` and ``moe`` (a uniform
[attention + MLP or MoE] stack), ``hybrid`` (zamba2: groups of Mamba2
layers, each group closed by one shared attention block, then a tail of
Mamba2 layers), ``xlstm`` (groups of mLSTM layers, each closed by an sLSTM
layer, then a tail of mLSTM layers) and ``encdec`` (seamless: a
bidirectional encoder and a causal decoder that cross-attends to its
output). The reference stacks the parameters of like layers on leading
axes and scans over them; here each stack is a list with one dict per
layer (``mamba_groups`` and ``mlstm_groups`` a list of lists) and the
forward pass is a Python loop.

Public entry points (uniform across families):
  init_params(cfg, seed, device)         → param dict (random, seeded)
  forward(params, cfg, batch)            → final hidden states (B, S, D),
                                           differentiable
  pool(hidden)                           → (B, D) embedding for the AFL head
  lm_logits(params, cfg, hidden)         → (B, S, vocab)
  init_cache(cfg, batch, max_seq)        → decode cache (the family's layout)
  prefill(params, cfg, batch, max_seq)   → (hidden, cache)
  decode_step(params, cfg, tok, cache, pos) → (hidden (B, 1, D), cache)
  stacked_layout(cfg)                    → the layer lists and their dims

Caches have the reference's layouts: ``{"k", "v"}`` (L, B, Hkv, max_seq,
hd) for dense and moe; for hybrid the Mamba states stacked as
``mamba_groups`` (n_groups, g - 1, …) and ``mamba_tail`` (tail, …) with the
shared block's KV as ``attn`` (n_groups, B, Hkv, max_seq, hd), one slice
for each of its applications; for xlstm the mLSTM and sLSTM states stacked
the same way; for encdec ``k``, ``v`` over ``max_seq`` and the
cross-attention's ``xk``, ``xv`` over the encoder memory. Every recurrent
state is f32. A cache is written in place: ``decode_step`` updates the
slots and states it writes and returns the same tensors (the reference's
arrays are immutable and its decode returns new ones).

``batch`` is a dict: tokens (B, S) integer and, for VLM / audio archs, the
modality stub: prefix_embeds (B, P, D), consumed as prefix tokens, or
enc_feats (B, S_enc, D), the encoder's input frames.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X

Params = Dict[str, Any]


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


# ----------------------------------------------------------- dense/moe block
def _init_block(gen, cfg: ModelConfig, device, cross_attn: bool = False):
    dt = cfg.param_dtype
    with_bias = cfg.norm == "layer"
    p = {
        "ln1": L.init_norm(cfg.d_model, dt, device, with_bias),
        "attn": L.init_attention(gen, _attn_dims(cfg), dt, device),
        "ln2": L.init_norm(cfg.d_model, dt, device, with_bias),
    }
    if cfg.moe is not None:
        p["moe"] = M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe, cfg.activation, dt,
                              device)
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                              device)
    if cross_attn:
        p["ln_x"] = L.init_norm(cfg.d_model, dt, device, with_bias)
        p["xattn"] = L.init_attention(gen, _attn_dims(cfg), dt, device)
    return p


def _block_ffn(p, cfg: ModelConfig, x):
    h = L.norm_apply(p["ln2"], x, cfg.norm_eps, cfg.norm)
    if cfg.moe is not None:
        out, _aux = M.moe_apply(p["moe"], h, cfg.moe, cfg.activation)
    elif cfg.d_ff:
        out = L.mlp_apply(p["mlp"], h, cfg.activation)
    else:
        out = torch.zeros_like(x)
    return x + out


def _block_fwd(p, cfg: ModelConfig, x, positions, window, theta, *, causal=True,
               kv_cache=None, pos=None, memory_kv=None):
    """One attention block. Returns (x, (k, v)): this block's keys and values
    without a cache, else the cache ``(ck, cv)`` (B, Hkv, clen, hd) after
    this block's keys and values were written into it in place. With
    ``memory_kv`` (the encoder memory's keys and values, enc-dec) the block
    cross-attends to them after its self-attention, non-causally.

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
    if memory_kv is not None:
        hx = L.norm_apply(p["ln_x"], x, cfg.norm_eps, cfg.norm)
        qx, _, _ = L.qkv_project(p["xattn"], dims, hx, positions, None)
        mk, mv = memory_kv
        x = x + L.attn_out(p["xattn"], L.sdpa(qx, mk, mv, causal=False, window=None))
    return _block_ffn(p, cfg, x), new_kv


def _memory_kv(p, cfg: ModelConfig, memory):
    """Cross-attention keys and values of the encoder memory (one decoder
    layer's): no rope."""
    _, mk, mv = L.qkv_project(p["xattn"], _attn_dims(cfg), memory, None, None)
    return mk, mv


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
    if cfg.encoder_layers:
        p["enc_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model, dt, device)
    return p


def _positions(b: int, s: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + s, dtype=torch.int32, device=device).expand(b, s)


def embed_inputs(params: Params, cfg: ModelConfig, batch):
    """tokens (+ optional VLM prefix) → (x (B,S,D), positions (B,S))."""
    emb = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device).long()
    x = emb[tokens]
    if cfg.prefix_tokens:
        prefix = torch.as_tensor(batch["prefix_embeds"], device=emb.device)
        x = torch.cat([prefix.to(x.dtype) @ params["mm_proj"], x], dim=1)
    return x, _positions(x.shape[0], x.shape[1], x.device)


def pool(hidden: torch.Tensor) -> torch.Tensor:
    """Sequence-mean embedding for the AFL analytic head."""
    return hidden.mean(dim=1)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ table




def _final(params, cfg, x):
    return L.norm_apply(params["final_norm"], x, cfg.norm_eps, cfg.norm)


def _kv_zeros(cfg, lead, batch, max_seq, dtype, device):
    shape = (lead, batch, cfg.num_kv_heads, max_seq, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _fits(s: int, max_seq: int) -> None:
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {max_seq}")


def _stack(one: Dict[str, torch.Tensor], lead: tuple) -> Dict[str, torch.Tensor]:
    """A state dict repeated on new leading dims, as fresh tensors."""
    return {k: a.expand(lead + tuple(a.shape)).clone() for k, a in one.items()}


def _at(tree: Dict[str, torch.Tensor], *idx) -> Dict[str, torch.Tensor]:
    """The views of one layer's state in a stacked state dict."""
    return {k: a[idx] for k, a in tree.items()}


def _write(tree: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    for k, a in tree.items():
        a.copy_(new[k])


# ------------------------------------------------------------ stacked layers
# every tree of like layers that a family's params may hold
STACKED = ("layers", "enc_layers", "mamba_groups", "mamba_tail", "mlstm_groups", "slstm",
           "mlstm_tail")


def stacked_layout(cfg: ModelConfig) -> Dict[str, tuple]:
    """The stacked layer trees of ``cfg``'s params, in the order they are
    drawn, each with its stacking dims: (n,) for a list of n layer dicts,
    (n, m) for n lists of m (the reference stacks the same trees on leading
    axes). ``init_params`` and ``init_cache`` build on it (a cache stacks
    its layers' states on the same dims), and ``convert.params_from_jax``
    checks the reference's trees against it."""
    fam = _family(cfg)
    if fam == "encdec":
        return {"enc_layers": (cfg.encoder_layers,), "layers": (cfg.num_layers,)}
    if fam in ("dense", "moe"):
        return {"layers": (cfg.num_layers,)}
    if fam == "hybrid":
        (g, n_groups, tail), names = _hybrid_split(cfg), ("mamba_groups", None, "mamba_tail")
    else:
        (g, n_groups, tail), names = _xlstm_split(cfg), ("mlstm_groups", "slstm", "mlstm_tail")
    out = {}
    if n_groups:
        out[names[0]] = (n_groups, g - 1)
        if names[1]:
            out[names[1]] = (n_groups,)
    if tail:
        out[names[2]] = (tail,)
    return out


def _layer_lists(lead: tuple, make):
    """``make()`` in nested lists of ``lead``'s dims."""
    if len(lead) == 1:
        return [make() for _ in range(lead[0])]
    return [_layer_lists(lead[1:], make) for _ in range(lead[0])]


def _init_stacks(p: Params, cfg: ModelConfig, makers) -> Params:
    """``p`` with the layer lists of ``stacked_layout``, each layer from its
    tree's maker."""
    for name, lead in stacked_layout(cfg).items():
        p[name] = _layer_lists(lead, makers[name])
    return p


# =====================================================================
# family: dense / moe (uniform stack)
# =====================================================================
def _init_dense(gen, cfg: ModelConfig, device):
    return _init_stacks(_init_common(gen, cfg, device), cfg,
                        {"layers": lambda: _init_block(gen, cfg, device)})


def _dense_forward(params, cfg, x, positions, causal=True):
    window, theta = layer_meta(cfg, cfg.num_layers)
    for lp, w, th in zip(params["layers"], window, theta):
        x, _ = _block_fwd(lp, cfg, x, positions, int(w), float(th), causal=causal)
    return _final(params, cfg, x)


def _dense_cache(cfg, batch, max_seq, dtype, device):
    return _kv_zeros(cfg, cfg.num_layers, batch, max_seq, dtype, device)


def _dense_prefill(params, cfg, x, positions, max_seq):
    """The forward pass over the prompt, each layer's keys and values
    written to slots [0, S) of a zeroed cache of ``max_seq`` slots."""
    b, s, _ = x.shape
    _fits(s, max_seq)
    window, theta = layer_meta(cfg, cfg.num_layers)
    cache = _dense_cache(cfg, b, max_seq, x.dtype, x.device)
    for i, (lp, w, th) in enumerate(zip(params["layers"], window, theta)):
        x, (k, v) = _block_fwd(lp, cfg, x, positions, int(w), float(th))
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    return _final(params, cfg, x), cache


def _dense_decode(params, cfg, x, cache, pos):
    """One-token decode: each layer writes its key and value into its slice
    of the stacked cache (slot ``pos % max_seq``) and attends over it."""
    window, theta = layer_meta(cfg, cfg.num_layers)
    positions = _positions(x.shape[0], 1, x.device, int(pos))
    for i, (lp, w, th) in enumerate(zip(params["layers"], window, theta)):
        x, _ = _block_fwd(lp, cfg, x, positions, int(w), float(th),
                          kv_cache=(cache["k"][i], cache["v"][i]), pos=pos)
    return _final(params, cfg, x), cache


# =====================================================================
# family: hybrid (zamba2): groups of (g - 1 Mamba2 + the shared block) + tail
# =====================================================================
def _hybrid_split(cfg: ModelConfig):
    g = cfg.shared_attn_every
    n_groups = cfg.num_layers // g
    tail = cfg.num_layers - n_groups * g
    return g, n_groups, tail


def _init_mamba_layer(gen, cfg: ModelConfig, device):
    dt = cfg.param_dtype
    return {"ln": L.init_norm(cfg.d_model, dt, device),
            "mixer": SSM.init_mamba(gen, cfg.d_model, cfg.ssm, dt, device)}


def _init_hybrid(gen, cfg: ModelConfig, device):
    def layer():
        return _init_mamba_layer(gen, cfg, device)

    p = _init_stacks(_init_common(gen, cfg, device), cfg,
                     {"mamba_groups": layer, "mamba_tail": layer})
    p["shared_attn"] = _init_block(gen, cfg, device)
    return p


def _mamba_layer_fwd(lp, cfg, h, state=None):
    """One Mamba2 layer; with ``state`` (the layer's views in the cache)
    the state is carried and written back in place."""
    hin = L.norm_apply(lp["ln"], h, cfg.norm_eps, cfg.norm)
    if state is None:
        return h + SSM.mamba_apply(lp["mixer"], hin, cfg.ssm)
    if hin.shape[1] == 1:
        out, new = SSM.mamba_decode(lp["mixer"], hin, state, cfg.ssm)
    else:
        out, new = SSM.mamba_apply(lp["mixer"], hin, cfg.ssm, init_state=state,
                                   return_state=True)
    _write(state, new)
    return h + out


def _hybrid_forward(params, cfg, x, positions):
    _, n_groups, tail = _hybrid_split(cfg)
    for gp in params.get("mamba_groups", []):
        for lp in gp:
            x = _mamba_layer_fwd(lp, cfg, x)
        x, _ = _block_fwd(params["shared_attn"], cfg, x, positions, cfg.window or 0,
                          cfg.rope_theta)
    for lp in params.get("mamba_tail", []):
        x = _mamba_layer_fwd(lp, cfg, x)
    return _final(params, cfg, x)


def _hybrid_cache(cfg, batch, max_seq, dtype, device):
    one = SSM.init_mamba_state(batch, cfg.d_model, cfg.ssm, dtype, device)
    layout = stacked_layout(cfg)
    cache = {name: _stack(one, lead) for name, lead in layout.items()}
    if "mamba_groups" in layout:     # the shared block's KV, a slice per group
        cache["attn"] = _kv_zeros(cfg, layout["mamba_groups"][0], batch, max_seq, dtype,
                                  device)
    return cache


def _hybrid_step(params, cfg, x, positions, cache, pos):
    """Prefill (S > 1, the shared block's keys and values to slots [0, S)
    of each application's slice) and decode (S = 1, slot ``pos``) alike,
    every state carried through ``cache`` in place."""
    s = x.shape[1]
    for gi, gp in enumerate(params.get("mamba_groups", [])):
        for li, lp in enumerate(gp):
            x = _mamba_layer_fwd(lp, cfg, x, _at(cache["mamba_groups"], gi, li))
        ck, cv = cache["attn"]["k"][gi], cache["attn"]["v"][gi]
        if s > 1:
            _fits(s, ck.shape[2])
            x, (k, v) = _block_fwd(params["shared_attn"], cfg, x, positions,
                                   cfg.window or 0, cfg.rope_theta)
            ck[:, :, :s] = k
            cv[:, :, :s] = v
        else:
            x, _ = _block_fwd(params["shared_attn"], cfg, x, positions, cfg.window or 0,
                              cfg.rope_theta, kv_cache=(ck, cv), pos=pos)
    for li, lp in enumerate(params.get("mamba_tail", [])):
        x = _mamba_layer_fwd(lp, cfg, x, _at(cache["mamba_tail"], li))
    return _final(params, cfg, x), cache


# =====================================================================
# family: xlstm: groups of (g - 1 mLSTM + 1 sLSTM) + an mLSTM tail
# =====================================================================
def _xlstm_split(cfg: ModelConfig):
    g = cfg.slstm_every
    n_groups = cfg.num_layers // g
    tail = cfg.num_layers - n_groups * g
    return g, n_groups, tail


def _init_xlstm(gen, cfg: ModelConfig, device):
    dt = cfg.param_dtype

    def init_m():
        return {"ln": L.init_norm(cfg.d_model, dt, device),
                "mixer": X.init_mlstm(gen, cfg.d_model, cfg.num_heads, dt, device)}

    def init_s():
        return {"ln": L.init_norm(cfg.d_model, dt, device),
                "mixer": X.init_slstm(gen, cfg.d_model, cfg.num_heads, dt, device)}

    return _init_stacks(_init_common(gen, cfg, device), cfg,
                        {"mlstm_groups": init_m, "slstm": init_s, "mlstm_tail": init_m})


def _xlstm_layer(apply, lp, cfg, h, state):
    """One mLSTM / sLSTM layer (``apply``); with ``state`` (the layer's
    views in the cache) the state is carried and written back in place."""
    hin = L.norm_apply(lp["ln"], h, cfg.norm_eps, cfg.norm)
    if state is None:
        return h + apply(lp["mixer"], hin, cfg.num_heads)
    out, new = apply(lp["mixer"], hin, cfg.num_heads, init_state=state, return_state=True)
    _write(state, new)
    return h + out


def _xlstm_run(params, cfg, x, states=None):
    """states None → the plain forward; else prefill or decode from the
    states in ``states``, which are updated in place → (hidden, states)."""
    def at(name, *idx):
        return None if states is None else _at(states[name], *idx)

    for gi, gp in enumerate(params.get("mlstm_groups", [])):
        for li, lp in enumerate(gp):
            x = _xlstm_layer(X.mlstm_apply, lp, cfg, x, at("mlstm_groups", gi, li))
        x = _xlstm_layer(X.slstm_apply, params["slstm"][gi], cfg, x, at("slstm", gi))
    for li, lp in enumerate(params.get("mlstm_tail", [])):
        x = _xlstm_layer(X.mlstm_apply, lp, cfg, x, at("mlstm_tail", li))
    x = _final(params, cfg, x)
    return x if states is None else (x, states)


def _xlstm_cache(cfg, batch, device):
    m_one = X.init_mlstm_state(batch, cfg.d_model, cfg.num_heads, device)
    one = {"mlstm_groups": m_one, "mlstm_tail": m_one,
           "slstm": X.init_slstm_state(batch, cfg.d_model, cfg.num_heads, device)}
    return {name: _stack(one[name], lead) for name, lead in stacked_layout(cfg).items()}


# =====================================================================
# family: encdec (seamless): encoder + cross-attending decoder
# =====================================================================
def _init_encdec(gen, cfg: ModelConfig, device):
    p = _init_stacks(_init_common(gen, cfg, device), cfg, {
        "enc_layers": lambda: _init_block(gen, cfg, device),
        "layers": lambda: _init_block(gen, cfg, device, cross_attn=True)})
    p["enc_norm"] = L.init_norm(cfg.d_model, cfg.param_dtype, device, cfg.norm == "layer")
    return p


def _encode(params, cfg, enc_feats):
    """Encoder frames (B, S_enc, D) → memory: non-causal blocks, then
    ``enc_norm``."""
    proj = params["enc_proj"]
    x = torch.as_tensor(enc_feats, device=proj.device).to(cfg.param_dtype) @ proj
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp in params["enc_layers"]:
        x, _ = _block_fwd(lp, cfg, x, positions, 0, cfg.rope_theta, causal=False)
    return L.norm_apply(params["enc_norm"], x, cfg.norm_eps, cfg.norm)


def _decoder_input(params, batch):
    emb = params["embed"]
    x = emb[torch.as_tensor(batch["tokens"], device=emb.device).long()]
    return x, _positions(x.shape[0], x.shape[1], x.device)


def _encdec_forward(params, cfg, batch):
    memory = _encode(params, cfg, batch["enc_feats"])
    x, positions = _decoder_input(params, batch)
    for lp in params["layers"]:
        x, _ = _block_fwd(lp, cfg, x, positions, 0, cfg.rope_theta,
                          memory_kv=_memory_kv(lp, cfg, memory))
    return _final(params, cfg, x)


def _encdec_cache(cfg, batch, max_seq, dtype, device, mem_len=None):
    cache = _kv_zeros(cfg, cfg.num_layers, batch, max_seq, dtype, device)
    cross = _kv_zeros(cfg, cfg.num_layers, batch, mem_len or cfg.encoder_seq, dtype, device)
    cache["xk"], cache["xv"] = cross["k"], cross["v"]
    return cache


def _encdec_prefill(params, cfg, batch, max_seq):
    memory = _encode(params, cfg, batch["enc_feats"])
    x, positions = _decoder_input(params, batch)
    b, s, _ = x.shape
    _fits(s, max_seq)
    cache = _encdec_cache(cfg, b, max_seq, x.dtype, x.device, memory.shape[1])
    for i, lp in enumerate(params["layers"]):
        mk, mv = _memory_kv(lp, cfg, memory)
        x, (k, v) = _block_fwd(lp, cfg, x, positions, 0, cfg.rope_theta, memory_kv=(mk, mv))
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
        cache["xk"][i] = mk
        cache["xv"][i] = mv
    return _final(params, cfg, x), cache


def _encdec_decode(params, cfg, x, cache, pos):
    positions = _positions(x.shape[0], 1, x.device, int(pos))
    for i, lp in enumerate(params["layers"]):
        x, _ = _block_fwd(lp, cfg, x, positions, 0, cfg.rope_theta,
                          kv_cache=(cache["k"][i], cache["v"][i]), pos=pos,
                          memory_kv=(cache["xk"][i], cache["xv"][i]))
    return _final(params, cfg, x), cache


# =====================================================================
# public dispatch
# =====================================================================
_INIT = {"dense": _init_dense, "moe": _init_dense, "hybrid": _init_hybrid,
         "xlstm": _init_xlstm, "encdec": _init_encdec}


def _family(cfg: ModelConfig) -> str:
    if cfg.arch_type not in _INIT:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")
    return cfg.arch_type


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters drawn on ``device`` (CUDA unless named) from a
    ``torch.Generator`` seeded with ``seed``. They are not the reference's
    ``jax.random`` draws; ``models.convert.params_from_jax`` carries those
    over when both packages must run on the same weights."""
    init = _INIT[_family(cfg)]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init(gen, cfg, dev)


def forward(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Final hidden states (B, S, D) of ``batch``. Differentiable: under grad
    mode, params that require grad get gradients (attention on the card
    through ``layers.FlashSDPA``); the frozen-backbone callers run it under
    ``torch.no_grad()``."""
    fam = _family(cfg)
    if fam == "encdec":
        return _encdec_forward(params, cfg, batch)
    x, positions = embed_inputs(params, cfg, batch)
    if fam == "hybrid":
        return _hybrid_forward(params, cfg, x, positions)
    if fam == "xlstm":
        return _xlstm_run(params, cfg, x)
    return _dense_forward(params, cfg, x, positions)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device=None,
               mem_len=None):
    """A fresh decode cache in the family's layout (see the module's
    docstring) on ``device`` (CUDA unless named): KV slots zero, recurrent
    states at their start. ``dtype`` (the parameters' by default) is that
    of the KV slots and conv caches; every recurrent state is f32. An
    enc-dec cache's cross-attention holds ``mem_len`` slots, the encoder
    memory's length (``cfg.encoder_seq`` by default)."""
    fam = _family(cfg)
    dtype = dtype or cfg.param_dtype
    dev = resolve_device(device)
    if fam == "hybrid":
        return _hybrid_cache(cfg, batch, max_seq, dtype, dev)
    if fam == "xlstm":
        return _xlstm_cache(cfg, batch, dev)
    if fam == "encdec":
        return _encdec_cache(cfg, batch, max_seq, dtype, dev, mem_len)
    return _dense_cache(cfg, batch, max_seq, dtype, dev)


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, max_seq: int):
    """The prompt's forward pass → (final hidden (B, S, D), cache with the
    prompt in slots [0, S) of ``max_seq`` and the recurrent states after
    it)."""
    fam = _family(cfg)
    if fam == "encdec":
        return _encdec_prefill(params, cfg, batch, max_seq)
    x, positions = embed_inputs(params, cfg, batch)
    if fam == "hybrid":
        cache = _hybrid_cache(cfg, x.shape[0], max_seq, cfg.param_dtype, x.device)
        return _hybrid_step(params, cfg, x, positions, cache, None)
    if fam == "xlstm":
        return _xlstm_run(params, cfg, x, states=_xlstm_cache(cfg, x.shape[0], x.device))
    return _dense_prefill(params, cfg, x, positions, max_seq)


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) integer, at position ``pos``. → (hidden (B, 1, D), cache),
    the cache updated in place."""
    fam = _family(cfg)
    emb = params["embed"]
    x = emb[torch.as_tensor(token, device=emb.device).long()[:, None]]
    if fam == "hybrid":
        positions = _positions(x.shape[0], 1, x.device, int(pos))
        return _hybrid_step(params, cfg, x, positions, cache, pos)
    if fam == "xlstm":
        return _xlstm_run(params, cfg, x, states=cache)
    if fam == "encdec":
        return _encdec_decode(params, cfg, x, cache, pos)
    return _dense_decode(params, cfg, x, cache, pos)
