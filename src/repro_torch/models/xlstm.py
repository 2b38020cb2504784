"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory, exp gating).

The port of ``repro.models.xlstm``. The reference runs both recurrences as
a ``lax.scan`` over time; here each is a per-token loop of the same step,
with stabilised exponential gating. mLSTM has no hidden-to-gate recurrence;
sLSTM has recurrent gate connections (R · h_{t-1}) and is sequential by
nature. Prefill and decode are the same loop, from a given state.

Per the config (d_ff=0) the blocks are projection-only: an up projection
(factor 2), the recurrent mixer, and a down projection. State layouts, all
f32 whatever the parameters' type:
  mLSTM: C (B, H, dh, dh), n (B, H, dh), m (B, H)
  sLSTM: c, n, h (B, H, dh), m (B, H)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

UP_FACTOR = 2
M_INIT = -1e30           # the stabiliser's start: no gate has fired yet


def _inner(d_model, num_heads):
    d_inner = UP_FACTOR * d_model
    dh = d_inner // num_heads
    return d_inner, dh


# ------------------------------------------------------------------- mLSTM
def init_mlstm(gen, d_model, num_heads, dtype, device):
    d_inner, dh = _inner(d_model, num_heads)
    return {
        "up": L.dense_init(gen, d_model, 2 * d_inner, dtype, device),   # [x_in, gate]
        "qkv": L.dense_init(gen, d_inner, 3 * d_inner, dtype, device),
        "if_proj": L.dense_init(gen, d_inner, 2 * num_heads, dtype, device),
        "down": L.dense_init(gen, d_inner, d_model, dtype, device),
    }


def _mlstm_step(state, q, k, v, i_raw, f_raw):
    c_mat, n_vec, m = state                     # (B,H,dh,dh), (B,H,dh), (B,H)
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_mat = f_g[..., None, None] * c_mat + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_vec = f_g[..., None] * n_vec + i_g[..., None] * k
    denom = torch.maximum((n_vec * q).sum(-1).abs(), torch.exp(-m_new))
    h = torch.einsum("bhd,bhde->bhe", q, c_mat) / denom[..., None]
    return (c_mat, n_vec, m_new), h


def mlstm_apply(p, x, num_heads, *, init_state=None, return_state=False):
    """x: (B, S, D) → (B, S, D)."""
    b, s, d_model = x.shape
    d_inner, dh = _inner(d_model, num_heads)
    f32 = torch.float32
    up = x @ p["up"]
    x_in, gate = up[..., :d_inner], up[..., d_inner:]
    qkv = (x_in @ p["qkv"]).to(f32).reshape(b, s, 3, num_heads, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1] / math.sqrt(dh), qkv[:, :, 2]   # (B,S,H,dh)
    if_g = (x_in @ p["if_proj"]).to(f32).reshape(b, s, 2, num_heads)
    i_raw, f_raw = if_g[:, :, 0], if_g[:, :, 1]                           # (B,S,H)

    if init_state is None:
        state = (torch.zeros((b, num_heads, dh, dh), dtype=f32, device=x.device),
                 torch.zeros((b, num_heads, dh), dtype=f32, device=x.device),
                 torch.full((b, num_heads), M_INIT, dtype=f32, device=x.device))
    else:
        state = (init_state["c"], init_state["n"], init_state["m"])
    hs = []
    for t in range(s):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_raw[:, t], f_raw[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(b, s, d_inner)
    out = (h.to(x.dtype) * F.silu(gate)) @ p["down"]
    if return_state:
        return out, {"c": state[0], "n": state[1], "m": state[2]}
    return out


def mlstm_decode(p, x, state, num_heads):
    return mlstm_apply(p, x, num_heads, init_state=state, return_state=True)


def init_mlstm_state(batch, d_model, num_heads, device=None):
    d_inner, dh = _inner(d_model, num_heads)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, num_heads, dh, dh), **f32),
        "n": torch.zeros((batch, num_heads, dh), **f32),
        "m": torch.full((batch, num_heads), M_INIT, **f32),
    }


# ------------------------------------------------------------------- sLSTM
def init_slstm(gen, d_model, num_heads, dtype, device):
    d_inner, dh = _inner(d_model, num_heads)
    r = torch.randn((4, num_heads, dh, dh), generator=gen, dtype=torch.float32, device=device)
    return {
        "up": L.dense_init(gen, d_model, 2 * d_inner, dtype, device),
        "wx": L.dense_init(gen, d_inner, 4 * d_inner, dtype, device),   # z,i,f,o
        # block-diagonal (per-head) recurrent kernel for the 4 gates
        "r": r.div_(math.sqrt(dh)).to(dtype),
        "down": L.dense_init(gen, d_inner, d_model, dtype, device),
    }


def _slstm_step(r, state, wx_t):
    c, n, h, m = state                               # (B,H,dh)×3, (B,H)
    rec = torch.einsum("ghde,bhd->bghe", r, h)
    pre = wx_t + rec                                 # (B,4,H,dh)
    z = torch.tanh(pre[:, 0])
    i_raw = pre[:, 1].mean(-1)                       # scalar gates per head
    f_raw = pre[:, 2].mean(-1)
    o = torch.sigmoid(pre[:, 3])
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g[..., None] * c + i_g[..., None] * z
    n = f_g[..., None] * n + i_g[..., None]
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new), h_new


def slstm_apply(p, x, num_heads, *, init_state=None, return_state=False):
    b, s, d_model = x.shape
    d_inner, dh = _inner(d_model, num_heads)
    f32 = torch.float32
    up = x @ p["up"]
    x_in, gate = up[..., :d_inner], up[..., d_inner:]
    wx = (x_in @ p["wx"]).to(f32).reshape(b, s, 4, num_heads, dh)
    if init_state is None:
        zeros = torch.zeros((b, num_heads, dh), dtype=f32, device=x.device)
        state = (zeros, zeros, zeros,
                 torch.full((b, num_heads), M_INIT, dtype=f32, device=x.device))
    else:
        state = (init_state["c"], init_state["n"], init_state["h"], init_state["m"])
    r = p["r"].to(f32)
    hs = []
    for t in range(s):
        state, h = _slstm_step(r, state, wx[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(b, s, d_inner)
    out = (h.to(x.dtype) * F.silu(gate)) @ p["down"]
    if return_state:
        return out, {"c": state[0], "n": state[1], "h": state[2], "m": state[3]}
    return out


def slstm_decode(p, x, state, num_heads):
    return slstm_apply(p, x, num_heads, init_state=state, return_state=True)


def init_slstm_state(batch, d_model, num_heads, device=None):
    d_inner, dh = _inner(d_model, num_heads)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, num_heads, dh), **f32),
            "n": torch.zeros((batch, num_heads, dh), **f32),
            "h": torch.zeros((batch, num_heads, dh), **f32),
            "m": torch.full((batch, num_heads), M_INIT, **f32)}
