"""Mamba2 (SSD) mixer: chunked scan for prefill, O(1) decode step.

The port of ``repro.models.ssm``. The state-space recurrence is blocked
into the chunkwise-parallel SSD form: within a chunk the terms are dense
products, across chunks a short loop carries the state over S/chunk steps.
The reference writes the three-operand contractions as single einsums and
leaves their order to XLA; torch would contract them pairwise left to
right, and at zamba2's width the first pair of ``y_intra`` alone would be a
(B, nc, c, c, nh, dh) tensor. So each is written out here in an order whose
intermediates are no larger than its operands or its result.

State layout for decode: conv cache (B, d_conv-1, conv_dim) + SSD state
(B, heads, d_state, d_head), the SSD state f32 whatever the parameters'
type.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.models import layers as L


def dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    nh = cfg.num_heads or max(1, d_inner // 64)
    dh = d_inner // nh
    conv_dim = d_inner + 2 * cfg.d_state
    return d_inner, nh, dh, conv_dim


def init_mamba(gen, d_model, cfg: SSMConfig, dtype, device):
    d_inner, nh, dh, conv_dim = dims(d_model, cfg)
    proj_out = 2 * d_inner + 2 * cfg.d_state + nh  # z, x, B, C, dt
    conv_w = torch.randn((cfg.d_conv, conv_dim), generator=gen, dtype=torch.float32,
                         device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.dense_init(gen, d_model, proj_out, dtype, device),
        "conv_w": conv_w.div_(math.sqrt(cfg.d_conv)).to(dtype),
        "a_log": torch.zeros((nh,), **f32),          # A = -exp(a_log) = -1
        "d_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "out_proj": L.dense_init(gen, d_inner, d_model, dtype, device),
    }


def _split_proj(proj, d_inner, d_state, nh):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, cache=None):
    """Depthwise causal conv over time. xbc (B, S, C); conv_w (K, C);
    cache (B, K-1, C), the inputs before this call's first (zeros if None).
    Returns (silu(conv), the last K-1 inputs as the next call's cache)."""
    k = conv_w.shape[0]
    if cache is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = cache.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * conv_w[0][None, None]
    for i in range(1, k):
        out = out + xp[:, i: i + s] * conv_w[i][None, None]
    new_cache = xp[:, xp.shape[1] - (k - 1):] if k > 1 else pad[:, :0]
    return F.silu(out), new_cache


def mamba_apply(p, x, cfg: SSMConfig, *, init_state=None, return_state=False):
    """Full-sequence (prefill) chunked SSD. x: (B, S, D)."""
    b, s, d_model = x.shape
    d_inner, nh, dh, conv_dim = dims(d_model, cfg)
    ds = cfg.d_state
    z, xbc, dt_raw = _split_proj(x @ p["in_proj"], d_inner, ds, nh)
    xbc, conv_cache = _causal_conv(xbc, p["conv_w"],
                                   None if init_state is None else init_state["conv"])
    f32 = torch.float32
    xs = xbc[..., :d_inner].reshape(b, s, nh, dh).to(f32)
    bmat = xbc[..., d_inner: d_inner + ds].to(f32)                      # (B,S,ds)
    cmat = xbc[..., d_inner + ds:].to(f32)                              # (B,S,ds)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])                      # (B,S,nh)
    neg_a = torch.exp(p["a_log"])                                       # (nh,)
    log_g = -dt * neg_a                                                 # log decay ≤ 0

    c = min(cfg.chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        log_g = F.pad(log_g, (0, 0, 0, pad))

    def ch(a):
        return a.reshape((b, nc, c) + tuple(a.shape[2:]))

    xs_c, b_c, c_c, dt_c, g_c = map(ch, (xs, bmat, cmat, dt, log_g))

    gcum = torch.cumsum(g_c, dim=2)                                     # (B,nc,c,nh)
    gtot = gcum[:, :, -1]                                               # (B,nc,nh)
    xw = xs_c * dt_c[..., None]                                         # (B,nc,c,nh,dh)

    # intra-chunk: y_t += C_t · Σ_{s≤t} exp(gcum_t − gcum_s) B_s xw_s.
    # (C_t·B_s) · decay first, one (B,nc,nh,t,s) tensor, then a batched
    # product over s with xw.
    decay = torch.exp(gcum[:, :, :, None] - gcum[:, :, None, :])       # (B,nc,t,s,nh)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    decay = torch.where(causal[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bnte,bnse->bnts", c_c, b_c)                  # C_t·B_s
    m = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)              # (B,nc,nh,t,s)
    y_intra = torch.matmul(m, xw.permute(0, 1, 3, 2, 4))                # (B,nc,nh,t,dh)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                            # (B,nc,t,nh,dh)

    # chunk boundary states: S_chunk = Σ_s exp(gtot − gcum_s) B_s ⊗ xw_s
    w_state = torch.exp(gtot[:, :, None] - gcum)                        # (B,nc,c,nh)
    chunk_states = torch.einsum("bnse,bnshd->bnhed", b_c, w_state[..., None] * xw)

    # inter-chunk carry: the state entering each chunk
    h = (torch.zeros((b, nh, ds, dh), dtype=f32, device=x.device) if init_state is None
         else init_state["ssd"].to(f32))
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(gtot[:, n])[..., None, None] + chunk_states[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                               # (B,nc,nh,ds,dh)
    y_inter = torch.einsum("bnte,bnhed->bnthd", c_c, h_prevs) * torch.exp(gcum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * c, nh, dh)[:, :s]
    y = y + xs.reshape(b, nc * c, nh, dh)[:, :s] * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": conv_cache, "ssd": h}
    return out


def mamba_decode(p, x, state, cfg: SSMConfig):
    """Single-token step. x: (B, 1, D); state: {'conv','ssd'}."""
    b, _, d_model = x.shape
    d_inner, nh, dh, _ = dims(d_model, cfg)
    ds = cfg.d_state
    f32 = torch.float32
    z, xbc, dt_raw = _split_proj(x @ p["in_proj"], d_inner, ds, nh)
    xbc, conv_cache = _causal_conv(xbc, p["conv_w"], state["conv"])
    xs = xbc[:, 0, :d_inner].reshape(b, nh, dh).to(f32)
    bvec = xbc[:, 0, d_inner: d_inner + ds].to(f32)
    cvec = xbc[:, 0, d_inner + ds:].to(f32)
    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])               # (B,nh)
    g = torch.exp(-dt * torch.exp(p["a_log"]))                          # decay
    xw = xs * dt[..., None]
    h = state["ssd"] * g[..., None, None] + bvec[:, None, :, None] * xw[:, :, None, :]
    y = torch.einsum("be,bhed->bhd", cvec, h) + xs * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_cache, "ssd": h}


def init_mamba_state(batch, d_model, cfg: SSMConfig, dtype=torch.float32, device=None):
    d_inner, nh, dh, conv_dim = dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, nh, cfg.d_state, dh), dtype=torch.float32, device=device),
    }
