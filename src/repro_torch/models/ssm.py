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
from repro_torch.core import act
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


def _ssd(x_part, b_part, c_part, dt_raw, a_log, d_skip, dt_bias, chunk, h0=None):
    """The chunked SSD of x (B, S, nh·dh), B and C (B, S, ds), dt_raw
    (B, S, nh) from the state h0 (B, nh, ds, dh), zeros when None → (y
    (B, S, nh, dh) f32 with the skip term, the last state), at whatever B
    and nh it is given (a rank's shard)."""
    b, s, _ = x_part.shape
    nh = dt_raw.shape[-1]
    dh = x_part.shape[-1] // nh
    ds = b_part.shape[-1]
    f32 = torch.float32
    xs = x_part.reshape(b, s, nh, dh).to(f32)
    bmat = b_part.to(f32)                                               # (B,S,ds)
    cmat = c_part.to(f32)                                               # (B,S,ds)
    dt = F.softplus(dt_raw.to(f32) + dt_bias)                           # (B,S,nh)
    neg_a = torch.exp(a_log)                                            # (nh,)
    log_g = -dt * neg_a                                                 # log decay ≤ 0

    c = min(chunk, s)
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
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x_part.device))
    decay = torch.where(causal[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bnte,bnse->bnts", c_c, b_c)                  # C_t·B_s
    m = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)              # (B,nc,nh,t,s)
    y_intra = torch.matmul(m, xw.permute(0, 1, 3, 2, 4))                # (B,nc,nh,t,dh)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                            # (B,nc,t,nh,dh)

    # chunk boundary states: S_chunk = Σ_s exp(gtot − gcum_s) B_s ⊗ xw_s
    w_state = torch.exp(gtot[:, :, None] - gcum)                        # (B,nc,c,nh)
    chunk_states = torch.einsum("bnse,bnshd->bnhed", b_c, w_state[..., None] * xw)

    # inter-chunk carry: the state entering each chunk
    h = (torch.zeros((b, nh, ds, dh), dtype=f32, device=x_part.device) if h0 is None
         else h0.to(f32))

    def carry(n, h):
        return h * torch.exp(gtot[:, n])[..., None, None] + chunk_states[:, n], h

    h, h_prevs = act.scan(carry, h, nc, 1, name="ssd")                 # (B,nc,nh,ds,dh)
    y_inter = torch.einsum("bnte,bnhed->bnthd", c_c, h_prevs) * torch.exp(gcum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * c, nh, dh)[:, :s]
    y = y + xs.reshape(b, nc * c, nh, dh)[:, :s] * d_skip[None, None, :, None]
    return y, h


def _ssd_step(x_vec, b_vec, c_vec, dt_raw, a_log, d_skip, dt_bias, h0):
    """One token of the SSD: x (B, nh·dh), B and C (B, ds), dt_raw (B, nh),
    the state h0 (B, nh, ds, dh) → (y (B, nh, dh) f32, the new state)."""
    b, nh = dt_raw.shape
    f32 = torch.float32
    xs = x_vec.reshape(b, nh, x_vec.shape[-1] // nh).to(f32)
    bvec = b_vec.to(f32)
    cvec = c_vec.to(f32)
    dt = F.softplus(dt_raw.to(f32) + dt_bias)                           # (B,nh)
    g = torch.exp(-dt * torch.exp(a_log))                               # decay
    xw = xs * dt[..., None]
    h = h0 * g[..., None, None] + bvec[:, None, :, None] * xw[:, :, None, :]
    y = torch.einsum("be,bhed->bhd", cvec, h) + xs * d_skip[None, :, None]
    return y, h


def _vecs(p):
    return p["a_log"], p["d_skip"], p["dt_bias"]


def mamba_apply(p, x, cfg: SSMConfig, *, init_state=None, return_state=False):
    """Full-sequence (prefill) chunked SSD. x: (B, S, D)."""
    if act.device_mesh_of(x) is not None:
        return _sharded(p, x, cfg, init_state, return_state, decode=False)
    b, s, d_model = x.shape
    d_inner, nh, dh, conv_dim = dims(d_model, cfg)
    ds = cfg.d_state
    z, xbc, dt_raw = _split_proj(x @ p["in_proj"], d_inner, ds, nh)
    xbc, conv_cache = _causal_conv(xbc, p["conv_w"],
                                   None if init_state is None else init_state["conv"])
    y, h = _ssd(xbc[..., :d_inner], xbc[..., d_inner: d_inner + ds], xbc[..., d_inner + ds:],
                dt_raw, *_vecs(p), cfg.chunk, None if init_state is None else init_state["ssd"])
    y = y.reshape(b, s, d_inner).to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": conv_cache, "ssd": h}
    return out


def mamba_decode(p, x, state, cfg: SSMConfig):
    """Single-token step. x: (B, 1, D); state: {'conv','ssd'}."""
    if act.device_mesh_of(x) is not None:
        return _sharded(p, x, cfg, state, True, decode=True)
    b, _, d_model = x.shape
    d_inner, nh, dh, _ = dims(d_model, cfg)
    ds = cfg.d_state
    z, xbc, dt_raw = _split_proj(x @ p["in_proj"], d_inner, ds, nh)
    xbc, conv_cache = _causal_conv(xbc, p["conv_w"], state["conv"])
    y, h = _ssd_step(xbc[:, 0, :d_inner], xbc[:, 0, d_inner: d_inner + ds],
                     xbc[:, 0, d_inner + ds:], dt_raw[:, 0], *_vecs(p), state["ssd"])
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_cache, "ssd": h}


def _sharded(p, x, cfg: SSMConfig, state, return_state: bool, *, decode: bool):
    """The mixer of ``DTensor`` x on each rank's shards, in one
    ``act.local_region``: the batch over the federation axes; z, x, dt,
    the conv's x channels, the SSD and its state over 'model' by heads
    (where they divide nh); B and C projected and convolved split over
    'model' by channel (where they divide 2·ds) and all-gathered before
    the SSD, their one collective. ``in_proj`` is cut into those parts as
    weights, so no rank gathers the whole projection. The state keeps the
    cache's placements outside the region; out_proj (row parallel) after
    it."""
    from torch.distributed import _functional_collectives as funcol

    # torch 2.13 renames all_gather_tensor (its old name warns)
    _all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    mesh = act.device_mesh_of(x)
    b, s, d_model = x.shape
    d_inner, nh, dh, conv_dim = dims(d_model, cfg)
    ds = cfg.d_state
    sizes = act.axis_sizes(mesh)
    fed, tp = act.fed_model_axes(mesh)
    bat, hd = act.axes_dividing(fed, b, sizes), act.axes_dividing(tp, nh, sizes)
    bcs = act.axes_dividing(tp, 2 * ds, sizes)
    # the cuts fall within a rank's columns once 'model' no longer splits
    # them: one gather of the weight, not one a part
    w, cw = act.constrain(p["in_proj"], ("batch", None)), p["conv_w"]
    weights = (w[:, :d_inner], w[:, d_inner: 2 * d_inner], w[:, 2 * d_inner: 2 * d_inner + 2 * ds],
               w[:, 2 * d_inner + 2 * ds:], cw[:, :d_inner], cw[:, d_inner:]) + _vecs(p)
    args = (x,) + weights
    specs = [(bat, None, None), (None, hd), (None, hd), (None, bcs), (None, hd), (None, hd),
             (None, bcs), (hd,), (hd,), (hd,)]
    if state is not None:
        conv = act.constrain(state["conv"], ("batch", None, None))
        args += (conv[..., :d_inner], conv[..., d_inner:], state["ssd"])
        specs += [(bat, None, hd), (bat, None, bcs), (bat, hd)]
    outs = [(bat, None, hd), (bat, None, hd), (bat, None, bcs), (bat, hd)]
    group = (mesh, list(mesh.mesh_dim_names).index(tp[0])) if bcs else None

    def local(x_l, w_z, w_x, w_bc, w_dt, cw_x, cw_bc, a_log, d_skip, dt_bias, *st):
        conv_x0, conv_bc0, h0 = st or (None, None, None)
        z = x_l @ w_z
        xin, conv_x = _causal_conv(x_l @ w_x, cw_x, conv_x0)
        bc, conv_bc = _causal_conv(x_l @ w_bc, cw_bc, conv_bc0)
        if group is not None:
            bc = _all_gather(bc, bc.dim() - 1, group)
            if isinstance(bc, funcol.AsyncCollectiveTensor):
                bc = bc.wait()
        dt_raw = x_l @ w_dt
        vecs = (a_log, d_skip, dt_bias)
        if decode:
            y, h = _ssd_step(xin[:, 0], bc[:, 0, :ds], bc[:, 0, ds:], dt_raw[:, 0], *vecs, h0)
        else:
            y, h = _ssd(xin, bc[..., :ds], bc[..., ds:], dt_raw, *vecs, cfg.chunk, h0)
        y = y.reshape(xin.shape).to(x_l.dtype) * F.silu(z)
        return y, conv_x, conv_bc, h

    y, conv_x, conv_bc, h = act.local_region(
        local, mesh, [act.to_placements(sp, mesh) for sp in specs],
        tuple(act.to_placements(sp, mesh) for sp in outs), name="mamba")(*args)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": torch.cat([conv_x, conv_bc], dim=-1), "ssd": h}
    return out


def init_mamba_state(batch, d_model, cfg: SSMConfig, dtype=torch.float32, device=None):
    d_inner, nh, dh, conv_dim = dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, nh, cfg.d_state, dh), dtype=torch.float32, device=device),
    }
