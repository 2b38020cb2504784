"""Shared neural building blocks (functional, params = dicts of tensors).

The port of ``repro.models.layers``, with its conventions and layouts:

  * params are nested dicts of tensors; init_* builds them from a
    ``torch.Generator``, apply fns use them.
  * weights are stored ``(d_in, d_out)`` and applied as ``x @ W``.
  * activations (B, S, D); attention heads (B, H, S, hd).
  * ``window <= 0`` (or ``None``) means "no window".
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

BIG_WINDOW = 1 << 30
MASKED = -1e30


# ---------------------------------------------------------------- init utils
def dense_init(gen, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def init_norm(d, dtype, device, with_bias=False):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, eps, kind="rms"):
    xf = x.to(torch.float32)
    if kind == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------------- rope
def apply_rope(x, positions, theta):
    """x: (B, H, S, D); positions: (B, S) or (S,); theta: python scalar.

    Rotates the two halves of each head (not interleaved pairs), with
    ``theta ** -(i / half)`` in f32. ``theta`` stays a Python number: a
    device tensor made from it would be a host-to-device copy, which
    synchronises the host with the card at every call.
    """
    d = x.shape[-1]
    half = d // 2
    freq_exp = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = float(theta) ** -freq_exp
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None]
    angles = pos[:, None, :, None] * inv_freq[None, None, None, :]  # (B,1,S,half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention
@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False


def init_attention(gen, dims: AttnDims, dtype, device):
    h, hk, hd, d = dims.num_heads, dims.num_kv_heads, dims.head_dim, dims.d_model
    p = {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, hk * hd, dtype, device),
        "wv": dense_init(gen, d, hk * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device,
                         scale=1.0 / math.sqrt(h * hd)),
    }
    if dims.qk_norm:
        p["q_norm"] = init_norm(hd, dtype, device)
        p["k_norm"] = init_norm(hd, dtype, device)
    return p


def _heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def qkv_project(p, dims: AttnDims, x, positions, theta, eps=1e-6):
    """Project + (optional) qk-norm + rope. Returns q (B,H,S,hd), k/v (B,Hk,S,hd)."""
    q = _heads(x @ p["wq"], dims.num_heads, dims.head_dim)
    k = _heads(x @ p["wk"], dims.num_kv_heads, dims.head_dim)
    v = _heads(x @ p["wv"], dims.num_kv_heads, dims.head_dim)
    if dims.qk_norm:
        q = norm_apply(p["q_norm"], q, eps)
        k = norm_apply(p["k_norm"], k, eps)
    if theta is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _mask(qpos, kpos, win, causal):
    mask = kpos > qpos - win
    if causal:
        mask = mask & (kpos <= qpos)
    return mask


def sdpa(q, k, v, *, causal=True, window=None, q_offset=0, softcap=0.0,
         q_chunk=256, kv_chunk=1024):
    """Scaled dot-product attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), query heads grouped
    ``(hkv, group)`` for GQA; query row ``s`` sits at position ``q_offset +
    s``; ``window`` None or <= 0 means no window. On CUDA tensors this is
    the hand-written flash kernel (``kernels.ops.flash_attention``), the
    softcap included; under grad, when q, k or v requires it, the kernel's
    forward inside :class:`FlashSDPA`, whose backward is ``sdpa_plain``'s
    gradient. On the CPU it is :func:`sdpa_plain`, which autograd
    differentiates as it stands.
    """
    if not q.is_cuda:
        return sdpa_plain(q, k, v, causal=causal, window=window, q_offset=q_offset,
                          softcap=softcap, q_chunk=q_chunk, kv_chunk=kv_chunk)
    win = None if window is None or window <= 0 else int(window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashSDPA.apply(q, k, v, causal, win, int(q_offset), float(softcap))
    return ops.flash_attention(q, k, v, causal=causal, window=win, q_offset=q_offset,
                               softcap=softcap)


class FlashSDPA(torch.autograd.Function):
    """Attention with a gradient: the forward is the flash kernel on the
    card (``kernels.ops.flash_attention`` on detached inputs; on the CPU,
    :func:`sdpa_plain`), the backward recomputes :func:`sdpa_plain` from
    the saved q, k, v and differentiates it, GQA's k and v gradients summed
    over the group.

    This backward is what the reference computes: XLA's gradient of its
    plain jnp ``layers.sdpa`` (its Pallas flash kernel has no backward). A
    flash backward kernel would be a feature the reference lacks; it waits
    until the port is done (ROADMAP, after Queue 1).

    ``apply(q, k, v, causal, window, q_offset, softcap)``: ``window`` None
    or a positive int.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        if q.is_cuda:
            return ops.flash_attention(q.detach(), k.detach(), v.detach(), **ctx.kw)
        return sdpa_plain(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = sdpa_plain(*ins, **ctx.kw)
            grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad],
                                             grad_out))
        return (*(next(grads) if n else None for n in need), None, None, None, None)


def sdpa_plain(q, k, v, *, causal=True, window=None, q_offset=0, softcap=0.0,
               q_chunk=256, kv_chunk=1024):
    """Plain torch attention: the counterpart of the reference's
    differentiable ``layers.sdpa`` (not of the Pallas kernel), with
    :func:`sdpa`'s arguments. Products in f32 (f64 for f64 inputs), masked
    logits ``-1e30``; up to ``Sq·Skv = 2²²`` the logits are materialized,
    past that an online softmax walks ``q_chunk × kv_chunk`` blocks, so
    prefill-length logits never exist at once.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, group, sq, d)
    win = BIG_WINDOW if window is None or window <= 0 else int(window)
    dev = q.device

    if sq * skv <= 1 << 22:  # small: direct path
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(ct), k.to(ct)) * scale
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(skv, device=dev)[None, :]
        logits = logits.masked_fill(~_mask(qpos, kpos, win, causal), MASKED)
        probs = torch.softmax(logits, -1)
        out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).to(ct), v.to(ct))
        return out.reshape(b, hq, sq, d).to(q.dtype)

    # chunked two-level online-softmax path
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    sq_p, skv_p = -(-sq // qc) * qc, -(-skv // kc) * kc
    qg = F.pad(qg, (0, 0, 0, sq_p - sq))
    kp = F.pad(k, (0, 0, 0, skv_p - skv))
    vp = F.pad(v, (0, 0, 0, skv_p - skv))
    outs = []
    for q0 in range(0, sq_p, qc):
        q_blk = qg[:, :, :, q0:q0 + qc].to(ct)
        qpos = q0 + torch.arange(qc, device=dev)[:, None] + q_offset
        m = torch.full((b, hkv, group, qc), MASKED, dtype=ct, device=dev)
        l = torch.zeros((b, hkv, group, qc), dtype=ct, device=dev)
        acc = torch.zeros((b, hkv, group, qc, d), dtype=ct, device=dev)
        for k0 in range(0, skv_p, kc):
            k_blk = kp[:, :, k0:k0 + kc].to(ct)
            v_blk = vp[:, :, k0:k0 + kc]
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kpos = k0 + torch.arange(kc, device=dev)[None, :]
            mask = _mask(qpos, kpos, win, causal) & (kpos < skv)
            s = s.masked_fill(~mask, MASKED)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype).to(ct), v_blk.to(ct))
            m = m_new
        l = torch.where(l > 0, l, torch.ones_like(l))
        outs.append(acc / l[..., None])
    out = torch.cat(outs, 3)[:, :, :, :sq]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attn_out(p, ctx):
    """ctx: (B, H, S, hd) → (B, S, D)."""
    b, h, s, hd = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, h * hd) @ p["wo"]


# ----------------------------------------------------------------------- MLP
def init_mlp(gen, d_model, d_ff, activation, dtype, device):
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def mlp_apply(p, x, activation):
    if activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif activation == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
