"""Mixture-of-Experts layer (top-k router, capacity-based grouped dispatch).

The port of ``repro.models.moe`` on one device: tokens are cut into groups
of ``group_size``, each token's top-k experts are taken from an f32 router
softmax, and each (token, choice) gets a slot in its expert's queue of
``cap`` places, in the order of the flattened (token, choice) sequence of
its group; a choice past its expert's capacity is dropped (its weight 0,
its slot the overflow bin). Expert weights lie on a leading E dim,
``(E, d_in, d_out)``, and the expert products are batched matmuls over E.

On a partitioned step (``DTensor`` activations on a ``DeviceMesh``, an
activation policy with ``tp > 1`` active) the expert FFN is the
reference's explicit-collective one, :func:`_ffn_shard_map`: one
``act.local_region`` in which token groups are split over the federation
axes and the expert weights over their d_ff dim along 'model', dispatch,
FFN and combine run on each rank's partial (f-shard) outputs, and ONE
all-reduce over 'model' of the rank's (ng/fsdp, g, d) tokens finishes the
layer. ``REPRO_MOE_FFN=dense`` forces the other path, as in the
reference; on ``DTensor``s that path is the same region with the tokens
replicated over the federation axes (each rank dispatches every group),
the schedule a partitioner takes when the groups do not divide them.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.core import act
from repro_torch.models import layers as L


def init_moe(gen, d_model, d_ff, moe: MoEConfig, activation, dtype, device):
    e = moe.num_experts

    def ed(d_in, d_out):
        flat = L.dense_init(gen, d_in, e * d_out, dtype, device)
        return flat.reshape(d_in, e, d_out).transpose(0, 1).contiguous()  # (E, d_in, d_out)

    p = {
        "router": L.dense_init(gen, d_model, e, dtype, device),
        "w_up": ed(d_model, d_ff),
        "w_down": ed(d_ff, d_model),
    }
    if activation == "swiglu":
        p["w_gate"] = ed(d_model, d_ff)
    return p


def _expert_hidden(p, h_in, activation):
    """(n, E, cap, d) → (n, E, cap, f): up/gate projection + nonlinearity."""
    up = torch.einsum("necd,edf->necf", h_in, p["w_up"])
    if activation == "swiglu":
        gate = torch.einsum("necd,edf->necf", h_in, p["w_gate"])
        return F.silu(gate) * up
    if activation == "relu2":
        return torch.square(F.relu(up))
    return F.gelu(up, approximate="tanh")


def _scatter_dispatch(groups, slot, e, cap):
    """Token vectors into expert-capacity slots. groups (ng, g, d), slot
    (ng, g, k) flat indices into [0, e·cap] (e·cap = the drop bin). Slots
    other than the drop bin are unique per group, so the index_add_ adds
    into each kept slot once; the drop bin is discarded."""
    ng, g, d = groups.shape
    k = slot.shape[-1]
    width = e * cap + 1
    src = groups[:, :, None, :].expand(ng, g, k, d).reshape(ng * g * k, d)
    base = torch.arange(ng, device=slot.device)[:, None] * width
    flat = (slot.reshape(ng, g * k) + base).reshape(-1)
    buf = torch.zeros((ng * width, d), dtype=groups.dtype, device=groups.device)
    buf.index_add_(0, flat, src)
    return buf.reshape(ng, width, d)[:, : e * cap].reshape(ng, e, cap, d)


def _gather_combine(out_e, slot, weight):
    """Inverse of _scatter_dispatch: each token's expert outputs weighted by
    its router probabilities. out_e (ng, e, cap, d); slot/weight (ng, g, k)."""
    ng, e, cap, d = out_e.shape
    g, k = slot.shape[1], slot.shape[2]
    flat = torch.cat([out_e.reshape(ng, e * cap, d),
                      out_e.new_zeros((ng, 1, d))], dim=1)
    rows = torch.arange(ng, device=slot.device)[:, None]
    gath = flat[rows, slot.reshape(ng, g * k)].reshape(ng, g, k, d)
    return (gath * weight[..., None]).sum(2)


def _ffn_dense(p, groups, slot, weight, e, cap, activation):
    """The expert FFN on one device: dispatch, two batched products over E,
    combine. On ``DTensor``s: :func:`_ffn_region` with every group on
    every rank."""
    if act.device_mesh_of(groups) is not None:
        return _ffn_region(p, groups, slot, weight, e, cap, activation, split_tokens=False)
    h_in = _scatter_dispatch(groups, slot, e, cap)
    hidden = _expert_hidden(p, h_in, activation)
    out_e = torch.einsum("necf,efd->necd", hidden, p["w_down"])
    return _gather_combine(out_e, slot, weight)


def _axes(mesh=None):
    """(federation axes, model axes, their sizes) of the active policy, or
    with none active of ``mesh`` by its axis names."""
    pol = act._POLICY.get()
    if pol is not None:
        fed, tp, sizes = pol["batch"], pol["model"], pol["sizes"]
    else:
        sizes = act.axis_sizes(mesh)
        fed, tp = act.fed_model_axes(mesh)
    return fed, tp, (math.prod(sizes[a] for a in fed), math.prod(sizes[a] for a in tp))


def _shard_map_ok(ng: int, d_ff: int) -> bool:
    """Use the explicit-collective FFN when a policy is active and the
    group / feature dims divide the federation / model axes, as the
    reference decides. ``REPRO_MOE_FFN=dense`` forces the other path (the
    reference's perf A/B)."""
    if os.environ.get("REPRO_MOE_FFN") == "dense":
        return False
    if act._POLICY.get() is None:
        return False
    _, _, (fsdp, tp) = _axes()
    return tp > 1 and ng % max(fsdp, 1) == 0 and d_ff % tp == 0


def _ffn_shard_map(p, groups, slot, weight, e, cap, activation):
    """Expert FFN with an explicit collective schedule (the reference's
    ``_ffn_shard_map``): token groups stay split over the federation axes,
    expert weights enter d_ff-split over 'model', dispatch / FFN / combine
    are local, the combine runs on the *partial* (f-shard) expert outputs
    (linearity lets it commute with the f-reduction), and ONE all-reduce
    in token space (ng/fsdp · g · d a rank) finishes the layer."""
    return _ffn_region(p, groups, slot, weight, e, cap, activation, split_tokens=True)


def _ffn_region(p, groups, slot, weight, e, cap, activation, *, split_tokens: bool):
    """The expert FFN as one ``act.local_region`` on ``DTensor`` groups:
    groups, slots and weights split on ng over the federation axes
    (``split_tokens``) or replicated; ``w_up`` / ``w_gate`` (E, d, f) split
    on f and ``w_down`` (E, f, d) on its f dim over 'model' where the
    model axes divide f, then the rank's combined tokens all-reduced over
    'model' (a functional collective, which the cost walk counts), else
    replicated weights and no collective."""
    from torch.distributed import _functional_collectives as funcol

    mesh = act.device_mesh_of(groups)
    fed, tp, (_, ntp) = _axes(mesh)
    f_split = ntp > 1 and p["w_up"].shape[-1] % ntp == 0
    ftp = tp if f_split else None
    tok = act.to_placements((fed if split_tokens else None,), mesh)
    names = [k for k in ("w_up", "w_gate", "w_down") if k in p]
    wspec = {"w_up": (None, None, ftp), "w_gate": (None, None, ftp),
             "w_down": (None, ftp, None)}
    in_pl = [tok, tok, tok] + [act.to_placements(wspec[k], mesh) for k in names]
    dims = [list(mesh.mesh_dim_names).index(a) for a in tp]

    def ffn(groups_l, slot_l, weight_l, *ws):
        w = dict(zip(names, ws))
        h_in = _scatter_dispatch(groups_l, slot_l, e, cap)
        hidden = _expert_hidden(w, h_in, activation)
        out_partial = torch.einsum("necf,efd->necd", hidden, w["w_down"])
        out_l = _gather_combine(out_partial, slot_l, weight_l)
        if f_split:
            out_l = funcol.all_reduce(out_l, "sum", (mesh, dims[0]))
            if isinstance(out_l, funcol.AsyncCollectiveTensor):
                out_l = out_l.wait()
        return out_l

    return act.local_region(ffn, mesh, in_pl, tok, name="moe_ffn")(
        groups, slot, weight, *(p[k] for k in names))


@dataclasses.dataclass
class Routing:
    """One MoE call's expert assignment, groups (ng, g) of tokens."""
    probs: torch.Tensor      # (ng, g, E) f32 router softmax
    top_i: torch.Tensor      # (ng, g, k) chosen experts, largest probability first
    slot: torch.Tensor       # (ng, g, k) flat slot in [0, E·cap]; E·cap = dropped
    weight: torch.Tensor     # (ng, g, k) renormalised top-k probability, 0 if dropped
    cap: int                 # places in each expert's queue


def _groups(x, moe: MoEConfig):
    """(B, S, D) → ((ng, g, D) token groups, zero-padded at the end; t)."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    g = min(moe.group_size, t)
    ng = -(-t // g)
    if ng * g - t:
        tokens = F.pad(tokens, (0, 0, 0, ng * g - t))
    return tokens.reshape(ng, g, d), t


def route(p, groups, moe: MoEConfig) -> Routing:
    """Top-k routing with capacity, as the reference's ``moe_apply``: the
    slot of (token, choice) is its place in its expert's queue, counted
    over the group's tokens in order and each token's choices largest
    first; equal probabilities go to the lower expert first, as
    ``lax.top_k`` orders them."""
    probs = torch.softmax((groups @ p["router"]).to(torch.float32), -1)   # (ng, g, E)
    top_i = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :moe.top_k]
    return assign(probs, top_i, moe)


def assign(probs, top_i, moe: MoEConfig) -> Routing:
    """The routing of the choices ``top_i`` (ng, g, k) under the router's
    ``probs`` (ng, g, E): their renormalised probabilities, each (token,
    choice)'s slot in its expert's queue of ``cap`` places, and the
    dropped ones' weight 0 and slot the overflow bin."""
    ng, g, e = probs.shape
    k = top_i.shape[-1]
    top_p = probs.gather(-1, top_i)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # Python's round (half to even), as the reference computes it
    cap = int(max(1, round(g * k / e * moe.capacity_factor)))
    one = F.one_hot(top_i, e).to(torch.float32)                          # (ng, g, k, E)
    pos = torch.cumsum(one.reshape(ng, g * k, e), dim=1).reshape(ng, g, k, e)
    pos_sel = (pos * one - 1.0).amax(-1)                                 # own-expert place
    keep = (pos_sel >= 0) & (pos_sel < cap)
    slot = torch.where(keep, top_i * cap + pos_sel.to(torch.int64), e * cap)
    weight = torch.where(keep, top_p, 0.0)
    return Routing(probs=probs, top_i=top_i, slot=slot, weight=weight, cap=cap)


def moe_apply(p, x, moe: MoEConfig, activation):
    """x: (B, S, D) → ((B, S, D), the Switch-style load-balance aux loss)."""
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    groups, t = _groups(x, moe)
    r = route(p, groups, moe)
    ng = groups.shape[0]
    if _shard_map_ok(ng, p["w_up"].shape[-1]) and act.device_mesh_of(groups) is not None:
        out = _ffn_shard_map(p, groups, r.slot, r.weight, e, r.cap, activation)
    else:
        out = _ffn_dense(p, groups, r.slot, r.weight, e, r.cap, activation)
    out = out.reshape(-1, d)[:t].reshape(b, s, d).to(x.dtype)

    # load-balance aux (Switch-style): E * Σ_e f_e · P_e
    chosen = F.one_hot(r.top_i, e).to(torch.float32)
    frac_tokens = chosen.sum(2).mean(dim=(0, 1)) / k
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_probs).sum()
    return out, aux
