"""Partitioned model steps on a ``torch.distributed`` ``DeviceMesh``.

The counterpart of the reference's steps jitted with ``in_shardings`` on a
mesh (``repro.launch.dryrun.build_lowerable``, ``tests/test_multidevice.py``):
the parameters, the batch, the analytic state and the decode cache are
``DTensor``s placed by ``launch.sharding``'s rules, the step runs under the
activation policy of the mesh (``core.act``), and the regions DTensor has
no rule for run on each rank's local shards (``core.act.local_region``):
attention through the flash kernel, the MoE expert FFN with its one
all-reduce over 'model', and the Gram fold with its one all-reduce over the
federation axes.

:func:`run_steps` runs the analytic train step, a prefill and greedy decode
steps on one mesh and reports what each rank saw: results (replicated,
gathered outside the counted steps), the collectives of each step (kinds,
axes, elements and bytes, in order), kernel launches, wall time and peak
device memory. It runs alike on real ranks (``core.distributed.run_ranks``)
and on the fake process group of ``launch.mesh.fake_device_mesh`` with meta
tensors, where the same steps walked by ``launch.cost_analysis`` predict
the real ranks' collectives op for op.

Usage (4 ranks on the CPU, reduced granite; on the card drop ``--device``):
  PYTHONPATH=src python -m repro_torch.launch.partitioned --arch granite_moe_3b_a800m \\
      --reduced --mesh 2,2 --batch 8 --seq 32 --decode 4 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import act, streaming
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram as _gram
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import transformer as T
from repro_torch.optim import tree_leaves


@dataclasses.dataclass(frozen=True)
class Plan:
    """One partitioned run: the model and what the steps take."""

    arch: str
    reduced: Optional[dict] = None   # ModelConfig.reduced overrides, None: full width
    batch: int = 8
    seq: int = 32
    decode: int = 4
    seed: int = 0
    layers: Optional[int] = None     # a depth cut that keeps the widths

    def config(self) -> ModelConfig:
        cfg = get_config(self.arch)
        cfg = cfg if self.reduced is None else cfg.reduced(**self.reduced)
        return cfg if self.layers is None else dataclasses.replace(cfg, num_layers=self.layers)


def policy(device_mesh):
    """The activation policy of a partitioned step on ``device_mesh``."""
    return act.activation_policy(device_mesh, M.batch_axes(device_mesh),
                                 M.model_axes(device_mesh))


def axis_groups(device_mesh) -> dict:
    """{process group name: axis names} of ``device_mesh``'s dims and of the
    federation axes flattened (the Gram fold's group on a mesh with 'pod')."""
    names = list(device_mesh.mesh_dim_names)
    out = {str(device_mesh.get_group(i).group_name): (a,) for i, a in enumerate(names)}
    fed = M.batch_axes(device_mesh)
    if len(fed) > 1:
        out[str(device_mesh[fed]._flatten().get_group().group_name)] = fed
    return out


def _log(cost: CA.Cost, groups: dict) -> list:
    """The cost's collectives as (kind, axes, elements, bytes, region)."""
    return [(kind, "+".join(groups.get(g, (g,))), n, b, region)
            for kind, g, n, b, region in cost.collective_log]


def _full(x) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


@contextlib.contextmanager
def _routing_spy(out: list, choices=None):
    """Record every MoE call's routing (``moe.route``: slots, expert
    choices, router probabilities) into ``out``; with ``choices`` (an
    iterator of (ng, g, k) expert indices, one a call) route each call by
    those instead of its own top-k (``moe.assign``), keeping its own
    choices beside them."""
    from repro_torch.models import moe as MOE

    route = MOE.route

    def spy(p, groups, moe):
        r = route(p, groups, moe)
        own = r.top_i
        if choices is not None:
            r = MOE.assign(r.probs, next(choices).to(own.device), moe)
        out.append((r.slot, r.top_i, r.probs, own))
        return r

    MOE.route = spy
    try:
        yield
    finally:
        MOE.route = route


def _local(t):
    """(local tensor on the CPU, placements, global shape) of a DTensor."""
    return (t.to_local().cpu(), [_placement(p) for p in t.placements], tuple(t.shape))


def _placement(p) -> Optional[int]:
    """A placement as the tensor dim it shards, None for replicated."""
    return p.dim if p.is_shard() else None


def assemble(blocks: list, mesh_shape: tuple) -> torch.Tensor:
    """The global tensor from each rank's ``(local, placements, shape)``
    (rank-major order on a mesh of ``mesh_shape``, row-major coordinates)."""
    shape = blocks[0][2]
    full = torch.empty(shape, dtype=blocks[0][0].dtype)
    coords = torch.arange(len(blocks)).reshape(mesh_shape)
    for r, (local, placements, _) in enumerate(blocks):
        coord = [int(c) for c in torch.nonzero(coords == r)[0]]
        idx = []
        for dim, n in enumerate(local.shape):
            mdims = [m for m, d in enumerate(placements) if d == dim]
            off = sum(coord[m] * n * math.prod(mesh_shape[k] for k in mdims if k > m)
                      for m in mdims)     # the major mesh dim cuts first
            idx.append(slice(off, off + n))
        full[tuple(idx)] = local
    return full


def run_steps(device_mesh, plan: Plan, *, device=None, params=None, data=None,
              walk: bool = False, routing: bool = False) -> dict:
    """The partitioned analytic train step, prefill and ``plan.decode``
    greedy decode steps of ``plan`` on ``device_mesh``.

    Real ranks (``walk`` False): ``params`` a full param tree on ``device``
    to distribute, or None to draw them from ``plan.seed`` layer by layer
    (``launch.sharding.distributed_params``); ``data`` the batch (tokens,
    labels and the modality stubs; ``plan.seed``'s ``sample_batch`` when
    None); the result holds, as plain
    CPU tensors, the train step's state, the prefill's last-token logits,
    every decode step's logits and the greedy tokens, and for each step
    its collectives (counted as they run; ``comm_debug`` their count by
    ``CommDebugMode``), flash / Gram kernel launches, wall seconds and
    ``scans``, the recurrences' carry shapes on this rank (``core.act.scan``:
    name, shapes), and the peak device bytes.

    With ``routing`` every step's MoE routing is kept too, each call's
    slots and expert choices as (local block, placements, global shape)
    (:func:`assemble` joins the ranks' blocks).

    Fake process group (``walk`` True, ``device`` "meta"): the same steps
    walked by ``cost_analysis.walk`` on meta tensors, each step's
    collectives in the same form, and its cost."""
    cfg = plan.config()
    dev = torch.device("meta") if walk else torch.device(device)
    chips = M.num_chips(device_mesh)
    groups = axis_groups(device_mesh)
    if params is None:
        params = (T.init_params(cfg, device="meta") if walk else
                  SH.distributed_params(cfg, device_mesh, seed=plan.seed, device=dev))
    if not _is_dtensor_tree(params):
        params = SH.distribute(params, SH.param_shardings(params, device_mesh), device_mesh)
    data = _batch(cfg, plan, data)
    data = {k: (torch.empty_like(v, device="meta") if walk else v.to(dev))
            for k, v in data.items()}
    place = lambda t: SH.distribute(t, SH.batch_shardings(cfg, t, device_mesh),  # noqa: E731
                                    device_mesh)
    out: dict[str, Any] = {"steps": {}}

    def count(name, fn, *args):
        launches = (_fa.flash_attention.launches, _gram.gram_update.launches)
        seen: list = []
        scans: list = []
        t0 = time.perf_counter()
        with policy(device_mesh), act.record_scans(scans), (
                _routing_spy(seen) if routing else contextlib.nullcontext()):
            if walk:
                cost, res = CA.walk(fn, *args, device="meta", chips=chips)
            else:
                from torch.distributed.tensor.debug import CommDebugMode

                with CommDebugMode() as comm:
                    cost, res = CA.count_collectives(fn, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"collectives": _log(cost, groups), "seconds": time.perf_counter() - t0,
               "flash_launches": _fa.flash_attention.launches - launches[0],
               "gram_launches": _gram.gram_update.launches - launches[1],
               "scans": sorted(set(scans))}
        if not walk:
            rec["comm_debug"] = comm.get_total_counts()
        if routing:
            rec["routing"] = [(_local(slot), _local(top_i)) for slot, top_i, _, _ in seen]
        if walk:
            rec["cost"] = dataclasses.asdict(cost)
        out["steps"][name] = rec
        return res

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = SH.distribute(streaming.init_state(cfg.d_model, cfg.num_classes, device=dev),
                          SH.state_shardings(device_mesh), device_mesh)
    train = ST.make_analytic_train_step(cfg, use_kernel=True)
    state = count("train", train, params, state, place(data))
    prompt = place({k: v for k, v in data.items() if k != "labels"})
    logits, cache = count("prefill", ST.make_prefill_step(cfg, plan.seq + plan.decode),
                          params, prompt)
    serve = ST.make_serve_step(cfg)
    pos = prompt["tokens"].shape[1] + cfg.prefix_tokens
    all_logits, tokens = [_full(logits)], []
    for i in range(plan.decode):
        tok = all_logits[-1].argmax(-1).to(torch.int32)
        tokens.append(tok)
        logits, cache = count(f"decode{i}", serve, params, cache,
                              place({"token": tok})["token"], pos + i)
        all_logits.append(_full(logits))
    if not walk:
        out.update(
            state={k: _full(v).cpu() for k, v in state._asdict().items()},
            logits=[t.cpu() for t in all_logits], tokens=[t.cpu() for t in tokens],
            peak_bytes=(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None))
    return out


def _batch(cfg: ModelConfig, plan: Plan, data=None) -> dict:
    """``data`` (arrays or tensors) as CPU tensors, or ``plan``'s sample."""
    if data is None:
        return sample_batch(cfg, plan.batch, plan.seq, seed=plan.seed, device="cpu")
    return {k: torch.as_tensor(np.array(v)) for k, v in data.items()}


def _is_dtensor_tree(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return all(isinstance(t, DTensor) for t in tree_leaves(tree))


def one_rank_steps(plan: Plan, *, device=None, params=None, data=None,
                   choices: Optional[dict] = None) -> dict:
    """The same steps on one device with plain tensors (the comparison of a
    partitioned run): the train step's state, the prefill's and each
    decode step's logits, the greedy tokens, and every step's MoE routing
    by call (slots, choices, router probabilities and the router's own
    choices). ``choices`` ({step name: [(ng, g, k) expert indices a call]},
    a partitioned run's) routes each MoE call by those: a teacher-forced
    comparison, where a near-tie that the two runs' sums in other orders
    break apart would otherwise send a token to another expert."""
    cfg = plan.config()
    dev = torch.device(device) if device is not None else torch.device("cuda")
    params = params if params is not None else T.init_params(cfg, seed=plan.seed, device=dev)
    data = {k: v.to(dev) for k, v in _batch(cfg, plan, data).items()}
    routes: dict = {}

    def run(name, fn, *args):
        seen: list = []
        forced = None if choices is None else iter(choices[name])
        with _routing_spy(seen, forced):
            res = fn(*args)
        routes[name] = [tuple(t.cpu() for t in call) for call in seen]
        return res

    state = streaming.init_state(cfg.d_model, cfg.num_classes, device=dev)
    state = run("train", ST.make_analytic_train_step(cfg, use_kernel=True),
                params, state, data)
    prompt = {k: v for k, v in data.items() if k != "labels"}
    logits, cache = run("prefill", ST.make_prefill_step(cfg, plan.seq + plan.decode),
                        params, prompt)
    serve = ST.make_serve_step(cfg)
    pos = prompt["tokens"].shape[1] + cfg.prefix_tokens
    all_logits, tokens = [logits], []
    for i in range(plan.decode):
        tok = all_logits[-1].argmax(-1).to(torch.int32)
        tokens.append(tok)
        logits, cache = run(f"decode{i}", serve, params, cache, tok, pos + i)
        all_logits.append(logits)
    return {"state": {k: v.cpu() for k, v in state._asdict().items()},
            "logits": [t.cpu() for t in all_logits], "tokens": [t.cpu() for t in tokens],
            "routing": routes}


def one_device_walk(plan: Plan) -> dict:
    """:func:`run_steps`' steps of ``plan`` walked on one device (plain meta
    tensors, no mesh) → {step name: its cost as a dict}: the work that a
    partitioned run's ranks share out (chips × rank 0's flops over these
    is the repeated work's ratio)."""
    cfg = plan.config()
    params = T.init_params(cfg, device="meta")
    data = {k: torch.empty_like(v, device="meta") for k, v in _batch(cfg, plan).items()}
    costs: dict = {}

    def walk(name, fn, *args):
        cost, res = CA.walk(fn, *args, device="meta")
        costs[name] = dataclasses.asdict(cost)
        return res

    walk("train", ST.make_analytic_train_step(cfg, use_kernel=True), params,
         streaming.init_state(cfg.d_model, cfg.num_classes, device="meta"), data)
    prompt = {k: v for k, v in data.items() if k != "labels"}
    logits, cache = walk("prefill", ST.make_prefill_step(cfg, plan.seq + plan.decode),
                         params, prompt)
    serve = ST.make_serve_step(cfg)
    pos = prompt["tokens"].shape[1] + cfg.prefix_tokens
    for i in range(plan.decode):
        logits, cache = walk(f"decode{i}", serve, params, cache,
                             logits.argmax(-1).to(torch.int32), pos + i)
    return costs


def rank_main(rank: int, device_mesh, plan: Plan, device: str, params_np=None,
              data=None, routing: bool = False) -> dict:
    """``core.distributed.run_ranks``' function: :func:`run_steps` on this
    rank's device; ``params_np`` the reference's params as numpy
    (``models.convert.params_from_jax``), else drawn from ``plan.seed``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    params = None
    if params_np is not None:
        from repro_torch.models.convert import params_from_jax

        params = params_from_jax(params_np, plan.config(), device=dev)
    return run_steps(device_mesh, plan, device=dev, params=params, data=data,
                     routing=routing)


def plans_main(rank: int, device_mesh, plans, device: str, routing=()) -> list:
    """``core.distributed.run_ranks``' function for several models on one
    set of ranks (one spawn): :func:`rank_main` of each of ``plans`` in
    turn, the MoE routing kept for the archs named in ``routing``, the
    device's cache emptied between models."""
    import gc

    out = []
    for plan in plans:
        out.append(rank_main(rank, device_mesh, plan, device, routing=plan.arch in routing))
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def moe_rank_main(rank: int, device_mesh, p_np: dict, x_np, moe, activation: str) -> dict:
    """``run_ranks``' function for one MoE layer: ``models.moe.moe_apply`` of
    the expert params ``p_np`` (numpy, the reference's ``init_moe`` layout)
    on ``x_np`` (B, S, D), both placed by the rules (x's batch over the
    federation axes), under the mesh's policy → the gathered output and aux
    loss and the layer's collectives."""
    from repro_torch.models import moe as MOE

    p = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    p = SH.distribute(p, SH.param_shardings(p, device_mesh), device_mesh)
    x = torch.from_numpy(x_np.copy())
    x = SH.distribute(x, SH.batch_shardings(None, x, device_mesh), device_mesh)
    with policy(device_mesh):
        cost, (out, aux) = CA.count_collectives(MOE.moe_apply, p, x, moe, activation)
    return {"out": _full(out), "aux": _full(aux),
            "collectives": _log(cost, axis_groups(device_mesh))}


def predict(plans, mesh_shape: tuple, axis_names: tuple, device_type: str, *,
            whole: bool = False) -> list:
    """Rank 0's steps of each of ``plans`` walked on a fake process group of
    the mesh (this process's one fake mesh; ``core.distributed.run_isolated``
    gives it a process) → :func:`run_steps`' records, each step's
    collectives and cost; with ``whole`` each record's "whole" holds the
    steps walked on one device (:func:`one_device_walk`)."""
    dm = M.fake_device_mesh(M.Mesh(tuple(mesh_shape), tuple(axis_names)), device_type)
    out = []
    for plan in plans:
        rec = run_steps(dm, plan, walk=True)
        if whole:
            rec["whole"] = one_device_walk(plan)
        out.append(rec)
    return out


def repeated_work(rec: dict, chips: int) -> dict:
    """{step: chips × rank 0's walked flops / the one-device walk's} of a
    :func:`predict` record made with ``whole``: 1 when no rank repeats
    another's work."""
    return {name: chips * step["cost"]["flops"] / rec["whole"][name]["flops"]
            for name, step in rec["steps"].items()}


def main(argv=None) -> None:
    from repro_torch.core.distributed import run_ranks

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="granite_moe_3b_a800m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="2,2", help="data,model")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--decode", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.mesh.split(","))
    plan = Plan(args.arch, reduced={} if args.reduced else None, batch=args.batch,
                seq=args.seq, decode=args.decode)
    ranks = run_ranks(rank_main, shape, ("data", "model"), device=args.device,
                      args=(plan, args.device), timeout=args.timeout)
    one = one_rank_steps(plan, device=args.device)
    err = max(float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
              for a, b in zip(ranks[0]["logits"], one["logits"]))
    print(json.dumps({"arch": args.arch, "mesh": shape, "logits_rel_err": err,
                      "tokens_equal": all(bool(torch.equal(a, b)) for a, b in
                                          zip(ranks[0]["tokens"], one["tokens"])),
                      "collectives": {k: len(v["collectives"])
                                      for k, v in ranks[0]["steps"].items()}}))


if __name__ == "__main__":
    main()
