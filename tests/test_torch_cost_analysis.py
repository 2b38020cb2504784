"""The port's cost walk against the reference's loop-aware HLO analysis.

``repro_torch.launch.cost_analysis.walk`` runs a step on meta tensors; its
flops are held to ``repro.launch.hlo_analysis.analyze(...).flops`` of the
same step jitted by the reference on the CPU, for the reduced analytic,
prefill and decode steps of one arch per family. Where they differ the
test names why and checks the difference to the flop. ``attention_flops``
and ``resolve_config`` are held to the reference's, read from its source:
importing ``repro.launch.dryrun`` would set ``XLA_FLAGS``. The walk's bytes
and live-storage accounting are checked on small functions, and the walk
by trip count of the per-token loops against walks of every trip. On a
fake process group (a process of its own), small DTensor programs: rank
0's flops, the collectives by kind and bytes (all-reduce, all-gather, and
on a CUDA mesh DTensor's all-to-all), the width cap, and the flops ranks
repeat.
"""

import ast
import dataclasses
from pathlib import Path
from typing import Optional

import jax
import numpy as np
import pytest
import torch

from repro.config import INPUT_SHAPES as R_SHAPES
from repro.config import InputShape as RInputShape
from repro.config import ModelConfig as RModelConfig
from repro.configs.registry import get_config as r_get_config
from repro.core import streaming as rstreaming
from repro.launch import hlo_analysis as HA
from repro.launch import inputs as rinputs
from repro.launch import steps as RST
from repro.models import transformer as RT

from repro_torch.config import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as DR

FAMILY_ARCHS = ["minicpm_2b", "granite_moe_3b_a800m", "zamba2_7b", "xlstm_350m",
                "seamless_m4t_medium"]
B, S = 2, 24


def _reference_dryrun_namespace() -> dict:
    """``resolve_config``, ``attention_flops`` and the long_500k constants
    of ``src/repro/launch/dryrun.py``, executed from its source with the
    reference's own modules bound to the names they use."""
    path = Path(RT.__file__).resolve().parents[1] / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in ("resolve_config",
                                                              "attention_flops"))
            or (isinstance(n, ast.Assign)
                and all(isinstance(t, ast.Name) and t.id.startswith("LONG_")
                        for t in n.targets))]
    ns = dict(dataclasses=dataclasses, np=np, T=RT, get_config=r_get_config,
              InputShape=RInputShape, ModelConfig=RModelConfig, Optional=Optional)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _ref_flops(rcfg, kind):
    params = jax.eval_shape(lambda: RT.init_params(jax.random.key(0), rcfg))
    shape = RInputShape("t", S, B, kind)
    specs = rinputs.input_specs(rcfg, shape)
    if kind == "train":
        state = jax.eval_shape(lambda: rstreaming.init_state(rcfg.d_model, rcfg.num_classes))
        fn, args = RST.make_analytic_train_step(rcfg), (params, state, specs)
    elif kind == "prefill":
        fn, args = RST.make_prefill_step(rcfg, S), (params, specs)
    else:
        cache = jax.eval_shape(lambda: RT.init_cache(rcfg, B, S))
        fn, args = RST.make_serve_step(rcfg), (params, cache, specs["token"], specs["pos"])
    return HA.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _known_gap(cfg, kind) -> int:
    """walk − reference flops, by design of the port's code:

    - xLSTM: the mLSTM normalizer n·q is an elementwise product and a sum
      in the port (no matmul flops) and an einsum (a dot) in the
      reference: 2·B·H·dh a token of each mLSTM layer;
    - enc-dec: the port's cross-attention projects all of q, k, v and
      drops what it does not use (q of the encoder memory, k and v of the
      decoder's stream), which XLA removes as dead code: 2·rows·d·width
      for each dropped projection, every decoder layer.
    """
    tokens = 1 if kind == "decode" else S
    if cfg.arch_type == "xlstm":
        g, n_groups = cfg.slstm_every, cfg.num_layers // cfg.slstm_every
        mlstm = n_groups * (g - 1) + (cfg.num_layers - n_groups * g)
        dh = 2 * cfg.d_model // cfg.num_heads
        return -2 * B * cfg.num_heads * dh * tokens * mlstm
    if cfg.arch_type == "encdec":
        hd = cfg.resolved_head_dim
        q_mem = 0 if kind == "decode" else 2 * B * min(cfg.encoder_seq, S) * cfg.d_model * (
            cfg.num_heads * hd)
        kv_dec = 2 * 2 * B * tokens * cfg.d_model * (cfg.num_kv_heads * hd)
        return cfg.num_layers * (q_mem + kv_dec)
    return 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_walk_flops_match_reference(arch, kind):
    """Within 1% of the reference's, and equal to it once the named gap is
    taken out."""
    rcfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    want = _ref_flops(rcfg, kind)
    got = DR.step_cost(cfg, InputShape("t", S, B, kind), "baseline",
                       use_kernel=False)["cost"].flops
    assert abs(got - want) <= 0.01 * want or arch == "seamless_m4t_medium", (got, want)
    assert got - _known_gap(cfg, kind) == want


def test_attention_flops_and_resolve_config_match_reference():
    ref = _reference_dryrun_namespace()
    for arch in list_archs():
        for name, shape in INPUT_SHAPES.items():
            for variant in ("baseline", "flash", "flash_pad"):
                rcfg = ref["resolve_config"](arch, R_SHAPES[name], variant)
                cfg = DR.resolve_config(arch, shape, variant)
                assert (rcfg is None) == (cfg is None), (arch, name)
                if cfg is None:
                    continue
                for f in dataclasses.fields(cfg):
                    if f.name not in ("moe", "ssm"):
                        assert getattr(cfg, f.name) == getattr(rcfg, f.name), (arch, f.name)
                assert DR.attention_flops(cfg, shape) == ref["attention_flops"](
                    rcfg, R_SHAPES[name]), (arch, name)
    assert (DR.LONG_WINDOW, DR.LONG_NATIVE, DR.LONG_SKIP) == (
        ref["LONG_WINDOW"], ref["LONG_NATIVE"], ref["LONG_SKIP"])


def _trip_walks(kind: str, mesh_shape) -> list:
    """Reduced xLSTM's ``kind`` step at S = 24 and 32 walked by trip count
    and walked through every trip, on one device (``mesh_shape`` None) or,
    in a process of its own, partitioned on a fake process group of
    ``mesh_shape`` → [(S, per-trip counts, full counts)]."""
    from repro_torch.core import act
    from repro_torch.launch import mesh as M

    cfg = get_config("xlstm_350m").reduced(num_layers=5)
    dm = None if mesh_shape is None else M.fake_device_mesh(
        M.Mesh(tuple(mesh_shape), ("data", "model")), "cpu")
    out = []
    for s in (24, 32):
        shape = InputShape("t", s, 4, kind)
        counts = []
        for trips in (CA.TRIPS, None):
            fn, args, _ = DR.build_step(cfg, shape, "flash")
            if dm is None:
                cost, _ = CA.walk(fn, *args, trips=trips)
            else:
                with act.activation_policy(dm, ("data",), ("model",), flash_surrogate=True):
                    cost, _ = CA.walk(fn, *DR.distribute_step(cfg, shape, args, dm), chips=4,
                                      trips=trips)
            counts.append({f: getattr(cost, f) for f in CA.EXACT})
        out.append((s, *counts))
    return out


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)], ids=["one", "fake_2x2"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_walk_by_trip_count_equals_full_walk(kind, mesh_shape):
    """Reduced xLSTM (two groups and a tail) at S = 24 and 32: the walk
    that runs a scan's first trips and counts the rest as the last one's
    repeat gives every count of a walk through every trip (flops, bytes,
    static and peak bytes, the largest intermediate, ops, and the
    collectives by kind, count and log in order), on one device and as a
    partitioned step on a fake (2, 2) mesh."""
    if mesh_shape is None:
        walks = _trip_walks(kind, None)
    else:
        from repro_torch.core.distributed import run_isolated

        walks = run_isolated(_trip_walks, kind, mesh_shape, timeout=300)
    for s, per_trip, full in walks:
        for f in CA.EXACT:
            assert per_trip[f] == full[f], (s, f)
        assert full["flops"] > 0 and full["peak_bytes"] > full["static_bytes"]
        if mesh_shape is not None:
            assert full["collective_count"] == len(full["collective_log"]) > 0
    assert walks[0][1]["flops"] < walks[1][1]["flops"]


def test_walk_by_trip_count_refuses_trips_that_differ():
    """A scan whose trips do not repeat (a shape that grows) cannot be
    counted by its trip count: the walk raises rather than extrapolate."""
    from repro_torch.core import act

    def grows(t, carry):
        return torch.cat([carry, carry[:1]]), carry.sum()

    def fn(x):
        return act.scan(grows, x, 6)

    with pytest.raises(ValueError, match="trips 1 and 2 differ"):
        CA.walk(fn, torch.empty(4, device="meta"))
    cost, (carry, ys) = CA.walk(fn, torch.empty(4, device="meta"), trips=None)
    assert tuple(carry.shape) == (10,) and tuple(ys.shape) == (6,)


def test_walk_by_trip_count_refuses_a_carry_off_meta():
    """A scan walked by its first trips gives a result right only in its
    shapes: on real tensors the walk raises, and with every trip run it
    gives the loop's own result."""
    from repro_torch.core import act

    def adds(t, carry):
        return carry + t, carry.sum()

    def fn(x):
        return act.scan(adds, x, 6)

    x = torch.zeros(4)
    with pytest.raises(ValueError, match="meta tensors"):
        CA.walk(fn, x, device="cpu")
    _, (carry, ys) = CA.walk(fn, x, device="cpu", trips=None)
    want_carry, want_ys = fn(x)
    assert torch.equal(carry, want_carry) and torch.equal(ys, want_ys)
    _, (carry, ys) = CA.walk(fn, torch.empty(4, device="meta"))
    assert tuple(carry.shape) == (4,) and tuple(ys.shape) == (6,)


def test_walk_bytes_and_live_storage():
    """A matmul reads both operands and writes its result; a view moves
    nothing; a gather reads the rows it gathers; a freed intermediate
    leaves the live count; the largest intermediate is named."""
    a = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, device="meta")
    idx = torch.empty(8, dtype=torch.int64, device="meta")

    def fn(a, w, idx):
        t = a @ w                      # 64·16·4 written, (64·32 + 32·16)·4 read
        v = t.T                        # a view: nothing moved
        r = v.sum()                    # reads 64·16·4, writes 4
        del t, v
        return a[idx], r               # gathers 8 rows of 32 (+ the indices)

    cost, (rows, _) = CA.walk(fn, a, w, idx)
    assert cost.flops == 2 * 64 * 32 * 16
    f = 4
    want = ((64 * 32 + 32 * 16 + 64 * 16) * f
            + (64 * 16 * f + f)
            + (2 * 8 * 32 * f + 8 * 8))
    assert cost.bytes_accessed == want
    assert cost.static_bytes == (64 * 32 + 32 * 16) * f + 8 * 8
    # at most the product and the sum's scalar live at once, or the gather
    assert cost.peak_bytes == cost.static_bytes + 64 * 16 * f + f
    assert cost.peak_aval_bytes == 64 * 16 * f and cost.peak_aval_shape == "float32[64, 16]"
    assert tuple(rows.shape) == (8, 32)


def test_step_cost_static_bytes_are_the_tensors():
    """The dry run's static bytes on the host mesh are the bytes of the
    tensors the step is given (and, for prefill, of the cache it makes)."""
    from repro_torch.core import streaming
    from repro_torch.models import transformer as T

    cfg = get_config("minicpm_2b").reduced()
    for kind in ("train", "prefill", "decode"):
        shape = InputShape("t", S, B, kind)
        out = DR.step_cost(cfg, shape, "flash")
        params = T.init_params(cfg, device="meta")
        want = {"params": CA.storage_bytes(params)}
        if kind == "train":
            want["state"] = CA.storage_bytes(streaming.init_state(cfg.d_model,
                                                                 cfg.num_classes,
                                                                 device="meta"))
            want["batch"] = (B * S + B) * 4
        elif kind == "prefill":
            want["cache"] = CA.storage_bytes(T.init_cache(cfg, B, S, device="meta"))
            want["batch"] = B * S * 4
        else:
            want["cache"] = CA.storage_bytes(T.init_cache(cfg, B, S, device="meta"))
            want["batch"] = B * 4
        assert out["static"] == want, kind
        assert out["attn_flops"] == DR.attention_flops(cfg, shape) > 0


# --------------------------------------------- collectives of a partitioned step
def _dtensor_walks(device_type: str) -> dict:
    """In a process of its own: small DTensor programs on a fake (2, 2)
    ('data', 'model') mesh of ``device_type``, walked and counted."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH

    dm = M.fake_device_mesh(M.Mesh((2, 2), ("data", "model")), device_type)
    x = SH.distribute(torch.empty(8, 64, device="meta"), [Shard(0), Shard(1)], dm)
    w = SH.distribute(torch.empty(64, 32, device="meta"), [Replicate(), Shard(0)], dm)

    def row_parallel(x, w):          # a Partial over 'model', then replicated
        return (x @ w).redistribute(dm, [Shard(0), Replicate()])

    def move(x):                     # the 'model' split from dim 1 to dim 0
        return x.redistribute(dm, [Replicate(), Shard(0)])

    y = SH.distribute(torch.empty(8, 64, device="meta"), [Replicate(), Shard(1)], dm)

    def replicated(w):               # every rank the whole product
        r = w.redistribute(dm, [Replicate(), Replicate()])
        return r.T @ r

    out = {}
    for name, fn, args in (("row_parallel", row_parallel, (x, w)), ("move", move, (y,)),
                           ("replicated", replicated, (w,))):
        cost, _ = CA.walk(fn, *args, chips=4)
        capped, _ = CA.walk(fn, *args, width_cap=2, chips=4)
        counted, _ = CA.count_collectives(fn, *args)
        out[name] = dict(flops=cost.flops, replicated=cost.replicated,
                         bytes=cost.collective_bytes, count=cost.collective_count,
                         capped=capped.collective_bytes,
                         log=[x[0] for x in cost.collective_log],
                         counted=[x[0] for x in counted.collective_log],
                         static=cost.static_bytes)
    return out


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_walk_counts_dtensor_collectives(device_type):
    """The walk counts rank 0's local ops of DTensor programs: its share of
    a product's flops, the collectives DTensor issues by the reference's
    kinds (an all-gather and an all-reduce count their result, an all-to-all
    its operand, each element at most ``width_cap`` bytes), the flops ranks
    repeat by op, and ``count_collectives`` sees the same collectives."""
    from repro_torch.core.distributed import run_isolated

    r = run_isolated(_dtensor_walks, device_type, timeout=300)
    rp = r["row_parallel"]
    # rank 0: x (4, 32) @ w (32, 32), then its (4, 32) partial all-reduced
    assert rp["flops"] == 2 * 4 * 32 * 32 and rp["log"] == ["all-reduce"]
    assert rp["bytes"]["all-reduce"] == 4 * 32 * 4 and rp["capped"]["all-reduce"] == 4 * 32 * 2
    assert rp["count"] == 1 and rp["counted"] == rp["log"]
    assert rp["replicated"] == {}
    assert rp["static"] == (4 * 32 + 32 * 32) * 4
    mv = r["move"]
    if device_type == "cuda":    # one all-to-all of rank 0's (8, 32) block
        assert mv["log"] == ["all-to-all"] and mv["bytes"]["all-to-all"] == 8 * 32 * 4
    else:                        # a CPU mesh: an all-gather (8, 64) and a chunk
        assert mv["log"] == ["all-gather"] and mv["bytes"]["all-gather"] == 8 * 64 * 4
    assert mv["counted"] == mv["log"] and mv["flops"] == 0
    rep = r["replicated"]
    # every rank computes the whole (32, 32) product: 3 of 4 repeat it
    assert rep["flops"] == 2 * 32 * 64 * 32
    assert rep["replicated"] == {"mm": 3 * 2 * 32 * 64 * 32}
    assert rep["log"] == ["all-gather"] * len(rep["log"]) and rep["log"]
