"""The partitioned steps on real ranks: gloo on the CPU, a (2, 2)
('data', 'model') mesh.

The counterpart of ``tests/test_multidevice.py``'s mesh tests, with four
processes as the ranks (``core.distributed.run_ranks``, one spawn per
scenario, each under a time limit so that a hung rank fails the test):

  * the port's explicit-collective MoE FFN (``_ffn_shard_map``) against the
    reference's ``moe_apply`` dense path on one device, on the reference's
    weights (1e-5, aux 1e-6), issuing exactly one all-reduce over 'model'
    of the rank's (ng/fsdp)·g·d token elements;
  * reduced granite's partitioned analytic train step against the
    reference's single-device ``make_analytic_train_step`` on its weights
    (relative 5e-5, the count exact), its state taking exactly one
    all-reduce over 'data' of d² + d·C + 1 values (the AA law as one
    collective), then its prefill and four greedy decode steps against the
    port's one-rank steps (logits within 1e-3 of a row's largest |logit|,
    the same tokens);
  * the same for reduced minicpm, its weights drawn on every rank from one
    seed and kept layer by layer (``launch.sharding.distributed_params``);
  * every step's collectives on the ranks equal, op for op, rank 0's steps
    walked on a fake process group of the same mesh (``launch.partitioned
    .predict``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as RefMoEConfig
from repro.configs.registry import get_config as ref_get_config
from repro.core import streaming as RS
from repro.launch import inputs as RI
from repro.launch import steps as RST
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.config import MoEConfig
from repro_torch.core.distributed import run_isolated, run_ranks
from repro_torch.kernels import build
from repro_torch.launch import partitioned as P
from repro_torch.models.convert import params_from_jax

MESH = ((2, 2), ("data", "model"))
TIMEOUT = 300.0


def _ranks(fn, *args):
    return run_ranks(fn, *MESH, device="cpu", args=args, timeout=TIMEOUT)


def _rel_rows(a, b) -> float:
    """Largest |a − b| of a row over that row's largest |b|."""
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def test_shard_map_moe_matches_reference_dense():
    moe = dict(num_experts=4, top_k=2, capacity_factor=2.0, group_size=16)
    d, ff = 32, 64
    p_ref = RM.init_moe(jax.random.key(0), d, ff, RefMoEConfig(**moe), "swiglu", jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, 32, d), jnp.float32))
    ref, aux_ref = RM.moe_apply(p_ref, jnp.asarray(x), RefMoEConfig(**moe), "swiglu")
    p_np = {k: np.asarray(v) for k, v in p_ref.items()}
    ranks = _ranks(P.moe_rank_main, p_np, x, MoEConfig(**moe), "swiglu")
    for r in ranks:
        np.testing.assert_array_less(np.abs(r["out"].numpy() - np.asarray(ref)).max(), 1e-5)
        assert abs(float(r["aux"]) - float(aux_ref)) < 1e-6
        # the FFN's one collective: the combined tokens over 'model'
        over_model = [c for c in r["collectives"] if c[:2] == ("all-reduce", "model")]
        ng, g, fsdp = 4 * 32 // 16, 16, 2
        assert over_model == [("all-reduce", "model", ng // fsdp * g * d,
                               4 * ng // fsdp * g * d, "moe_ffn")]


def _granite():
    return dict(num_classes=8)


def test_partitioned_granite_steps_match_reference_and_one_rank():
    plan = P.Plan("granite_moe_3b_a800m", reduced=_granite(), batch=8, seq=32, decode=4)
    rcfg = ref_get_config("granite_moe_3b_a800m").reduced(**_granite())
    p_ref = RT.init_params(jax.random.key(0), rcfg)
    batch = RI.sample_batch(rcfg, 8, 32, seed=0)
    ref = RST.make_analytic_train_step(rcfg)(
        p_ref, RS.init_state(rcfg.d_model, rcfg.num_classes), batch)
    p_np = jax.tree.map(np.asarray, p_ref)
    data = {k: np.asarray(v) for k, v in batch.items()}
    ranks = _ranks(P.rank_main, plan, "cpu", p_np, data)
    cfg = plan.config()
    d, c = cfg.d_model, cfg.num_classes
    g_ref = np.asarray(ref.gram)
    for r in ranks:
        st = r["state"]
        err = np.abs(st["gram"].numpy() - g_ref).max() / max(np.abs(g_ref).max(), 1)
        assert err < 5e-5, err
        m_ref = np.asarray(ref.moment)
        assert np.abs(st["moment"].numpy() - m_ref).max() / max(np.abs(m_ref).max(), 1) < 5e-5
        assert float(st["count"]) == float(ref.count) == 8
        # the AA law as one collective: the packed state over 'data', last
        train = r["steps"]["train"]["collectives"]
        packed = [x for x in train if x[4] == "gram_fold"]
        assert packed == [("all-reduce", "data", d * d + d * c + 1, 4 * (d * d + d * c + 1),
                           "gram_fold")]
        assert train[-1] == packed[0]
        # each MoE layer's one collective: its tokens over 'model'
        moe = [x for x in train if x[4] == "moe_ffn"]
        tokens = 8 * 32
        assert moe == [("all-reduce", "model", tokens // 2 * d, 4 * tokens // 2 * d,
                        "moe_ffn")] * cfg.num_layers
    one = P.one_rank_steps(plan, device="cpu",
                           params=params_from_jax(p_np, cfg, device="cpu"), data=data)
    for r in ranks:
        assert len(r["logits"]) == 5
        for a, b in zip(r["logits"], one["logits"]):
            assert _rel_rows(a, b) < 1e-3
        assert all(torch.equal(a, b) for a, b in zip(r["tokens"], one["tokens"]))
    pred = run_isolated(P.predict, [plan], *MESH, "cpu", timeout=TIMEOUT)[0]
    for name, step in pred["steps"].items():
        for r in ranks:     # every rank issues rank 0's collectives
            got = r["steps"][name]
            assert [tuple(c) for c in step["collectives"]] == \
                [tuple(c) for c in got["collectives"]], name
            assert got["comm_debug"] == len(got["collectives"]), name


def test_partitioned_minicpm_prefill_decode_match_one_rank():
    plan = P.Plan("minicpm_2b", reduced=dict(num_classes=8), batch=8, seq=32, decode=4)
    ranks = _ranks(P.rank_main, plan, "cpu")
    one = P.one_rank_steps(plan, device="cpu")
    cfg = plan.config()
    d, c = cfg.d_model, cfg.num_classes
    for r in ranks:
        for a, b in zip(r["logits"], one["logits"]):
            assert _rel_rows(a, b) < 1e-3
        assert all(torch.equal(a, b) for a, b in zip(r["tokens"], one["tokens"]))
        g = one["state"]["gram"]
        assert float((r["state"]["gram"] - g).abs().max() / g.abs().max()) < 5e-5
        assert float(r["state"]["count"]) == 8
        packed = [x for x in r["steps"]["train"]["collectives"] if x[4]]
        assert packed == [("all-reduce", "data", d * d + d * c + 1, 4 * (d * d + d * c + 1),
                           "gram_fold")]
    pred = run_isolated(P.predict, [plan], *MESH, "cpu", timeout=TIMEOUT)[0]
    for name, step in pred["steps"].items():
        assert [tuple(x) for x in step["collectives"]] == \
            [tuple(x) for x in ranks[0]["steps"][name]["collectives"]], name
        # the walk's count is the ranks' count, and its bytes add up by kind
        cost = step["cost"]
        assert cost["collective_count"] == len(step["collectives"])
        for kind, total in cost["collective_bytes"].items():
            assert total == sum(x[3] for x in step["collectives"] if x[0] == kind)


# the families with recurrences or an encoder: at five layers the hybrid
# and xLSTM stacks have two groups and a tail
FAMILIES = ["xlstm_350m", "zamba2_7b", "seamless_m4t_medium"]
FAMILY_LAYERS = 5
# the reference's sLSTM scan body holds 7 collectives a trip (its HLO on
# four forced CPU devices): the most a partitioned step may add a token
SLSTM_TRIP_COLLECTIVES = 7


def _local_scans(cfg, batch: int) -> dict:
    """The carry shapes each recurrence should have on a rank of the (2, 2)
    mesh: the batch over 'data', the heads over 'model'."""
    b, heads = batch // 2, cfg.num_heads // 2
    if cfg.arch_type == "xlstm":
        dh = 2 * cfg.d_model // cfg.num_heads
        return {"mlstm": ((b, heads, dh, dh), (b, heads, dh), (b, heads)),
                "slstm": ((b, heads, dh),) * 3 + ((b, heads),)}
    if cfg.arch_type == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        nh = cfg.ssm.num_heads
        return {"ssd": ((b, nh // 2, cfg.ssm.d_state, d_inner // nh),)}
    return {}


@pytest.mark.parametrize("arch", FAMILIES)
def test_partitioned_family_steps_split_the_work(arch):
    """xLSTM, zamba2 and seamless partitioned as the reference partitions
    them, on four gloo ranks: the train step equals the reference's
    single-device one on its weights (relative 5e-5, the count exact),
    prefill and four decode steps the port's one rank (1e-3 of a row's
    largest, the same tokens), every rank's collectives the fake process
    group's walk op for op; each recurrence's carry is the rank's shard
    (batch over 'data', heads over 'model'); 4 × rank 0's walked flops over
    the one-device walk's is at most 1.01 in the train and prefill steps
    (no rank repeats another's work); and the recurrences' loops issue no
    collective: the mLSTM and sLSTM regions none, the Mamba2 region one
    all-gather of B and C a layer, the steps' counts the same at S = 16
    and 32 within the reference's 7 a trip of each sLSTM layer."""
    over = dict(num_classes=8, num_layers=FAMILY_LAYERS)
    plan = P.Plan(arch, reduced=over, batch=8, seq=32, decode=4)
    short = P.Plan(arch, reduced=over, batch=8, seq=16, decode=1)
    rcfg = ref_get_config(arch).reduced(**over)
    p_ref = RT.init_params(jax.random.key(0), rcfg)
    batch = RI.sample_batch(rcfg, 8, 32, seed=0)
    ref = RST.make_analytic_train_step(rcfg)(
        p_ref, RS.init_state(rcfg.d_model, rcfg.num_classes), batch)
    p_np = jax.tree.map(np.asarray, p_ref)
    data = {k: np.asarray(v) for k, v in batch.items()}
    ranks = _ranks(P.rank_main, plan, "cpu", p_np, data)
    cfg = plan.config()
    g_ref, m_ref = np.asarray(ref.gram), np.asarray(ref.moment)
    one = P.one_rank_steps(plan, device="cpu",
                           params=params_from_jax(p_np, cfg, device="cpu"), data=data)
    want_scans = _local_scans(cfg, plan.batch)
    for r in ranks:
        st = r["state"]
        assert np.abs(st["gram"].numpy() - g_ref).max() / np.abs(g_ref).max() < 5e-5
        assert np.abs(st["moment"].numpy() - m_ref).max() / np.abs(m_ref).max() < 5e-5
        assert float(st["count"]) == float(ref.count) == 8
        assert len(r["logits"]) == 5
        for a, b in zip(r["logits"], one["logits"]):
            assert _rel_rows(a, b) < 1e-3
        assert all(torch.equal(a, b) for a, b in zip(r["tokens"], one["tokens"]))
        for name in ("train", "prefill"):
            assert set(r["steps"][name]["scans"]) == set(want_scans.items()), name
    pred, pred_short = run_isolated(P.predict, [plan, short], *MESH, "cpu", whole=True,
                                    timeout=TIMEOUT)
    for name, step in pred["steps"].items():
        for r in ranks:
            got = r["steps"][name]
            assert [tuple(c) for c in step["collectives"]] == \
                [tuple(c) for c in got["collectives"]], name
            assert got["comm_debug"] == len(got["collectives"]), name
    ratio = P.repeated_work(pred, 4)
    n_slstm = cfg.num_layers // cfg.slstm_every if cfg.arch_type == "xlstm" else 0
    n_mamba = (cfg.num_layers - cfg.num_layers // cfg.shared_attn_every
               if cfg.arch_type == "hybrid" else 0)
    for name in ("train", "prefill"):
        assert ratio[name] <= 1.01, (name, ratio)
        log = pred["steps"][name]["collectives"]
        assert [c for c in log if c[4] in ("mlstm", "slstm")] == [], name
        assert [c[:2] for c in log if c[4] == "mamba"] == [("all-gather", "model")] * n_mamba
        grown = len(log) - len(pred_short["steps"][name]["collectives"])
        assert abs(grown) <= SLSTM_TRIP_COLLECTIVES * n_slstm * (plan.seq - short.seq), name


def test_plan_layers_cut_depth_only():
    cfg = P.Plan("zamba2_7b", layers=15).config()
    full = P.Plan("zamba2_7b").config()
    assert cfg.num_layers == 15 and cfg.d_model == full.d_model == 3584
    assert cfg == dataclasses.replace(full, num_layers=15)
    from repro_torch.models import transformer as T

    assert T._hybrid_split(cfg) == (6, 2, 3)   # two groups of five Mamba2 layers, a tail of 3
    reduced = P.Plan("xlstm_350m", reduced={}, layers=5).config()
    assert reduced.num_layers == 5 and reduced.d_model == 128


def _hang(rank, device_mesh):
    import time

    if rank == 1:
        time.sleep(60)
    return rank


def _fail(rank, device_mesh):
    if rank == 2:
        raise ValueError("rank two fails")
    import torch.distributed as dist

    dist.barrier()
    return rank


def test_run_ranks_raises_a_failing_or_hung_rank():
    with pytest.raises(RuntimeError, match="rank 2 of 4 failed(.|\n)*rank two fails"):
        run_ranks(_fail, *MESH, device="cpu", timeout=120)
    with pytest.raises(TimeoutError, match=r"ranks \[.*1.*\] of 4 overran"):
        run_ranks(_hang, *MESH, device="cpu", timeout=15)


def test_dtensor_refused_by_kernel_wrappers():
    """A DTensor that reaches a kernel's entry point raises TypeError before
    any pointer is read (one rank, a fake process group)."""
    out = run_isolated(_dtensor_to_kernels, timeout=TIMEOUT)
    assert out == ["TypeError"] * 2


def _dtensor_to_kernels():
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M

    dm = M.fake_device_mesh(M.Mesh((1, 1), ("data", "model")), "cpu")
    q = distribute_tensor(torch.zeros(1, 2, 4, 8), dm, [Replicate(), Replicate()])
    x = distribute_tensor(torch.zeros(4, 8), dm, [Replicate(), Replicate()])
    out = []
    for call in (lambda: ops.flash_attention(q, q, q), lambda: ops.gram_update(x, x)):
        try:
            call()
            out.append("returned")
        except TypeError:
            out.append("TypeError")
    return out


def test_reject_dtensor_passes_plain_tensors():
    build.reject_dtensor("k", torch.zeros(2), None)


def _collectives(rank, device_mesh, shared):
    """Each collective a partitioned step issues, on rank-seeded tensors, by
    the mesh's collective path (funcol over 'data' and over 'model')."""
    from torch.distributed import _functional_collectives as funcol

    def done(t):
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t

    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(rank))
    out = {}
    for dim, axis in enumerate(device_mesh.mesh_dim_names):
        g = (device_mesh, dim)
        out[f"all_reduce/{axis}"] = done(funcol.all_reduce(x, "sum", g))
        out[f"all_gather/{axis}"] = done(funcol.all_gather_tensor(x, 0, g))
        out[f"reduce_scatter/{axis}"] = done(funcol.reduce_scatter_tensor(x, "sum", 0, g))
        out[f"all_to_all/{axis}"] = done(funcol.all_to_all_single(x, None, None, g))
        name = funcol._resolve_group_name(g)
        if shared:   # DTensor's own op on a CUDA mesh
            y = torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, name)
        else:        # what it computes: gathered on dim 0, this rank's dim-1 half
            y = out[f"all_gather/{axis}"].chunk(2, 1)[device_mesh.get_local_rank(dim)]
        out[f"shard_dim_alltoall/{axis}"] = y.contiguous()
    return out


def test_shared_collective_path_equals_gloo():
    """The path of ranks that share a device (buffers each rank maps,
    ``core.distributed.share_collectives``; shared memory here, CUDA IPC on
    a card) gives gloo's results bit for bit, sums in group rank order."""
    gloo = run_ranks(_collectives, *MESH, device="cpu", args=(False,), timeout=TIMEOUT)
    shared = run_ranks(_collectives, *MESH, device="cpu", backend="shared", args=(True,),
                       timeout=TIMEOUT)
    for a, b in zip(gloo, shared):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
