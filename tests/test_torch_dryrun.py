"""The port's dry run: abstract inputs, meta parameters and the CLI.

``repro_torch.launch.inputs``' abstract specs against the reference's
``ShapeDtypeStruct``s for every arch × input shape; ``init_params`` on the
meta device against a CPU draw (the same tree of shapes and dtypes); and
``python -m repro_torch.launch.dryrun``'s ``main`` on the CPU: an ``ok``
record for one arch of each family, the pod meshes' records, and the
documented skip (seamless at long_500k). On the pod meshes each step is
partitioned (DTensors on a fake process group, rank 0's walk): the
collectives are counted by kind, the AA law is one all-reduce over the
federation axes, each MoE layer one all-reduce over 'model', the static
bytes are the rules' ``sharded_bytes``, and the chips' flops less the
named replicated terms are the one-device walk's.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import INPUT_SHAPES as R_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.launch import inputs as rinputs

from repro_torch.config import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import inputs
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.optim import tree_leaves

FAMILY_ARCHS = ["minicpm_2b", "granite_moe_3b_a800m", "zamba2_7b", "xlstm_350m",
                "seamless_m4t_medium"]


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        for rdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = rinputs.input_specs(r_get_config(arch), R_SHAPES[name], dtype=rdt)
            got = inputs.input_specs(get_config(arch), shape, dtype=dt)
            assert list(got) == list(want), (arch, name)
            for k, spec in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(spec.shape), (arch, name, k)
                assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype), (arch, k)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_init_params_matches_cpu(arch):
    """The same tree, shapes and dtypes as a CPU draw; no storage; a CPU
    draw after a meta one is the same as before it (the meta init draws
    nothing)."""
    cfg = get_config(arch).reduced()
    cpu = T.init_params(cfg, seed=3, device="cpu")
    meta = T.init_params(cfg, seed=3, device="meta")
    again = T.init_params(cfg, seed=3, device="cpu")
    c, m, a = tree_leaves(cpu), tree_leaves(meta), tree_leaves(again)
    assert len(c) == len(m) > 0
    for x, y, z in zip(c, m, a):
        assert y.device.type == "meta"
        assert (y.shape, y.dtype) == (x.shape, x.dtype)
        assert torch.equal(x, z)
    bf16 = T.init_params(get_config(arch).reduced(dtype="bfloat16"), device="meta")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf16) if t.is_floating_point()
               and t.dim() >= 2)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cli_writes_ok_record(arch, tmp_path, capsys):
    DR.main(["--arch", arch, "--shape", "decode_32k", "--mesh", "one", "--variant", "flash",
             "--out", str(tmp_path)])
    rec = json.loads((tmp_path / f"{arch}__decode_32k__one__flash.json").read_text())
    assert rec["ok"] and rec["chips"] == 1
    mem, roof = rec["memory"], rec["roofline"]
    assert set(mem["static_bytes_per_device"]) == {"params", "cache", "batch"}
    assert mem["peak_bytes_per_device"] >= sum(mem["static_bytes_per_device"].values())
    assert mem["fits"] == (mem["peak_bytes_per_device"] <= M.HBM_BYTES)
    assert rec["collectives"]["total"] == 0.0 and roof["collective_s"] == 0.0
    assert rec["flops_per_device"] == rec["flops_global"] > 0
    assert rec["attn_flops_global"] == DR.attention_flops(
        DR.resolve_config(arch, INPUT_SHAPES["decode_32k"], "flash"), INPUT_SHAPES["decode_32k"])
    assert roof["dtype"] == "bfloat16" and roof["dominant"] in ("compute", "memory")
    np.testing.assert_allclose(roof["compute_s"], rec["flops_global"] / 989e12)
    np.testing.assert_allclose(roof["memory_s"], rec["bytes_global"] / 3.35e12)
    assert "[ ok ]" in capsys.readouterr().out


def test_cli_pod_meshes_and_skip(tmp_path, capsys):
    """On the pod meshes the step is partitioned: static bytes follow the
    rules, the chips' flops less the replicated terms are the one-device
    walk's, and the collectives are counted by kind with a roofline term;
    seamless at long_500k is the documented skip."""
    DR.main(["--arch", "minicpm_2b", "--shape", "decode_32k", "--mesh", "all",
             "--variant", "flash", "--out", str(tmp_path)])
    recs = {m: json.loads((tmp_path / f"minicpm_2b__decode_32k__{m}__flash.json").read_text())
            for m in DR.MESHES}
    one = recs["one"]
    assert one["collectives"]["total"] == 0 and one["collectives"]["count"] == 0
    for m, chips in (("single", 256), ("multi", 512)):
        r = recs[m]
        assert r["ok"] and r["chips"] == chips
        assert r["flops_global"] == r["flops_per_device"] * chips
        np.testing.assert_allclose(
            r["flops_global"] - sum(r["replicated_flops"].values()), one["flops_global"],
            rtol=1e-9)
        coll = r["collectives"]
        assert "reason" not in coll and coll["count"] > 0
        assert coll["total"] == sum(coll[k] for k in COLLECTIVE_KINDS) > 0
        np.testing.assert_allclose(r["roofline"]["collective_s"], coll["total"] / M.NVLINK_BW)
        static = r["memory"]["static_bytes_per_device"]
        assert static["params"] < one["memory"]["static_bytes_per_device"]["params"]
        assert static["cache"] == one["memory"]["static_bytes_per_device"]["cache"] // chips
    DR.main(["--arch", "seamless_m4t_medium", "--shape", "long_500k", "--mesh", "one",
             "--variant", "flash", "--out", str(tmp_path)])
    skip = json.loads((tmp_path / "seamless_m4t_medium__long_500k__one__flash.json").read_text())
    assert not skip["ok"] and "inapplicable" in skip["skipped"]
    assert "[skip]" in capsys.readouterr().out


COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
SMALL_TRAIN = InputShape("train_small", 256, 64, "train")


def _pod_walks(mesh_name: str) -> list:
    """In a process of its own (one fake process group): the train step of
    minicpm, granite and grok1, reduced and at full width, walked on the
    pod mesh and on one device → what the test checks."""
    from repro_torch.launch import partitioned as PT

    mesh = M.make_production_mesh(multi_pod=mesh_name == "multi")
    out = []
    for arch in ("minicpm_2b", "granite_moe_3b_a800m", "grok1_314b"):
        for reduced in (True, False):
            cfg = get_config(arch)
            cfg = (cfg.reduced(dtype="bfloat16") if reduced
                   else dataclasses.replace(cfg, dtype="bfloat16"))
            pod = DR.step_cost(cfg, SMALL_TRAIN, "flash", mesh)
            one = DR.step_cost(cfg, SMALL_TRAIN, "flash", M.make_host_mesh())
            groups = PT.axis_groups(M.fake_device_mesh(mesh))
            c = pod["cost"]
            out.append(dict(
                arch=arch, reduced=reduced, layers=cfg.num_layers, d=cfg.d_model,
                classes=cfg.num_classes, moe=cfg.moe is not None,
                flops=c.flops, replicated=c.replicated, global_flops=one["cost"].flops,
                static_walk=c.static_bytes, static_rules=sum(pod["static"].values()),
                bytes=c.collective_bytes, total=c.collective_total,
                count=c.collective_count,
                log=[(k, "+".join(groups.get(g, (g,))), n, b, r)
                     for k, g, n, b, r in c.collective_log]))
    return out


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_pod_mesh_steps_are_partitioned(mesh_name):
    from repro_torch.core.distributed import run_isolated

    mesh = M.make_production_mesh(multi_pod=mesh_name == "multi")
    chips = M.num_chips(mesh)
    fed = "+".join(M.batch_axes(mesh))
    fsdp = chips // 16
    recs = run_isolated(_pod_walks, mesh_name, timeout=600)
    assert len(recs) == 6
    for r in recs:
        what = f"{r['arch']} reduced={r['reduced']} on {mesh_name}"
        # collectives by kind, non-null
        assert r["count"] == len(r["log"]) > 0, what
        assert r["total"] == sum(r["bytes"].values()) > 0, what
        for kind in r["bytes"]:
            assert r["bytes"][kind] == sum(x[3] for x in r["log"] if x[0] == kind), what
        # the AA law: one all-reduce over the federation axes, the step's
        # last (f32 counted at the bf16 model's 2 bytes, the reference's cap)
        d, c = r["d"], r["classes"]
        fold = [x for x in r["log"] if x[4] == "gram_fold"]
        assert fold == [("all-reduce", fed, d * d + d * c + 1, 2 * (d * d + d * c + 1),
                         "gram_fold")], what
        assert r["log"][-1] == fold[0], what
        # each MoE layer: its rank's tokens over 'model', once (bf16, 2 bytes)
        moe = [x for x in r["log"] if x[4] == "moe_ffn"]
        tokens = SMALL_TRAIN.global_batch * SMALL_TRAIN.seq_len // fsdp
        want = [("all-reduce", "model", tokens * d, 2 * tokens * d, "moe_ffn")]
        assert moe == (want * r["layers"] if r["moe"] else []), what
        # static residency: the rules' sharded bytes
        assert r["static_walk"] == r["static_rules"], what
        # the chips' flops: the global walk's plus the named replicated terms
        assert r["flops"] * chips >= r["global_flops"], what
        assert all(v > 0 for v in r["replicated"].values()), what
        np.testing.assert_allclose(r["flops"] * chips - sum(r["replicated"].values()),
                                   r["global_flops"], rtol=1e-9, err_msg=what)


def _record(arch: str, shape: str, mesh_name: str, before: str) -> dict:
    """``arch``'s record of a cell walked in a process that walked
    ``before``'s at the same shape first."""
    DR.run_one(before, shape, mesh_name, "flash")
    rec = DR.run_one(arch, shape, mesh_name, "flash")
    rec.pop("walk_s", None)
    return rec


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_xlstm_pod_cells_walk_by_trip_count(mesh_name, tmp_path, capsys):
    """Every xLSTM cell of a pod mesh gives an ``ok`` record through the
    CLI (its per-token loops walked by trip count, at full length), each
    recurrence on its rank's batch shard, and another fresh process gives
    the same record, though it walked minicpm's train step first: what
    a process walked before cannot change a record (the flattened
    federation dim, which DTensor's collectives take once it exists, is
    made with the mesh)."""
    from repro_torch.core.distributed import run_isolated

    DR.main(["--arch", "xlstm_350m", "--shape", "all", "--mesh", mesh_name,
             "--variant", "flash", "--out", str(tmp_path)])
    assert "[FAIL]" not in capsys.readouterr().out
    for name, shape in INPUT_SHAPES.items():
        rec = json.loads((tmp_path / f"xlstm_350m__{name}__{mesh_name}__flash.json").read_text())
        assert rec["ok"], (name, rec.get("error"))
        assert rec["collectives"]["count"] > 0 and rec["flops_per_device"] > 0, name
        if shape.kind != "decode":
            # the mLSTM region: its rank's batch, every head (4 on a 16-wide
            # 'model' axis do not divide), the state at the local batch
            assert rec["replicated_flops"]["region:mlstm"] > 0, name
            assert not rec["memory"]["peak_aval_shape"].startswith(
                f"float32[{shape.global_batch}, 4,"), name
    again = run_isolated(_record, "xlstm_350m", "train_4k", mesh_name, "minicpm_2b",
                         timeout=600)
    first = json.loads((tmp_path / f"xlstm_350m__train_4k__{mesh_name}__flash.json").read_text())
    first.pop("walk_s")
    assert again == first
