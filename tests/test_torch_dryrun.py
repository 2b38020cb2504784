"""The port's dry run: abstract inputs, meta parameters and the CLI.

``repro_torch.launch.inputs``' abstract specs against the reference's
``ShapeDtypeStruct``s for every arch × input shape; ``init_params`` on the
meta device against a CPU draw (the same tree of shapes and dtypes); and
``python -m repro_torch.launch.dryrun``'s ``main`` on the CPU: an ``ok``
record for one arch of each family, the pod meshes' records, and the
documented skip (seamless at long_500k).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import INPUT_SHAPES as R_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.launch import inputs as rinputs

from repro_torch.config import INPUT_SHAPES
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
    """On the pod meshes the static bytes follow the rules, flops divide by
    the chips and the collective term is null with its reason; seamless at
    long_500k is the documented skip."""
    DR.main(["--arch", "minicpm_2b", "--shape", "decode_32k", "--mesh", "all",
             "--variant", "flash", "--out", str(tmp_path)])
    recs = {m: json.loads((tmp_path / f"minicpm_2b__decode_32k__{m}__flash.json").read_text())
            for m in DR.MESHES}
    one = recs["one"]
    for m, chips in (("single", 256), ("multi", 512)):
        r = recs[m]
        assert r["ok"] and r["chips"] == chips
        assert r["flops_global"] == one["flops_global"]
        assert r["flops_per_device"] == one["flops_global"] / chips
        assert r["collectives"] == {"total": None, "reason": DR.NO_PARTITIONER}
        assert r["roofline"]["collective_s"] is None
        static = r["memory"]["static_bytes_per_device"]
        assert static["params"] < one["memory"]["static_bytes_per_device"]["params"]
        assert static["cache"] == one["memory"]["static_bytes_per_device"]["cache"] // chips
    DR.main(["--arch", "seamless_m4t_medium", "--shape", "long_500k", "--mesh", "one",
             "--variant", "flash", "--out", str(tmp_path)])
    skip = json.loads((tmp_path / "seamless_m4t_medium__long_500k__one__flash.json").read_text())
    assert not skip["ok"] and "inapplicable" in skip["skipped"]
    assert "[skip]" in capsys.readouterr().out
