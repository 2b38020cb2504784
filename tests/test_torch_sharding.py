"""The port's sharding rules and activation policy against the JAX package's.

``repro_torch.launch.sharding`` against ``repro.launch.sharding`` on the
reference's production meshes, as abstract meshes (no devices): the
parameter specs of every registry arch leaf by leaf, the batch, state and
cache specs of every input shape, and the per-device static bytes they
give; ``repro_torch.core.act`` against ``repro.core.act`` (the reference's
constraint captured by patching ``jax.lax.with_sharding_constraint`` inside
the test); ``to_placements`` and ``constrain`` on a DTensor over a
world-size-1 gloo mesh. ``repro.launch.dryrun`` is never imported: it sets
``XLA_FLAGS`` when imported.
"""

import dataclasses
import math
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.config import INPUT_SHAPES as R_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.core import act as ract
from repro.core import streaming as rstreaming
from repro.launch import inputs as rinputs
from repro.launch import sharding as RSH
from repro.models import transformer as RT

from repro_torch.config import INPUT_SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import act, streaming
from repro_torch.launch import inputs, mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as T

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), M.Mesh(sizes, axes)


def _norm(spec) -> tuple:
    """A PartitionSpec's or a port spec's entries, each a tuple of axis
    names or None (a lone name as a 1-tuple)."""
    return tuple((e,) if isinstance(e, str) else (tuple(e) if e else None)
                 for e in spec)


def _bf16(arch):
    return (dataclasses.replace(r_get_config(arch), dtype="bfloat16"),
            dataclasses.replace(get_config(arch), dtype="bfloat16"))


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _ref_at(tree, path):
    for k in path:
        if isinstance(k, str):
            tree = tree[k]
    return tree


def _ref_at_port(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_bytes(shapes, specs, mesh) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(l.shape)) * l.dtype.itemsize
               for l, s in zip(leaves, spec_leaves))


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch):
    """Every leaf's spec is the reference's without its stacking entries
    (one a list index on the port's path), on both production meshes; the
    per-device parameter bytes are the reference's."""
    rcfg, cfg = _bf16(arch)
    r_params = jax.eval_shape(lambda: RT.init_params(jax.random.key(0), rcfg))
    params = T.init_params(cfg, device="meta")
    for name in MESHES:
        rmesh, mesh = _meshes(name)
        r_specs = RSH.param_specs(r_params, rmesh)
        specs = SH.param_specs(params, mesh)
        n = 0
        for path, leaf in _port_leaves(params):
            stack = sum(isinstance(k, int) for k in path)
            want = _norm(_ref_at(r_specs, path))[stack:]
            got = _norm(_ref_at_port(specs, path))
            assert got == want, (name, path, got, want)
            assert tuple(leaf.shape) == tuple(_ref_at(r_params, path).shape)[stack:]
            n += 1
        assert n > 0
        assert SH.sharded_bytes(params, specs, mesh) == _ref_bytes(r_params, r_specs, rmesh)


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_batch_state_cache_specs_match_reference(shape_name):
    """Batch specs of every arch's inputs, the state's and the decode
    cache's (at the shape's batch, a short cache so the sequence-dim rule
    and the batch rule both show) equal the reference's on both meshes,
    with equal per-device bytes."""
    r_shape, shape = R_SHAPES[shape_name], INPUT_SHAPES[shape_name]
    for arch in list_archs():
        rcfg, cfg = _bf16(arch)
        r_in = rinputs.input_specs(rcfg, r_shape, dtype=jnp.bfloat16)
        p_in = inputs.input_specs(cfg, shape, dtype=torch.bfloat16)
        r_cache = jax.eval_shape(lambda: RT.init_cache(rcfg, r_shape.global_batch, 2048))
        p_cache = T.init_cache(cfg, shape.global_batch, 2048, device="meta")
        for name in MESHES:
            rmesh, mesh = _meshes(name)
            rb, pb = RSH.batch_specs(rcfg, r_in, rmesh), SH.batch_specs(cfg, p_in, mesh)
            assert {k: _norm(v) for k, v in rb.items()} == {k: _norm(v) for k, v in pb.items()}
            assert SH.sharded_bytes(p_in, pb, mesh) == _ref_bytes(r_in, rb, rmesh)
            rc = RSH.cache_specs(rcfg, r_cache, r_shape, rmesh)
            pc = SH.cache_specs(cfg, p_cache, shape, mesh)
            r_flat = jax.tree_util.tree_flatten_with_path(
                rc, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
            for kpath, r_spec in r_flat:
                keys = [k.key for k in kpath]
                assert _norm(_ref_at_port(pc, keys)) == _norm(r_spec), (arch, name, keys)
            assert SH.sharded_bytes(p_cache, pc, mesh) == _ref_bytes(r_cache, rc, rmesh)
            rs, ps = RSH.state_specs(rmesh), SH.state_specs(mesh)
            assert [_norm(s) for s in rs] == [_norm(s) for s in ps]
    # the state's bytes: replicated on every device
    r_state = jax.eval_shape(lambda: rstreaming.init_state(64, 16))
    p_state = streaming.init_state(64, 16, device="meta")
    rmesh, mesh = _meshes("single")
    assert (SH.sharded_bytes(p_state, SH.state_specs(mesh), mesh)
            == _ref_bytes(r_state, RSH.state_specs(rmesh), rmesh))


def _captured_constraints(calls):
    """The specs the reference's ``constrain`` hands ``with_sharding_constraint``
    for ``calls`` [(fn name, shape)], under its policy on the single-pod
    mesh."""
    rmesh, _ = _meshes("single")
    got = []
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, sh: (got.append(_norm(sh.spec)), x)[1]
    try:
        with ract.activation_policy(rmesh, ("data",), ("model",)):
            for fn, shape in calls:
                getattr(ract, fn)(jnp.zeros(shape, jnp.float32))
    finally:
        jax.lax.with_sharding_constraint = orig
    return got


def test_constrain_identity_without_policy():
    x = torch.zeros(4, 36, 8, 16)
    assert not act.active() and not act.flash_surrogate_active()
    assert act.constrain_heads(x) is x
    h = x[:, 0]
    assert act.constrain_bsd(h) is h
    assert act.constrain(x, ("batch", "model", None, None)) is x
    assert act.resolve_spec(x.shape, ("batch", "model", None, None)) is None


def test_constrain_resolves_as_reference():
    """minicpm's 36 heads on a 16-wide model axis drop the axis, 32 keep
    it; a batch of 32 shards over 'data', one of 8 does not."""
    calls = [("constrain_heads", (32, 36, 4, 8)), ("constrain_heads", (32, 32, 4, 8)),
             ("constrain_bsd", (32, 4, 2304)), ("constrain_bsd", (8, 4, 2304)),
             ("constrain_heads", (8, 48, 2, 8))]
    want = _captured_constraints(calls)
    _, mesh = _meshes("single")
    labels = {"constrain_heads": ("batch", "model", None, None),
              "constrain_bsd": ("batch", None, None)}
    with act.activation_policy(mesh, M.batch_axes(mesh), M.model_axes(mesh)):
        got = [_norm(act.resolve_spec(shape, labels[fn])) for fn, shape in calls]
        x = torch.zeros(2, 3, 4)
        assert act.constrain_bsd(x) is x      # a plain tensor carries no layout
    assert got == want
    assert got[0][1] is None and got[1][1] == ("model",)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_to_placements_and_dtensor_constrain_world_one():
    """On a world-size-1 gloo mesh: a spec's placements, and ``constrain``
    redistributing a DTensor to the policy's (every axis of size 1: the
    guard drops them all, so it comes back replicated)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        dmesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        assert SH.to_placements((("data",), ("model",)), dmesh) == [Shard(0), Shard(1)]
        assert SH.to_placements((None, ("model",)), dmesh) == [Replicate(), Shard(1)]
        assert SH.to_placements((), dmesh) == [Replicate(), Replicate()]
        x = distribute_tensor(torch.arange(24.0).reshape(2, 3, 4), dmesh,
                              [Shard(0), Replicate()])
        with act.activation_policy(dmesh, ("data",), ("model",)):
            y = act.constrain_bsd(x)
        assert list(y.placements) == [Replicate(), Replicate()]
        np.testing.assert_array_equal(y.full_tensor().numpy(), x.full_tensor().numpy())
        assert act.constrain_bsd(x) is x
    finally:
        dist.destroy_process_group()
