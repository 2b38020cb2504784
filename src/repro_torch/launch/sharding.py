"""Logical→mesh sharding rules (MaxText-style FSDP + tensor parallelism).

The port of ``repro.launch.sharding``. A spec is a tuple with one entry per
tensor dim: a tuple of mesh axis names that dim is split over, or None
(replicated); dims past the end of a shorter tuple are replicated, so
``()`` replicates a whole tensor (the ``PartitionSpec`` convention).

Parameter rules are keyed by leaf *name* and describe the trailing dims of
the leaf; leading dims are replicated. The reference stacks like layers on
leading axes, (L, d, d) for ``layers.attn.wq``; the port keeps one dict per
layer in a list, a (d, d) leaf in each, so the stacking dims are list
indices and a leaf's spec is the reference's without its stacking entries.
Every assignment is divisibility-guarded: an axis group that does not
divide the dim is dropped rather than producing an invalid sharding, so the
same rules serve all ten architectures (36-head minicpm and 8-expert grok
included).

Logical axes:
  fsdp  = ('pod', 'data')  — weight d_model dim, batch dim
  tp    = ('model',)       — heads / ff / vocab dim

On a ``torch.distributed`` ``DeviceMesh`` the ``*_shardings`` functions
give each spec as DTensor placements (the counterparts of the reference's
``NamedSharding`` trees), and :func:`distribute` places a tree of tensors
by them, each rank keeping only its own slice of each leaf.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.config import InputShape, ModelConfig
from repro_torch.core.act import axis_sizes, to_placements  # noqa: F401 (re-exported)
from repro_torch.core.streaming import AnalyticState
from repro_torch.launch.mesh import batch_axes, model_axes

# name → spec template for the *trailing* dims ("fsdp" / "tp" / None).
# 2-entry templates apply to matrices, 1-entry to vectors.
_COL = ("fsdp", "tp")      # d_model → features   (column parallel)
_ROW = ("tp", "fsdp")      # features → d_model   (row parallel)
PARAM_RULES: dict[str, tuple] = {
    # attention / mlp (layers.py)
    "wq": _COL, "wk": _COL, "wv": _COL, "w_up": _COL, "w_gate": _COL,
    "wo": _ROW, "w_down": _ROW,
    # embeddings / heads (transformer.py)
    "embed": ("tp", "fsdp"),           # vocab over tp, d_model over fsdp
    "lm_head": _COL,                   # (d_model, vocab)
    "mm_proj": _COL, "enc_proj": _COL,
    # MoE (moe.py) — (E, d_in, d_out) leaves: E replicated (left-pad), the
    # matrices tensor-parallel. router (d_model, E): E is tiny → fsdp only.
    "router": ("fsdp", None),
    # Mamba2 (ssm.py)
    "in_proj": _COL, "out_proj": _ROW,
    "conv_w": (None, None),            # (d_conv, conv_dim) — small, replicate
    # xLSTM (xlstm.py)
    "up": _COL, "qkv": _COL, "if_proj": _COL, "wx": _COL, "down": _ROW,
    "r": (None, None, None, None),     # per-head recurrent kernels, replicate
}


def _axes_for(label, mesh):
    if label == "fsdp":
        return batch_axes(mesh)
    if label == "tp":
        return model_axes(mesh)
    return ()


def _guard(dim: int, axes: Sequence[str], mesh) -> Optional[tuple]:
    """Return the axis tuple if it divides ``dim``, else None (replicate)."""
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in axes)
    if total > 1 and dim % total == 0:
        return tuple(axes)
    return None


def _leaf_spec(name: str, shape: tuple, mesh) -> tuple:
    rule = PARAM_RULES.get(name)
    if rule is None or len(shape) < len(rule):
        return ()
    pad = len(shape) - len(rule)
    entries: list = [None] * pad
    for dim, label in zip(shape[pad:], rule):
        entries.append(_guard(dim, _axes_for(label, mesh), mesh))
    return tuple(entries)


def _map(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and (named) tuples of
    tensors, in a tree of the same shape; ``path`` holds the dict keys and
    list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        items = [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(path, tree)


def _pairs(tree, specs):
    """(leaf, spec) of every tensor of ``tree`` with its place in ``specs``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _pairs(v, specs[i])
    else:
        yield tree, specs


def param_specs(params: Any, mesh) -> Any:
    """Spec tree matching a param tree (meta or real tensors): each leaf by
    its name, the last dict key on its path."""

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        return _leaf_spec(name, tuple(leaf.shape), mesh)

    return _map(spec, params)


# ------------------------------------------------------------------- batches
def batch_specs(cfg: ModelConfig, specs: dict, mesh) -> dict:
    """Shard every batch input along its leading (batch) dim."""
    baxes = batch_axes(mesh)

    def one(_path, leaf):
        if leaf.dim() == 0:
            return ()
        return (_guard(leaf.shape[0], baxes, mesh),) + (None,) * (leaf.dim() - 1)

    return _map(one, specs)


# ----------------------------------------------------------- analytic state
def state_specs(mesh) -> AnalyticState:
    """AFL sufficient statistics are replicated: the batch-sharded Gram
    contraction reduces over the federation axes, and that reduction is the
    paper's one aggregation all-reduce."""
    return AnalyticState(gram=(), moment=(), count=())


# -------------------------------------------------------------------- caches
def cache_specs(cfg: ModelConfig, cache: Any, shape: InputShape, mesh) -> Any:
    """Decode-cache sharding.

    Per leaf: the dim equal to the global batch shards over the federation
    axes; the *last* dim (head_dim for KV caches) shards over 'model', so
    the per-token write stays shard-local. Only when the batch cannot use
    the federation axes (long_500k B=1) does the sequence dim shard, over
    those unused axes, so a 500k-token cache still spreads across the pod.
    """
    baxes = batch_axes(mesh)
    maxes = model_axes(mesh)
    b = shape.global_batch

    def one(_path, leaf):
        nd = leaf.dim()
        entries: list = [None] * nd
        used_batch = False
        for i, d in enumerate(leaf.shape):
            if d == b and _guard(d, baxes, mesh):
                entries[i] = _guard(d, baxes, mesh)
                used_batch = True
                break
        if nd >= 2 and entries[-1] is None:
            entries[-1] = _guard(leaf.shape[-1], maxes, mesh)
        if not used_batch:
            cand = [(d, i) for i, d in enumerate(leaf.shape)
                    if entries[i] is None and d >= 1024]
            if cand:
                d, i = max(cand)
                entries[i] = _guard(d, baxes, mesh)
        return tuple(entries)

    return _map(one, cache)


def replicated(mesh) -> tuple:
    return ()


# ------------------------------------------------------------ device bytes
def shard_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes:
            out[i] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def sharded_bytes(tree: Any, specs: Any, mesh) -> int:
    """Static per-device residency of a tensor tree under its spec tree."""
    total = 0
    for leaf, spec in _pairs(tree, specs):
        if isinstance(leaf, torch.Tensor):
            total += math.prod(shard_shape(leaf.shape, spec, mesh)) * leaf.element_size()
    return total


# ---------------------------------------------------- DTensor placements
def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _placements(specs, device_mesh):
    """A spec tree as DTensor placements (a list a leaf) on ``device_mesh``."""
    if _is_spec(specs):
        return to_placements(specs, device_mesh)
    if isinstance(specs, dict):
        return {k: _placements(v, device_mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_placements(v, device_mesh) for v in specs]
    items = [_placements(v, device_mesh) for v in specs]
    return type(specs)(*items) if hasattr(specs, "_fields") else tuple(items)


def param_shardings(params: Any, device_mesh) -> Any:
    return _placements(param_specs(params, device_mesh), device_mesh)


def batch_shardings(cfg: ModelConfig, specs: dict, device_mesh) -> dict:
    return _placements(batch_specs(cfg, specs, device_mesh), device_mesh)


def state_shardings(device_mesh) -> AnalyticState:
    return _placements(state_specs(device_mesh), device_mesh)


def cache_shardings(cfg: ModelConfig, cache: Any, shape: InputShape, device_mesh) -> Any:
    return _placements(cache_specs(cfg, cache, shape, device_mesh), device_mesh)


def local_shape(shape: Sequence[int], placements, device_mesh) -> tuple:
    """One rank's block of a tensor of ``shape`` under ``placements``."""
    out = list(shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= device_mesh.size(mdim)
    return tuple(out)


def local_slice(leaf: torch.Tensor, placements, device_mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``placements``: a view. A dim
    split over several mesh dims is cut by the first of them first, as
    DTensor and ``PartitionSpec`` cut it."""
    coord = device_mesh.get_coordinate()
    out = leaf
    for mdim, p in enumerate(placements):
        if p.is_shard():
            n = out.shape[p.dim] // device_mesh.size(mdim)
            out = out.narrow(p.dim, coord[mdim] * n, n)
    return out


def distribute(tree: Any, shardings: Any, device_mesh) -> Any:
    """``tree`` as DTensors on ``device_mesh`` under ``shardings`` (a tree of
    placements, the ``*_shardings`` functions'): each leaf's local slice
    (:func:`local_slice`) is copied out and wrapped, with no collective;
    the caller's full leaf can be freed at once. Every rank must hold the
    same full leaves (drawn from one seed on its own device,
    :func:`distributed_params`)."""
    from torch.distributed.tensor import DTensor

    def one(leaf, placements):
        local = local_slice(leaf, placements, device_mesh).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(local, device_mesh, placements, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    def walk(t, sh):
        if isinstance(t, dict):
            return {k: walk(v, sh[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sh[i]) for i, v in enumerate(t)]
        if isinstance(t, tuple):
            items = [walk(v, sh[i]) for i, v in enumerate(t)]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return one(t, sh)

    return walk(tree, shardings)


def distributed_params(cfg: ModelConfig, device_mesh, *, seed: int = 0, device=None):
    """``models.transformer.init_params(cfg, seed, device)`` as DTensors
    under :func:`param_shardings`, drawn layer by layer: each rank draws
    every leaf from the seed on its own device, as one device would, and
    keeps its own slice of each layer as soon as the layer is drawn, so no
    rank ever holds more of the full model than one layer."""
    from repro_torch.models import transformer as T

    shardings = param_shardings(T.init_params(cfg, device="meta"), device_mesh)

    def place(path, subtree):
        sh = shardings
        for k in path:
            sh = sh[k]
        return distribute(subtree, sh, device_mesh)

    return T.init_params(cfg, seed=seed, device=device, place=place)
