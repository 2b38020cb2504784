"""Activation-sharding policy: logical constraints the model code can emit.

The port of ``repro.core.act``. The model definitions stay mesh-agnostic;
they call ``constrain(x, dims)`` with *logical* dim labels ("batch",
"model", None). When a policy is active (the dry run installs one around its
walk), a label resolves to mesh axes with the reference's divisibility
guard: an axis group that does not divide the dim is dropped (minicpm's 36
heads on a 16-wide model axis), one that does is kept. With no policy it is
the identity, the same object back and no op.

Under a policy, ``constrain`` redistributes a ``DTensor`` on a
``DeviceMesh`` to the resolved placements (the counterpart of
``with_sharding_constraint``); a plain tensor comes back as it is, since it
carries no layout to constrain. ``mesh`` is either a
``launch.mesh.Mesh`` (the production meshes, which name axes and sizes and
hold no process group) or a ``torch.distributed.DeviceMesh``.

Where DTensor has no sharding rule for a piece of the model (the attention
kernel, the MoE expert FFN, the Gram fold), :func:`local_region` runs it
on each rank's local shards, the counterpart of the reference's
``shard_map``: its inputs are redistributed to the placements it names,
the function sees plain local tensors, and its outputs are wrapped back
with the placements it names. While a region runs,
:func:`current_region` names it and its replication factor, for the cost
walk (``launch.cost_analysis``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import sys
from typing import Optional, Sequence

import torch

_POLICY: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "activation_policy", default=None)
_REGION: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "local_region", default=None)
_UNCOUNTED: contextvars.ContextVar[bool] = contextvars.ContextVar("uncounted", default=False)

Spec = tuple  # one entry per tensor dim: a tuple of mesh axis names, or None


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``launch.mesh.Mesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@contextlib.contextmanager
def activation_policy(mesh, batch_axes: Sequence[str], model_axes: Sequence[str], *,
                      flash_surrogate: bool = False):
    """Install the policy for the steps run inside. On a ``DeviceMesh`` (a
    partitioned step) plain tensors that the model makes inside (positions,
    masks) meet ``DTensor``s as replicated ones
    (``implicit_replication``): they are the same on every rank."""
    token = _POLICY.set({
        "mesh": mesh,
        "sizes": axis_sizes(mesh),
        "batch": tuple(batch_axes),
        "model": tuple(model_axes),
        "flash_surrogate": flash_surrogate,
    })
    try:
        if getattr(mesh, "mesh_dim_names", None) is not None:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _POLICY.reset(token)


def active() -> bool:
    return _POLICY.get() is not None


def flash_surrogate_active() -> bool:
    """True when the dry run stands in for the flash-attention kernel.

    The surrogate (see ``models.layers.sdpa``) reads q, k, v once and
    writes the output, the kernel's boundary traffic, with no logits; the
    kernel's flops are added analytically by the dry run
    (``launch.dryrun.attention_flops``).
    """
    pol = _POLICY.get()
    return bool(pol and pol["flash_surrogate"])


def resolve_spec(shape: Sequence[int], dims: Sequence[Optional[str]]) -> Optional[Spec]:
    """The active policy's spec for a tensor of ``shape`` labelled ``dims``
    ("batch" | "model" | None each): per dim the label's mesh axes where
    their product divides the dim and exceeds 1, else None. None when no
    policy is set."""
    pol = _POLICY.get()
    if pol is None:
        return None
    sizes = pol["sizes"]
    entries = []
    for label, size in zip(dims, shape):
        axes = pol[label] if label else ()
        total = math.prod(sizes[a] for a in axes) if axes else 1
        entries.append(tuple(axes) if total > 1 and size % total == 0 else None)
    return tuple(entries)


def to_placements(spec: Spec, device_mesh) -> list:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(i)`` on
    each mesh dim that tensor dim ``i`` is split over, ``Replicate()`` on
    the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        for a in axes or ():
            placements[names.index(a)] = Shard(dim)
    return placements


def constrain(x: torch.Tensor, dims: Sequence[Optional[str]]) -> torch.Tensor:
    """dims: one logical label per tensor dim — "batch" | "model" | None."""
    pol = _POLICY.get()
    if pol is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = resolve_spec(x.shape, dims)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def divides(n: int, label: str) -> bool:
    """The active policy's axes of ``label`` divide ``n`` (False with no
    policy, or when they are one device)."""
    pol = _POLICY.get()
    if pol is None:
        return False
    total = math.prod(pol["sizes"][a] for a in pol[label])
    return total > 1 and n % total == 0


def constrain_bsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations: batch over the federation axes."""
    return constrain(x, ("batch", None, None))


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd): batch, and heads over 'model' when the count divides."""
    return constrain(x, ("batch", "model", None, None))


# ------------------------------------------------------------ local regions
def device_mesh_of(*xs):
    """The ``DeviceMesh`` of the first ``DTensor`` among ``xs``, else None.
    No ``DTensor`` exists before its module is imported: a plain run never
    imports it here."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None:
        return None
    for x in xs:
        if isinstance(x, dtensor.DTensor):
            return x.device_mesh
    return None


@contextlib.contextmanager
def uncounted():
    """Set-up work that is no part of a step (the shapes of an empty cache
    on the meta device): the cost walk does not count the ops run inside."""
    token = _UNCOUNTED.set(True)
    try:
        yield
    finally:
        _UNCOUNTED.reset(token)


def counted() -> bool:
    return not _UNCOUNTED.get()


def current_region() -> Optional[tuple]:
    """(name, replication factor) of the :func:`local_region` running now,
    else None. The factor is the number of ranks that compute each shard:
    the product of the mesh dims on which every input is replicated."""
    return _REGION.get()


def local_region(fn, device_mesh, in_placements: Sequence, out_placements, *,
                 name: Optional[str] = None):
    """``fn`` run on each rank's local shards of its ``DTensor`` arguments
    (``torch.distributed.tensor.experimental.local_map``): each tensor
    argument is redistributed to its entry of ``in_placements`` (a list of
    placements, one per flattened argument; None for a non-tensor), ``fn``
    gets the local tensors, and its outputs become ``DTensor``s with
    ``out_placements`` (one list, or a tuple of lists for several). Every
    collective inside ``fn`` is the caller's: the region adds none but the
    redistribution of its inputs."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    repl = math.prod(
        size for i, size in enumerate(device_mesh.shape)
        if all(p is None or isinstance(p[i], Replicate) for p in in_placements))
    label = (name or getattr(fn, "__name__", "region"), repl)

    def inner(*args):
        token = _REGION.set(label)
        try:
            return fn(*args)
        finally:
            _REGION.reset(token)

    return local_map(inner, out_placements=out_placements,
                     in_placements=tuple(None if p is None else tuple(p)
                                         for p in in_placements),
                     device_mesh=device_mesh, redistribute_inputs=True)
