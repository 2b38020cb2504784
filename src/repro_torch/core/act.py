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
from typing import Callable, Optional, Sequence

import torch

_POLICY: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "activation_policy", default=None)
_REGION: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "local_region", default=None)
_UNCOUNTED: contextvars.ContextVar[bool] = contextvars.ContextVar("uncounted", default=False)
# the cost walk's runner of a scan's trips (launch.cost_analysis), and a
# recorder of each scan's carry shapes (launch.partitioned)
_SCAN: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar("scan", default=None)
_SCANS: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar("scans", default=None)

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


def fed_model_axes(device_mesh) -> tuple[tuple, tuple]:
    """(federation axes, model axes) of ``device_mesh`` by its axis names."""
    sizes = axis_sizes(device_mesh)
    return (tuple(a for a in ("pod", "data") if a in sizes),
            tuple(a for a in ("model",) if a in sizes))


def axes_dividing(axes: tuple, n: int, sizes: dict) -> Optional[tuple]:
    """``axes`` where their product divides ``n`` and exceeds 1, else None."""
    total = math.prod(sizes[a] for a in axes)
    return axes if axes and total > 1 and n % total == 0 else None


def heads_region(fn, args: Sequence, in_dims: Sequence[tuple], out_dims: Sequence[tuple],
                 *, heads: int, name: str):
    """``fn(*args)`` on each rank's shard of a recurrence: each tensor of
    ``args`` and of ``fn``'s flat outputs has its (batch dim, heads dim)
    at its entry of ``in_dims`` / ``out_dims`` (a batch dim None: no batch,
    as a per-head weight); the batch is split over the federation axes
    where they divide it, the ``heads`` over 'model' where it divides them
    (else replicated, the reference's guard). One :func:`local_region`:
    its inputs' redistribution is its only collective, and ``fn`` sees plain
    local tensors (a state it makes, at the local shape). ``args`` may hold
    None (no state yet). With no ``DTensor`` among ``args``, ``fn(*args)``
    as it is."""
    mesh = device_mesh_of(*args)
    if mesh is None:
        return fn(*args)
    sizes = axis_sizes(mesh)
    fed, tp = fed_model_axes(mesh)
    b = next(a.shape[bd] for a, (bd, _) in zip(args, in_dims)
             if a is not None and bd is not None)
    bat, hd = axes_dividing(fed, b, sizes), axes_dividing(tp, heads, sizes)

    def placements(dims):
        bd, hdim = dims
        spec = [None] * (max(bd or 0, hdim) + 1)
        if bd is not None:
            spec[bd] = bat
        spec[hdim] = hd
        return to_placements(tuple(spec), mesh)

    present = [i for i, a in enumerate(args) if a is not None]

    def local(*xs):
        full = [None] * len(args)
        for i, x in zip(present, xs):
            full[i] = x
        return fn(*full)

    return local_region(local, mesh, [placements(in_dims[i]) for i in present],
                        tuple(placements(d) for d in out_dims), name=name)(
        *(args[i] for i in present))


def scan(body: Callable, carry, n: int, dim: int = 0, *, name: str = "scan"):
    """The reference's ``lax.scan`` as a loop: ``carry, y = body(t, carry)``
    for t in range(n) → (the last carry, the ys stacked on ``dim``). Every
    trip does the same work on the same shapes (a per-token or per-chunk
    recurrence). Under the cost walk (``launch.cost_analysis.walk``) the
    walk runs the trips: the first ones, and the rest counted as the last
    one repeated, as the reference's HLO analysis multiplies a while body
    by its trip count. Under :func:`record_scans` the carry's shapes are
    noted by ``name`` (a carry is a tensor or a tuple of them)."""
    rec = _SCANS.get()
    if rec is not None:
        leaves = carry if isinstance(carry, tuple) else (carry,)
        rec.append((name, tuple(tuple(t.shape) for t in leaves)))
    runner = _SCAN.get()
    if runner is not None:
        return runner(body, carry, n, dim)
    ys = []
    for t in range(n):
        carry, y = body(t, carry)
        ys.append(y)
    return carry, torch.stack(ys, dim)


@contextlib.contextmanager
def scan_runner(runner: Callable):
    """Run every :func:`scan` inside by ``runner(body, carry, n, dim)``."""
    token = _SCAN.set(runner)
    try:
        yield
    finally:
        _SCAN.reset(token)


@contextlib.contextmanager
def record_scans(out: list):
    """Append (name, carry shapes) of every :func:`scan` run inside to
    ``out``: on a rank, its local shapes."""
    token = _SCANS.set(out)
    try:
        yield
    finally:
        _SCANS.reset(token)
