"""Meshes and the NVIDIA H100's roofline.

The port of ``repro.launch.mesh``. A mesh here is a plain description, axis
names and sizes, with no process group: the dry run resolves sharding
specs and per-device bytes from it, as the reference resolves them from an
abstract mesh. A ``torch.distributed.DeviceMesh`` with the same axis names
serves where tensors are really placed (``core.act``,
``launch.sharding``): :func:`make_device_mesh` builds one over the live
process group (real ranks), :func:`fake_device_mesh` one over a fake
process group at a ``Mesh``'s sizes, in which this process plays rank 0 of
every device and each collective returns at once: the dry run walks rank
0's local step on it and counts the collectives that step issues.

Meshes:
  host (``make_host_mesh``): the port's deployment, one H100 as (1, 1)
      with axes ('data', 'model');
  single-pod: (16, 16) ('data', 'model'), and multi-pod: (2, 16, 16)
      ('pod', 'data', 'model'), the reference's production meshes.

The 'pod' and 'data' axes together are the *federation* axes of AFL: each
shard group along them is a client cohort, and the single aggregation
round is one all-reduce over them. 'model' carries tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# ----------------------------------------------------------------- hardware
# NVIDIA H100 SXM (data sheet; dense rates, at the 700 W power limit).
HBM_BW = 3.35e12                 # B/s
PEAK_FLOPS = {torch.float32: 67e12,     # f32 outside the tensor cores (TF32 off)
              torch.bfloat16: 989e12,
              torch.float64: 67e12}     # f64 in the tensor cores (34 outside them)
NVLINK_BW = 450e9                # NVLink 4, per direction, B/s
# torch.cuda.get_device_properties(0).total_memory on an
# "NVIDIA H100 80GB HBM3, 700.00 W" (chip_smoke.py prints it beside the card)
HBM_BYTES = 85_017_493_504

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh; no devices, no process group."""

    sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(MULTI_POD_SHAPE, MULTI_POD_AXES)
    return Mesh(SINGLE_POD_SHAPE, SINGLE_POD_AXES)


def make_host_mesh() -> Mesh:
    """The port's deployment: one H100."""
    return Mesh((1, 1), ("data", "model"))


def make_device_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the live
    process group (``torch.distributed`` initialised, world size
    ``prod(shape)``), ranks laid out row-major as ``jax.make_mesh`` lays out
    devices. ``device`` is the device type of the ranks' tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    return _federated(init_device_mesh(torch.device(device).type, tuple(shape),
                                       mesh_dim_names=tuple(axes)))


def _federated(device_mesh):
    """``device_mesh`` with its federation axes flattened into one dim when
    there are several ('pod', 'data'): DTensor moves a tensor split over
    both by one collective over the flattened dim once it exists, and by
    one a dim before, so it is made with the mesh, not by the first step
    that needs it (the Gram fold): every step, rank and walk then sees
    the same mesh, whatever ran before it in the process."""
    fed = batch_axes(device_mesh)
    if len(fed) > 1:
        device_mesh[fed]._flatten()
    return device_mesh


def fake_device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """A ``DeviceMesh`` at ``mesh``'s sizes over a fake process group, this
    process rank 0 of it. Its collectives move nothing and return at once, so a step run on it with
    meta tensors has rank 0's local shapes and issues rank 0's
    collectives. ``device_type`` is that of the ranks it stands for: DTensor
    moves a shard from one dim to another by an all-to-all on a CUDA mesh
    and by an all-gather on a CPU one. Building it touches no device.

    A process holds one fake mesh: asked for the same one again, this
    returns it; asked for another, it raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    key = (tuple(mesh.sizes), tuple(mesh.axis_names), device_type)
    if key in _FAKE:
        return _FAKE[key]
    if dist.is_initialized():
        # DTensor caches plans by mesh, and a new group under an equal
        # mesh would meet the old group's plans
        raise RuntimeError("this process already has a process group: walk each "
                           "mesh in a process of its own (launch.dryrun does)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.sizes))
    _FAKE[key] = _federated(DeviceMesh(
        device_type, torch.arange(math.prod(mesh.sizes)).reshape(mesh.sizes),
        mesh_dim_names=tuple(mesh.axis_names)))
    return _FAKE[key]


_FAKE: dict = {}


def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch / act as AFL federation axes."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def model_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("model",) if a in _names(mesh))


def num_chips(mesh) -> int:
    sizes = mesh.shape
    return math.prod(sizes.values() if isinstance(sizes, dict) else sizes)


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline of one step on ``chips`` H100s, the compute term
    at ``dtype``'s peak. ``collective_bytes`` is the sum over devices of
    the bytes each device's collectives move (the dry run's per-device
    count times the chips), each device's share at ``NVLINK_BW``; None: no
    term, and ``dominant`` is read from the other two."""

    flops: float
    hbm_bytes: float
    collective_bytes: Optional[float]
    chips: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS[self.dtype])

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> Optional[float]:
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            terms["collective"] = self.collective_s
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "dtype": str(self.dtype).removeprefix("torch."),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }
