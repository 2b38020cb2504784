"""Meshes and the NVIDIA H100's roofline.

The port of ``repro.launch.mesh``. A mesh here is a plain description, axis
names and sizes, with no process group: the dry run resolves sharding
specs and per-device bytes from it, as the reference resolves them from an
abstract mesh. A ``torch.distributed.DeviceMesh`` with the same axis names
serves where tensors are really placed (``core.act``,
``launch.sharding.to_placements``).

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


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch / act as AFL federation axes."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def model_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("model",) if a in mesh.shape)


def num_chips(mesh) -> int:
    return math.prod(mesh.shape.values())


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Three-term roofline of one step on ``chips`` H100s, the compute term
    at ``dtype``'s peak. ``collective_bytes`` None: no term (a mesh whose
    collectives were not counted), and ``dominant`` is read from the other
    two."""

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
