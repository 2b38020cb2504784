"""Cost of one step from a walk on meta tensors.

The port of ``repro.launch.hlo_analysis``. PyTorch has no HLO text to
re-walk, so the step itself is run once on the meta device (shapes and
dtypes, no storage, no arithmetic) under ``FlopCounterMode`` and a
dispatch mode that sees every aten op:

  flops             the matmul family (``mm``, ``bmm``, ``addmm``,
                    ``baddbmm``, convolutions) as ``FlopCounterMode``
                    counts it: 2 · out_elems · contracted_elems, the
                    reference's ``dot`` / ``convolution`` count;
                    elementwise flops are ignored, standard for MFU.
  bytes             Σ (operand + result) bytes of every aten op that moves
                    data: a view moves none, a gather reads the rows it
                    gathers, an in-place write to a slice writes the
                    slice. These are *unfused* bytes: each op reads its
                    inputs from memory and writes its outputs back, an
                    upper bound on fused kernels, where the reference
                    counts at XLA's fusion boundaries.
  peak_bytes        the most bytes live at once: the walk's arguments
                    (params, batch, state or cache) plus every
                    intermediate from the op that makes its storage until
                    the storage is freed, the counterpart of
                    ``memory_analysis``'s argument + output + temp.
  peak_aval_bytes   the largest single intermediate (the reference's
                    ``peak_aval_bytes``).

Every count is for one device holding the whole step (the port's mesh of
one H100); a mesh's per-device share is the dry run's.

The port's eager loops run every trip where the reference multiplies a
scan body by its trip count. Where a step's cost is affine in its sequence
length (the xLSTM family's per-token loops), :func:`affine_walk` walks two
short lengths and extends the line; ``tests/test_torch_cost_analysis.py``
holds the extension to full walks.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from fractions import Fraction
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

# ops whose first operand is overwritten without being read
_OVERWRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}
# gathers: the first operand is read only where indexed (output-sized)
_GATHER = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
           aten.embedding.default}
# scatters into the first operand: read the values and indices, write the values
_SCATTER = {aten.index_put_.default, aten.index_put.default, aten.scatter_.src,
            aten.scatter.src, aten.scatter_add_.default, aten.scatter_add.default,
            aten.index_add_.default, aten.index_add.default}


@dataclasses.dataclass
class Cost:
    flops: int = 0
    bytes_accessed: int = 0
    static_bytes: int = 0           # the walk's arguments
    peak_bytes: int = 0             # static + the most intermediate bytes live
    peak_aval_bytes: int = 0
    peak_aval_shape: str = ""
    ops: int = 0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.static_bytes


# the fields of ``Cost`` that a walk extends along a line in S
_AFFINE = ("flops", "bytes_accessed", "static_bytes", "peak_bytes", "peak_aval_bytes", "ops")


@functools.cache
def _is_view(func) -> bool:
    """Every result aliases an input without writing it (a view)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    """What reading or writing ``t`` moves: its elements, or its storage
    where that is smaller (an expanded view)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class _Walk(TorchDispatchMode):
    """Bytes moved and storages live over the ops on ``device``."""

    def __init__(self, device: torch.device, static: set):
        super().__init__()
        self.device = device
        self.static = static            # argument storages: held by the caller
        self.live: dict = {}            # storage id → nbytes
        self.live_bytes = 0
        self.cost = Cost()

    def _ours(self, t) -> bool:
        return isinstance(t, torch.Tensor) and _on(t, self.device)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        if _is_view(func):
            return out
        outs = [t for t in tree_leaves(out) if self._ours(t)]
        ins = [t for t in tree_leaves((args, kwargs)) if self._ours(t)]
        written = sum(_nbytes(t) for t in outs)
        if func in _OVERWRITE:
            read = sum(_nbytes(t) for t in ins[1:])
        elif func in _GATHER:
            read = written + sum(_nbytes(t) for t in ins[1:])
        elif func in _SCATTER:
            read = sum(_nbytes(t) for t in ins[1:])
            written = _nbytes(ins[-1]) if len(ins) > 1 else written
        else:
            read = sum(_nbytes(t) for t in ins)
        c.bytes_accessed += read + written
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.static:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            # the storage's Python object lives exactly as long as the
            # storage (PyTorch preserves it): its finalizer is the free
            weakref.finalize(st, self._free, key).atexit = False
            if n > c.peak_aval_bytes:
                c.peak_aval_bytes = n
                c.peak_aval_shape = f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
        c.peak_bytes = max(c.peak_bytes, c.static_bytes + self.live_bytes)
        return out


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """``t`` lies on ``dev`` (a device without an index: any of its type)."""
    return t.device.type == dev.type and dev.index in (None, t.device.index)


def storage_bytes(tree: Any, device=None) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (on
    ``device`` if given)."""
    dev = None if device is None else torch.device(device)
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and (dev is None or _on(t, dev)):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


@functools.cache
def _check_storage_lifetime() -> None:
    """The walk frees an intermediate when its storage's Python object is
    finalized: that object must outlive its wrapper and die with the
    storage (PyObject preservation of ``UntypedStorage``)."""
    fired = []
    t = torch.empty(4, device="meta")
    weakref.finalize(t.untyped_storage(), fired.append, 1)
    kept = not fired
    del t
    if not (kept and fired):
        raise RuntimeError(f"torch {torch.__version__} does not tie a storage's Python "
                           "object to the storage: the walk cannot see frees")


def walk(fn: Callable, *args, device="meta") -> tuple[Cost, Any]:
    """Run ``fn(*args)`` once, counting its ops on ``device`` → (cost,
    result). The arguments' storages are static bytes, held across the
    step; the result's stay live at its end."""
    _check_storage_lifetime()
    dev = torch.device(device)
    static = {t.untyped_storage()._cdata for t in tree_leaves(args)
              if isinstance(t, torch.Tensor) and _on(t, dev)}
    mode = _Walk(dev, static)
    mode.cost.static_bytes = storage_bytes(args, dev)
    mode.cost.peak_bytes = mode.cost.static_bytes
    with FlopCounterMode(display=False) as fc, mode:
        out = fn(*args)
    mode.cost.flops = int(fc.get_total_flops())
    return mode.cost, out


def affine_walk(make: Callable[[int], tuple], s_full: int, s_small=(8, 16)) -> Cost:
    """The cost at sequence length ``s_full`` of a step whose every count is
    affine in S: ``make(s)`` → (fn, args) at length ``s``, walked at the
    two lengths of ``s_small`` and the line through them read at
    ``s_full``."""
    s1, s2 = s_small
    fn, args = make(s1)
    c1, _ = walk(fn, *args)
    fn, args = make(s2)
    c2, _ = walk(fn, *args)
    out = dataclasses.replace(c2)
    for f in _AFFINE:
        a, b = getattr(c1, f), getattr(c2, f)
        setattr(out, f, int(a + Fraction(b - a, s2 - s1) * (s_full - s1)))
    return out
