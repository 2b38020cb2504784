"""Cost of one step from a walk on meta tensors.

The port of ``repro.launch.hlo_analysis``. PyTorch has no HLO text to
re-walk, so the step itself is run once on the meta device (shapes and
dtypes, no storage, no arithmetic) under a dispatch mode that sees every
aten op:

  flops             the matmul family (``mm``, ``bmm``, ``addmm``,
                    ``baddbmm``, convolutions) by the formulas of
                    ``torch.utils.flop_counter``: 2 · out_elems · contracted_elems, the
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

  collectives       every ``_c10d_functional`` op the step issues (a
                    partitioned step's DTensor redistributions and the
                    model's explicit all-reduces), by the reference's kinds
                    (``all-reduce``, ``all-gather``, ``reduce-scatter``,
                    ``all-to-all``, ``collective-permute``), with the bytes
                    each device moves as the reference's HLO walk counts
                    them: the result for an all-gather, all-reduce or
                    permute, the operand for a reduce-scatter or
                    all-to-all, each element at most ``width_cap`` bytes
                    (2 for a bf16 model: the reference's cap).

A plain step's counts are those of one device holding the whole step. On
``DTensor``s (a partitioned step, on real ranks or on the fake process
group of ``launch.mesh.fake_device_mesh``) the walk steps aside at each
``DTensor`` op, as ``CommDebugMode`` does, and counts the local ops and
collectives that DTensor issues for this rank: every count is this
rank's. ``Cost.replicated`` names the flops that ranks repeat: for each
``DTensor`` op, its local flops times the chips less the op's flops on the
global shapes, and for each ``core.act.local_region``, its local flops
times the chips times (1 − 1/r), r the ranks that share its inputs.

The reference multiplies each while body by its trip count
(``known_trip_count``). The port's recurrences (the xLSTM's per-token
loops, the SSD's chunk carry) go through ``core.act.scan``: under the walk
the first trips run and the rest are counted as the last one repeated, so
a step is walked once at its full length in the time of a few trips;
``tests/test_torch_cost_analysis.py`` holds it to a walk of every trip.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import weakref
from fractions import Fraction
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import act

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


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_c10d = torch.ops._c10d_functional
# functional collective → (the reference's kind, counts its result (else operand))
_COLLECTIVE = {
    _c10d.all_reduce.default: ("all-reduce", True),
    _c10d.all_reduce_.default: ("all-reduce", True),
    _c10d.all_gather_into_tensor.default: ("all-gather", True),
    _c10d.reduce_scatter_tensor.default: ("reduce-scatter", False),
    _c10d.all_to_all_single.default: ("all-to-all", False),
    _c10d.broadcast.default: ("collective-permute", True),
}
if hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
    # DTensor's shard-to-shard move on a non-CPU mesh (one all-to-all)
    _COLLECTIVE[torch.ops._dtensor.shard_dim_alltoall.default] = ("all-to-all", False)
_NO_BYTES = {_c10d.wait_tensor.default}


@dataclasses.dataclass
class Cost:
    flops: int = 0
    bytes_accessed: int = 0
    static_bytes: int = 0           # the walk's arguments
    peak_bytes: int = 0             # static + the most intermediate bytes live
    peak_aval_bytes: int = 0
    peak_aval_shape: str = ""
    ops: int = 0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})
    collective_count: int = 0
    # (kind, process group name, elements, bytes, the core.act.local_region
    # it was issued in or "") of each collective, in order
    collective_log: list = dataclasses.field(default_factory=list)
    replicated: dict = dataclasses.field(default_factory=dict)  # name → flops

    @property
    def collective_total(self) -> int:
        return sum(self.collective_bytes.values())

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.static_bytes


# the counts of ``Cost`` that a walk by trip count keeps exact
EXACT = ("flops", "bytes_accessed", "static_bytes", "peak_bytes", "peak_aval_bytes", "ops",
         "collective_bytes", "collective_count", "collective_log")
# a scan's trips walked before the rest are counted as the last one's
# repeat: the first may differ (its carry is the caller's), the two after
# it must agree
TRIPS = 3


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


def _flops(func, args, kwargs, out) -> int:
    count = flop_registry.get(func._overloadpacket)
    return 0 if count is None else int(count(*args, **kwargs, out_val=out))


def _propagating() -> bool:
    """DTensor is working out an op's output on fake tensors (its sharding
    propagation): no op of the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def _is_dtensor(types) -> bool:
    """One of ``types`` is ``DTensor`` (none exists before its module is
    imported)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and any(issubclass(t, dtensor.DTensor) for t in types)


class _Walk(TorchDispatchMode):
    """Flops, bytes moved, storages live and collectives over the ops on
    ``device``; ``chips`` ranks for the replicated flops."""

    def __init__(self, device: torch.device, static: set, width_cap: int = 0,
                 chips: int = 1, trips: Optional[int] = TRIPS):
        super().__init__()
        self.trips = trips              # a scan's trips walked, None: every one
        self.high = 0                   # the most live bytes since a scan's trip began
        self.device = device
        self.static = static            # argument storages: held by the caller
        self.live: dict = {}            # storage id → nbytes
        self.live_bytes = 0
        self.cost = Cost()
        self.width_cap = width_cap
        self.chips = chips
        self.op = None                  # the DTensor op whose local ops run now
        self.local: dict = {}           # name → (local flops, replication)
        self.glob: dict = {}            # DTensor op name → global flops

    def _collective(self, func, args, out) -> None:
        kind, of_result = _COLLECTIVE[func]
        t = out if of_result else args[0]
        width = t.element_size()
        if self.width_cap and width > self.width_cap:
            width = self.width_cap
        c = self.cost
        c.collective_bytes[kind] += t.numel() * width
        c.collective_count += 1
        region = act.current_region()
        c.collective_log.append((kind, str(args[-1]), t.numel(), t.numel() * width,
                                 region[0] if region else ""))

    def replicated(self) -> dict:
        out = {}
        for name, (f, r) in self.local.items():
            if name in self.glob:
                extra = self.chips * f - self.glob[name]
            else:
                extra = int(self.chips * f * (1 - Fraction(1, r)))
            if extra > 0:
                out[name] = extra
        return out

    def _ours(self, t) -> bool:
        return isinstance(t, torch.Tensor) and _on(t, self.device)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not act.counted() or _propagating():
            return func(*args, **kwargs)
        if _is_dtensor(types):
            # let DTensor run and count the local ops it issues; note the
            # op's flops on the global shapes
            self.op = func._overloadpacket.__name__
            g = _flops(func, args, kwargs, None)
            if g:
                self.glob[self.op] = self.glob.get(self.op, 0) + g
            return NotImplemented
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        f = _flops(func, args, kwargs, out)
        if f:
            c.flops += f
            region = act.current_region()
            name, r = region if region is not None else (self.op or "local", 1)
            if region is not None:
                name = f"region:{name}"
            prev = self.local.get(name, (0, r))[0]
            self.local[name] = (prev + f, r)
        if func in _COLLECTIVE:
            self._collective(func, args, out)
        if _is_view(func) or func in _NO_BYTES:
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
        self.high = max(self.high, self.live_bytes)
        return out

    # ------------------------------------------------------------- scans
    def _mark(self) -> dict:
        c = self.cost
        self.high = self.live_bytes
        return dict(flops=c.flops, bytes=c.bytes_accessed, ops=c.ops,
                    count=c.collective_count, kinds=dict(c.collective_bytes),
                    log=len(c.collective_log), local=dict(self.local), glob=dict(self.glob),
                    live=self.live_bytes)

    def _since(self, m: dict) -> dict:
        """What ran since ``_mark`` gave ``m``: the counts added, the bytes
        a trip leaves live and its most live above its start."""
        c = self.cost
        return dict(
            flops=c.flops - m["flops"], bytes=c.bytes_accessed - m["bytes"], ops=c.ops - m["ops"],
            count=c.collective_count - m["count"],
            kinds={k: v - m["kinds"][k] for k, v in c.collective_bytes.items()},
            log=list(c.collective_log[m["log"]:]),
            local={k: (f - m["local"].get(k, (0, r))[0], r) for k, (f, r) in self.local.items()
                   if f != m["local"].get(k, (0, r))[0]},
            glob={k: f - m["glob"].get(k, 0) for k, f in self.glob.items()
                  if f != m["glob"].get(k, 0)},
            kept=self.live_bytes - m["live"], high=self.high - m["live"])

    def _repeat(self, d: dict, k: int) -> int:
        """Count ``k`` more trips like the one ``d`` describes; → the bytes
        they leave live (their outputs), held as if they were."""
        c = self.cost
        c.flops += k * d["flops"]
        c.bytes_accessed += k * d["bytes"]
        c.ops += k * d["ops"]
        c.collective_count += k * d["count"]
        for kind, v in d["kinds"].items():
            c.collective_bytes[kind] += k * v
        c.collective_log.extend(d["log"] * k)
        for name, (f, r) in d["local"].items():
            self.local[name] = (self.local[name][0] + k * f, r)
        for name, f in d["glob"].items():
            self.glob[name] += k * f
        # the trips start where the last one left off and each keeps ``kept``
        top = self.live_bytes + max(0, (k - 1) * d["kept"]) + d["high"]
        c.peak_bytes = max(c.peak_bytes, c.static_bytes + top)
        self.high = max(self.high, top)
        self.live_bytes += k * d["kept"]
        return k * d["kept"]

    def scan(self, body, carry, n: int, dim: int):
        """``core.act.scan`` under the walk: the first ``trips`` trips run;
        when more remain, the last two run must agree in every count, and
        the rest are counted as the last one repeated: its flops, bytes,
        ops and collectives (the log in order) times the trips left, the
        bytes each leaves live (its output) held until the stack, and the
        most live bytes at the last trip. The stack of every trip's output
        is run (the last one's standing for those not run): a scan cut so
        gives its result's shapes only, so its carry must be on the meta
        device."""
        run = n if self.trips is None else min(n, max(self.trips, 2))
        if run < n and any(t.device.type != "meta" for t in _locals(carry)):
            raise ValueError(f"a scan of {n} trips walked by its first {run} has a "
                             "result right only in its shapes: walk it on meta tensors, "
                             "or with trips=None")
        ys, seen = [], []
        for t in range(run):
            m = self._mark()
            carry, y = body(t, carry)
            ys.append(y)
            seen.append(self._since(m))
        held = 0
        if run < n:
            if seen[-1] != seen[-2]:
                diff = sorted(k for k in seen[-1] if seen[-1][k] != seen[-2][k])
                raise ValueError(f"a scan's trips {run - 2} and {run - 1} differ in {diff}: "
                                 "the walk cannot count the rest as their repeat")
            held = self._repeat(seen[-1], n - run)
            ys += [ys[-1]] * (n - run)
        out = torch.stack(ys, dim)
        del ys
        self.live_bytes -= held
        return carry, out


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


def _locals(tree) -> list:
    """The tensors of ``tree``, each ``DTensor`` as its local tensor."""
    out = []
    for t in tree_leaves(tree):
        if _is_dtensor((type(t),)):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def walk(fn: Callable, *args, device="meta", width_cap: int = 0,
         chips: int = 1, trips: Optional[int] = TRIPS) -> tuple[Cost, Any]:
    """Run ``fn(*args)`` once, counting its ops on ``device`` → (cost,
    result). The arguments' storages are static bytes, held across the
    step; the result's stay live at its end. ``DTensor`` arguments count
    by their local tensors. ``width_cap`` caps a collective's element
    width (bytes), ``chips`` is the rank count of a partitioned step.
    Each ``core.act.scan`` runs its first ``trips`` trips and counts the
    rest by its trip count (``_Walk.scan``; on meta tensors only, since
    the result is then right only in its shapes); ``trips=None`` runs
    every trip."""
    _check_storage_lifetime()
    dev = torch.device(device)
    local_args = _locals(args)
    static = {t.untyped_storage()._cdata for t in local_args if _on(t, dev)}
    mode = _Walk(dev, static, width_cap, chips, trips)
    mode.cost.static_bytes = storage_bytes(local_args, dev)
    mode.cost.peak_bytes = mode.cost.static_bytes
    with mode, act.scan_runner(mode.scan):
        out = fn(*args)
    mode.cost.replicated = mode.replicated()
    return mode.cost, out


def count_collectives(fn: Callable, *args) -> tuple[Cost, Any]:
    """Run ``fn(*args)`` counting only its collectives (kinds, bytes, the
    ordered log), on any device: the real ranks' count that the fake
    process group's walk predicts."""

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.walk = _Walk(torch.device("meta"), set())

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _is_dtensor(types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func in _COLLECTIVE and not _propagating():
                self.walk._collective(func, args, out)
            return out

    mode = Count()
    with mode:
        out = fn(*args)
    return mode.walk.cost, out
