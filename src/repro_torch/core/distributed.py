"""Distributed AFL aggregation: the single round as a single collective.

The port of ``repro.core.distributed``. Each shard of the federation plays
one client cohort and holds a local
:class:`~repro_torch.core.engine.SuffStats` (C_k^r implicit: raw Gram + a
client count, γ per client added lazily — the engine's bookkeeping,
algebraically the paper's C_k^r = C_k + γI per client, eq (15):
Σ C_i^r = Σ C_i + kγI). ``federated_solve`` then performs the paper's whole
aggregation stage as

    psum(SuffStats)  →  RI restore  →  Cholesky solve (engine, torch backend)

i.e. ONE all-reduce round — the communication pattern the AA law licenses.

**The shard mesh.** The reference runs one SPMD program over a jax ``Mesh``
of local devices (``shard_map``; eight fake CPU devices in its tests). The
port runs the same per-shard code in one process: :func:`federation_mesh`
names a device for each shard, and :class:`ShardGroup` runs one Python
thread a shard, each under its own device, with ``gather`` and ``psum``
meeting on a barrier. Shards may share a device, so eight shards run on one
card and really exchange their panels. All shards on one card enqueue on
its current stream: the order in which work is enqueued is the order of the
data, and a collective needs no event. ``ShardGroup`` stays in one process;
over process groups it waits for a machine with more than one card.

**Real ranks.** :func:`run_ranks` runs a function in one process per rank
of a ``torch.distributed`` ``DeviceMesh`` (the partitioned model steps of
``launch.partitioned``). The ranks meet through a ``FileStore`` in a
temporary directory, so no port is taken and concurrent runs never
collide. The collective path is fixed when the mesh is built, for all its
collectives (:func:`collective_backend`): NCCL where each rank has a card
of its own; gloo on the CPU; and, where ranks share a card, the card's
memory itself (:func:`share_collectives`): each rank's buffer is mapped
into the others by CUDA IPC, and a collective is a copy into the rank's
buffer, a gloo barrier, and the result read from every member's buffer on
the card. NCCL refuses two ranks on one GPU, and gloo's CUDA
path is no answer: on an H100 with torch 2.11 its all_gather_into_tensor
of CUDA tensors kills the rank (SIGSEGV), and its other collectives, or
all of them staged through the host, move about 0.2 GB/s a rank
(``tools/gloo_cuda_probe.py``), where a partitioned granite step
all-gathers 6 GB a rank.

**The tiled Gram.** :func:`make_tiled_federated_solve` takes one ``(r, d)``
row tile of the global Gram a shard. With ``distributed_factor=True`` the
factor runs tile-parallel through the panel kernels
(:func:`repro_torch.kernels.solve.tile_cholesky_factor`): the panel's owner
is static, one gather replicates its (b, b) diagonal block and one its
(d, b) column, and every shard applies trsm and the trailing update to its
own rows, so no shard ever holds the (d, d) system. Otherwise one psum
assembles the system on every shard and the engine solves it there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.core.engine import AnalyticEngine, SuffStats
from repro_torch.core.streaming import AnalyticState, to_stats
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "Shard",
    "ShardGroup",
    "psum_stats",
    "psum_state",
    "federation_mesh",
    "mesh_devices",
    "federated_solve",
    "federated_solve_no_ri",
    "make_federated_solve",
    "make_tiled_federated_solve",
    "run_ranks",
    "run_isolated",
    "collective_backend",
    "share_collectives",
]


@functools.cache
def _engine(device: torch.device, dtype: torch.dtype) -> AnalyticEngine:
    """The plain torch engine on ``device`` (no kernel, as the reference's
    ``AnalyticEngine("jax")`` has none), built on first use."""
    return AnalyticEngine("torch", dtype=dtype, device=device)


def mesh_devices(devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None) -> List[torch.device]:
    """The devices a mesh may place shards on: ``devices`` as given (a bare
    ``"cuda"`` there the current card), else ``device`` alone (``"cpu"`` → the CPU; a bare ``"cuda"`` or ``None`` →
    every visible CUDA device). Without a GPU, a CUDA device raises, by
    :func:`~repro_torch.device.resolve_device`'s rule."""
    if devices is not None:
        devs = [_indexed(resolve_device(d)) for d in devices]
        if not devs:
            raise ValueError("a federation mesh needs at least one device")
        return devs
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _indexed(dev: torch.device) -> torch.device:
    """A bare ``cuda`` in a device list is the current card, by index, so
    that one card is one device of the mesh however it is named."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def federation_mesh(n_shards: int, devices: Optional[Sequence[DeviceLike]] = None,
                    *, device: DeviceLike = None) -> tuple:
    """The devices of ``n_shards`` shards: shard ``i`` on
    ``devices[i % len(devices)]`` (``devices`` / ``device`` as in
    :func:`mesh_devices`).

    The elastic coordinator (``ShardedCoordinator.grow/shrink`` and the
    shard-count-changing ``from_state``) places shards through this one
    constructor. Unlike the reference's, more shards than devices is no
    error: "n shards need n devices" is a limit of a jax ``Mesh``, not of
    the semantics, and shards that share a device take turns on its
    stream.
    """
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"a federation mesh needs ≥1 shard, got {n}")
    devs = mesh_devices(devices, device)
    return tuple(devs[i % len(devs)] for i in range(n))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard's view of a :meth:`ShardGroup.run`: its index, the shard
    count, its device, and the two collectives.

    ``gather(x)`` stacks every shard's ``x`` in shard order → ``(n, …)`` on
    this shard's device; ``psum(x)`` sums them in the fixed order 0…n−1, so
    every shard gets the same bits, as a jax psum replicates. Shards on one
    device share one result, read-only.
    """

    index: int
    n: int
    device: torch.device
    gather: Callable[[torch.Tensor], torch.Tensor]
    psum: Callable[[torch.Tensor], torch.Tensor]


class _Exchange:
    """The slots and the barrier of one run: every shard writes its operand
    and waits; the barrier's action, run by one thread once all have
    arrived, combines the operands for each device before any is
    released."""

    def __init__(self, mesh: tuple):
        self.mesh = mesh
        self.devices = tuple(dict.fromkeys(mesh))
        self.ops: List[Optional[str]] = [None] * len(mesh)
        self.slots: List[Any] = [None] * len(mesh)
        self.out: dict = {}
        self.barrier = threading.Barrier(len(mesh), action=self._combine)

    def _combine(self) -> None:
        if len(set(self.ops)) != 1:
            raise RuntimeError(f"shards disagree on the collective: {self.ops}")
        op, vals = self.ops[0], self.slots
        out = {}
        for dev in self.devices:
            parts = [v.to(dev) for v in vals]
            if op == "gather":
                out[dev] = torch.stack(parts)
            else:
                total = parts[0]
                for p in parts[1:]:
                    total = total + p
                out[dev] = total
        self.out = out
        self.slots = [None] * len(self.mesh)

    def collective(self, op: str, i: int, x: torch.Tensor) -> torch.Tensor:
        self.ops[i], self.slots[i] = op, x
        self.barrier.wait()
        return self.out[self.mesh[i]]


@contextlib.contextmanager
def _on(dev: torch.device, stream):
    """``dev`` (and its caller's stream) current in this thread: a thread's
    current CUDA device is its own."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


class ShardGroup:
    """Runs a function once a shard, one thread a shard, over ``mesh`` (a
    sequence of devices, e.g. :func:`federation_mesh`'s).

    >>> group = ShardGroup(federation_mesh(8, device="cpu"))
    >>> totals = group.run(lambda s: s.psum(torch.tensor(float(s.index))))

    Each thread runs under its shard's device and the stream that was
    current there for the caller. A shard that raises aborts the barrier,
    so every other shard leaves its collective at once, and :meth:`run`
    re-raises that shard's error in the caller: nothing hangs. Every shard
    must make the same collectives in the same order.
    """

    def __init__(self, mesh: Sequence[DeviceLike]):
        self.mesh = tuple(torch.device(d) for d in mesh)
        if not self.mesh:
            raise ValueError("a shard group needs at least one shard")

    @property
    def size(self) -> int:
        return len(self.mesh)

    def run(self, fn: Callable[[Shard], Any]) -> list:
        """``[fn(shard) for every shard]``, in shard order."""
        n = self.size
        ex = _Exchange(self.mesh)
        streams = {dev: torch.cuda.current_stream(dev)
                   for dev in ex.devices if dev.type == "cuda"}
        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n

        def body(i: int) -> None:
            dev = self.mesh[i]
            shard = Shard(i, n, dev, functools.partial(ex.collective, "gather", i),
                          functools.partial(ex.collective, "psum", i))
            try:
                with _on(dev, streams.get(dev)):
                    results[i] = fn(shard)
            except BaseException as exc:   # noqa: BLE001 — re-raised in run
                errors[i] = exc
                ex.barrier.abort()

        threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                    name=f"afl-shard-{i}") for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # the shard that failed first, not the others' broken barrier
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)), None)
        first = first or next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        return results


def _tree_psum(tree, psum):
    return type(tree)(*(None if leaf is None else psum(leaf) for leaf in tree))


def psum_stats(stats: SuffStats, psum: Callable) -> SuffStats:
    """All-reduce the sufficient statistics over the shards (``psum`` a
    shard's collective).

    The AA law (Thm 1) makes this one psum *the whole aggregation stage*:
    statistics (and the lazy client count) simply add.
    """
    return _tree_psum(stats, psum)


def psum_state(state: AnalyticState, psum: Callable) -> AnalyticState:
    """Back-compat: all-reduce a bare 3-leaf AnalyticState."""
    return _tree_psum(state, psum)


def federated_solve(state: AnalyticState, *, psum: Callable, num_clients: int,
                    gamma: float, target_gamma: float = 0.0) -> torch.Tensor:
    """AFL aggregation stage on one shard: one psum + RI + solve.

    ``state`` holds this shard's *raw* Gram/moment (no γ added). Per the RI
    process (Thm 2), the regularized aggregate would be C_agg + KγI;
    restoring (eq 16) means solving with C_agg + target_γ·I directly — the
    engine's lazy-γ semantics, so the KγI term is never materialized. The
    γ/num_clients arguments are kept so callers can instead request the
    *biased* (no-RI) solution for the Table-3 ablation.
    """
    agg = psum_stats(to_stats(state, clients=1.0), psum)
    return _engine(agg.gram.device, agg.gram.dtype).solve(
        agg, use_ri=True, target_gamma=target_gamma)


def federated_solve_no_ri(state: AnalyticState, *, psum: Callable,
                          num_clients: int, gamma: float) -> torch.Tensor:
    """Biased aggregate w/o RI: solves with C_agg + KγI (Table 3 left columns).

    ``num_clients`` is authoritative for K — a shard cohort may stand in for
    more than one client, so the per-shard clients tags are overridden.
    """
    agg = psum_stats(to_stats(state, clients=1.0), psum)
    agg = agg._replace(clients=torch.tensor(float(num_clients), dtype=agg.gram.dtype,
                                            device=agg.gram.device))
    eng = AnalyticEngine("torch", gamma=gamma, dtype=agg.gram.dtype,
                         device=agg.gram.device)
    return eng.solve(agg, use_ri=False)


def make_federated_solve(mesh: Sequence[DeviceLike], *, gamma: float = 1.0,
                         target_gamma: float = 0.0, use_ri: bool = True,
                         dtype: torch.dtype = torch.float32):
    """Build the shard-mapped aggregation: AnalyticState-per-shard → W.

    The returned function consumes an ``AnalyticState`` whose leaves carry a
    leading federation dimension (tensors or arrays on any device), split
    into equal contiguous blocks over the shards of ``mesh``; each shard
    moves its block to its device in ``dtype``, sums it, and the
    collective returns the replicated global weight — the whole FL round
    with exactly one all-reduce for each statistic.
    """
    group = ShardGroup(mesh)
    n = group.size
    solver = federated_solve if use_ri else federated_solve_no_ri
    extra = {"target_gamma": target_gamma} if use_ri else {}

    def agg(stacked: AnalyticState) -> torch.Tensor:
        m = len(stacked.gram)
        if m % n:
            raise ValueError(f"{m} stacked states do not split over {n} shards")
        per = m // n

        def shard_fn(s: Shard) -> torch.Tensor:
            rows = slice(s.index * per, (s.index + 1) * per)
            local = AnalyticState(*(
                torch.as_tensor(leaf[rows], dtype=dtype, device=s.device).sum(0)
                for leaf in stacked))
            return solver(local, psum=s.psum, num_clients=n, gamma=gamma, **extra)

        return group.run(shard_fn)[0]

    return agg


def _tile(tiles, s: Shard, dtype: torch.dtype, copy: bool) -> torch.Tensor:
    """Shard ``s``'s tile on its device in ``dtype``: a copy of its own
    when ``copy``, else the given tensor itself where it already is one."""
    t = tiles[s.index]
    if not copy:
        return torch.as_tensor(t, dtype=dtype, device=s.device)
    out = torch.empty(tuple(t.shape), dtype=dtype, device=s.device)
    return out.copy_(torch.as_tensor(t))


def make_tiled_federated_solve(mesh: Sequence[DeviceLike], *,
                               target_gamma: float = 0.0, use_kernel: bool = False,
                               distributed_factor: bool = False,
                               dim: Optional[int] = None, block: Optional[int] = None,
                               dtype: torch.dtype = torch.float32):
    """Build the aggregation over a row-TILED Gram: tiles-per-shard → W.

    :func:`make_federated_solve` psums whole (d, d) leaves — every shard
    holds a full-size partial aggregate, d² a shard whatever the mesh. Here
    each shard holds ONE ``(d/shards, d)`` row tile of the one global Gram
    (``ShardedCoordinator(tiled_gram=True)`` scatters every arrival across
    the tiles at ingest, so the tiles already ARE the aggregate). The
    returned function takes the gram tiles ``(shards, d/shards, d)`` and the
    matching moment tiles ``(shards, d/shards, C)`` — stacked, or a sequence
    of one tile a shard; tensors on any device or host arrays — and on each
    shard, in ``dtype`` on the shard's device:

      1. scatters its tile into an otherwise-zero full system at its own
         row offset,
      2. ONE psum assembles the replicated global (d, d) system (each shard
         contributes every Gram entry exactly once),
      3. RI restore is a diagonal shift (raw tiles + ``target_gamma``·I —
         the engine's lazy-γ semantics), and the system is factored and
         solved by the torch engine (``use_kernel=True``: the streamed or
         blocked kernels, on the card).

    With ``distributed_factor=True`` step 2 never happens: the factor itself
    runs tile-parallel (:func:`repro_torch.kernels.solve.
    tile_cholesky_factor`) through the panel kernels (their plain versions
    on the CPU), at panels of :func:`~repro_torch.kernels.solve.panel_width`
    of the tile rows under ``block`` (default
    :func:`~repro_torch.kernels.solve.stream_block` of ``dtype``: 256 in
    f32, 128 in f64); the diagonal blocks' inverses of the factor serve the
    solve, so ``panel_tri_inv`` is not launched. Each shard puts its tile
    into a fresh buffer on its device (the upload, where the tiles are host
    arrays as :class:`~repro_torch.fl.api.ShardedCoordinator` keeps them)
    and builds the factor in that buffer, so its live bytes stay at its
    (r, d) tile plus one panel column, never the (d, d) system; the given
    tiles are not modified.

    ``dim`` gives the TRUE head width when the tiles are padded
    (``ShardedCoordinator`` pads indivisible dims with zero rows); pad rows
    get a unit diagonal so the padded block factors to I and decouples, and
    the returned weight is sliced back to ``dim`` rows. The weight is
    replicated; the function returns shard 0's, on its device.
    """
    from repro_torch.kernels.solve import (panel_width, stream_block,
                                           tile_cholesky_factor, tile_cholesky_solve)

    group = ShardGroup(mesh)
    n_shards = group.size

    def _agg_dist(s: Shard, gram_tiles, moment_tiles) -> torch.Tensor:
        a = _tile(gram_tiles, s, dtype, copy=True)
        mt = _tile(moment_tiles, s, dtype, copy=False)
        rows, d_p = a.shape
        d_true = d_p if dim is None else dim
        # RI restore on the true diagonal (lazy-γ: raw tiles + γ·I) and a
        # unit diagonal on pad rows, so the pad block factors to I and never
        # couples back: only the diagonal is written, off-diagonal entries
        # pass through bit-identically
        diag = a.diagonal(offset=s.index * rows)
        true = min(rows, max(0, d_true - s.index * rows))
        diag[:true] += target_gamma
        diag[true:] = 1.0
        b = panel_width(rows, block or stream_block(dtype))
        tile_l, zs = tile_cholesky_factor(a, shard=s.index, n_shards=n_shards,
                                          gather=s.gather, block=b, in_place=True)
        w = tile_cholesky_solve(tile_l, mt, zs, shard=s.index, n_shards=n_shards,
                                gather=s.gather, psum=s.psum, block=b)
        return w[:d_true]

    def _agg(s: Shard, gram_tiles, moment_tiles) -> torch.Tensor:
        gt = _tile(gram_tiles, s, dtype, copy=False)
        mt = _tile(moment_tiles, s, dtype, copy=False)
        rows, d = gt.shape
        lo = s.index * rows
        full_g = torch.zeros((d, d), dtype=dtype, device=s.device)
        full_g[lo:lo + rows] = gt
        full_m = torch.zeros((d, mt.shape[1]), dtype=dtype, device=s.device)
        full_m[lo:lo + rows] = mt
        full_g = s.psum(full_g)
        full_m = s.psum(full_m)
        d_true = d if dim is None else dim
        a_sys = full_g + target_gamma * torch.eye(d, dtype=dtype, device=s.device)
        if d_true != d:
            # padded system: unit diagonal on the pad block, then slice back
            a_sys.diagonal()[d_true:] = 1.0
        engine = AnalyticEngine("torch", use_kernel=use_kernel, dtype=dtype,
                                device=s.device)
        return engine.backend.solve_sym(a_sys, full_m)[:d_true]

    per_shard = _agg_dist if distributed_factor else _agg

    def solve(gram_tiles, moment_tiles) -> torch.Tensor:
        if len(gram_tiles) != n_shards or len(moment_tiles) != n_shards:
            raise ValueError(f"expected {n_shards} tiles, got {len(gram_tiles)} "
                             f"gram and {len(moment_tiles)} moment tiles")
        return group.run(lambda s: per_shard(s, gram_tiles, moment_tiles))[0]

    return solve



# ------------------------------------------------------------------ real ranks
SHARED = "shared"


def collective_backend(world: int, device: DeviceLike) -> str:
    """The collective path of a mesh of ``world`` ranks on ``device``'s type:
    ``nccl`` when every rank has a card of its own, :data:`SHARED` (the
    card's memory, shared) when ranks share a card, ``gloo`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl" if world <= torch.cuda.device_count() else SHARED
    return "gloo"


# the functional collectives a partitioned step issues (DTensor's and the
# model's), and DTensor's shard-to-shard all-to-all
_SHARED_OPS = ("all_reduce", "all_reduce_", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast",
               "shard_dim_alltoall")
_SHARED_LIBS: list = []


class _SharedGroup:
    """One process group's buffers for ranks on one device: each member's
    two buffers are mapped into every member (CUDA IPC on a card, shared
    memory on the CPU), grown by all members together (every member runs
    the same collectives at the same sizes). Exchanges alternate between
    the two, so that one barrier an exchange keeps a member from writing
    a buffer that another still reads: writing buffer b for exchange n + 2
    follows exchange n + 1's barrier, which every member passes only once
    its reads of exchange n (buffer b) are done."""

    groups: dict = {}

    def __init__(self, pg):
        import torch.distributed as dist

        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)
        self.nbytes = 0
        self.turn = 0
        self.mine: list = []
        self.peers: list = []       # [member][buffer]

    @classmethod
    def of(cls, group_name) -> "_SharedGroup":
        from torch.distributed.distributed_c10d import _resolve_process_group

        key = str(group_name)
        if key not in cls.groups:
            cls.groups[key] = cls(_resolve_process_group(key))
        return cls.groups[key]

    def _grow(self, nbytes: int, device) -> None:
        import pickle
        from multiprocessing.reduction import ForkingPickler

        import torch.distributed as dist
        import torch.multiprocessing  # noqa: F401 (registers the tensors' sharing)

        self._sync(device)               # every member is done with the old ones
        size = max(nbytes, 2 * self.nbytes, 1 << 20)
        self.peers = []
        self.mine = [torch.empty(size, dtype=torch.uint8, device=device) for _ in range(2)]
        if device.type == "cpu":
            for t in self.mine:
                t.share_memory_()
        # the buffers' handles, not their bytes: CUDA IPC handles, or file names
        handles: list = [None] * self.size
        dist.all_gather_object(handles, [bytes(ForkingPickler.dumps(t)) for t in self.mine],
                               group=self.pg)
        self.peers = [self.mine if i == self.rank else [pickle.loads(b) for b in h]
                      for i, h in enumerate(handles)]
        self.nbytes = size

    def _sync(self, device) -> None:
        import torch.distributed as dist

        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        dist.barrier(group=self.pg)

    def exchange(self, x: torch.Tensor, fn):
        """``fn([each member's x, in group rank order])``, the members' x
        read in place from their buffers; its result must not alias them."""
        nb = x.numel() * x.element_size()
        if nb > self.nbytes:
            self._grow(nb, x.device)
        b, self.turn = self.turn, 1 - self.turn
        self.mine[b][:nb].copy_(x.detach().contiguous().reshape(-1).view(torch.uint8))
        self._sync(x.device)             # every member's x is in its buffer b
        return fn([p[b][:nb].view(x.dtype).view(x.shape) for p in self.peers])


def _reduce(parts, op: str):
    """The members' tensors reduced in group rank order (the same bits on
    every member)."""
    out = parts[0].clone()
    for p in parts[1:]:
        if op in ("sum", "avg"):
            out.add_(p)
        elif op == "max":
            torch.maximum(out, p, out=out)
        elif op == "min":
            torch.minimum(out, p, out=out)
        else:
            raise ValueError(f"reduce op {op!r} has no shared-buffer path")
    return out.div_(len(parts)) if op == "avg" else out


def _shared_impls() -> dict:
    def all_reduce(input, op, group_name):
        return _SharedGroup.of(group_name).exchange(input, lambda ps: _reduce(ps, op.lower()))

    def all_reduce_(input, op, group_name):
        return input.copy_(all_reduce(input, op, group_name))

    def all_gather_into_tensor(input, group_size, group_name):
        return _SharedGroup.of(group_name).exchange(input, lambda ps: torch.cat(ps))

    def reduce_scatter_tensor(input, op, group_size, group_name):
        g = _SharedGroup.of(group_name)
        return g.exchange(input, lambda ps: _reduce(
            [p.chunk(g.size)[g.rank] for p in ps], op.lower()))

    def all_to_all_single(input, output_split_sizes, input_split_sizes, group_name):
        g = _SharedGroup.of(group_name)
        if len(set(input_split_sizes or [0])) > 1 or len(set(output_split_sizes or [0])) > 1:
            raise ValueError("uneven all-to-all has no shared-buffer path")
        return g.exchange(input, lambda ps: torch.cat([p.chunk(g.size)[g.rank] for p in ps]))

    def broadcast(input, src, group_name):
        import torch.distributed as dist

        g = _SharedGroup.of(group_name)
        root = dist.get_group_rank(g.pg, src)
        return g.exchange(input, lambda ps: ps[root].clone())

    def shard_dim_alltoall(input, gather_dim, shard_dim, group_name):
        g = _SharedGroup.of(group_name)
        return g.exchange(input, lambda ps: torch.cat(ps, gather_dim).chunk(
            g.size, shard_dim)[g.rank].contiguous())

    return dict(locals())


def share_collectives(device_type: str) -> None:
    """Route every functional collective on ``device_type`` in this process
    through buffers the ranks share (:class:`_SharedGroup`), for ranks on
    one device (:data:`SHARED`): the kernel of each op of ``_SHARED_OPS``
    for that device becomes a copy into this rank's buffer, a barrier, and
    the op computed from every member's buffer in place. Made once, before
    a mesh is built. On the CPU (buffers in shared memory) it
    is the path's test; gloo carries only the barriers and the buffers'
    handles."""
    if _SHARED_LIBS:
        return
    if device_type == "cpu":
        # a CPU buffer's handle is a file name, which pickles through gloo
        torch.multiprocessing.set_sharing_strategy("file_system")
    impls = _shared_impls()
    for name in _SHARED_OPS:
        ns = "_dtensor" if name == "shard_dim_alltoall" else "_c10d_functional"
        if getattr(getattr(torch.ops, ns), name, None) is None:
            continue
        lib = torch.library.Library(ns, "IMPL")
        lib.impl(name, impls[name], device_type.upper())
        _SHARED_LIBS.append(lib)


def _rank_main(rank: int, world: int, store_path: str, out_dir: str, fn: Callable,
               mesh_shape: tuple, axis_names: tuple, device: str, backend: str,
               args: tuple) -> None:
    import faulthandler
    import os
    import traceback

    import torch.distributed as dist

    faulthandler.enable()  # a rank that dies by a signal leaves its stack on stderr
    result_path = os.path.join(out_dir, f"rank{rank}.pt")

    def failed():
        # written before the group goes down: the ranks that then lose their
        # peers write theirs later, and the parent raises the first
        if not os.path.exists(result_path):
            torch.save({"ok": False, "error": traceback.format_exc()}, result_path)

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:  # ranks that share the host's cores take one each
            torch.set_num_threads(1)
        if backend == SHARED:
            share_collectives(dev.type)
        dist.init_process_group("gloo" if backend == SHARED else backend,
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            from repro_torch.launch.mesh import make_device_mesh

            device_mesh = make_device_mesh(mesh_shape, axis_names, device=dev.type)
            out = fn(rank, device_mesh, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dist.barrier()
        except BaseException:
            failed()
            raise
        finally:
            dist.destroy_process_group()
        torch.save({"ok": True, "result": out}, result_path)
    except BaseException:  # the parent raises it with this rank's name
        failed()
        raise SystemExit(1)


def run_ranks(fn: Callable, mesh_shape: Sequence[int], axis_names: Sequence[str], *,
              device: DeviceLike = None, backend: Optional[str] = None,
              args: tuple = (), timeout: float = 600.0) -> list:
    """``fn(rank, device_mesh, *args)`` in one spawned process per rank of a
    ``DeviceMesh`` of ``mesh_shape`` named ``axis_names`` → the ranks'
    results, by rank (each moved to the CPU by ``torch.save``; tensors in
    it must be plain). ``fn`` must be importable by name (a module-level
    function). Ranks on CUDA (the default device) take card
    ``rank % device_count``; ``backend`` defaults to
    :func:`collective_backend`'s. The ranks are joined within ``timeout``
    seconds: a rank that fails raises here with its traceback (every other
    rank killed), and ranks that overrun (a hung rank and those that wait
    for it) are killed and raise ``TimeoutError``."""
    import math
    import multiprocessing
    import multiprocessing.connection
    import os
    import tempfile
    import time

    dev = resolve_device(device)
    world = math.prod(mesh_shape)
    backend = backend or collective_backend(world, dev)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="afl-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, tmp, fn, tuple(mesh_shape),
                                   tuple(axis_names), str(dev), backend, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = dict(enumerate(procs))
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    # a hung rank holds the others at a collective
                    raise TimeoutError(f"ranks {sorted(pending)} of {world} overran "
                                       f"{timeout} s")
                multiprocessing.connection.wait([p.sentinel for p in pending.values()],
                                                timeout=left)
                for r, p in list(pending.items()):
                    if p.exitcode is None:
                        continue
                    del pending[r]
                    if p.exitcode != 0:
                        _raise_first_failure(tmp, procs, world)
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False)["result"] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()


def _isolated_main(out_path: str, fn: Callable, args: tuple) -> None:
    import traceback

    try:
        torch.save({"ok": True, "result": fn(*args)}, out_path)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out_path)
        raise SystemExit(1)


def run_isolated(fn: Callable, *args, timeout: float = 600.0, **kwargs) -> Any:
    """``fn(*args, **kwargs)`` in a spawned process of its own → its result
    (through ``torch.save``): for work that leaves state in its process,
    such as the fake process group of ``launch.mesh.fake_device_mesh``.
    Raises with the process's traceback if it fails, ``TimeoutError`` (the
    process killed) if it overruns ``timeout`` seconds."""
    import multiprocessing
    import os
    import tempfile

    if kwargs:
        fn = functools.update_wrapper(functools.partial(fn, **kwargs), fn)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="afl-isolated-") as tmp:
        path = os.path.join(tmp, "out.pt")
        p = ctx.Process(target=_isolated_main, args=(path, fn, args), daemon=True)
        p.start()
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join()
            raise TimeoutError(f"{getattr(fn, '__name__', fn)} overran {timeout} s")
        rec = torch.load(path, weights_only=False) if os.path.exists(path) else None
        if p.exitcode != 0 or rec is None or not rec["ok"]:
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed:\n"
                               + (rec["error"] if rec else f"exit code {p.exitcode}"))
        return rec["result"]


def _raise_first_failure(tmp: str, procs: list, world: int) -> None:
    """Raise the failure of the rank that failed first: a rank's failure
    makes the ranks it shares a collective with fail too, a moment later."""
    import os
    import time

    time.sleep(1.0)
    failed = []
    for r, p in enumerate(procs):
        if p.exitcode not in (None, 0):
            path = os.path.join(tmp, f"rank{r}.pt")
            failed.append((os.path.getmtime(path) if os.path.exists(path) else float("inf"),
                           r, p.exitcode))
    _, r, code = min(failed)
    err = _rank_error(tmp, r) or f"exit code {code}"
    others = sorted(x[1] for x in failed if x[1] != r)
    raise RuntimeError(f"rank {r} of {world} failed:\n{err}"
                       + (f"\n(then ranks {others})" if others else ""))


def _rank_error(tmp: str, rank: int) -> Optional[str]:
    import os

    path = os.path.join(tmp, f"rank{rank}.pt")
    if not os.path.exists(path):
        return None
    rec = torch.load(path, weights_only=False)
    return None if rec["ok"] else rec["error"]
