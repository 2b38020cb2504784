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
data, and a collective needs no event. Process groups across cards and
hosts (``torch.distributed``) are not this module's.

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

