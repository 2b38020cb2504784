"""Event-loop AFL serving: submissions stream in, solves never wait.

The AA law makes AFL aggregation a *sum* of sufficient statistics, so there
is no round structure to synchronize on: the server can accept a client
upload at any moment and every ``solve()`` is the exact joint solution of
whatever has arrived so far. :class:`AsyncAFLServer` turns that property
into a serving loop conforming to the :class:`repro_torch.fl.api.Coordinator`
protocol (same methods, same return values, awaited):

  * ``submit()`` hands a :class:`~repro_torch.fl.api.ClientReport` to a single
    worker task that drains arrivals in order, and resolves to the same
    fold-outcome bool the synchronous server returns (True: cached factors
    survived; False: the next solve refactors). ``enqueue()`` /
    ``enqueue_many()`` are the fire-and-forget variants for producers that
    must not block on apply.
  * The worker folds arrivals as **micro-batches**: each wakeup drains the
    whole pending queue (up to ``batch_max``), validates every report
    individually (a bad one rejects alone, exactly as if submitted
    sequentially), then applies the batch in ONE pass — one stacked
    SuffStats merge and one grouped rank-(Σk) Cholesky sweep over the
    concatenated roots (``AFLServer.submit_batch`` machinery) instead of B
    separate O(d²) merges and column sweeps. The fold is bit-for-bit the
    sequential result at f64; outcomes fan back to the per-report futures.
  * Usable low-rank arrivals therefore still fold into the live cached
    factors as **rank updates** (O(Σn_k·d²) per batch) instead of
    invalidating them — the d³ refactorization stays off the arrival hot
    path, now with the per-arrival wakeup/lock/merge overhead amortized
    across the batch.
  * ``solve()`` / ``solve_multi_gamma()`` / ``sweep()`` serve concurrently
    from the live factor: they reflect every arrival *applied* so far and
    never block on submissions still queued (``join()`` waits for the queue
    to drain when a caller wants the everyone-included answer).
  * ``state()`` / ``from_state()`` round-trip the same checkpoint schema as
    the synchronous server, so an event-loop deployment checkpoints and
    restarts like any other coordinator.

Deferred-refactor policy
------------------------
Rank updates are exact in exact arithmetic but each sweep rounds; after many
updates the cached factor drifts from chol(Σ XᵀX + γI), and past a rank
crossover (≈ d/16 rows per arrival at d=2048, measured on a CPU host by
the reference's ``benchmarks/async_server_bench.py``) updating costs more
than refactoring.
The worker therefore tracks, per submission epoch:

  * ``applied_rank`` — total update rows folded into the live factors, and
  * an error proxy ``ε·√d·applied_rank`` for the worst-case relative drift
    of the factor (each rank-1 sweep is one pass of d Householder
    rotations, backward-stable to O(ε) each).

When an arrival has no usable root (masked upload, batch past the rank
budget) or would push either counter over its threshold
(``refactor_rank``, default d/2; ``error_budget``, default 1e-8), the
worker *invalidates* instead of updating and resets the counters. The
refactor itself is deferred to the next ``solve()`` — so a burst of
cache-killing arrivals is batched into ONE d³ factorization rather than one
per arrival, and pure-submission periods never pay d³ at all.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from repro_torch.fl.api import (AFLServer, ClientReport, GammaSweep,
                                VersionedWeights, _sweep_from_weights)
from repro_torch.fl.errors import Backpressure

__all__ = ["AsyncAFLServer", "SubmitAborted"]


class SubmitAborted(RuntimeError):
    """A report in a :meth:`AsyncAFLServer.submit_many` pipeline was skipped
    because an earlier report in the same call was rejected — sync
    stop-at-first-rejection semantics: the skipped report was NOT
    aggregated."""


class _SubmitGroup:
    """Shared abort token for one pipelined ``submit_many`` call."""

    __slots__ = ("failed",)

    def __init__(self):
        self.failed = False


class AsyncAFLServer:
    """Asyncio front-end over :class:`AFLServer` with incremental factors.

    >>> async with AsyncAFLServer(dim=d, num_classes=c, gamma=1.0) as srv:
    ...     folded = await srv.submit(report)  # fold outcome, like sync
    ...     w_now = await srv.solve()      # exact for everything applied
    ...     await srv.join()               # drain stragglers
    ...     w_all = await srv.solve()

    Statistics are always merged exactly on arrival; the policy only decides
    whether the cached *factorization* is updated in place or lazily
    rebuilt. ``updates`` / ``deferred_refactors`` count the two paths.
    """

    def __init__(
        self,
        dim: int,
        num_classes: int,
        gamma: float = 1.0,
        *,
        update_rank_budget: Optional[int] = None,
        refactor_rank: Optional[int] = None,
        error_budget: float = 1e-8,
        max_pending: Optional[int] = None,
        batch_max: int = 32,
        rejected_max: int = 256,
        server: Optional[AFLServer] = None,
    ):
        # ``server`` adopts an existing aggregate (e.g. restored from a
        # checkpoint) instead of starting empty
        if server is not None:
            if (server.dim, server.num_classes,
                    server.gamma) != (dim, num_classes, gamma):
                raise ValueError("adopted server disagrees with (dim, C, γ)")
            if update_rank_budget is not None:
                server.update_rank_budget = int(update_rank_budget)
            self._server = server
        else:
            self._server = AFLServer(dim, num_classes, gamma,
                                     update_rank_budget=update_rank_budget)
        self.refactor_rank = max(1, dim // 2) if refactor_rank is None \
            else int(refactor_rank)
        self.error_budget = float(error_budget)
        # ingest high-watermark: with max_pending set, enqueue() refuses new
        # fire-and-forget uploads once the queue holds that many unapplied
        # reports (the backpressure signal transports surface as HTTP 429).
        # submit() is unaffected — an awaiting producer IS the backpressure.
        self.max_pending = None if max_pending is None else int(max_pending)
        # micro-batch fold cap: the worker drains up to this many queued
        # reports per wakeup and folds them in ONE pass (one stacked
        # statistics merge + one grouped rank-(Σk) factor sweep). 1 restores
        # strict per-report apply; larger values amortize the per-wakeup
        # lock/future/sweep overhead at the cost of coarser fold latency.
        self.batch_max = max(1, int(batch_max))
        self._queue: asyncio.Queue = asyncio.Queue()
        self._lock = asyncio.Lock()
        self._worker: Optional[asyncio.Task] = None
        self._applied_rank = 0
        # observability: arrivals folded as rank updates vs cache kills,
        # plus uploads the wrapped server refused (duplicate id, γ mismatch).
        # ``rejected`` is BOUNDED (a long-lived server facing a misbehaving
        # client must not leak); overflow evicts the oldest entry and bumps
        # ``rejected_dropped``.
        self.updates = 0
        self.deferred_refactors = 0
        self.rejected: collections.deque = collections.deque(
            maxlen=max(1, int(rejected_max)))
        self.rejected_dropped = 0
        self.batches_folded = 0
        self.last_batch = 0

    # -- protocol surface (delegated) ---------------------------------------

    @property
    def dim(self) -> int:
        return self._server.dim

    @property
    def num_classes(self) -> int:
        return self._server.num_classes

    @property
    def gamma(self) -> float:
        return self._server.gamma

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "AsyncAFLServer":
        if self._worker is None:
            self._worker = asyncio.create_task(self._run())
        return self

    async def close(self) -> None:
        if self._worker is not None:
            await self._queue.join()
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
            self._worker = None

    async def __aenter__(self) -> "AsyncAFLServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- submission side ----------------------------------------------------

    async def submit(self, report: ClientReport) -> bool:
        """Submit one upload and await its application, resolving to the
        same fold-outcome bool :meth:`AFLServer.submit` returns. A rejected
        upload (duplicate id, γ mismatch, malformed report) raises here —
        exactly like the sync server — without killing the worker."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((report, fut, None))
        return await fut

    async def enqueue(self, report: ClientReport) -> None:
        """Fire-and-forget: enqueue an upload and return immediately; the
        worker applies it in arrival order. Rejections land in
        ``self.rejected`` instead of raising to the producer. With
        ``max_pending`` configured, a full queue raises
        :class:`~repro_torch.fl.errors.Backpressure` — the report is NOT queued
        and coordinator state is untouched; back off and resubmit."""
        if self.max_pending is not None \
                and self._queue.qsize() >= self.max_pending:
            raise Backpressure(
                f"ingest queue at high-watermark ({self._queue.qsize()} "
                f"pending ≥ max_pending={self.max_pending})")
        await self._queue.put((report, None, None))

    async def enqueue_many(self, reports: Sequence[ClientReport]) -> int:
        """Bulk fire-and-forget: queue reports until the ``max_pending``
        watermark trips, returning how many were admitted (the rest were
        NOT queued — back off and resubmit them). One event-loop crossing
        for the whole batch, which is what lets a streaming transport hand
        the worker real micro-batches instead of a report per crossing."""
        admitted = 0
        for report in reports:
            if self.max_pending is not None \
                    and self._queue.qsize() >= self.max_pending:
                break
            self._queue.put_nowait((report, None, None))
            admitted += 1
        return admitted

    async def submit_many(self, reports: Iterable[ClientReport]) -> None:
        """Bulk submit with sync semantics: applied in order, stopping at
        the first rejection (later reports are NOT aggregated) — post-
        exception state matches :meth:`AFLServer.submit_many` exactly.
        Pipelined: the whole iterable is enqueued before any outcome is
        awaited, so the worker folds it as micro-batches; the
        stop-at-first-rejection contract survives via a shared abort token
        the worker checks per report (reports after a rejection are skipped,
        never validated or aggregated)."""
        loop = asyncio.get_running_loop()
        group = _SubmitGroup()
        futs = []
        for r in reports:
            fut: asyncio.Future = loop.create_future()
            await self._queue.put((r, fut, group))
            futs.append(fut)
        outcomes = await asyncio.gather(*futs, return_exceptions=True)
        for out in outcomes:
            if isinstance(out, BaseException) \
                    and not isinstance(out, SubmitAborted):
                raise out

    async def join(self) -> None:
        """Wait until every enqueued submission has been applied."""
        await self._queue.join()

    async def _run(self) -> None:
        while True:
            batch = [await self._queue.get()]
            while len(batch) < self.batch_max:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                async with self._lock:
                    self._fold_batch(batch)
            except Exception as e:             # noqa: BLE001 — worker must
                # survive; _fold_batch already fanned out per-report errors,
                # so anything landing here is systemic — fail the batch's
                # still-unresolved futures rather than hang their awaiters
                for _, fut, _ in batch:
                    self._resolve(fut, exc=e)
            finally:
                for _ in batch:
                    self._queue.task_done()

    def _fold_batch(self, batch) -> None:
        """Fold one drained micro-batch under the lock: per-report
        validation and deferred-refactor policy in arrival order (each bad
        report rejects alone, bit-for-bit the sequential semantics), then
        ONE :meth:`AFLServer._apply_validated` pass — one stacked statistics
        merge, one grouped rank-(Σk) factor sweep — with the fold outcomes
        fanned back to the per-report futures."""
        srv = self._server
        seen = set(srv._seen)
        items = []                    # (client_id, upload, root-or-None)
        futs = []                     # aligned with items
        # the policy trajectory is fully determined by root ranks and the
        # cache-alive state, so simulate the sequential per-report decisions
        # upfront; _try_factor_update_batch then reproduces exactly these
        # survived flags from the roots we hand it
        cache_alive = bool(srv._factor_cache)
        updatable = cache_alive and all(
            f.updatable for f in srv._factor_cache.values())
        applied = self._applied_rank
        for report, fut, group in batch:
            if group is not None and group.failed:
                self._resolve(fut, exc=SubmitAborted(
                    "skipped: an earlier report in this submit_many call "
                    "was rejected"))
                continue
            try:
                upload, root = srv._validate_report(report, seen)
            except Exception as e:             # noqa: BLE001 — per-report
                self._record_rejected(report, e)
                if group is not None:
                    group.failed = True
                self._resolve(fut, exc=e)
                continue
            seen.add(report.client_id)
            rank = 0 if root is None else int(root.shape[0])
            # rank 0 (an empty client's root) folds trivially — same
            # outcome as the sync server, no reason to kill the cache
            usable = root is not None and rank <= srv.update_rank_budget
            over = (applied + rank > self.refactor_rank
                    or self._error_proxy(applied + rank) > self.error_budget)
            if not (usable and not over):
                # policy says refactor: strip the root so the cache dies and
                # the NEXT solve pays the d³ once for this and any further
                # cache-killing arrivals in the burst
                root = None
            if cache_alive:
                survived = root is not None and updatable
                if survived:
                    applied += rank
                    self.updates += 1 if rank else 0
                else:
                    # fold refused (policy, or non-updatable pinv fallback)
                    applied = 0
                    cache_alive = False
                    self.deferred_refactors += 1
            items.append((report.client_id, upload, root))
            futs.append(fut)
        self._applied_rank = applied
        if items:
            flags = srv._apply_validated(items)
            for fut, flag in zip(futs, flags):
                self._resolve(fut, result=flag)
        self.batches_folded += 1
        self.last_batch = len(batch)

    def _record_rejected(self, report, exc: Exception) -> None:
        if len(self.rejected) == self.rejected.maxlen:
            self.rejected_dropped += 1
        self.rejected.append((getattr(report, "client_id", None), str(exc)))

    @staticmethod
    def _resolve(fut: Optional[asyncio.Future], result=None,
                 exc: Optional[BaseException] = None) -> None:
        if fut is None or fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _error_proxy(self, applied_rank: int) -> float:
        """Worst-case relative drift of a factor after ``applied_rank``
        rank-1 sweeps: each sweep is d Householder rotations, each backward
        stable to O(ε) — proxy ε·√d per sweep, summed."""
        eps = float(np.finfo(np.float64).eps)
        return eps * np.sqrt(self._server.dim) * applied_rank

    # -- serving side -------------------------------------------------------

    async def solve(self, target_gamma: float = 0.0) -> np.ndarray:
        """Joint solution over every *applied* arrival, from the live factor
        (rank-updated in place, or refactored here if a deferral is due)."""
        async with self._lock:
            return self._server.solve(target_gamma)

    async def solve_multi_gamma(self, gammas: Sequence[float]) -> list:
        """γ sweep over everything applied, served from the wrapped
        server's rank-updated eigendecomposition handle: low-rank arrivals
        fold into the cached eigenbasis (Woodbury) instead of forcing a d³
        re-factorization per sweep — the event-loop twin of the factor-cache
        rank updates on the single-solve path."""
        async with self._lock:
            return self._server.solve_multi_gamma(gammas)

    async def sweep(self, gammas: Sequence[float], holdout) -> GammaSweep:
        """Server-side γ cross-validation off the cached (rank-updated)
        eigendecomposition — see :meth:`solve_multi_gamma`."""
        async with self._lock:
            weights = self._server.solve_multi_gamma(gammas)
        return _sweep_from_weights(weights, gammas, holdout)

    async def weights(self, target_gamma: float = 0.0, *,
                      if_etag: Optional[str] = None) -> VersionedWeights:
        """Versioned solved-head download over everything *applied* so far
        (see :meth:`repro_torch.fl.api.AFLServer.weights`)."""
        async with self._lock:
            return self._server.weights(target_gamma, if_etag=if_etag)

    # -- checkpointing ------------------------------------------------------

    async def state(self) -> Dict[str, np.ndarray]:
        """Serializable state of everything *applied* so far (same schema as
        :meth:`AFLServer.state`; ``await join()`` first to include queued
        arrivals)."""
        async with self._lock:
            return self._server.state()

    async def checkpoint(self) -> Dict[str, np.ndarray]:
        """Drain-then-state: wait for every queued arrival to apply, then
        snapshot — the consistent cut a failover daemon wants (a plain
        :meth:`state` can miss reports still sitting in the ingest queue)."""
        await self.join()
        return await self.state()

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray],
                   num_classes: Optional[int] = None,
                   **kwargs) -> "AsyncAFLServer":
        """Rebuild an (unstarted) async coordinator from a checkpoint; use
        ``async with`` / ``await start()`` to bring the worker up."""
        server = AFLServer.from_state(state, num_classes)
        return cls(server.dim, server.num_classes, server.gamma,
                   server=server, **kwargs)

    # -- introspection ------------------------------------------------------

    @property
    def num_clients(self) -> int:
        """Clients applied so far (excludes queued-but-unapplied)."""
        return self._server.num_clients

    @property
    def version(self) -> int:
        """Submission epoch of everything *applied* so far."""
        return self._server.version

    @property
    def pending(self) -> int:
        return self._queue.qsize()

    @property
    def server(self) -> AFLServer:
        """The wrapped synchronous server (shared statistics, same cache)."""
        return self._server

    def new_etag_salt(self) -> str:
        """Mint a fresh ETag salt (see :meth:`AFLServer.new_etag_salt`) —
        tokens are minted by the wrapped server, so the salt lives there.
        Synchronous: an identity change (promotion) happens outside the
        serving loop."""
        return self._server.new_etag_salt()
