"""The AFL client/coordinator API.

The port of ``repro.fl.api``:

  * :class:`ClientReport` — the canonical, versioned wire format of a client
    upload: regularized sufficient statistics (C_k^r, Q_k), the sample count,
    and an optional low-rank root of the raw Gram. ``to_bytes()`` /
    ``from_bytes()`` are byte-compatible with the reference package: a
    report written by either parses in the other.
  * :class:`AFLClient` — the one-epoch local stage: (optionally) embed with a
    frozen backbone / feature map, fold batches into engine ``SuffStats``
    (on a torch device, optionally through the CUDA Gram kernel), track a
    low-rank QR root, and emit one :class:`ClientReport`.
  * :class:`Coordinator` — the protocol every server-side implementation
    satisfies: ``submit / submit_many / solve / solve_multi_gamma /
    sweep(gammas, holdout) / weights / state / num_clients / version``.
    :class:`AFLServer` (synchronous, cached rank-updatable Cholesky) and
    :class:`~repro_torch.fl.async_server.AsyncAFLServer` (event-loop
    serving over the same seam) implement it, and so does the wire-true
    :class:`~repro_torch.fl.service.RemoteCoordinator`.
  * :class:`Transport` — the bytes-in / bytes-out seam of the service layer
    (:mod:`repro_torch.fl.service`, :mod:`repro_torch.fl.mux`).
  * :class:`AFLServer` — the synchronous coordinator: host-f64 aggregation
    with a cached, rank-updatable Cholesky, γ sweeps, versioned weights and
    ``state`` / ``from_state`` checkpoints in the reference's schema.
  * :class:`ShardedCoordinator` — the 1000-client backend: per-shard
    host-f64 accumulators (or row tiles of one global Gram) solved as one
    collective over an in-process shard mesh
    (:mod:`repro_torch.core.distributed`), elastic (``grow`` / ``shrink`` /
    exact resharding ``from_state``), with the same checkpoint schema.

All aggregation math routes through
:class:`repro_torch.core.engine.AnalyticEngine`; failure modes are the typed
taxonomy of :mod:`repro_torch.fl.errors`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import struct
import uuid
import zlib
from typing import (Callable, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.core.distributed import (federation_mesh, make_federated_solve,
                                          make_tiled_federated_solve, mesh_devices)
from repro_torch.core.engine import (AnalyticEngine, Factorization, SuffStats,
                                     SweepFactorization, SweepRefreshNeeded,
                                     to_numpy)
from repro_torch.core.streaming import AnalyticState
from repro_torch.fl.errors import (BadRequest, Backpressure, DuplicateClient,
                                   EmptyFederation, GammaMismatch)

__all__ = [
    "SCHEMA_VERSION",
    "ClientReport",
    "AFLClient",
    "make_report",
    "masked_reports",
    "evaluate_weight",
    "GammaSweep",
    "VersionedWeights",
    "Coordinator",
    "Transport",
    "AFLServer",
    "ShardedCoordinator",
]

# ---------------------------------------------------------------------------
# Canonical wire format
# ---------------------------------------------------------------------------

SCHEMA_VERSION = 1
_MAGIC = b"AFLR"
_WIRE_DTYPES = {"float64": np.float64, "float32": np.float32}


@dataclasses.dataclass(frozen=True)
class ClientReport:
    """What one client uploads: regularized sufficient statistics.

    gram:   C_k^r = X_kᵀX_k + γI   (d, d)
    moment: Q_k   = X_kᵀY_k        (d, C)
    (Equivalent information to the paper's (Ŵ_k^r, C_k^r) upload —
    Q_k = C_k^r Ŵ_k^r — but numerically nicer to accumulate.)
    count: number of local samples (diagnostics only; 0 when unknown).
    root:  optional (n_k, d) square root of the RAW Gram, ``rootᵀroot =
           X_kᵀX_k`` (e.g. the R factor of QR(X_k)). It carries exactly the
           information already in ``gram`` — no extra privacy exposure — but
           lets a coordinator fold the arrival into a cached Cholesky factor
           as a rank-n_k update instead of refactoring. ``None`` (unknown
           root, e.g. after masking) forces the refactor path.

    Wire format (``to_bytes`` / ``from_bytes``), schema version 1::

        b"AFLR" | u32 header_len | header JSON | gram | moment | [root]

    Arrays travel C-order in the header-declared dtype; the header carries a
    CRC-32 of the payload, so a flipped or truncated byte is rejected on
    ingest (``ValueError``), as are unknown versions/dtypes and inconsistent
    shapes. The default encoding (float64, uncompressed root) round-trips
    **losslessly**; ``dtype=np.float32`` halves the wire size at ~1e-7
    relative error, and ``compress_root=True`` stores only the root in f32
    (the folded rootᵀ·root then deviates by ≲1e-6 relative — documented
    tolerance for the rank-update path; gram/moment stay exact).
    """

    client_id: int
    gram: np.ndarray
    moment: np.ndarray
    gamma: float
    count: float = 0.0
    root: Optional[np.ndarray] = None

    def to_bytes(self, *, dtype=np.float64, compress_root: bool = False) -> bytes:
        """Serialize to the canonical wire format (see class docstring)."""
        dt = np.dtype(dtype)
        if dt.name not in _WIRE_DTYPES:
            raise ValueError(f"unsupported wire dtype {dt.name!r} "
                             f"(one of {sorted(_WIRE_DTYPES)})")
        gram = np.ascontiguousarray(np.asarray(self.gram, dt))
        if gram.ndim != 2 or gram.shape[0] != gram.shape[1]:
            raise ValueError(f"gram must be square, got {gram.shape}")
        moment = np.ascontiguousarray(np.asarray(self.moment, dt))
        if moment.ndim != 2 or moment.shape[0] != gram.shape[0]:
            raise ValueError(f"moment shape {moment.shape} does not match "
                             f"dim {gram.shape[0]}")
        root = None
        root_dt = np.dtype(np.float32) if compress_root else dt
        if self.root is not None:
            root = np.ascontiguousarray(
                np.asarray(self.root, root_dt).reshape(-1, gram.shape[0]))
        payload = gram.tobytes() + moment.tobytes() + (
            root.tobytes() if root is not None else b"")
        header = {
            "version": SCHEMA_VERSION,
            "client_id": int(self.client_id),
            "gamma": float(self.gamma),
            "count": float(self.count),
            "dtype": dt.name,
            "dim": int(gram.shape[0]),
            "num_classes": int(moment.shape[1]),
            "root_dtype": root_dt.name if root is not None else None,
            "root_rows": int(root.shape[0]) if root is not None else None,
            "crc32": zlib.crc32(payload),
        }
        hb = json.dumps(header, sort_keys=True).encode("utf-8")
        return _MAGIC + struct.pack("<I", len(hb)) + hb + payload

    @classmethod
    def from_bytes(cls, data: bytes) -> "ClientReport":
        """Parse + validate a wire report; arrays land host-f64.

        Raises ``ValueError`` for anything that is not a well-formed,
        checksum-clean, schema-consistent version-1 report.
        """
        data = bytes(data)
        if len(data) < len(_MAGIC) + 4 or data[: len(_MAGIC)] != _MAGIC:
            raise ValueError("not an AFL client report (bad magic)")
        (hlen,) = struct.unpack("<I", data[len(_MAGIC): len(_MAGIC) + 4])
        body = len(_MAGIC) + 4
        if len(data) < body + hlen:
            raise ValueError("truncated report header")
        try:
            header = json.loads(data[body: body + hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"corrupt report header: {e}") from None
        if header.get("version") != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported report schema version {header.get('version')!r}"
                f" (expected {SCHEMA_VERSION})")
        try:
            dt = _WIRE_DTYPES[header["dtype"]]
            dim, num_classes = int(header["dim"]), int(header["num_classes"])
            root_rows = header["root_rows"]
            root_dt = (_WIRE_DTYPES[header["root_dtype"]]
                       if root_rows is not None else None)
            client_id = int(header["client_id"])
            gamma, count = float(header["gamma"]), float(header["count"])
            crc = int(header["crc32"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed report header: {e}") from None
        if dim <= 0 or num_classes <= 0 or (
                root_rows is not None and root_rows < 0):
            raise ValueError("malformed report header: non-positive shapes")
        isz = np.dtype(dt).itemsize
        n_gram, n_mom = dim * dim * isz, dim * num_classes * isz
        n_root = (root_rows * dim * np.dtype(root_dt).itemsize
                  if root_rows is not None else 0)
        payload = data[body + hlen:]
        if len(payload) != n_gram + n_mom + n_root:
            raise ValueError(
                f"payload length {len(payload)} does not match header shapes")
        if zlib.crc32(payload) != crc:
            raise ValueError("report payload failed its CRC-32 check")
        gram = np.frombuffer(payload, dt, dim * dim).reshape(dim, dim)
        moment = np.frombuffer(
            payload, dt, dim * num_classes, offset=n_gram
        ).reshape(dim, num_classes)
        root = None
        if root_rows is not None:
            root = np.frombuffer(
                payload, root_dt, root_rows * dim, offset=n_gram + n_mom
            ).reshape(root_rows, dim).astype(np.float64)
        if not (np.isfinite(gram).all() and np.isfinite(moment).all()
                and (root is None or np.isfinite(root).all())
                and np.isfinite(gamma) and np.isfinite(count)):
            raise ValueError("report carries non-finite statistics")
        return cls(client_id, gram.astype(np.float64),
                   moment.astype(np.float64), gamma, count=count, root=root)


# ---------------------------------------------------------------------------
# The client side
# ---------------------------------------------------------------------------


class AFLClient:
    """One client's local stage, start to finish.

    ``update()`` folds (token or feature) batches — embedding them first when
    a frozen ``backbone_fn`` / ``feature_map`` is configured — into engine
    :class:`~repro_torch.core.engine.SuffStats`; ``report()`` emits the single
    canonical :class:`ClientReport` (regularized Gram, moment, sample count,
    and — while the local row count stays below ``d`` — the low-rank QR root
    of the raw Gram that lets coordinators rank-update cached factors).

    >>> report = AFLClient(client_id=3, gamma=1.0).local_stage(x, y_onehot)
    >>> payload = report.to_bytes()            # ...crosses the network...
    >>> server.submit(ClientReport.from_bytes(payload))

    The engine backend is pluggable: ``numpy_f64`` (default, paper-faithful
    host arithmetic) or ``torch`` (accumulation on ``device`` — CUDA unless
    another is named — in ``dtype``, f32 by default; ``use_kernel=True``
    folds batches through the CUDA Gram kernel, ``kahan=True`` compensates
    the f32 sums). Whatever the backend, the report is host f64.
    """

    def __init__(
        self,
        client_id: int,
        gamma: float = 1.0,
        *,
        backbone_fn: Optional[Callable] = None,
        feature_map: Optional[Callable] = None,
        backend: str = "numpy_f64",
        dtype=None,
        device=None,
        use_kernel: bool = False,
        kahan: bool = False,
        embed_batch: int = 256,
    ):
        self.client_id = client_id
        self.gamma = float(gamma)
        self.backbone_fn = backbone_fn
        self.feature_map = feature_map
        self.embed_batch = int(embed_batch)
        self.engine = AnalyticEngine(
            backend, gamma=gamma, dtype=dtype, device=device,
            use_kernel=use_kernel, kahan=kahan)
        self._stats: Optional[SuffStats] = None
        self._root_blocks: Optional[List[np.ndarray]] = []
        self._rows = 0

    def _embed(self, x):
        if self.backbone_fn is not None:
            x = np.asarray(x)
            b = self.embed_batch
            x = np.concatenate(
                [to_numpy(self.backbone_fn(x[i: i + b]), None)
                 for i in range(0, len(x), b)], 0) if len(x) else x
        if self.feature_map is not None:
            x = to_numpy(self.feature_map(x), None)
        return x

    def update(self, x, y_onehot) -> "AFLClient":
        """Fold one batch of local data into the running statistics."""
        x = self._embed(x)
        dim = int(x.shape[-1])
        classes = int(y_onehot.shape[-1])
        if self._stats is None:
            self._stats = self.engine.init(dim, classes)
        if self._stats.dim != dim:
            raise ValueError(
                f"batch dim {dim} != client dim {self._stats.dim}")
        self._stats = self.engine.update(self._stats, x, y_onehot)
        n = math.prod(x.shape[:-1])
        self._rows += n
        if self._root_blocks is not None:
            if self._rows >= dim:
                # a ≥ d-row root is no cheaper than a refactor — stop tracking
                self._root_blocks = None
            elif n:
                # a host copy of the batch while the rows stay below d
                self._root_blocks.append(to_numpy(x).reshape(-1, dim))
        return self

    def report(self) -> ClientReport:
        """Finish the local stage: one canonical report (host f64)."""
        if self._stats is None:
            raise ValueError("no local data folded in (call update first)")
        stats = self.engine.finalize_client(self._stats)
        gram = to_numpy(self.engine.regularized_gram(stats))
        moment = to_numpy(stats.moment)
        root = None
        if self._root_blocks is not None:
            rows = (np.concatenate(self._root_blocks, 0) if self._root_blocks
                    else np.zeros((0, stats.dim)))
            root = np.linalg.qr(rows, mode="r") if len(rows) else rows
        return ClientReport(self.client_id, gram, moment, self.gamma,
                            count=float(stats.count), root=root)

    def local_stage(self, x, y_onehot) -> ClientReport:
        """One-shot convenience: ``update(x, y)`` then ``report()``."""
        return self.update(x, y_onehot).report()


def make_report(client_id: int, x: np.ndarray, y_onehot: np.ndarray,
                gamma: float) -> ClientReport:
    """One client's local stage → upload (thin :class:`AFLClient` wrapper)."""
    return AFLClient(client_id, gamma=gamma).local_stage(x, y_onehot)


def masked_reports(reports: Sequence[ClientReport],
                   seed: int = 0) -> list[ClientReport]:
    """SecAgg-style pairwise masking of the uploads.

    Every pair (u, v), u < v derives a shared mask from a common seed; u adds
    it, v subtracts it. Any single report is then statistically useless to
    the server, but Σ reports is unchanged — and since AFL aggregation IS
    that sum, the masked protocol is exact (tested to ~1e-9).
    """
    n = len(reports)
    masked_g = [r.gram.astype(np.float64).copy() for r in reports]
    masked_q = [r.moment.astype(np.float64).copy() for r in reports]
    for u in range(n):
        for v in range(u + 1, n):
            rng = np.random.default_rng(
                (seed, reports[u].client_id, reports[v].client_id))
            mg = rng.standard_normal(masked_g[u].shape)
            mq = rng.standard_normal(masked_q[u].shape)
            masked_g[u] += mg
            masked_g[v] -= mg
            masked_q[u] += mq
            masked_q[v] -= mq
    return [
        # the mask is dense and full-rank, so a masked gram has no usable
        # low-rank root — drop it and let the server take the refactor path
        dataclasses.replace(r, gram=g, moment=q, root=None)
        for r, g, q in zip(reports, masked_g, masked_q)
    ]


# ---------------------------------------------------------------------------
# Coordinator helpers
# ---------------------------------------------------------------------------


def evaluate_weight(weight, x, y) -> float:
    """Top-1 accuracy of a linear head ``weight`` on features/int labels."""
    pred = np.argmax(to_numpy(x, None) @ to_numpy(weight, None), axis=-1)
    return float(np.mean(pred == to_numpy(y, None)))


@dataclasses.dataclass(frozen=True)
class VersionedWeights:
    """A solved-head snapshot stamped with its ETag-style staleness token.

    ``etag`` is opaque and binds everything that identifies THIS head: the
    coordinator's submission epoch (``version``, bumped on every successful
    submit), the requested ``target_gamma``, and a per-coordinator-instance
    salt (so a token minted before a checkpoint restore can never
    accidentally match a restored server that happens to reach the same
    epoch count). A downloader that remembers its last token asks
    ``weights(target_gamma, if_etag=token)`` and gets a cheap not-modified
    answer (``weight is None``) instead of a re-solve + re-download when
    nothing new arrived — and a token minted for one γ can never validate a
    download of another.
    """

    version: int
    target_gamma: float
    weight: Optional[np.ndarray]
    etag: str = ""

    @property
    def not_modified(self) -> bool:
        return self.weight is None


@dataclasses.dataclass(frozen=True)
class GammaSweep:
    """Result of a server-side γ model sweep against a holdout set."""

    gammas: Tuple[float, ...]
    weights: List[np.ndarray]
    accuracies: Tuple[float, ...]
    best_gamma: float
    best_weight: np.ndarray

    @property
    def best_accuracy(self) -> float:
        return max(self.accuracies)


def _sweep_from_weights(weights: Sequence[np.ndarray],
                        gammas: Sequence[float], holdout) -> GammaSweep:
    x, y = holdout
    accs = tuple(evaluate_weight(w, x, y) for w in weights)
    best = int(np.argmax(accs))
    return GammaSweep(tuple(float(g) for g in gammas), list(weights), accs,
                      float(gammas[best]), weights[best])


def _ingest_upload(report: ClientReport, *, dim: int, gamma: float,
                   seen) -> SuffStats:
    """Shared coordinator ingest: duplicate-id and γ checks, then strip the
    lazily re-derivable γI (uploads carry the regularized C_k^r, the engine
    keeps raw Grams with lazy per-client γ)."""
    if report.client_id in seen:
        raise DuplicateClient(f"client {report.client_id} already aggregated")
    if report.gamma != gamma:
        raise GammaMismatch(f"client γ={report.gamma} != server γ={gamma}")
    # subtract γ on the diagonal only — bitwise equal to the full
    # ``gram − γ·eye`` (x − 0.0 ≡ x in IEEE, −0.0 included) at O(d) instead
    # of materializing and subtracting a d² identity per report
    raw = np.array(report.gram, np.float64, copy=True)
    if raw.shape != (dim, dim):
        raise ValueError(
            f"report gram shape {raw.shape} != ({dim}, {dim})")
    idx = np.arange(dim)
    raw[idx, idx] -= gamma
    return SuffStats(
        gram=raw,
        moment=np.asarray(report.moment, np.float64),
        count=float(report.count),
        clients=1.0,
    )


def _restore_stats(state: Dict[str, np.ndarray], gamma: float, dim: int):
    """Shared checkpoint restore: (SuffStats, seen ids) from the one state
    schema every coordinator writes (regularized aggregate → raw + k)."""
    seen = set(int(i) for i in state["seen"])
    k = len(seen)
    gram = np.array(state["gram"], np.float64) - k * gamma * np.eye(dim)
    diag = state.get("gram_diag_raw")
    if diag is not None:
        # The regularized form loses last-ulp diagonal bits to the
        # +kγ − kγ round trip; checkpoints also carry the raw diagonal
        # (d scalars — negligible next to the d² gram) so a restore is
        # bit-for-bit lossless. Off-diagonal entries are untouched by
        # regularization and were exact already.
        np.fill_diagonal(gram, np.asarray(diag, np.float64))
    stats = SuffStats(
        gram=gram,
        moment=np.array(state["moment"], np.float64),
        # older checkpoints predate the count field — restore as 0
        count=float(state.get("count", 0.0)),
        clients=float(k),
    )
    return stats, seen


def _validate_state(state: Dict[str, np.ndarray],
                    num_classes: Optional[int] = None) -> Tuple[int, int]:
    """Up-front checkpoint validation shared by every ``from_state``:
    returns ``(dim, num_classes)`` or raises the typed ``bad_request``.

    Without this, a caller-supplied ``num_classes`` that contradicts the
    checkpointed moment shape used to construct a coordinator whose solves
    crashed much later with an opaque broadcasting error."""
    try:
        gram = np.asarray(state["gram"])
        moment = np.asarray(state["moment"])
    except KeyError as exc:
        raise BadRequest(f"checkpoint missing key {exc}") from None
    if gram.ndim != 2 or gram.shape[0] != gram.shape[1]:
        raise BadRequest(f"checkpoint gram must be square, got {gram.shape}")
    if moment.ndim != 2 or moment.shape[0] != gram.shape[0]:
        raise BadRequest(
            f"checkpoint moment shape {moment.shape} does not match "
            f"gram dim {gram.shape[0]}")
    classes = int(moment.shape[1])
    if num_classes is not None and int(num_classes) != classes:
        raise BadRequest(
            f"num_classes={num_classes} contradicts the checkpoint moment "
            f"shape {tuple(moment.shape)} ({classes} classes)")
    return int(gram.shape[0]), classes


@runtime_checkable
class Coordinator(Protocol):
    """What every AFL coordinator — sync, async, sharded — satisfies.

    Methods may be coroutines (``AsyncAFLServer``); callers that must not
    care use ``await``-when-awaitable dispatch (see the conformance suite).
    ``submit`` returns the fold outcome: True when any cached factorization
    survived the arrival (rank-updated in place, or nothing was cached),
    False when the next solve will refactor. ``version`` is the submission
    epoch — it changes on every successful submit — and ``weights`` returns
    a :class:`VersionedWeights` snapshot honoring ``if_etag`` as an
    ETag-style staleness token (opaque; binds epoch + γ + instance).
    """

    dim: int
    num_classes: int
    gamma: float

    @property
    def num_clients(self) -> int: ...

    @property
    def version(self) -> int: ...

    def submit(self, report: ClientReport): ...

    def submit_many(self, reports: Iterable[ClientReport]): ...

    def solve(self, target_gamma: float = 0.0): ...

    def solve_multi_gamma(self, gammas: Sequence[float]): ...

    def sweep(self, gammas: Sequence[float], holdout): ...

    def weights(self, target_gamma: float = 0.0, *,
                if_etag: Optional[str] = None): ...

    def state(self) -> Dict[str, np.ndarray]: ...


@runtime_checkable
class Transport(Protocol):
    """What every service transport satisfies — opaque byte envelopes in,
    opaque byte envelopes out, no knowledge of what they carry. Implemented
    by :class:`~repro_torch.fl.service.InProcTransport`,
    :class:`~repro_torch.fl.service.HttpTransport`, and
    :class:`~repro_torch.fl.mux.MuxTransport`; anything satisfying it plugs into
    :class:`~repro_torch.fl.service.RemoteCoordinator` unchanged."""

    def request(self, route: str, body: bytes = b"",
                federation: str = "default") -> bytes: ...

    def close(self) -> None: ...


# ---------------------------------------------------------------------------
# Synchronous coordinator
# ---------------------------------------------------------------------------


class AFLServer:
    """Incremental AFL aggregation with RI restore at solve time.

    >>> server = AFLServer(dim=d, num_classes=c, gamma=1.0)
    >>> server.submit(report)              # any order, any time
    >>> w = server.solve()                 # exact joint weight over arrivals

    The AA law makes sufficient statistics additive ⇒ clients aggregate
    **incrementally, in any order, at any time**; after any subset S has
    reported, ``solve()`` is the exact joint solution over ∪S (Thm 1), and a
    straggler that reports later just extends the subset. ``solve()`` factors
    the regularized aggregate once per submission epoch (and per distinct
    ``target_gamma``); repeated polls between arrivals reuse the cached
    factor. A ``submit`` whose report carries a low-rank ``root`` (n_k ≤
    ``update_rank_budget``) folds the arrival into every cached factor as an
    O(n_k·d²) rank update; any other submit invalidates the cache and the
    next solve refactors.
    """

    def __init__(self, dim: int, num_classes: int, gamma: float = 1.0,
                 *, update_rank_budget: Optional[int] = None,
                 sweep_rank_budget: Optional[int] = None):
        self.dim = dim
        self.num_classes = num_classes
        self.gamma = gamma
        self.engine = AnalyticEngine("numpy_f64", gamma=gamma)
        # Rank-update crossover: past ~d/16 rows the k fused rank-1 sweeps
        # cost as much as the BLAS refactor (measured at d=2048 in
        # benchmarks/async_server_bench.py; small d always favors refactor).
        self.update_rank_budget = (
            max(1, dim // 16) if update_rank_budget is None
            else int(update_rank_budget))
        # Sweep-handle crossover: the eigendecomposition behind
        # solve_multi_gamma is ~10× a Cholesky, so the Woodbury-updated
        # handle stays worthwhile to much higher accumulated rank than the
        # d/16 factor budget — past ~d/8 pending rows the per-γ k×k extras
        # rival a fresh eigh (measured in benchmarks/solve_kernels_bench.py).
        self.sweep_rank_budget = (
            max(1, dim // 8) if sweep_rank_budget is None
            else int(sweep_rank_budget))
        self._stats = self.engine.init(dim, num_classes)
        self._seen: set[int] = set()
        self._factor_cache: Dict[float, Factorization] = {}
        self._sweep_cache: Optional[SweepFactorization] = None
        self._version = 0
        # per-instance etag salt: tokens minted against THIS coordinator can
        # never validate against a restored/rebuilt one at the same epoch
        self._etag_salt = uuid.uuid4().hex[:8]

    @property
    def num_clients(self) -> int:
        return len(self._seen)

    @property
    def version(self) -> int:
        """Submission epoch: bumps on every successful submit. The staleness
        token :meth:`weights` honors (restored checkpoints resume at k)."""
        return self._version

    def submit(self, report: ClientReport) -> bool:
        """Merge one upload; returns True when the cached factors survived
        (rank-updated in place, or nothing was cached), False when the
        arrival invalidated them and the next solve will refactor."""
        upload = _ingest_upload(report, dim=self.dim, gamma=self.gamma,
                                seen=self._seen)
        self._stats = self.engine.merge(self._stats, upload)
        self._seen.add(report.client_id)
        self._version += 1
        self._maintain_sweep_cache(report.root)
        if self._try_factor_update(report.root):
            return True
        self._factor_cache.clear()
        return False

    def _maintain_sweep_cache(self, root: Optional[np.ndarray]) -> None:
        """Fold an arrival's root into the cached eigendecomposition handle
        (Woodbury pending set), or drop the handle when the arrival has no
        root / would push past the sweep rank budget. Independent of the
        Cholesky factor cache — the two have different crossovers."""
        h = self._sweep_cache
        if h is None:
            return
        if root is None:
            self._sweep_cache = None
            return
        root = np.asarray(root, np.float64).reshape(-1, self.dim)
        if h.rank + root.shape[0] > self.sweep_rank_budget:
            self._sweep_cache = None
            return
        self._sweep_cache = h.rank_update(root)

    def _try_factor_update(self, root: Optional[np.ndarray]) -> bool:
        """Fold an arrival's low-rank root into every cached factor; False
        when the cache must be invalidated instead (no root, rank past the
        crossover, or a non-updatable pinv-fallback factor)."""
        if not self._factor_cache:
            return True                    # nothing cached — nothing to do
        if root is None:
            return False
        root = np.asarray(root, np.float64).reshape(-1, self.dim)
        if root.shape[0] > self.update_rank_budget:
            return False
        if not all(f.updatable for f in self._factor_cache.values()):
            return False
        self._factor_cache = {
            key: f.rank_update(root) for key, f in self._factor_cache.items()}
        return True

    def submit_many(self, reports: Iterable[ClientReport]) -> None:
        for r in reports:
            self.submit(r)

    # -- micro-batch fold ---------------------------------------------------

    def _validate_report(self, report: ClientReport, seen):
        """Validation half of a submit, against a caller-owned ``seen``
        overlay (so a batch can track intra-batch duplicates without
        touching coordinator state): reshapes the root, runs the ingest
        checks, touches nothing. Returns ``(upload, root)`` or raises."""
        root = report.root
        if root is not None:
            root = np.asarray(root, np.float64).reshape(-1, self.dim)
        upload = _ingest_upload(report, dim=self.dim, gamma=self.gamma,
                                seen=seen)
        return upload, root

    def _apply_validated(self, items) -> list:
        """Application half of a batched submit: ``items`` is a list of
        ``(client_id, upload, root)`` that already passed
        :meth:`_validate_report` (``root`` may be None — e.g. stripped by
        the async deferred-refactor policy). Cannot reject; returns the
        per-report fold-outcome bools. ONE stacked statistics merge and ONE
        grouped rank-(Σk) factor sweep replace the per-report passes,
        bit-for-bit equal to sequential submits."""
        self._stats = self.engine.merge_many(
            self._stats, [upload for _, upload, _ in items])
        for client_id, _, _ in items:
            self._seen.add(client_id)
        self._version += len(items)
        roots = [root for _, _, root in items]
        self._maintain_sweep_cache_batch(roots)
        return self._try_factor_update_batch(roots)

    def submit_batch(self, reports: Sequence[ClientReport]) -> list:
        """Fold a micro-batch of uploads in one pass.

        Each report validates individually — a bad one (duplicate id, γ
        mismatch, malformed arrays) rejects ALONE, recorded as the exception
        instance in its slot rather than raised, and the rest of the batch
        still folds. Returns a list aligned with ``reports``: the
        fold-outcome bool per accepted report (same meaning as
        :meth:`submit`) or the rejecting exception. State after the call is
        bit-for-bit what sequential :meth:`submit` calls (skipping the
        rejected reports) would leave — the property the conformance suite
        pins. Unlike bare :meth:`submit`, the root is validated BEFORE any
        state changes, so a malformed root cannot half-apply.
        """
        outcomes: list = [None] * len(reports)
        seen = set(self._seen)
        accepted = []
        for i, report in enumerate(reports):
            try:
                upload, root = self._validate_report(report, seen)
            except Exception as exc:           # noqa: BLE001 — per-report
                outcomes[i] = exc
                continue
            seen.add(report.client_id)
            accepted.append((i, report.client_id, upload, root))
        if accepted:
            flags = self._apply_validated(
                [(cid, upload, root) for _, cid, upload, root in accepted])
            for (i, *_), flag in zip(accepted, flags):
                outcomes[i] = flag
        return outcomes

    def _maintain_sweep_cache_batch(self, roots) -> None:
        """Batch twin of :meth:`_maintain_sweep_cache`. A cache-killing root
        anywhere in the batch drops the handle outright — sequential folds
        the prefix and then discards it, so skipping the dead projections
        reaches the identical end state with none of the work."""
        h = self._sweep_cache
        if h is None:
            return
        rank = h.rank
        for root in roots:
            if root is None:
                self._sweep_cache = None
                return
            rank += int(root.shape[0])
            if rank > self.sweep_rank_budget:
                self._sweep_cache = None
                return
        for root in roots:
            # per-root projections, in order — bitwise what sequential
            # rank_update calls produce (each projects against the same
            # fixed eigenbasis)
            h = h.rank_update(root)
        self._sweep_cache = h

    def _try_factor_update_batch(self, roots) -> list:
        """Batch twin of :meth:`_try_factor_update`: per-report survived
        flags under sequential semantics, fused execution. Updatable roots
        ahead of any cache kill fold as ONE grouped rank-(Σk) sweep per
        cached factor; a killer anywhere clears the cache with no prefix
        work (sequential's prefix updates die with the cache — same end
        state, bit for bit)."""
        flags = []
        alive = bool(self._factor_cache)
        updatable = alive and all(
            f.updatable for f in self._factor_cache.values())
        fuse = []
        killed = False
        for root in roots:
            if not alive:
                flags.append(True)         # nothing cached — nothing to do
                continue
            if (root is None or root.shape[0] > self.update_rank_budget
                    or not updatable):
                flags.append(False)
                alive = False
                killed = True
                continue
            fuse.append(root)
            flags.append(True)
        if killed:
            self._factor_cache.clear()
        elif fuse:
            self._factor_cache = {
                key: f.rank_update_many(fuse)
                for key, f in self._factor_cache.items()}
        return flags

    def solve(self, target_gamma: float = 0.0) -> np.ndarray:
        """Exact joint solution over all clients aggregated *so far*.

        RI restore (Thm 2): the engine's lazy-γ bookkeeping means the kγI of
        the k arrivals is never materialized; only ``target_gamma`` enters
        the system. Stragglers simply have not been added yet — calling
        solve() again after they report gives the exact larger-joint
        solution (and re-factors, since the statistics changed).
        """
        if not self._seen:
            raise EmptyFederation("no clients aggregated")
        key = float(target_gamma)
        fact = self._factor_cache.get(key)
        if fact is None:
            fact = self.engine.factor(self._stats, target_gamma=key)
            self._factor_cache[key] = fact
        return self.engine.factor_solve(fact, self._stats.moment)

    def solve_multi_gamma(self, gammas: Sequence[float]) -> list[np.ndarray]:
        """γ model sweep over the current aggregate from a CACHED
        eigendecomposition: the d³ eigh is paid once per cache lifetime, and
        low-rank arrivals rank-update the handle (exact Woodbury in the
        fixed eigenbasis) instead of invalidating it — repeated sweeps on an
        evolving federation cost d²·(C+k) per γ, not d³ each (see
        ``AnalyticEngine.sweep_factor``)."""
        if not self._seen:
            raise EmptyFederation("no clients aggregated")
        if self._sweep_cache is None:
            self._sweep_cache = self.engine.sweep_factor(self._stats)
        try:
            return self.engine.sweep_solve(self._sweep_cache,
                                           self._stats.moment, gammas)
        except SweepRefreshNeeded:
            # pending updates + spectral truncation: rebuild from current
            # statistics (a fresh handle always answers exactly)
            self._sweep_cache = self.engine.sweep_factor(self._stats)
            return self.engine.sweep_solve(self._sweep_cache,
                                           self._stats.moment, gammas)

    def sweep(self, gammas: Sequence[float], holdout) -> GammaSweep:
        """Server-side cross-validation: solve every candidate γ off ONE
        eigendecomposition and score each on ``holdout = (x, y)``."""
        return _sweep_from_weights(
            self.solve_multi_gamma(gammas), gammas, holdout)

    def _etag(self, target_gamma: float) -> str:
        return f"{self._etag_salt}-{self._version}-{float(target_gamma)!r}"

    def new_etag_salt(self) -> str:
        """Refresh the instance ETag salt, permanently invalidating every
        outstanding ``weights`` token. Tokens are *instance*-scoped on
        purpose: a restore, promotion, or reshard installs a coordinator
        whose state history diverges from the one that minted the token,
        so revalidating across the boundary could serve a stale head as
        fresh. New instances mint a fresh salt in ``__init__``; this is
        the hook for in-place identity changes (standby promotion, mesh
        resize)."""
        self._etag_salt = uuid.uuid4().hex[:8]
        return self._etag_salt

    def weights(self, target_gamma: float = 0.0, *,
                if_etag: Optional[str] = None) -> VersionedWeights:
        """Versioned solved-head download. ``if_etag`` equal to the current
        token for this (epoch, γ) short-circuits to a not-modified snapshot
        (``weight is None``) without solving; the token is opaque and
        γ-bound, so a head cached for one γ can never be revalidated as
        another's."""
        tag = self._etag(target_gamma)
        if if_etag is not None and str(if_etag) == tag:
            return VersionedWeights(self._version, float(target_gamma),
                                    None, tag)
        return VersionedWeights(self._version, float(target_gamma),
                                self.solve(target_gamma), tag)

    def state(self) -> Dict[str, np.ndarray]:
        """Serializable coordinator state, in the reference's checkpoint
        schema (a reference ``AFLServer.state()`` restores here and back). ``gram``
        is the paper-form regularized aggregate C_agg^r = ΣC_k^r, kept for
        format stability across the raw-Gram refactor."""
        return {
            "gram": self.engine.regularized_gram(self._stats).copy(),
            "moment": self._stats.moment.copy(),
            "seen": np.array(sorted(self._seen), np.int64),
            "gamma": np.float64(self.gamma),
            "count": np.float64(self._stats.count),
            # raw diagonal rider: restores undo +kγ on the diagonal, which
            # rounds — carrying the d raw entries makes restore bit-lossless
            "gram_diag_raw": np.array(np.diag(self._stats.gram), np.float64),
        }

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray],
                   num_classes: Optional[int] = None) -> "AFLServer":
        dim, classes = _validate_state(state, num_classes)
        srv = cls(dim, classes, float(state["gamma"]))
        srv._stats, srv._seen = _restore_stats(state, srv.gamma, dim)
        srv._version = len(srv._seen)
        return srv


# ---------------------------------------------------------------------------
# Sharded coordinator (the 1000-client backend)
# ---------------------------------------------------------------------------


class ShardedCoordinator:
    """AFL coordination with the statistics sharded over a shard mesh.

    The statistics of a K-client federation are a 4-leaf additive tuple, so
    at K≥1000 the coordinator does not need one global host aggregate:
    arrivals land in per-shard accumulators (host f64, so ingest stays exact
    and lock-free), and ``solve()`` runs the whole aggregation stage —
    per-shard partial sums → one psum → RI restore → Cholesky — as one
    collective via :func:`repro_torch.core.distributed.make_federated_solve`,
    each shard's (d, d) statistics uploaded to its own device.

    The mesh is :func:`~repro_torch.core.distributed.federation_mesh`'s: one
    thread a shard, shard ``i`` on ``devices[i % len(devices)]``
    (``devices`` as given, else ``device`` alone, else every visible CUDA
    device; ``device="cpu"`` runs on the CPU). Shards may share a card, so
    eight shards run on one. Device arithmetic is ``dtype`` (f32 by
    default, as jax's default precision; ``torch.float64`` is the
    1e-6-vs-sync conformance path), with no global switch.

    Placement is **load-aware** by default: ``submit`` routes each arrival
    to the emptiest shard (ties broken cyclically, so uniform traffic
    degenerates to exact round-robin), which keeps occupancy flat under
    skewed arrival patterns and makes :meth:`rebalance` a recovery tool
    rather than routine maintenance. ``placement="round_robin"`` keeps the
    plain cursor (placement never changes the aggregate — the AA law makes
    shard contents additive — only the occupancy profile). In this mode the
    shards are logical: they group onto ``min(num_shards, len(devices))``
    participants of the collective.

    ``tiled_gram=True`` changes what a shard *holds*: instead of a whole
    (d, d) partial aggregate per shard (psum of whole leaves), each shard
    keeps only its (d/shards, d) **row tile of the one global Gram** — every
    arrival's statistics are scattered across all tiles, so placement is the
    aggregation and per-shard resident memory scales as d²/shards. There is
    one participant a tile. ``solve()`` then runs
    :func:`~repro_torch.core.distributed.make_tiled_federated_solve` with
    ``distributed_factor=True`` (the default here): the factorization runs
    tile-parallel on the shards where the Gram lives — panel owners
    broadcast one (d, b) L-column per panel and every shard applies
    trsm and the trailing update to its own rows through the panel kernels
    — so no shard ever holds the full (d, d) system.
    ``distributed_factor=False`` is the gather-then-factor collective (one
    psum'd (d, d) system a shard). Dims that don't divide the shard count
    are padded up to the next tile multiple (zero pad rows, unit diagonal
    inside the solve, sliced away from the result — d=6144 on 7 shards
    just works); the explicit error remains only when padding would exceed
    one extra tile (e.g. dim=10 on 8 shards). A solve that comes back
    non-finite (rank-deficient γ=0 ablations) falls back to the host
    engine's pinv path on the merged statistics, and counts itself in
    :attr:`host_fallbacks`: a caller that needs the device's answer reads
    that count, since the host's answer is otherwise indistinguishable.

    ``solve_multi_gamma`` / ``sweep`` run on the merged statistics through
    the host engine — one eigendecomposition, every γ — matching
    :class:`AFLServer` exactly, and ``state()`` speaks the reference's
    checkpoint schema, so the coordinator kinds (of either package) are
    interchangeable behind :class:`Coordinator`.
    """

    def __init__(self, dim: int, num_classes: int, gamma: float = 1.0,
                 *, devices=None, device=None, dtype=None,
                 placement: str = "load_aware", tiled_gram: bool = False,
                 distributed_factor: bool = True,
                 num_shards: Optional[int] = None):
        self.dim = dim
        self.num_classes = num_classes
        self.gamma = gamma
        self.engine = AnalyticEngine("numpy_f64", gamma=gamma)
        self.tiled_gram = bool(tiled_gram)
        self.dtype = dtype or torch.float32
        self.devices = tuple(mesh_devices(devices, device))
        if num_shards is not None and int(num_shards) < 1:
            raise BadRequest(f"num_shards must be ≥1, got {num_shards}")
        n_shards = len(self.devices) if num_shards is None else int(num_shards)
        if placement not in ("load_aware", "round_robin"):
            raise ValueError(f"unknown placement policy {placement!r} "
                             "(load_aware | round_robin)")
        self.placement = placement
        self.distributed_factor = bool(distributed_factor)
        if self.tiled_gram:
            self._init_tiles(n_shards)
            self._shards: List[SuffStats] = []
        else:
            self._shards = [
                self.engine.init(dim, num_classes) for _ in range(n_shards)]
        self.mesh = self._make_mesh(n_shards)
        self._seen: set[int] = set()
        self._order = 0
        self._solve_fns: Dict[float, Callable] = {}
        self._version = 0
        self._mesh_epoch = 0
        self._resizing = False
        self._etag_salt = uuid.uuid4().hex[:8]
        self._last_rebalance: Optional[Tuple[int, int]] = None
        # solves whose device answer was non-finite and was replaced by the
        # host engine's (the γ = 0 pinv fallback)
        self.host_fallbacks = 0

    # -- elastic-mesh plumbing ----------------------------------------------

    def _make_mesh(self, n_shards: int) -> tuple:
        """The participants backing ``n_shards``: one a tile in tiled mode,
        else as many as there are devices (logical shards group onto
        them)."""
        n_dev = (n_shards if self.tiled_gram
                 else min(n_shards, len(self.devices)))
        try:
            return federation_mesh(n_dev, self.devices)
        except ValueError as exc:
            raise BadRequest(str(exc)) from None

    @staticmethod
    def _plan_tile_rows(dim: int, n_shards: int) -> int:
        """Rows per tile for ``dim`` over ``n_shards`` — indivisible dims
        pad up to the next tile multiple; prefer 8-row-aligned tiles
        (panel widths divide the tile) when alignment keeps the pad under
        one tile."""
        rows = -(-dim // n_shards)
        if rows >= 16:
            r8 = ((rows + 7) // 8) * 8
            if n_shards * r8 - dim < r8:
                rows = r8
        if n_shards * rows - dim >= rows:
            raise BadRequest(
                f"tiled_gram would pad dim={dim} by a full tile on "
                f"{n_shards} shards (tile_rows={rows}) — use fewer "
                f"shards or a wider head")
        return rows

    def _init_tiles(self, n_shards: int) -> None:
        rows = self._plan_tile_rows(self.dim, n_shards)
        self._tile_rows = rows
        self._dim_padded = n_shards * rows
        self._gram_tiles: List[np.ndarray] = [
            np.zeros((rows, self._dim_padded)) for _ in range(n_shards)]
        self._moment_tiles: List[np.ndarray] = [
            np.zeros((rows, self.num_classes)) for _ in range(n_shards)]
        self._count = 0.0

    def _scatter_tiles(self, gram: np.ndarray, moment: np.ndarray) -> None:
        """Place true-dim aggregate rows into the per-shard row tiles
        (pad rows stay zero) — the tiled restore/retile primitive."""
        r = self._tile_rows
        for i in range(self.num_shards):
            lo, hi = i * r, min(i * r + r, self.dim)
            if hi > lo:
                self._gram_tiles[i][:hi - lo, :self.dim] = gram[lo:hi]
                self._moment_tiles[i][:hi - lo] = moment[lo:hi]

    def _check_resizing(self) -> None:
        if self._resizing:
            raise Backpressure(
                f"mesh resize in flight (epoch {self._mesh_epoch} → "
                f"{self._mesh_epoch + 1}) — back off and retry")

    @property
    def mesh_epoch(self) -> int:
        """Bumps on every completed :meth:`grow`/:meth:`shrink`. In-flight
        requests that race a resize get a retryable backpressure error, so
        an epoch observed around a call brackets which mesh answered it."""
        return self._mesh_epoch

    @property
    def num_shards(self) -> int:
        return (len(self._gram_tiles) if self.tiled_gram
                else len(self._shards))

    @property
    def num_clients(self) -> int:
        return len(self._seen)

    @property
    def version(self) -> int:
        """Submission epoch (see :meth:`AFLServer.version`)."""
        return self._version

    def _place(self) -> int:
        """Pick the shard for the next arrival: emptiest under the default
        load-aware policy (cyclic tie-break from the round-robin cursor, so
        equal occupancy IS round-robin), or the plain cursor."""
        n = self.num_shards
        if self.placement == "round_robin":
            i = self._order % n
            self._order += 1
            return i
        occ = self.occupancy()
        low = min(occ)
        for off in range(n):
            j = (self._order + off) % n
            if occ[j] == low:
                self._order = j + 1
                return j
        raise AssertionError("unreachable: some shard holds the minimum")

    def submit(self, report: ClientReport) -> bool:
        """Merge one upload — into the emptiest shard (load-aware default),
        or scattered as row tiles across every shard in tiled-Gram mode.
        Returns True — the sharded backend keeps no host factor cache to
        invalidate (the device program refactors per solve), so every
        arrival 'survives'."""
        self._check_resizing()
        upload = _ingest_upload(report, dim=self.dim, gamma=self.gamma,
                                seen=self._seen)
        if self.tiled_gram:
            gram = np.asarray(upload.gram, np.float64)
            moment = np.asarray(upload.moment, np.float64)
            r = self._tile_rows
            for i in range(self.num_shards):
                lo, hi = i * r, min(i * r + r, self.dim)
                if hi > lo:
                    self._gram_tiles[i][:hi - lo, :self.dim] += gram[lo:hi]
                    self._moment_tiles[i][:hi - lo] += moment[lo:hi]
            self._count += float(upload.count)
        else:
            i = self._place()
            self._shards[i] = self.engine.merge(self._shards[i], upload)
        self._seen.add(report.client_id)
        self._version += 1
        return True

    def submit_many(self, reports: Iterable[ClientReport]) -> None:
        for r in reports:
            self.submit(r)

    def occupancy(self) -> List[int]:
        """Per-shard residency: clients per shard (the signal load-aware
        placement and :meth:`rebalance` act on), or — in tiled-Gram mode,
        where every client's statistics span all shards — the per-shard
        resident Gram rows (always balanced by construction)."""
        if self.tiled_gram:
            return [self._tile_rows] * self.num_shards
        return [int(s.clients) for s in self._shards]

    def rebalance(self) -> Optional[Tuple[int, int]]:
        """Migrate the fullest shard's statistics into the emptiest.

        The AA law makes shard contents additive, so migration is a merge:
        the aggregate — and therefore every solve — is invariant under it.
        This is the primitive mid-federation mesh growth / load-aware
        placement builds on: a new empty shard can absorb the hottest
        shard's load in O(d²) host work, no device traffic. The freed shard
        becomes the next round-robin target, so future arrivals fill the
        vacated slot first.

        Returns ``(src, dst)`` shard indices, or ``None`` when there is
        nothing to move: fewer than 2 shards, the fullest holds at most one
        more client than the emptiest, tiled-Gram mode (tiles are balanced
        by construction), or the candidate move would just undo this
        epoch's previous migration (without this guard,
        ``while coord.rebalance(): ...`` would ping-pong the same blob
        between two shards forever — at most one migration is performed per
        submission epoch).
        """
        self._check_resizing()
        if self.tiled_gram:
            return None
        occ = self.occupancy()
        if len(occ) < 2:
            return None
        src = int(np.argmax(occ))
        dst = int(np.argmin(occ))
        if occ[src] - occ[dst] <= 1:
            return None
        if self._last_rebalance == (self._version, src):
            return None                    # would re-move this epoch's blob
        self._shards[dst] = self.engine.merge(self._shards[dst],
                                              self._shards[src])
        self._shards[src] = self.engine.init(self.dim, self.num_classes)
        self._order = src                  # fill the vacated shard next
        self._last_rebalance = (self._version, dst)
        return src, dst

    def grow(self, n: int = 1) -> int:
        """Admit ``n`` fresh empty shards mid-federation.

        Exact by the AA law: the aggregate is a sum over shards and the new
        shards join empty, so every solve is invariant. Load-aware placement
        then fills the admitted shards first. In tiled-Gram mode the global
        Gram is re-tiled to the new row plan. Returns the new
        :attr:`mesh_epoch`.
        """
        if int(n) < 1:
            raise BadRequest(f"grow() admits ≥1 shard, got {n}")
        return self._resize(self.num_shards + int(n))

    def shrink(self, n: int = 1) -> int:
        """Retire the ``n`` highest-numbered shards, folding their
        statistics into the survivors (shard ``i`` → ``i % remaining`` —
        merge = migration, so solves are invariant). At least one shard must
        survive. Returns the new :attr:`mesh_epoch`."""
        if int(n) < 1:
            raise BadRequest(f"shrink() retires ≥1 shard, got {n}")
        if int(n) >= self.num_shards:
            raise BadRequest(
                f"cannot retire {n} of {self.num_shards} shards — at least "
                "one must survive")
        return self._resize(self.num_shards - int(n))

    def _resize(self, new_count: int) -> int:
        """Re-shard to ``new_count`` under the epoch guard: validate the new
        mesh and tile plan FIRST (a rejected resize must leave the
        coordinator untouched), then migrate, then bump the epoch. Requests
        racing the migration window get retryable :class:`Backpressure`."""
        new_count = int(new_count)
        if new_count == self.num_shards:
            return self._mesh_epoch
        if self.tiled_gram:
            rows = self._plan_tile_rows(self.dim, new_count)
        new_mesh = self._make_mesh(new_count)
        self._resizing = True
        try:
            if self.tiled_gram:
                agg = self._merged()       # true-dim rows, old tile plan
                self._tile_rows = rows
                self._dim_padded = new_count * rows
                self._gram_tiles = [
                    np.zeros((rows, self._dim_padded))
                    for _ in range(new_count)]
                self._moment_tiles = [
                    np.zeros((rows, self.num_classes))
                    for _ in range(new_count)]
                self._scatter_tiles(np.asarray(agg.gram, np.float64),
                                    np.asarray(agg.moment, np.float64))
            elif new_count > self.num_shards:
                self._shards = self._shards + [
                    self.engine.init(self.dim, self.num_classes)
                    for _ in range(new_count - self.num_shards)]
            else:
                kept = list(self._shards[:new_count])
                for i in range(new_count, self.num_shards):
                    j = i % new_count
                    kept[j] = self.engine.merge(kept[j], self._shards[i])
                self._shards = kept
            self.mesh = new_mesh
            self._solve_fns.clear()        # built for the old mesh
            self._last_rebalance = None
            self.new_etag_salt()           # old-epoch tokens must die here
            self._mesh_epoch += 1
        finally:
            self._resizing = False
        return self._mesh_epoch

    def _merged(self) -> SuffStats:
        if self.tiled_gram:
            # the tiles ARE the aggregate, partitioned by (padded) rows
            d = self.dim
            return SuffStats(
                gram=np.concatenate(self._gram_tiles, 0)[:d, :d],
                moment=np.concatenate(self._moment_tiles, 0)[:d],
                count=float(self._count),
                clients=float(len(self._seen)),
            )
        agg = self._shards[0]
        for s in self._shards[1:]:
            agg = self.engine.merge(agg, s)
        return agg

    def _stacked(self):
        """Per-shard statistics stacked on a leading federation dim, as the
        3-leaf :class:`~repro_torch.core.streaming.AnalyticState` the
        collective consumes (host f64 tensors; clients bookkeeping is
        irrelevant under RI).

        Logical shards may outnumber the mesh's participants (non-tiled
        shards are host accumulators); participant ``g`` then carries the
        host-f64 merge of logical shards ``g, g+m, g+2m, …`` — additive, so
        the psummed aggregate is unchanged."""
        m = len(self.mesh)
        if m == self.num_shards:
            groups: List[SuffStats] = self._shards
        else:
            groups = []
            for g in range(m):
                agg = self._shards[g]
                for s in self._shards[g + m::m]:
                    agg = self.engine.merge(agg, s)
                groups.append(agg)
        return AnalyticState(
            gram=torch.from_numpy(np.stack([s.gram for s in groups])),
            moment=torch.from_numpy(np.stack([s.moment for s in groups])),
            count=torch.from_numpy(np.stack(
                [np.float64(s.count) for s in groups])),
        )

    def solve(self, target_gamma: float = 0.0) -> np.ndarray:
        """One collective: psum the sharded statistics (whole leaves, or
        row tiles placed into the global system in tiled-Gram mode),
        RI-restore, solve."""
        self._check_resizing()
        if not self._seen:
            raise EmptyFederation("no clients aggregated")
        key = float(target_gamma)
        fn = self._solve_fns.get(key)
        if fn is None:
            if self.tiled_gram:
                fn = make_tiled_federated_solve(
                    self.mesh, target_gamma=key,
                    distributed_factor=self.distributed_factor,
                    dim=self.dim, dtype=self.dtype)
            else:
                fn = make_federated_solve(
                    self.mesh, gamma=self.gamma, target_gamma=key,
                    dtype=self.dtype)
            self._solve_fns[key] = fn
        if self.tiled_gram:
            w = to_numpy(fn(self._gram_tiles, self._moment_tiles))
        else:
            w = to_numpy(fn(self._stacked()))
        if not np.isfinite(w).all():
            # singular system (rank-deficient γ=0 ablation): the device
            # Cholesky surfaces NaNs by design — reroute to the host
            # engine's pinv fallback on the merged statistics
            self.host_fallbacks += 1
            return np.asarray(
                self.engine.solve(self._merged(), use_ri=True,
                                  target_gamma=key), np.float64)
        return w

    def solve_multi_gamma(self, gammas: Sequence[float]) -> list[np.ndarray]:
        """γ model sweep on the merged statistics (host engine, one eigh) —
        identical math to :meth:`AFLServer.solve_multi_gamma`."""
        self._check_resizing()
        if not self._seen:
            raise EmptyFederation("no clients aggregated")
        return self.engine.solve_multi_gamma(self._merged(), gammas)

    def sweep(self, gammas: Sequence[float], holdout) -> GammaSweep:
        return _sweep_from_weights(
            self.solve_multi_gamma(gammas), gammas, holdout)

    def _etag(self, target_gamma: float) -> str:
        return f"{self._etag_salt}-{self._version}-{float(target_gamma)!r}"

    def new_etag_salt(self) -> str:
        """Refresh the instance ETag salt (see
        :meth:`AFLServer.new_etag_salt`) — called by :meth:`_resize`, so a
        token minted against one mesh epoch can never revalidate against
        another."""
        self._etag_salt = uuid.uuid4().hex[:8]
        return self._etag_salt

    def weights(self, target_gamma: float = 0.0, *,
                if_etag: Optional[str] = None) -> VersionedWeights:
        """Versioned solved-head download (see :meth:`AFLServer.weights`)."""
        tag = self._etag(target_gamma)
        if if_etag is not None and str(if_etag) == tag:
            return VersionedWeights(self._version, float(target_gamma),
                                    None, tag)
        return VersionedWeights(self._version, float(target_gamma),
                                self.solve(target_gamma), tag)

    def state(self) -> Dict[str, np.ndarray]:
        """Same checkpoint schema as :meth:`AFLServer.state` — coordinator
        kinds are interchangeable across a save/restore boundary — plus
        ``shard_clients``, the per-shard occupancy (extra keys are ignored
        by every ``from_state``, so interchange still holds)."""
        self._check_resizing()
        agg = self._merged()
        return {
            "gram": self.engine.regularized_gram(agg).copy(),
            "moment": agg.moment.copy(),
            "gram_diag_raw": np.array(np.diag(agg.gram), np.float64),
            "seen": np.array(sorted(self._seen), np.int64),
            "gamma": np.float64(self.gamma),
            "count": np.float64(agg.count),
            "shard_clients": np.array(self.occupancy(), np.int64),
        }

    def _restore_split(self, stats: SuffStats,
                       shard_clients=None) -> None:
        """Split a restored aggregate across the shards as disjoint row
        blocks: shard ``i`` holds rows ``[i·r, (i+1)·r)`` of the aggregate
        Gram/moment and zeros elsewhere, so the shard sum reproduces the
        aggregate *bitwise* (0 + x = x) on any shard count. The sample
        count rides whole on shard 0 for the same reason.

        Occupancy is reconstructed from the checkpointed ``shard_clients``
        folded onto this shard count (old shard ``i`` → ``i % n``). Tiled
        checkpoints record resident rows there, not clients — when the
        folded counts don't account for every seen client, fall back to an
        even client split."""
        n = self.num_shards
        dim = self.dim
        gram = np.asarray(stats.gram, np.float64)
        moment = np.asarray(stats.moment, np.float64)
        clients = None
        if shard_clients is not None:
            folded = [0] * n
            for i, c in enumerate(np.asarray(shard_clients, np.int64)):
                folded[i % n] += int(c)
            if sum(folded) == int(stats.clients):
                clients = folded
        if clients is None:
            k, rem = divmod(int(stats.clients), n)
            clients = [k + (1 if i < rem else 0) for i in range(n)]
        r = -(-dim // n)
        shards = []
        for i in range(n):
            g = np.zeros((dim, dim))
            m = np.zeros((dim, moment.shape[1]))
            lo, hi = i * r, min(i * r + r, dim)
            if hi > lo:
                g[lo:hi] = gram[lo:hi]
                m[lo:hi] = moment[lo:hi]
            shards.append(SuffStats(
                gram=g, moment=m,
                count=float(stats.count) if i == 0 else 0.0,
                clients=float(clients[i])))
        self._shards = shards

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray],
                   num_classes: Optional[int] = None, *,
                   devices=None, device=None, dtype=None,
                   placement: str = "load_aware", tiled_gram: bool = False,
                   distributed_factor: bool = True,
                   num_shards: Optional[int] = None,
                   ) -> "ShardedCoordinator":
        """Cold-start from any coordinator kind's checkpoint (of either
        package), on ANY shard count — resharding is exact because the
        statistics are additive (merge = migration). ``num_shards``
        defaults to one per device."""
        dim, classes = _validate_state(state, num_classes)
        coord = cls(dim, classes, float(state["gamma"]), devices=devices,
                    device=device, dtype=dtype, placement=placement,
                    tiled_gram=tiled_gram,
                    distributed_factor=distributed_factor,
                    num_shards=num_shards)
        stats, seen = _restore_stats(state, coord.gamma, dim)
        coord._seen = seen
        if tiled_gram:
            coord._scatter_tiles(np.asarray(stats.gram, np.float64),
                                 np.asarray(stats.moment, np.float64))
            coord._count = float(stats.count)
        else:
            coord._restore_split(stats, state.get("shard_clients"))
        coord._order = len(coord._seen)
        coord._version = len(coord._seen)
        return coord
