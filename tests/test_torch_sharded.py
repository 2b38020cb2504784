"""The port's ``ShardedCoordinator``: placement, elastic resharding, the
tiled solve, and checkpoints across packages.

The port of tests/test_elastic.py's coordinator cases, of
tests/test_distributed_cholesky.py:153-201 and of tests/test_service.py's
sharded placement cases, on the CPU. Where the
reference needs a device a shard (its 8-device x64 cases run in a
subprocess), the port's shards are threads, so ``devices=["cpu"] * n``
gives n participants here. Device arithmetic is the coordinator's
``dtype``: f32 by default, ``torch.float64`` for the ≤1e-10 cases (no
global switch). Every checkpoint a port coordinator writes restores into
the reference's ``AFLServer``, ``AsyncAFLServer`` and one-device
``ShardedCoordinator``, and theirs into the port's, with the same bits.
"""

import asyncio

import numpy as np
import pytest
import torch

from repro.fl import AFLServer as RefServer
from repro.fl import AsyncAFLServer as RefAsync
from repro.fl import ShardedCoordinator as RefSharded
from repro_torch.checkpoint import SnapshotDaemon
from repro_torch.fl import (AFLServer, AsyncAFLServer, FederationService,
                            RemoteCoordinator, ShardedCoordinator, make_report,
                            serve_http)
from repro_torch.fl import errors as E

DIM, C, GAMMA = 24, 5, 1.0
CPU = dict(device="cpu")
F64 = dict(device="cpu", dtype=torch.float64)


def _reports(n=8, rows=10, seed=0, start_id=0, dim=DIM):
    rng = np.random.default_rng(seed)
    return [make_report(start_id + k, rng.standard_normal((rows, dim)),
                        np.eye(C)[rng.integers(0, C, rows)], GAMMA)
            for k in range(n)]


def _oracle(reports, dim=DIM):
    srv = AFLServer(dim, C, gamma=GAMMA)
    srv.submit_many(reports)
    return srv


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / max(1.0, np.abs(b).max())


# ---------------------------------------------------------------------------
# Placement and the mesh
# ---------------------------------------------------------------------------


class TestPlacement:
    def test_round_robin_spreads_clients(self):
        """Each shard's Gram is PSD and they sum to the aggregate
        (tests/test_coordinator_conformance.py:424-436)."""
        reps = _reports(10)
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4, **CPU)
        coord.submit_many(reps)
        assert sum(float(s.clients) for s in coord._shards) == len(reps)
        agg = sum(np.asarray(s.gram) for s in coord._shards)
        np.testing.assert_allclose(agg, _oracle(reps)._stats.gram, rtol=1e-12, atol=1e-9)

    @pytest.mark.parametrize("placement, want", [("round_robin", [3, 3, 2, 2]),
                                                 ("load_aware", [3, 3, 2, 2])])
    def test_placement_policies(self, placement, want):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4,
                                   placement=placement, **CPU)
        coord.submit_many(_reports(10))
        assert coord.occupancy() == want
        with pytest.raises(ValueError):
            ShardedCoordinator(DIM, C, placement="random", **CPU)

    def test_rebalance_and_its_ping_pong_guard(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=3,
                                   placement="round_robin", **CPU)
        coord.submit_many(_reports(6))
        w0 = coord.solve_multi_gamma([0.2])[0]
        # skew the occupancy by hand: shard 2 absorbs shard 1
        coord._shards[2] = coord.engine.merge(coord._shards[2], coord._shards[1])
        coord._shards[1] = coord.engine.init(DIM, C)
        assert coord.occupancy() == [2, 0, 4]
        assert coord.rebalance() == (2, 1)
        assert coord.occupancy() == [2, 4, 0]
        # the guard: moving shard 1 back would undo this epoch's migration
        assert coord.rebalance() is None
        np.testing.assert_allclose(coord.solve_multi_gamma([0.2])[0], w0,
                                   rtol=1e-12, atol=1e-12)
        coord.submit(_reports(1, start_id=40, seed=4)[0])   # a new epoch
        assert coord.occupancy() == [2, 4, 1]      # the vacated shard first
        assert coord.rebalance() == (1, 2)
        tiled = ShardedCoordinator(DIM, C, gamma=GAMMA, tiled_gram=True, num_shards=4, **CPU)
        assert tiled.rebalance() is None and tiled.occupancy() == [6] * 4

    def test_participants(self):
        """Tiled: one participant a tile, cyclically on the devices;
        non-tiled: logical shards grouped onto min(n, devices) of them.
        Where the reference refuses a tiled mesh wider than its devices,
        the port places the tiles cyclically (shards share a device)."""
        tiled = ShardedCoordinator(DIM, C, tiled_gram=True, num_shards=6, **CPU)
        assert tiled.mesh == (torch.device("cpu"),) * 6
        wide = ShardedCoordinator(DIM, C, num_shards=12, devices=["cpu"] * 8)
        assert len(wide.mesh) == 8 and wide.num_shards == 12
        assert len(ShardedCoordinator(DIM, C, num_shards=3, **CPU).mesh) == 1
        assert ShardedCoordinator(DIM, C, devices=["cpu"] * 5).num_shards == 5
        with pytest.raises(E.BadRequest):
            ShardedCoordinator(DIM, C, num_shards=0, **CPU)


class TestPlacementOps:
    """tests/test_service.py's sharded placement cases (there the shard list
    is padded by hand on a 1-device host; here ``num_shards`` sets it)."""

    def test_occupancy_tracks_round_robin_and_lands_in_state(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4, **CPU)
        coord.submit_many(_reports(7))
        occ = coord.occupancy()
        assert sum(occ) == 7 and max(occ) - min(occ) <= 1
        state = coord.state()
        np.testing.assert_array_equal(state["shard_clients"], occ)
        assert AFLServer.from_state(state).num_clients == 7

    def test_rebalance_moves_fullest_into_emptiest_invariantly(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4,
                                   placement="round_robin", **CPU)
        for r in _reports(9):
            coord.submit(r)
            coord._order = 0                       # everything lands in shard 0
        assert coord.occupancy()[0] == 9
        before = coord.state()
        moved = coord.rebalance()
        assert moved is not None and moved[0] == 0
        assert coord.occupancy()[0] == 0 and sum(coord.occupancy()) == 9
        after = coord.state()
        for key in ("gram", "moment"):
            np.testing.assert_allclose(after[key], before[key], rtol=1e-12, atol=1e-9)
        assert coord.rebalance() is None           # no ping-pong
        coord.submit(_reports(1, start_id=77)[0])
        assert coord.rebalance() is not None

    def test_rebalance_noop_when_balanced(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=3, **CPU)
        coord.submit_many(_reports(3))
        assert coord.rebalance() is None
        assert ShardedCoordinator(DIM, C, num_shards=1, **CPU).rebalance() is None

    def test_uniform_traffic_degenerates_to_round_robin(self):
        la = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4, **CPU)
        rr = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4,
                                placement="round_robin", **CPU)
        la.submit_many(_reports(10))
        rr.submit_many(_reports(10))
        assert la.occupancy() == rr.occupancy()

    def test_skewed_restore_fills_empty_shards_first(self):
        seed = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=1, **CPU)
        seed.submit_many(_reports(4))
        coord = ShardedCoordinator.from_state(seed.state(), num_shards=1, **CPU)
        coord._shards += [coord.engine.init(DIM, C) for _ in range(3)]
        assert coord.occupancy() == [4, 0, 0, 0]
        coord.submit_many(_reports(3, seed=5, start_id=100))
        assert coord.occupancy() == [4, 1, 1, 1]
        assert coord.rebalance() is not None

    def test_aggregate_invariant_vs_round_robin(self):
        la = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4, **CPU)
        rr = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4,
                                placement="round_robin", **CPU)
        for i, r in enumerate(_reports(9, seed=11)):
            la.submit(r)
            rr.submit(r)
            if i % 3 == 0:
                la._order = rr._order = 0
        assert la.occupancy() != rr.occupancy()
        sa, sr = la.state(), rr.state()
        for key in ("gram", "moment"):
            np.testing.assert_allclose(sa[key], sr[key], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(sa["seen"], sr["seen"])
        np.testing.assert_allclose(la.solve(0.2), rr.solve(0.2), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The tiled solve (tests/test_distributed_cholesky.py:153-201)
# ---------------------------------------------------------------------------


class TestCoordinatorDistributed:
    def _reports(self, dim, k, rng):
        return [make_report(i, rng.standard_normal((3 * dim, dim)),
                            np.eye(4)[rng.integers(0, 4, 3 * dim)], 1.0)
                for i in range(k)]

    @pytest.mark.parametrize("dim", [32, 30])
    def test_tiled_solve_matches_host(self, dim):
        rng = np.random.default_rng(dim)
        coord = ShardedCoordinator(dim, 4, gamma=1.0, tiled_gram=True,
                                   devices=["cpu"] * 8)
        assert coord.distributed_factor and coord.num_shards == 8
        coord.submit_many(self._reports(dim, 3, rng))
        w = coord.solve(0.3)
        m = coord._merged()
        ref = np.linalg.solve(m.gram + 0.3 * np.eye(dim), m.moment)
        assert w.shape == (dim, 4) and w.dtype == np.float64
        assert _rel(w, ref) < 1e-4 and coord.host_fallbacks == 0

    def test_rank_deficient_gamma0_falls_back_to_pinv(self):
        """γ=0 on rank-deficient statistics: the distributed Cholesky
        surfaces NaNs, the coordinator reroutes to the host pinv path."""
        rng = np.random.default_rng(5)
        dim, c = 24, 3
        coord = ShardedCoordinator(dim, c, gamma=0.5, tiled_gram=True,
                                   devices=["cpu"] * 8)
        x = rng.standard_normal((2, dim))              # rank 2 << dim
        y = np.eye(c)[rng.integers(0, c, 2)]
        coord.submit(make_report(0, x, y, 0.5))
        assert coord.host_fallbacks == 0
        w = coord.solve(0.0)
        assert np.isfinite(w).all() and coord.host_fallbacks == 1
        m = coord._merged()
        assert np.allclose(w, np.linalg.pinv(m.gram) @ m.moment, atol=1e-6)
        coord.solve(0.5)                   # definite: the device's answer stands
        assert coord.host_fallbacks == 1

    def test_state_roundtrip_padded(self):
        rng = np.random.default_rng(6)
        coord = ShardedCoordinator(30, 4, gamma=1.0, tiled_gram=True, devices=["cpu"] * 8)
        coord.submit_many(self._reports(30, 2, rng))
        back = ShardedCoordinator.from_state(coord.state(), 4, tiled_gram=True,
                                             devices=["cpu"] * 8)
        np.testing.assert_allclose(back.solve(0.2), coord.solve(0.2), rtol=1e-4, atol=1e-5)

    def test_gather_path_still_available(self):
        rng = np.random.default_rng(9)
        kw = dict(gamma=1.0, tiled_gram=True, devices=["cpu"] * 8)
        coord = ShardedCoordinator(32, 4, distributed_factor=False, **kw)
        coord.submit_many(self._reports(32, 2, rng))
        ref = ShardedCoordinator(32, 4, **kw)
        ref.submit_many(self._reports(32, 2, np.random.default_rng(9)))
        np.testing.assert_allclose(coord.solve(0.1), ref.solve(0.1), rtol=1e-4, atol=1e-5)

    def test_repeat_solves_give_the_same_bits(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, tiled_gram=True,
                                   devices=["cpu"] * 8)
        coord.submit_many(_reports(5))
        np.testing.assert_array_equal(coord.solve(0.1), coord.solve(0.1))


# ---------------------------------------------------------------------------
# Shard-count-changing restore
# ---------------------------------------------------------------------------


class TestReshardingRestore:
    def test_restore_is_bitwise_identical_across_shard_counts(self):
        """The disjoint row-block split makes the shard sum reproduce the
        aggregate bitwise (0 + x = x), so the restored device solve is
        bit-for-bit the same on any shard count, at f32."""
        base = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4, **CPU)
        base.submit_many(_reports(7))
        state = base.state()
        solves = []
        for n in (1, 2, 3, 5, 7):
            coord = ShardedCoordinator.from_state(state, num_shards=n, devices=["cpu"] * n)
            assert coord.num_shards == n and len(coord.mesh) == n
            assert sum(coord.occupancy()) == 7
            solves.append(np.asarray(coord.solve(0.25), np.float64))
        for w in solves[1:]:
            np.testing.assert_array_equal(solves[0], w)

    def test_restored_aggregate_matches_sync_oracle_bitwise(self):
        reports = _reports(6)
        oracle = _oracle(reports)
        ref_state = oracle.state()
        for n in (2, 5):
            coord = ShardedCoordinator.from_state(ref_state, num_shards=n, **CPU)
            back = coord.state()
            for key in ("gram", "moment", "seen", "gram_diag_raw"):
                np.testing.assert_array_equal(back[key], ref_state[key])
            np.testing.assert_array_equal(coord.solve_multi_gamma([0.3])[0],
                                          oracle.solve_multi_gamma([0.3])[0])

    def test_cross_kind_roundtrip_sync_sharded_tiled_async(self):
        reports = _reports(6)
        oracle = _oracle(reports)
        sharded = ShardedCoordinator.from_state(oracle.state(), num_shards=3, **CPU)
        tiled = ShardedCoordinator.from_state(sharded.state(), tiled_gram=True,
                                              devices=["cpu"] * 4)
        back = AFLServer.from_state(tiled.state())
        np.testing.assert_array_equal(back.solve(0.1), oracle.solve(0.1))
        asrv = AsyncAFLServer.from_state(back.state())
        np.testing.assert_array_equal(asrv.server.solve(0.1), oracle.solve(0.1))

    def test_occupancy_folds_and_survives_roundtrip(self):
        base = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4,
                                  placement="round_robin", **CPU)
        base.submit_many(_reports(6))
        assert base.occupancy() == [2, 2, 1, 1]
        assert ShardedCoordinator.from_state(base.state(), num_shards=4,
                                             **CPU).occupancy() == [2, 2, 1, 1]
        assert ShardedCoordinator.from_state(base.state(), num_shards=2,
                                             **CPU).occupancy() == [3, 3]
        assert sum(ShardedCoordinator.from_state(base.state(), num_shards=6,
                                                 **CPU).occupancy()) == 6

    def test_tiled_checkpoint_occupancy_falls_back_to_even_split(self):
        tiled = ShardedCoordinator(DIM, C, gamma=GAMMA, tiled_gram=True,
                                   devices=["cpu"] * 8)
        tiled.submit_many(_reports(5))
        coord = ShardedCoordinator.from_state(tiled.state(), num_shards=2, **CPU)
        assert sum(coord.occupancy()) == 5
        assert max(coord.occupancy()) - min(coord.occupancy()) <= 1

    def test_padded_tile_plan(self):
        """Indivisible dims pad up to the next tile multiple; a plan that
        would pad by a full tile is rejected up front (and the 8-aligned
        plans of the card's d = 2304 and 6144 heads)."""
        plan = ShardedCoordinator._plan_tile_rows
        assert plan(30, 4) == 8 and plan(30, 8) == 4
        with pytest.raises(E.BadRequest):
            plan(8, 7)
        assert [plan(2304, 8), plan(2304, 12), plan(2304, 4)] == [288, 192, 576]
        assert [plan(6144, 8), plan(6144, 7)] == [768, 880]

    @pytest.mark.parametrize("cls", [ShardedCoordinator])
    def test_contradictory_num_classes_raises_typed_bad_request(self, cls):
        state = _oracle(_reports(3)).state()
        with pytest.raises(E.BadRequest):
            cls.from_state(state, num_classes=C + 2, **CPU)
        assert cls.from_state(state, num_classes=C, **CPU).num_classes == C


class TestF64Parity:
    """The reference's 8-device x64 acceptance bar (tests/test_elastic.py:
    408-461), with f64 shards in process: every restore and live resize
    within 1e-10 of the sync oracle."""

    @pytest.fixture(scope="class")
    def setup(self):
        d, g = 30, 1.0
        rng = np.random.default_rng(7)
        reports = [make_report(k, rng.standard_normal((40, d)),
                               np.eye(C)[rng.integers(0, C, 40)], g) for k in range(12)]
        oracle = AFLServer(d, C, gamma=g)
        oracle.submit_many(reports)
        base = ShardedCoordinator(d, C, gamma=g, num_shards=4, **F64)
        base.submit_many(reports)
        return base.state(), oracle.solve(0.3)

    @pytest.mark.parametrize("kw", [
        dict(num_shards=2), dict(num_shards=8),
        dict(num_shards=4, tiled_gram=True),
        dict(num_shards=8, tiled_gram=True, distributed_factor=False),
        dict(num_shards=12)])
    def test_restore(self, setup, kw):
        state, w_ref = setup
        coord = ShardedCoordinator.from_state(state, devices=["cpu"] * 8,
                                              dtype=torch.float64, **kw)
        assert np.abs(coord.solve(0.3) - w_ref).max() < 1e-10

    def test_live_tiled_grow_and_shrink(self, setup):
        state, w_ref = setup
        t = ShardedCoordinator.from_state(state, num_shards=4, tiled_gram=True, **F64)
        assert t.grow(4) == 1 and t.num_shards == 8 and len(t.mesh) == 8
        assert np.abs(t.solve(0.3) - w_ref).max() < 1e-10
        assert t.shrink(6) == 2 and t.num_shards == 2
        assert np.abs(t.solve(0.3) - w_ref).max() < 1e-10


# ---------------------------------------------------------------------------
# Live grow/shrink under the epoch guard
# ---------------------------------------------------------------------------


class TestLiveResize:
    def test_grow_admits_empty_shards_and_placement_fills_them(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=2, **CPU)
        coord.submit_many(_reports(4))
        w0 = coord.solve_multi_gamma([0.25])[0]
        assert coord.grow(2) == 1 and coord.num_shards == 4
        assert coord.occupancy() == [2, 2, 0, 0]
        np.testing.assert_array_equal(coord.solve_multi_gamma([0.25])[0], w0)
        coord.submit_many(_reports(2, start_id=100, seed=9))
        assert coord.occupancy() == [2, 2, 1, 1]

    def test_shrink_folds_retired_shards_exactly(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=5, **CPU)
        coord.submit_many(_reports(7))
        before = coord.state()
        assert coord.shrink(3) == 1 and coord.num_shards == 2
        after = coord.state()
        np.testing.assert_allclose(after["gram"], before["gram"], rtol=1e-12, atol=1e-9)
        np.testing.assert_array_equal(after["seen"], before["seen"])
        assert sum(coord.occupancy()) == 7

    def test_resize_bounds_raise_typed_bad_request(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=2, **CPU)
        for call in (lambda: coord.grow(0), lambda: coord.shrink(2),
                     lambda: coord.shrink(5), lambda: coord.shrink(0)):
            with pytest.raises(E.BadRequest):
                call()
        assert coord.num_shards == 2 and coord.mesh_epoch == 0

    def test_rejected_resize_leaves_coordinator_untouched(self):
        """Validation precedes mutation. The reference rejects grow(64) on
        a tiled mesh for want of devices; the port places shards
        cyclically, so here it is the tile plan (dim 24 over 72 shards
        would pad by more than a tile) that rejects it."""
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, tiled_gram=True,
                                   devices=["cpu"] * 8)
        coord.submit_many(_reports(3))
        w0 = coord.solve_multi_gamma([0.1])[0]
        salt, tiles = coord._etag_salt, [t.copy() for t in coord._gram_tiles]
        with pytest.raises(E.BadRequest):
            coord.grow(64)
        assert coord.mesh_epoch == 0 and coord.num_shards == 8 and len(coord.mesh) == 8
        assert coord._etag_salt == salt
        for a, b in zip(coord._gram_tiles, tiles):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(coord.solve_multi_gamma([0.1])[0], w0)

    def test_inflight_requests_get_retryable_backpressure_mid_resize(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=2, **CPU)
        coord.submit_many(_reports(2))
        coord._resizing = True                     # freeze mid-migration
        for call in (lambda: coord.submit(_reports(1, start_id=50)[0]),
                     lambda: coord.solve(0.1),
                     lambda: coord.solve_multi_gamma([0.1]),
                     coord.state, coord.rebalance):
            with pytest.raises(E.Backpressure) as exc:
                call()
            assert exc.value.retryable
        coord._resizing = False
        assert coord.num_clients == 2

    def test_resize_mints_a_new_etag(self):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=2, **CPU)
        coord.submit_many(_reports(3))
        vw = coord.weights()
        assert coord.weights(if_etag=vw.etag).not_modified
        coord.grow(1)
        fresh = coord.weights(if_etag=vw.etag)
        assert not fresh.not_modified and fresh.etag != vw.etag

    def test_wire_grow_shrink_and_describe(self):
        svc = FederationService(ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=2, **CPU))
        rc = RemoteCoordinator(svc)
        rc.submit_many(_reports(3))
        info = rc.describe()
        assert info["num_shards"] == 2 and info["mesh_epoch"] == 0
        assert rc.grow(1) == 1 and rc.num_shards == 3
        assert rc.shrink(2) == 2 and rc.num_shards == 1
        rc2 = RemoteCoordinator(FederationService(AFLServer(DIM, C, gamma=GAMMA)))
        assert rc2.num_shards is None
        with pytest.raises(E.BadRequest):
            rc2.grow(1)


# ---------------------------------------------------------------------------
# Snapshots and failover
# ---------------------------------------------------------------------------


class TestSnapshotDaemon:
    def test_epoch_keyed_snapshots_catch_resharding(self, tmp_path):
        coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=2, **CPU)
        svc = FederationService(coord)
        RemoteCoordinator(svc).submit_many(_reports(3))
        d = SnapshotDaemon(svc, directory=tmp_path, keep=10)
        assert d.snapshot_once().name == "snap-000000000003-000000"
        coord.grow(1)                              # state changed, count not
        second = d.snapshot_once()
        assert second is not None and second.name == "snap-000000000003-000001"
        assert d.latest() == second and d.latest_version == 3
        assert d.snapshot_once() is None
        restored = d.restore(ShardedCoordinator, num_shards=3, **CPU)
        np.testing.assert_array_equal(restored.solve(0.2), coord.solve(0.2))

    def test_restore_cold_starts_on_any_shard_count(self, tmp_path):
        """SnapshotDaemon.restore(ShardedCoordinator, num_shards=8)."""
        reports = _reports(5)
        oracle = _oracle(reports)
        svc = FederationService(AFLServer(DIM, C, gamma=GAMMA))
        RemoteCoordinator(svc).submit_many(reports)
        d = SnapshotDaemon(svc, directory=tmp_path)
        d.snapshot_once()
        for kw in (dict(num_shards=3), dict(num_shards=8, tiled_gram=True)):
            resharded = d.restore(ShardedCoordinator, **kw, **CPU)
            assert resharded.num_shards == kw["num_shards"]
            np.testing.assert_array_equal(resharded.solve_multi_gamma([0.2])[0],
                                          oracle.solve_multi_gamma([0.2])[0])


def test_http_failover_drill_with_resharded_replacement(tmp_path):
    """Kill → snapshot-restore into a sharded coordinator → resume, over
    loopback HTTP (tests/test_elastic.py:_drill): clients only see typed
    retryable errors, the restore is bit-exact, and the served f32 device
    head stays within device precision."""
    reports = _reports(16)
    svc = FederationService(AFLServer(DIM, C, gamma=GAMMA))
    with serve_http(svc) as http:
        rc = RemoteCoordinator(http.url)
        try:
            rc.submit_many(reports[:10])
            daemon = SnapshotDaemon(http.url, directory=tmp_path)
            daemon.snapshot_once()
            assert daemon.latest_version == 10
            svc.suspend_federation()
            errors = []
            for r in reports[10:]:
                with pytest.raises(E.ServiceError) as exc:
                    rc.submit(r)
                errors.append(exc.value)
            assert all(isinstance(e, E.Unavailable) and e.retryable for e in errors)
            svc.restore_federation("default", daemon.restore(ShardedCoordinator,
                                                             num_shards=2, **CPU))
            for r in reports[10:]:
                rc.submit(r)
            assert rc.num_clients == 16
            final = np.asarray(rc.solve(0.25), np.float64)
        finally:
            rc.close()
        ref = _oracle(reports).solve(0.25)
        np.testing.assert_allclose(svc.coordinator().solve_multi_gamma([0.25])[0], ref,
                                   rtol=1e-12, atol=1e-12)
        assert np.abs(final - ref).max() < 1e-4


# ---------------------------------------------------------------------------
# Checkpoints across packages
# ---------------------------------------------------------------------------


_KEYS = ("gram", "moment", "seen", "gamma", "count", "gram_diag_raw")


def _same_state(a, b):
    for key in _KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("ref_kind", ["sync", "async", "sharded"])
def test_state_interchange_with_the_reference(tiled, ref_kind):
    """The port's state() restores into the reference's AFLServer,
    AsyncAFLServer and one-device ShardedCoordinator, and each of theirs
    back into the port's, with the same bits: the statistics, the seen
    ids and the host f64 sweep; the device solves agree to f32."""
    reps = _reports(8, seed=3)
    coord = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=3, tiled_gram=tiled,
                               devices=["cpu"] * 3)
    coord.submit_many(reps[:5])
    state = coord.state()
    ref_cls = {"sync": RefServer, "async": RefAsync, "sharded": RefSharded}[ref_kind]
    ref = ref_cls.from_state(state)

    async def drive():
        if ref_kind == "async":
            await ref.start()
        try:
            assert ref.num_clients == 5
            with pytest.raises(ValueError):
                await _maybe(ref.submit(reps[0]))
            await _maybe(ref.submit_many(reps[5:]))
            return await _maybe(ref.state()), await _maybe(ref.solve_multi_gamma([0.4]))
        finally:
            if ref_kind == "async":
                await ref.close()

    back_state, ref_sweep = asyncio.run(drive())
    if ref_kind != "async":
        _same_state(ref_cls.from_state(state).state(), state)
    back = ShardedCoordinator.from_state(back_state, num_shards=2, tiled_gram=tiled,
                                         devices=["cpu"] * 2)
    assert back.num_clients == 8
    _same_state(back.state(), back_state)
    np.testing.assert_array_equal(back.solve_multi_gamma([0.4])[0], ref_sweep[0])
    # against one sequential fold: the shards sum in another order
    oracle = _oracle(reps)
    for key in ("gram", "moment"):
        np.testing.assert_allclose(back.state()[key], oracle.state()[key],
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref_sweep[0], oracle.solve_multi_gamma([0.4])[0],
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(back.solve(0.4), oracle.solve(0.4), rtol=1e-3, atol=2e-3)


async def _maybe(result):
    import inspect

    return await result if inspect.isawaitable(result) else result
