"""``repro_torch.fl.async_server`` against the reference's.

Every case of tests/test_async_server.py runs on the port's
``AsyncAFLServer``: concurrent submit/solve interleavings, rank-updated
factors and deferred refactors land on the synchronous server's weights,
masked cohorts aggregate to its exact statistics, bad uploads reject alone,
and ``submit`` resolves to the sync fold outcome. Then the port's async
coordinator is held to the reference's on the same reports (made from a
numpy seed in the reference's ``make_report``): aggregated statistics and
weights bit for bit (``assert_array_equal``, as tests/test_async_server.py
holds its own), fold outcomes and counters equal, ``enqueue_many`` and
``Backpressure`` alike, and ``state()`` restoring across the packages.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from repro.fl import AsyncAFLServer as RefAsync
from repro.fl import make_report as ref_make_report
from repro.fl import masked_reports as ref_masked
from repro.fl.errors import Backpressure as RefBackpressure
from repro_torch.core import analytic as al
from repro_torch.fl import (AFLServer, AsyncAFLServer, ClientReport,
                            SubmitAborted, make_report, masked_reports)
from repro_torch.fl.errors import Backpressure

D, C, GAMMA = 24, 5, 1.0


def _reports(n_clients=10, rows_each=6, seed=0):
    """Small per-client batches (rows ≪ d) so roots ride along."""
    rng = np.random.default_rng(seed)
    n = n_clients * rows_each
    x = rng.standard_normal((n, D))
    y = np.eye(C)[rng.integers(0, C, n)]
    reps = [make_report(k, x[k * rows_each:(k + 1) * rows_each],
                        y[k * rows_each:(k + 1) * rows_each], GAMMA)
            for k in range(n_clients)]
    return x, y, reps


def _both(reps):
    """The same reports as the reference's ``ClientReport``s (wire bytes)."""
    from repro.fl import ClientReport as RefReport
    return [RefReport.from_bytes(r.to_bytes()) for r in reps]


# --- tests/test_async_server.py on the port -------------------------------------

def test_concurrent_interleaving_matches_sequential():
    x, y, reps = _reports(n_clients=12)

    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA,
                                  update_rank_budget=6) as srv:
            async def producer(chunk):
                for r in chunk:
                    await srv.submit(r)
                    await asyncio.sleep(0)

            async def consumer():
                polls = []
                while srv.num_clients < 12:
                    if srv.num_clients:
                        polls.append(await srv.solve())
                    await asyncio.sleep(0)
                return polls

            _, _, polls = await asyncio.gather(
                producer(reps[:6]), producer(reps[6:]), consumer())
            await srv.join()
            return await srv.solve(), polls, srv.updates

    w_async, polls, updates = asyncio.run(scenario())
    assert all(np.all(np.isfinite(p)) for p in polls)
    assert updates > 0
    seq = AFLServer(D, C, gamma=GAMMA)
    seq.submit_many(reps)
    np.testing.assert_allclose(w_async, seq.solve(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(w_async, al.ridge_solve(x, y, 0.0),
                               rtol=1e-7, atol=1e-9)


def test_masked_reports_bit_exact_vs_sync_path():
    x, y, reps = _reports(n_clients=8, seed=3)
    masked = masked_reports(reps, seed=7)
    assert all(r.root is None for r in masked)

    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA) as srv:
            await srv.submit_many(masked)
            await srv.join()
            return srv.server._stats, await srv.solve()

    stats_async, w_async = asyncio.run(scenario())
    sync = AFLServer(D, C, gamma=GAMMA)
    sync.submit_many(masked)
    np.testing.assert_array_equal(stats_async.gram, sync._stats.gram)
    np.testing.assert_array_equal(stats_async.moment, sync._stats.moment)
    np.testing.assert_array_equal(w_async, sync.solve())
    np.testing.assert_allclose(w_async, al.ridge_solve(x, y, 0.0),
                               rtol=1e-6, atol=1e-7)


def test_deferred_refactor_policy_stays_exact():
    x, y, reps = _reports(n_clients=12, seed=5)

    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA, update_rank_budget=6,
                                  refactor_rank=8) as srv:
            for r in reps:
                await srv.submit(r)
                await srv.join()
                await srv.solve()
            return await srv.solve(), srv.updates, srv.deferred_refactors

    w, updates, deferred = asyncio.run(scenario())
    assert deferred > 0 and updates > 0
    np.testing.assert_allclose(w, al.ridge_solve(x, y, 0.0),
                               rtol=1e-7, atol=1e-9)


def test_solve_multi_gamma_served_concurrently():
    x, y, reps = _reports(n_clients=6, seed=8)

    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA) as srv:
            await srv.submit_many(reps)
            await srv.join()
            return await asyncio.gather(
                srv.solve_multi_gamma([0.0, 0.1, 1.0]), srv.solve())

    sweep, w0 = asyncio.run(scenario())
    np.testing.assert_allclose(sweep[0], w0, rtol=1e-7, atol=1e-8)
    sync = AFLServer(D, C, gamma=GAMMA)
    sync.submit_many(reps)
    for w_a, w_s in zip(sweep, sync.solve_multi_gamma([0.0, 0.1, 1.0])):
        np.testing.assert_allclose(w_a, w_s, rtol=1e-10, atol=1e-12)


def test_bad_uploads_rejected_without_killing_worker():
    _, _, reps = _reports(n_clients=4, seed=9)

    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA) as srv:
            await srv.submit_many(reps)
            await srv.enqueue(reps[0])
            await srv.enqueue(dataclasses.replace(reps[1], client_id=77,
                                                  gamma=2.0))
            await srv.enqueue(dataclasses.replace(reps[2], client_id=[78]))
            await srv.join()
            with pytest.raises(ValueError):
                await srv.submit(reps[0])
            return srv.num_clients, srv.rejected, await srv.solve()

    n, rejected, w = asyncio.run(scenario())
    assert n == 4
    assert len(rejected) == 4
    assert np.all(np.isfinite(w))


def test_submit_returns_the_sync_fold_outcome():
    _, _, reps = _reports(n_clients=10, seed=11)
    sequence = reps[:5] + masked_reports(reps[5:], seed=1)
    sync = AFLServer(D, C, gamma=GAMMA, update_rank_budget=6)
    sync_outcomes = []
    for r in sequence:
        sync_outcomes.append(sync.submit(r))
        sync.solve()

    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA, update_rank_budget=6,
                                  refactor_rank=10**6,
                                  error_budget=1.0) as srv:
            outcomes = []
            for r in sequence:
                outcomes.append(await srv.submit(r))
                await srv.solve()
            return outcomes

    async_outcomes = asyncio.run(scenario())
    assert async_outcomes == sync_outcomes
    assert True in async_outcomes and False in async_outcomes


def test_solve_before_any_arrival_raises():
    async def scenario():
        async with AsyncAFLServer(D, C, gamma=GAMMA) as srv:
            with pytest.raises(ValueError):
                await srv.solve()

    asyncio.run(scenario())


# --- the port against the reference -----------------------------------------------

def _drive(cls, reps, *, sequential, **kw):
    """Fold ``reps`` through an async coordinator of either package: one
    awaited submit at a time (each solved, so a live factor takes the rank
    updates) or one pipelined ``submit_many``; returns statistics, weights,
    outcomes and counters."""
    async def scenario():
        async with cls(D, C, gamma=GAMMA, **kw) as srv:
            outcomes = []
            if sequential:
                for r in reps:
                    outcomes.append(await srv.submit(r))
                    await srv.solve()
            else:
                await srv.submit_many(reps)
            await srv.join()
            stats = srv.server._stats
            return dict(gram=stats.gram, moment=stats.moment,
                        w=await srv.solve(), w_half=await srv.solve(0.5),
                        sweep=await srv.solve_multi_gamma([0.0, 0.1, 1.0]),
                        outcomes=outcomes, updates=srv.updates,
                        deferred=srv.deferred_refactors,
                        clients=srv.num_clients)

    return asyncio.run(scenario())


@pytest.mark.parametrize("case", ["rank_updates", "deferred", "masked",
                                  "pipelined"])
def test_port_async_equals_reference_async_bit_for_bit(case):
    _, _, reps = _reports(n_clients=12, seed=21)
    kw = dict(update_rank_budget=6)
    if case == "deferred":
        kw["refactor_rank"] = 8
    if case == "masked":
        reps = reps[:6] + masked_reports(reps[6:], seed=2)
    sequential = case != "pipelined"
    port = _drive(AsyncAFLServer, reps, sequential=sequential, **kw)
    ref = _drive(RefAsync, _both(reps), sequential=sequential, **kw)
    for key in ("gram", "moment", "w", "w_half"):
        np.testing.assert_array_equal(port[key], ref[key])
    for a, b in zip(port["sweep"], ref["sweep"]):
        np.testing.assert_array_equal(a, b)
    for key in ("outcomes", "updates", "deferred", "clients"):
        assert port[key] == ref[key], key
    if case == "deferred":
        assert port["updates"] > 0 and port["deferred"] > 0


def test_reports_from_the_reference_fold_like_the_port_own():
    """A reference ``make_report`` (the same numpy inputs) is the port's
    report byte for byte, and folds to the same bits."""
    x, y, reps = _reports(n_clients=6, seed=4)
    ref_reps = [ref_make_report(k, x[6 * k:6 * (k + 1)], y[6 * k:6 * (k + 1)], GAMMA)
                for k in range(6)]
    assert [r.to_bytes() for r in ref_reps] == [r.to_bytes() for r in reps]
    port = _drive(AsyncAFLServer, ref_reps, sequential=False)
    own = _drive(AsyncAFLServer, reps, sequential=False)
    np.testing.assert_array_equal(port["w"], own["w"])
    masked = masked_reports(reps, seed=3)
    ref_m = ref_masked(ref_reps, seed=3)
    assert [r.to_bytes() for r in masked] == [r.to_bytes() for r in ref_m]


def test_enqueue_many_and_backpressure_match_the_reference():
    _, _, reps = _reports(n_clients=6, seed=6)

    def scenario(cls, bp, batch):
        async def body():
            srv = cls(D, C, gamma=GAMMA, max_pending=3)   # worker not started
            admitted = await srv.enqueue_many(batch)
            with pytest.raises(bp):
                await srv.enqueue(batch[-1])
            assert srv.pending == 3
            await srv.start()
            await srv.join()
            await srv.enqueue_many(batch[admitted:])
            await srv.join()
            out = (admitted, srv.num_clients, await srv.solve())
            await srv.close()
            return out

        return asyncio.run(body())

    a_p, n_p, w_p = scenario(AsyncAFLServer, Backpressure, reps)
    a_r, n_r, w_r = scenario(RefAsync, RefBackpressure, _both(reps))
    assert (a_p, n_p) == (a_r, n_r) == (3, 6)
    np.testing.assert_array_equal(w_p, w_r)
    assert (Backpressure.code, Backpressure.http_status) == \
        (RefBackpressure.code, RefBackpressure.http_status)


def test_submit_many_aborts_after_a_rejection_like_the_reference():
    _, _, reps = _reports(n_clients=4, seed=12)
    conflict = make_report(reps[0].client_id, np.ones((4, D)),
                           np.eye(C)[np.zeros(4, int)], GAMMA)

    def scenario(cls, batch, first):
        async def body():
            async with cls(D, C, gamma=GAMMA) as srv:
                await srv.submit(first)
                with pytest.raises(ValueError):
                    await srv.submit_many(batch)
                return srv.num_clients, await srv.solve()

        return asyncio.run(body())

    batch = [reps[1], conflict, reps[2], reps[3]]
    n_p, w_p = scenario(AsyncAFLServer, batch, reps[0])
    n_r, w_r = scenario(RefAsync, _both(batch), _both(reps[:1])[0])
    assert n_p == n_r == 2
    np.testing.assert_array_equal(w_p, w_r)
    assert issubclass(SubmitAborted, RuntimeError)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_state_restores_across_packages(direction):
    _, _, reps = _reports(n_clients=8, seed=13)
    src_cls, dst_cls = ((AsyncAFLServer, RefAsync) if direction == "port_to_ref"
                        else (RefAsync, AsyncAFLServer))
    src_reps = reps if src_cls is AsyncAFLServer else _both(reps)
    dst_reps = reps if dst_cls is AsyncAFLServer else _both(reps)

    async def body():
        async with src_cls(D, C, gamma=GAMMA) as srv:
            await srv.submit_many(src_reps[:5])
            state = await srv.checkpoint()
            w0 = await srv.solve()
        async with dst_cls.from_state(state) as back:
            assert back.num_clients == 5
            w1 = await back.solve()
            with pytest.raises(ValueError):      # dedup survives the trip
                await back.submit(dst_reps[0])
            await back.submit_many(dst_reps[5:])
            return w0, w1, await back.solve()

    w0, w1, w_all = asyncio.run(body())
    np.testing.assert_array_equal(w1, w0)
    oracle = AFLServer(D, C, gamma=GAMMA)
    oracle.submit_many(reps)
    np.testing.assert_array_equal(w_all, oracle.solve())
