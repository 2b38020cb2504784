"""``repro_torch.core.distributed``: the shard mesh and its collectives, the
psum solve and the tiled solve, against the reference and numpy.

The port of tests/test_distributed_cholesky.py's schedule cases and
tests/test_core_distributed.py, on the CPU, where the panel schedule runs
the kernels' plain versions. The reference runs its shards as devices of a
jax ``Mesh``; the port runs them as threads of one process
(``ShardGroup``), so where the reference needs eight fake devices in a
subprocess, the port's eight shards run here on the CPU. The reference's
own 8-device x64 ``make_tiled_federated_solve`` still runs in a subprocess,
as its tests run it, and the port's 8-shard answer on the same tiles is
held to it.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.core import streaming as rstreaming
from repro_torch.core import analytic as al
from repro_torch.core import distributed as DD
from repro_torch.core import streaming
from repro_torch.kernels import solve as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spd(rng, d, ridge=0.5, dtype=np.float32):
    x = rng.standard_normal((d + 32, d)).astype(dtype)
    a = x.T @ x
    a[np.arange(d), np.arange(d)] += dtype(ridge)
    return a


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.abs(a.astype(np.float64) - b).max() / max(1.0, np.abs(b).max())


def _tiles(a, n):
    """(n, rows, …) row tiles of ``a``."""
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


def _cpu_mesh(n):
    return DD.federation_mesh(n, device="cpu")


# --- the mesh -----------------------------------------------------------------


class TestFederationMesh:
    def test_cyclic_placement(self):
        """Shard i sits on devices[i % len(devices)]. Where the reference
        asserts "n shards need n devices" (a limit of a jax Mesh), the port
        places more shards than devices cyclically: shards that share a
        device take turns on it."""
        devs = [torch.device("cpu"), torch.device("meta")]
        mesh = DD.federation_mesh(5, devs)
        assert mesh == tuple(devs[i % 2] for i in range(5))
        assert DD.federation_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
        assert DD.federation_mesh(2, ["cpu"] * 4) == (torch.device("cpu"),) * 2

    def test_bounds_and_default_device(self):
        with pytest.raises(ValueError):
            DD.federation_mesh(0, device="cpu")
        with pytest.raises(ValueError):
            DD.federation_mesh(2, [])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                DD.federation_mesh(2)


# --- the runner ---------------------------------------------------------------


class TestShardGroup:
    def test_gather_and_psum_order_and_bits(self):
        """gather stacks in shard order; psum sums in the fixed order
        0…n−1, so every shard holds the same bits (f32 sums of values that
        differ in scale, where another order rounds differently)."""
        n = 8
        rng = np.random.default_rng(0)
        vals = torch.tensor(rng.standard_normal((n, 5)) * 10.0 ** rng.integers(
            -4, 5, (n, 1)), dtype=torch.float32)

        def body(s):
            return s.index, s.n, s.gather(vals[s.index]), s.psum(vals[s.index])

        out = DD.ShardGroup(_cpu_mesh(n)).run(body)
        want = vals[0].clone()
        for v in vals[1:]:
            want = want + v
        for i, (index, count, gathered, total) in enumerate(out):
            assert (index, count) == (i, n)
            assert torch.equal(gathered, vals)
            assert torch.equal(total, want)

    def test_failing_shard_raises_in_the_caller_without_hanging(self):
        """A shard that raises aborts the barrier: the shards waiting in a
        collective leave it, and the caller gets the failing shard's error
        (not a broken barrier), well within a time limit."""
        n = 6
        entered = threading.Barrier(n)

        def body(s):
            entered.wait(timeout=10)
            if s.index == 4:
                time.sleep(0.2)           # the others are in the psum by now
                raise KeyError("shard 4 failed")
            return s.psum(torch.ones(3))

        t0 = time.perf_counter()
        with pytest.raises(KeyError, match="shard 4 failed"):
            DD.ShardGroup(_cpu_mesh(n)).run(body)
        assert time.perf_counter() - t0 < 5.0
        assert not [t for t in threading.enumerate() if t.name.startswith("afl-shard-")]

    def test_mismatched_collectives_raise(self):
        def body(s):
            x = torch.ones(2)
            return s.gather(x) if s.index else s.psum(x)

        with pytest.raises(RuntimeError, match="disagree"):
            DD.ShardGroup(_cpu_mesh(3)).run(body)

    def test_psum_stats_adds_every_leaf(self):
        from repro_torch.core.engine import SuffStats

        def body(s):
            st = SuffStats(torch.full((2, 2), float(s.index)), torch.ones(2, 1),
                           torch.tensor(3.0), torch.tensor(1.0))
            return DD.psum_stats(st, s.psum)

        out = DD.ShardGroup(_cpu_mesh(4)).run(body)[2]
        assert torch.equal(out.gram, torch.full((2, 2), 6.0))
        assert float(out.count) == 12.0 and float(out.clients) == 4.0
        assert out.gram_c is None


# --- the tiled solve ----------------------------------------------------------


class TestDistributedFactor:
    def test_single_shard_bit_for_bit(self):
        """1-shard distributed ≡ the streamed solve, bitwise
        (tests/test_distributed_cholesky.py:89-104)."""
        rng = np.random.default_rng(7)
        d, gamma, block = 256, 0.5, 64
        g = _spd(rng, d, ridge=0.0)
        q = rng.standard_normal((d, 9)).astype(np.float32)
        a = g.copy()
        a[np.arange(d), np.arange(d)] += np.float32(gamma)
        fn = DD.make_tiled_federated_solve(
            _cpu_mesh(1), target_gamma=gamma, distributed_factor=True, dim=d,
            block=block)
        w_dist = fn(g[None], q[None])
        l = S.streamed_cholesky(torch.from_numpy(a), block=block)
        w_loc = S.streamed_cholesky_solve(l, torch.from_numpy(q), block=block)
        assert torch.equal(w_dist, w_loc)

    def test_padded_dim_matches_host(self):
        """dim not divisible by the tile rows: pad rows carry a unit
        diagonal and are sliced off the result
        (tests/test_distributed_cholesky.py:106-124)."""
        rng = np.random.default_rng(8)
        d, d_p = 120, 128
        g = _spd(rng, d, ridge=0.0)
        q = rng.standard_normal((d, 5)).astype(np.float32)
        gp = np.zeros((d_p, d_p), np.float32)
        gp[:d, :d] = g
        qp = np.zeros((d_p, 5), np.float32)
        qp[:d] = q
        fn = DD.make_tiled_federated_solve(
            _cpu_mesh(1), target_gamma=0.5, distributed_factor=True, dim=d, block=32)
        w = fn(gp[None], qp[None])
        assert w.shape == (d, 5)
        ref = np.linalg.solve(g.astype(np.float64) + 0.5 * np.eye(d), q.astype(np.float64))
        assert _rel(w, ref) < 1e-4

    @pytest.mark.parametrize("n, d, d_p", [(4, 64, 64), (8, 60, 64)])
    def test_gather_branch_matches_distributed(self, n, d, d_p):
        rng = np.random.default_rng(n)
        g = _spd(rng, d, ridge=0.0)
        q = rng.standard_normal((d, 3)).astype(np.float32)
        gp = np.zeros((d_p, d_p), np.float32)
        gp[:d, :d] = g
        qp = np.zeros((d_p, 3), np.float32)
        qp[:d] = q
        kw = dict(target_gamma=0.5, dim=d)
        w_g = DD.make_tiled_federated_solve(_cpu_mesh(n), **kw)(_tiles(gp, n), _tiles(qp, n))
        w_d = DD.make_tiled_federated_solve(_cpu_mesh(n), distributed_factor=True, block=8,
                                            **kw)(_tiles(gp, n), _tiles(qp, n))
        ref = np.linalg.solve(g.astype(np.float64) + 0.5 * np.eye(d), q.astype(np.float64))
        assert w_g.shape == w_d.shape == (d, 3)
        assert _rel(w_g, ref) < 1e-4 and _rel(w_d, ref) < 1e-4
        np.testing.assert_allclose(w_d.numpy(), w_g.numpy(), rtol=1e-4, atol=1e-5)

    def test_tiles_are_not_consumed(self):
        """The factor is built in each shard's own upload of its tile: the
        given tiles, tensors or the coordinator's host f64 arrays, are left
        as they were, and both give the same answer."""
        rng = np.random.default_rng(3)
        d, n = 32, 4
        g = torch.from_numpy(_spd(rng, d))
        q = torch.from_numpy(rng.standard_normal((d, 2)).astype(np.float32))
        kept = _tiles(g.clone(), n)
        host = [t.double().numpy() for t in _tiles(g.clone(), n)]
        fn = DD.make_tiled_federated_solve(_cpu_mesh(n), distributed_factor=True, block=8)
        w = fn(kept, _tiles(q, n))
        assert torch.equal(kept.reshape(d, d), g)
        assert torch.equal(fn(host, [t.double().numpy() for t in _tiles(q, n)]), w)
        assert np.array_equal(np.concatenate(host), g.double().numpy())

    def test_distributed_factor_never_exchanges_the_system(self, monkeypatch):
        """The reference's "never materializes the full system" invariant
        (tests/test_distributed_cholesky.py:126-151), read on what the
        shards exchange: the gather branch psums the (d, d) system, the
        distributed factor at most one (d, b) panel column."""
        seen = []
        collective = DD._Exchange.collective

        def spy(self, op, i, x):
            seen.append(x.numel())
            return collective(self, op, i, x)

        monkeypatch.setattr(DD._Exchange, "collective", spy)
        rng = np.random.default_rng(4)
        d, n, b = 64, 4, 8
        g = _spd(rng, d)
        q = rng.standard_normal((d, 3)).astype(np.float32)
        DD.make_tiled_federated_solve(_cpu_mesh(n))(_tiles(g, n), _tiles(q, n))
        assert max(seen) == d * d
        seen.clear()
        DD.make_tiled_federated_solve(_cpu_mesh(n), distributed_factor=True, block=b)(
            _tiles(g, n), _tiles(q, n))
        assert max(seen) == (d // n) * b

    def test_padded_8_shards_f64(self):
        """d = 150 padded to 152 over 8 shards at panels of 8, f64, within
        1e-10 of numpy (the reference's x64 case, run here in process)."""
        rng = np.random.default_rng(0)
        d, d_p, n, c = 150, 152, 8, 6
        x = rng.standard_normal((d + 64, d))
        g = x.T @ x
        q = rng.standard_normal((d, c))
        gp = np.zeros((d_p, d_p))
        gp[:d, :d] = g
        qp = np.zeros((d_p, c))
        qp[:d] = q
        fn = DD.make_tiled_federated_solve(_cpu_mesh(n), target_gamma=0.5,
                                           distributed_factor=True, dim=d, block=8,
                                           dtype=torch.float64)
        w = fn(_tiles(gp, n), _tiles(qp, n))
        assert w.dtype == torch.float64 and w.shape == (d, c)
        assert _rel(w, np.linalg.solve(g + 0.5 * np.eye(d), q)) < 1e-10


# --- d = 2048 over 8 shards in f64: numpy, and the reference's own 8 devices ---

_REF_X64 = textwrap.dedent(
    """
    import os, sys, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_ENABLE_X64"] = "1"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core.distributed as RD

    # the reference passes shard_map(check_rep=…), which jax renamed
    # check_vma; translate it so its tiled path runs on this jax
    _shard_map = RD.shard_map
    def shard_map(f=None, **kw):
        if "check_rep" in kw:
            kw["check_vma"] = kw.pop("check_rep")
        if f is None:
            return functools.partial(shard_map, **kw)
        return _shard_map(f, **kw)
    RD.shard_map = shard_map

    z = np.load(sys.argv[1])
    mesh = Mesh(np.array(jax.devices()), ("data",))
    fn = RD.make_tiled_federated_solve(mesh, target_gamma=0.5,
                                       distributed_factor=True, dim=int(z["d"]))
    w = np.asarray(fn(jnp.asarray(z["gt"]), jnp.asarray(z["mt"])))
    assert w.dtype == np.float64, w.dtype
    np.save(sys.argv[2], w)
    print("OK")
    """
)


@pytest.fixture(scope="module")
def x64_d2048():
    """Seeded tiles of a d = 2048 system over 8 shards, and the port's
    8-shard f64 distributed solve of them (panels of 128)."""
    rng = np.random.default_rng(0)
    d, n, c = 2048, 8, 6
    x = rng.standard_normal((d + 64, d))
    g = x.T @ x
    q = rng.standard_normal((d, c))
    gt, mt = _tiles(g, n), _tiles(q, n)
    fn = DD.make_tiled_federated_solve(_cpu_mesh(n), target_gamma=0.5,
                                       distributed_factor=True, dim=d,
                                       dtype=torch.float64)
    return dict(d=d, g=g, q=q, gt=gt, mt=mt, w=fn(gt, mt))


def test_x64_8_shards_d2048_matches_numpy(x64_d2048):
    z = x64_d2048
    ref = np.linalg.solve(z["g"] + 0.5 * np.eye(z["d"]), z["q"])
    assert z["w"].dtype == torch.float64
    assert _rel(z["w"], ref) < 1e-10


def test_x64_8_shards_d2048_matches_the_reference_8_devices(x64_d2048, tmp_path):
    """The reference's make_tiled_federated_solve on its 8-device x64 mesh
    (a subprocess, as its tests run it; Pallas panels in interpret mode),
    and the port's 8 shards on the same tiles: within 1e-10."""
    z = x64_d2048
    np.savez(tmp_path / "in.npz", d=z["d"], gt=z["gt"], mt=z["mt"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_X64, str(tmp_path / "in.npz"),
                          str(tmp_path / "w.npy")], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    w_ref = np.load(tmp_path / "w.npy")
    assert _rel(z["w"], w_ref) < 1e-10


# --- the psum solve -----------------------------------------------------------


def test_single_device_mesh_matches_the_reference():
    """make_federated_solve on one shard against the reference's on one jax
    device (f32): within the reference's 1e-4, and both within its 2e-3 of
    the host f64 ridge solve (tests/test_core_distributed.py:23-34)."""
    rng = np.random.default_rng(0)
    n, d, c = 256, 32, 7
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    st = streaming.update_state(streaming.init_state(d, c, device="cpu"),
                                torch.from_numpy(x), torch.from_numpy(y))
    stacked = streaming.AnalyticState(*(leaf[None] for leaf in st))
    w = DD.make_federated_solve(_cpu_mesh(1), gamma=1.0, target_gamma=0.05)(stacked)
    rst = rstreaming.update_state(rstreaming.init_state(d, c), jnp.asarray(x), jnp.asarray(y))
    r_stacked = jax.tree.map(lambda a: a[None], rst)
    w_ref = np.asarray(RD.make_federated_solve(
        jax.make_mesh((1,), ("data",)), axis_names=("data",), gamma=1.0,
        target_gamma=0.05)(r_stacked))
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=1e-4, atol=1e-4 * np.abs(w_ref).max())
    w_host = al.ridge_solve(x.astype(np.float64), y.astype(np.float64), 0.05)
    np.testing.assert_allclose(w.numpy(), w_host, atol=2e-3)


@pytest.mark.parametrize("use_ri", [True, False])
def test_8_shards_psum_matches_the_pairwise_aa_law(use_ri):
    """Eight per-shard states through one psum against the paper's
    Algorithm 1 over the eight clients on the host
    (tests/test_core_distributed.py:40-80); the no-RI ablation against the
    host's biased aggregate."""
    rng = np.random.default_rng(42)
    d, c, per = 24, 5, 40
    xs = rng.standard_normal((8, per, d)).astype(np.float32)
    ys = np.eye(c, dtype=np.float32)[rng.integers(0, c, (8, per))]
    states = [streaming.update_state(streaming.init_state(d, c, device="cpu"),
                                     torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
              for i in range(8)]
    stacked = streaming.AnalyticState(*(torch.stack(v) for v in zip(*states)))
    w = DD.make_federated_solve(_cpu_mesh(8), gamma=1.0, use_ri=use_ri)(stacked)
    ups = [al.local_stage(xs[i].astype(np.float64), ys[i].astype(np.float64), 1.0)
           for i in range(8)]
    w_host = al.afl_aggregate(ups, use_ri=use_ri, pairwise=use_ri)
    assert np.abs(w.numpy() - w_host).max() < 5e-3
    with pytest.raises(ValueError, match="split"):
        DD.make_federated_solve(_cpu_mesh(3))(stacked)
    if use_ri:
        # more stacked states than shards: each shard sums its block first
        # (without RI, K is the shard count, so the biased answer moves)
        w4 = DD.make_federated_solve(_cpu_mesh(4), gamma=1.0)(stacked)
        np.testing.assert_allclose(w4.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


# --- shared state under thread switches ---------------------------------------


def test_launch_counter_and_collectives_under_thread_switches():
    """Stress with more shards than cores and a shortened switch interval:
    the panel wrappers' launch counter (bumped under a lock from every
    shard thread) loses no count, and every round of collectives returns
    each shard the exact sum and the rows in shard order."""
    from repro_torch.kernels import panel as P

    n, rounds = max(16, 2 * (os.cpu_count() or 1)), 50
    before = P.panel_update.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(s):
            out = []
            for r in range(rounds):
                for _ in range(20):
                    P._count(P.panel_update)
                out.append((float(s.psum(torch.tensor(float(s.index + r)))),
                            s.gather(torch.tensor([s.index]))[:, 0].tolist()))
            return out

        t0 = time.perf_counter()
        results = DD.ShardGroup(_cpu_mesh(n)).run(body)
        assert time.perf_counter() - t0 < 60.0
    finally:
        sys.setswitchinterval(interval)
        added = P.panel_update.launches - before
        P.panel_update.launches = before
    assert added == n * rounds * 20
    for res in results:
        assert res == [(float(sum(range(n)) + n * r), list(range(n))) for r in range(rounds)]
