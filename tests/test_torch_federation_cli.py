"""The port's federation entry points, in subprocesses.

``python -m repro_torch.launch.serve --federation`` on a free port (its URL
read from the ``… up:`` line within a time limit, stopped by SIGINT at the
end), driven by ``python -m repro_torch.launch.train --server-url``
(reduced minicpm_2b on the CPU): the accuracy is the in-process run's, the
ledger holds exactly the posted report and the served head is an
in-process ``AFLServer``'s solve of it, bit for bit, for the async and the
sync coordinator. A trainer of another width is refused; ``--restore-from``
and ``--snapshot-dir`` use the port's checkpoints; ``run_afl`` over the
served federation is the in-process round; ``--mux`` with TLS and a
bearer token serves the same bits; ``--replica`` and ``--standby-of``
serve the ledger read-only and promote on the primary's death. Every
subprocess wait is bounded.
"""

import os
import queue
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro_torch.fl import AFLServer, ClientReport, RemoteCoordinator, make_report
from repro_torch.fl import errors as E

DIM, C, GAMMA = 16, 4, 1.0
ROOT = Path(__file__).resolve().parents[1]


def _reports(n=6, rows=5, seed=0, start_id=0):
    rng = np.random.default_rng(seed)
    return [make_report(start_id + k, rng.standard_normal((rows, DIM)),
                        np.eye(C)[rng.integers(0, C, rows)], GAMMA)
            for k in range(n)]


def _oracle(reps):
    srv = AFLServer(DIM, C, gamma=GAMMA)
    srv.submit_many(reps)
    return srv


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _Served:
    """``python -m repro_torch.launch.serve --federation …`` on a free port:
    its URL read from the ``… up:`` line within ``timeout``; stopped
    (SIGINT, then killed) on exit."""

    def __init__(self, *args, timeout=60.0):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
             "--port", "0", *args], cwd=ROOT, env=_env(), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self.lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()
        self.url, self.out = None, []
        try:
            while self.url is None:
                line = self.lines.get(timeout=timeout)
                self.out.append(line)
                m = re.search(r"(?:federation|weights replica|warm standby) up: (\S+)",
                              line)
                if m:
                    self.url = m.group(1)
                elif line == "":
                    raise AssertionError("".join(self.out))
        except BaseException:
            self.stop()
            raise

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put("")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=20)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _train(*args, timeout=300):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm_2b",
         "--reduced", "--samples", "256", "--seq", "16", "--classes", "8",
         "--batch", "64", "--device", "cpu", *args],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return float(re.search(r"acc=([0-9.]+)", res.stdout).group(1)), res.stdout


@pytest.mark.parametrize("coordinator", ["async", "sync"])
def test_serve_federation_cli_and_train_server_url(coordinator, tmp_path):
    """The serve CLI hosts a federation in a subprocess; the train CLI
    posts its report there and gets the in-process run's accuracy; the
    ledger holds exactly that report, and the service's head is an
    in-process server's solve of it, bit for bit."""
    from repro_torch.fl.replication import LedgerTailer

    acc_local, _ = _train()
    ledger = tmp_path / "ledger"
    with _Served("--coordinator", coordinator, "--dim", "128", "--classes", "8",
                 "--ledger-dir", str(ledger)) as srv:
        acc_remote, out = _train("--server-url", srv.url)
        assert f"via {srv.url}" in out
        rc = RemoteCoordinator(srv.url)
        try:
            assert (rc.num_clients, rc.kind) == (1, {"async": "AsyncAFLServer",
                                                     "sync": "AFLServer"}[coordinator])
            w_remote = rc.solve()
        finally:
            rc.close()
    assert acc_remote == acc_local
    records = LedgerTailer(ledger).poll()
    assert len(records) == 1
    oracle = AFLServer(128, 8, gamma=1.0)
    oracle.submit(ClientReport.from_bytes(records[0][2]))
    np.testing.assert_array_equal(w_remote, oracle.solve())


def test_train_refuses_a_federation_of_another_width():
    with _Served("--dim", "64", "--classes", "8") as srv:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm_2b",
             "--reduced", "--samples", "128", "--seq", "8", "--classes", "8",
             "--device", "cpu", "--server-url", srv.url],
            cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "dim=64 != model d_model=128" in res.stderr


def test_serve_federation_restores_from_a_checkpoint(tmp_path):
    """``--restore-from`` cold-starts the served coordinator from a port
    checkpoint, and ``--snapshot-dir`` runs a snapshot daemon beside it."""
    from repro_torch import checkpoint as ckpt

    reps = _reports(4, seed=8)
    src = AFLServer(DIM, C, gamma=GAMMA)
    src.submit_many(reps[:3])
    ckpt.save_server(tmp_path / "ck", src)
    with _Served("--coordinator", "async", "--dim", str(DIM), "--classes", str(C),
                 "--restore-from", str(tmp_path / "ck"), "--snapshot-dir",
                 str(tmp_path / "snaps"), "--snapshot-every", "0.2") as srv:
        assert any("restored async coordinator" in line for line in srv.out)
        rc = RemoteCoordinator(srv.url)
        try:
            assert rc.num_clients == 3
            rc.submit(reps[3])
            w = rc.solve()
        finally:
            rc.close()
    np.testing.assert_array_equal(w, _oracle(reps).solve())
    snaps = sorted((tmp_path / "snaps").glob("snap-*"))
    assert snaps and ckpt.load_server(snaps[-1]).num_clients >= 3


def test_run_afl_over_a_served_federation_matches_in_process():
    from repro_torch.config import FLConfig
    from repro_torch.data import synthetic as D
    from repro_torch.fl import afl

    ds = D.gaussian_mixture(n=1200, dim=32, num_classes=6, seed=1)
    train, test = D.train_test_split(ds, 0.25, seed=0)
    fl = FLConfig(num_clients=20, partition="niid1", alpha=0.1)
    local = afl.run_afl(train, test, fl)
    with _Served("--coordinator", "async", "--dim", "32", "--classes", "6") as srv:
        res = afl.run_afl(train, test, fl, coordinator=srv.url)
    np.testing.assert_array_equal(res.weight, local.weight)
    assert res.accuracy == local.accuracy


def test_serve_role_replica_and_standby_clis(tmp_path):
    """``--replica`` serves the primary's ledger read-only (writes answer the
    typed 403); ``--standby-of`` tails it, answers 503 while the primary
    lives, and promotes itself when the primary stops answering, with every
    acknowledged report."""
    ledger = str(tmp_path / "ledger")
    reps = _reports(5, seed=6)
    common = ["--dim", str(DIM), "--classes", str(C), "--ledger-dir", ledger]
    with _Served("--coordinator", "sync", *common) as primary:
        rc = RemoteCoordinator(primary.url)
        try:
            rc.submit_many(reps[:4])
        finally:
            rc.close()
        with _Served("--replica", *common) as replica:
            rr = RemoteCoordinator(replica.url)
            try:
                assert rr.describe()["read_only"] is True
                np.testing.assert_array_equal(rr.solve(), _oracle(reps[:4]).solve())
                with pytest.raises(E.ReadOnlyFederation):
                    rr.submit(reps[4])
            finally:
                rr.close()
        standby = _Served("--standby-of", primary.url, "--grace", "2",
                          "--watch-every", "0.2", *common)
    try:
        line = ""
        while "PROMOTED" not in line:
            line = standby.lines.get(timeout=60)
            assert line, "".join(standby.out)
        rs = RemoteCoordinator(standby.url)
        try:
            assert rs.num_clients == 4
            rs.submit(reps[4])
            np.testing.assert_array_equal(rs.solve(), _oracle(reps).solve())
        finally:
            rs.close()
    finally:
        standby.stop()


def test_serve_federation_over_mux_with_tls_and_a_token(tmp_path):
    """``--mux --tls-cert/--tls-key --auth-token``: a ``muxs://`` client
    pinned to the certificate and holding the token solves the in-process
    bits; a wrong token is refused with the typed 401 at construction."""
    from repro_torch.fl import generate_self_signed_cert

    cert, key = generate_self_signed_cert(tmp_path)
    reps = _reports(4, seed=9)
    with _Served("--mux", "--tls-cert", cert, "--tls-key", key, "--auth-token", "tok",
                 "--dim", str(DIM), "--classes", str(C)) as srv:
        assert srv.url.startswith("muxs://")
        with pytest.raises(E.Unauthorized):
            RemoteCoordinator(srv.url, auth_token="wrong", cafile=cert)
        rc = RemoteCoordinator(srv.url, auth_token="tok", cafile=cert)
        try:
            rc.submit_many(reps)
            np.testing.assert_array_equal(rc.solve(), _oracle(reps).solve())
        finally:
            rc.close()


# --- the sharded coordinator ------------------------------------------------------


def test_serve_sharded_tiled_federation_grows_and_shrinks_over_the_wire(tmp_path):
    """``--coordinator sharded --shards 4 --tiled --device cpu``: the served
    head is, bit for bit, an in-process ``ShardedCoordinator`` of the same
    configuration fed the same reports, within the f32 tolerance of the
    host f64 oracle; ``grow`` / ``shrink`` over the wire re-tile it and
    bump ``describe``'s ``mesh_epoch``; its state restores in an
    ``AFLServer`` to the oracle's bits; ``tools/torch_snapshotd.py`` pulls
    it, and ``tools/torch_standbyd.py --once`` and the daemon's
    ``restore`` bring it back on other shard counts."""
    from repro_torch.checkpoint import SnapshotDaemon
    from repro_torch.fl import ShardedCoordinator

    reps = _reports(6, seed=11)
    oracle = _oracle(reps)
    inproc = ShardedCoordinator(DIM, C, gamma=GAMMA, num_shards=4, tiled_gram=True,
                                device="cpu")
    inproc.submit_many(reps)
    ledger, snaps = tmp_path / "ledger", tmp_path / "snaps"
    with _Served("--coordinator", "sharded", "--shards", "4", "--tiled", "--device", "cpu",
                 "--dim", str(DIM), "--classes", str(C), "--ledger-dir", str(ledger)) as srv:
        assert any("shards=4 tiled=True" in line for line in srv.out)
        rc = RemoteCoordinator(srv.url)
        try:
            rc.submit_many(reps)
            info = rc.describe()
            assert (info["num_shards"], info["mesh_epoch"]) == (4, 0)
            assert rc.kind == "ShardedCoordinator"
            w = rc.solve()
            np.testing.assert_array_equal(w, inproc.solve())
            np.testing.assert_allclose(w, oracle.solve(), rtol=1e-3, atol=2e-3)
            for verb, n, shards, epoch in (("grow", 2, 6, 1), ("shrink", 3, 3, 2)):
                assert getattr(rc, verb)(n) == epoch
                info = rc.describe()
                assert (info["num_shards"], info["mesh_epoch"]) == (shards, epoch)
                np.testing.assert_allclose(rc.solve(), oracle.solve(), rtol=1e-3, atol=2e-3)
            np.testing.assert_array_equal(AFLServer.from_state(rc.state()).solve(),
                                          oracle.solve())
        finally:
            rc.close()
        res = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_snapshotd.py"),
                              "--url", srv.url, "--dir", str(snaps), "--once"],
                             cwd=ROOT, env=_env(), capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
        assert "snap-000000000006-000002" in res.stdout
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_standbyd.py"),
                          "--ledger-dir", str(ledger), "--snapshot-dir", str(snaps),
                          "--coordinator", "sharded", "--shards", "5", "--device", "cpu",
                          "--once"], cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ShardedCoordinator with 6 clients" in res.stdout and "on 5 shards" in res.stdout
    restored = SnapshotDaemon(srv.url, directory=snaps).restore(
        ShardedCoordinator, num_shards=2, tiled_gram=True, device="cpu")
    assert restored.num_shards == 2 and restored.num_clients == 6
    np.testing.assert_array_equal(restored.solve_multi_gamma([0.3])[0],
                                  oracle.solve_multi_gamma([0.3])[0])


def test_serve_sharded_restores_from_a_checkpoint(tmp_path):
    """``--coordinator sharded --restore-from``: a sync server's checkpoint
    cold-starts the served coordinator through
    ``ShardedCoordinator.from_state`` on the flag's shard count."""
    from repro_torch import checkpoint as ckpt

    reps = _reports(5, seed=12)
    src = AFLServer(DIM, C, gamma=GAMMA)
    src.submit_many(reps[:4])
    ckpt.save_server(tmp_path / "ck", src)
    with _Served("--coordinator", "sharded", "--shards", "3", "--device", "cpu",
                 "--dim", str(DIM), "--classes", str(C),
                 "--restore-from", str(tmp_path / "ck")) as srv:
        assert any("restored sharded coordinator" in line for line in srv.out)
        rc = RemoteCoordinator(srv.url)
        try:
            info = rc.describe()
            assert (info["num_shards"], info["num_clients"]) == (3, 4)
            rc.submit(reps[4])
            sweep = rc.solve_multi_gamma([0.2])
        finally:
            rc.close()
    np.testing.assert_array_equal(sweep[0], _oracle(reps).solve_multi_gamma([0.2])[0])


def test_train_cli_through_the_sharded_coordinator():
    """``launch/train.py --shards 4 --tiled``: the reduced trainer's head
    solved over four f32 shards gets the one-shard run's accuracy."""
    acc_local, _ = _train()
    acc_sharded, out = _train("--shards", "4", "--tiled")
    assert "over 4 shards (tiled)" in out
    assert acc_sharded == acc_local
