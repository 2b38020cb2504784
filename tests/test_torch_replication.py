"""``repro_torch.fl.replication`` against the reference's.

The port's report ledger (append / sync / replay, rotation, the torn-tail
recovery, compaction and its floor), its tailer, the service's durable
ingest, ``WarmStandby`` (cold-start sources, promotion bit for bit the
never-crashed oracle, the kill-the-primary-mid-stream drill, promotion
over the wire) and ``WeightsReplica`` (following the primary, the typed
read-only refusal), as tests/test_replication.py holds the reference's.

Across the packages: the same appends give segment files equal byte for
byte, and a ledger written by either package is tailed and replayed by the
other, to a coordinator whose head is the oracle's bits.
"""

import time

import numpy as np
import pytest

from repro.fl import AFLServer as RefServer
from repro.fl import FederationService as RefService
from repro.fl import RemoteCoordinator as RefRemote
from repro.fl import errors as RE
from repro.fl.replication import LedgerTailer as RefTailer
from repro.fl.replication import ReportLedger as RefLedger
from repro.fl.replication import WarmStandby as RefStandby
from repro.fl.replication import WeightsReplica as RefReplica
from repro.fl.replication import last_seq_on_disk as ref_last_seq
from repro_torch.checkpoint import SnapshotDaemon
from repro_torch.fl import (AFLServer, AsyncAFLServer, FederationService,
                            InProcTransport, LedgerTailer, RemoteCoordinator,
                            ReportLedger, WarmStandby, WeightsReplica,
                            compact_ledger_dir, make_report, promote_remote)
from repro_torch.fl import errors as E
from repro_torch.fl.replication import last_seq_on_disk
from repro_torch.fl.service import _decode_response

DIM, C, GAMMA = 16, 4, 1.0
_CTOR = dict(dim=DIM, num_classes=C, gamma=GAMMA)


def _reports(n=8, rows=10, seed=0, start_id=0):
    rng = np.random.default_rng(seed)
    return [make_report(start_id + k, rng.standard_normal((rows, DIM)),
                        np.eye(C)[rng.integers(0, C, rows)], GAMMA)
            for k in range(n)]


def _oracle(reports):
    srv = AFLServer(DIM, C, gamma=GAMMA)
    srv.submit_many(reports)
    return srv


def _drain(coord, timeout=5.0):
    deadline = time.monotonic() + timeout
    while coord.pending and time.monotonic() < deadline:
        time.sleep(0.005)
    assert coord.pending == 0


# --- the ledger and its tailer ------------------------------------------------------

class TestReportLedger:
    def test_append_sync_replay_roundtrip(self, tmp_path):
        payloads = [r.to_bytes() for r in _reports(5)]
        with ReportLedger(tmp_path) as led:
            for cid, p in enumerate(payloads):
                assert led.append(p, cid) == cid + 1
            led.sync()
            assert led.last_seq == led.durable_seq == 5
        led2 = ReportLedger(tmp_path)
        got = list(led2.records())
        assert [(s, c) for s, c, _ in got] == [(k + 1, k) for k in range(5)]
        assert [p for _, _, p in got] == payloads
        assert [s for s, _, _ in led2.records(after_seq=3)] == [4, 5]
        led2.close()

    def test_rotation_seals_segments_and_replay_spans_them(self, tmp_path):
        payloads = [r.to_bytes() for r in _reports(6)]
        led = ReportLedger(tmp_path, segment_bytes=2 * len(payloads[0]))
        for cid, p in enumerate(payloads):
            led.append(p, cid)
        segs = sorted(tmp_path.glob("ledger-*.seg"))
        assert len(segs) >= 2 and segs[0].name == "ledger-000000000001.seg"
        assert [c for _, c, _ in led.records()] == list(range(6))
        assert last_seq_on_disk(tmp_path) == 6
        led.close()

    def test_torn_tail_garbage_is_truncated_on_open(self, tmp_path):
        led = ReportLedger(tmp_path)
        for cid, r in enumerate(_reports(3)):
            led.append(r.to_bytes(), cid)
        led.close()
        seg = sorted(tmp_path.glob("ledger-*.seg"))[-1]
        clean = seg.stat().st_size
        with seg.open("ab") as f:
            f.write(b"\x13\x37" * 9)
        led2 = ReportLedger(tmp_path)
        assert led2.last_seq == 3 and seg.stat().st_size == clean
        led2.close()

    def test_compaction_keeps_suffix_and_floor(self, tmp_path):
        payloads = [r.to_bytes() for r in _reports(6)]
        led = ReportLedger(tmp_path, segment_bytes=1)
        for cid, p in enumerate(payloads):
            led.append(p, cid)
        assert len(led.compact("/snaps/snap-000000000004-000000", 4)) == 4
        assert led.base_seq == 4
        assert [s for s, _, _ in led.records()] == [5, 6]
        led.compact(None, 2)
        assert led.base_seq == 4
        led.append(payloads[0], 10)
        assert led.last_seq == 7
        led.close()


class TestLedgerTailer:
    def test_incremental_polls_across_rotation(self, tmp_path):
        led = ReportLedger(tmp_path, segment_bytes=1)
        tail = LedgerTailer(tmp_path)
        assert tail.poll() == []
        led.append(b"a", 0)
        led.append(b"b", 1)
        led.sync()
        assert tail.poll() == [(1, 0, b"a"), (2, 1, b"b")]
        assert tail.poll() == []
        led.append(b"c", 2)
        led.sync()
        assert [p for _, _, p in tail.poll()] == [b"c"]
        assert tail.position == 3 and tail.lag() == 0
        led.close()

    def test_tailer_stops_at_torn_tail_then_follows_past_compaction(self, tmp_path):
        led = ReportLedger(tmp_path / "a")
        led.append(b"ok", 0)
        led.sync()
        seg = sorted((tmp_path / "a").glob("ledger-*.seg"))[-1]
        with seg.open("ab") as f:
            f.write(b"\xde\xad\xbe\xef")
        tail = LedgerTailer(tmp_path / "a")
        assert [p for _, _, p in tail.poll()] == [b"ok"] and tail.poll() == []
        led.close()
        led = ReportLedger(tmp_path / "b", segment_bytes=1)
        for cid in range(4):
            led.append(bytes([cid]), cid)
        led.compact(None, 2)
        assert [s for s, _, _ in LedgerTailer(tmp_path / "b").poll()] == [3, 4]
        led.close()


class TestServiceLedger:
    def test_sync_submit_is_durable_before_the_ack(self, tmp_path):
        svc = FederationService(AFLServer(**_CTOR), ledger_dir=tmp_path)
        rc = RemoteCoordinator(svc)
        rc.submit(_reports(1)[0])
        led = svc._fed("default").ledger
        assert led.last_seq == 1 and led.durable_seq == 1
        assert rc.submit(_reports(1)[0]) is True       # idempotent retry
        assert led.last_seq == 1
        svc.close()

    def test_stream_appends_on_admission_one_fsync_per_batch(self, tmp_path):
        svc = FederationService(AsyncAFLServer(**_CTOR), ledger_dir=tmp_path)
        rc = RemoteCoordinator(svc)
        payloads = [r.to_bytes() for r in _reports(5)]
        assert rc.submit_stream(payloads)["accepted"] == 5
        led = svc._fed("default").ledger
        assert led.last_seq == 5 and led.durable_seq == 5
        _drain(svc.coordinator())
        out = rc.submit_stream(payloads)
        assert all(r.get("duplicate") for r in out["results"])
        assert led.last_seq == 5
        svc.close()


# --- warm standby and weights replica --------------------------------------------------

class TestWarmStandby:
    def test_cold_start_sources(self, tmp_path):
        led_dir = tmp_path / "ledger"
        ReportLedger(led_dir).close()
        with pytest.raises(E.BadRequest):
            WarmStandby(led_dir)
        assert WarmStandby(led_dir, ctor_kw=_CTOR).coordinator.num_clients == 0
        oracle = _oracle(_reports(2))
        assert WarmStandby(led_dir, coordinator=oracle).coordinator is oracle
        snaps = tmp_path / "snaps"
        SnapshotDaemon(oracle, directory=snaps).snapshot_once()
        assert WarmStandby(led_dir, snapshot_dir=snaps).coordinator.num_clients == 2
        led = ReportLedger(led_dir)
        led.compact(sorted(snaps.glob("snap-*"))[0], 2)
        led.close()
        assert WarmStandby(led_dir).coordinator.num_clients == 2

    def test_promote_is_bitwise_the_oracle(self, tmp_path):
        reports = _reports(12)
        svc = FederationService(AFLServer(**_CTOR), ledger_dir=tmp_path / "ledger")
        rc = RemoteCoordinator(svc)
        for r in reports[:7]:
            rc.submit(r)
        snaps = tmp_path / "snaps"
        SnapshotDaemon(svc, directory=snaps).snapshot_once()
        rc.submit_stream([r.to_bytes() for r in reports[7:]])
        coord = WarmStandby(tmp_path / "ledger", snapshot_dir=snaps).promote()
        assert coord.num_clients == 12
        oracle = _oracle(reports)
        for g in (0.0, 0.3, 2.0):
            np.testing.assert_array_equal(coord.solve(g), oracle.solve(g))
        np.testing.assert_array_equal(coord.state()["gram"], oracle.state()["gram"])
        svc.close()

    def test_kill_primary_mid_stream_zero_loss(self, tmp_path):
        reports = _reports(16)
        primary = AsyncAFLServer(**_CTOR)
        svc = FederationService(primary, ledger_dir=tmp_path / "ledger")
        rc = RemoteCoordinator(svc)
        rc.submit_stream([r.to_bytes() for r in reports[:10]])
        _drain(primary)
        snaps = tmp_path / "snaps"
        SnapshotDaemon(svc, directory=snaps).snapshot_once()
        standby = WarmStandby(tmp_path / "ledger", snapshot_dir=snaps,
                              poll_interval=0.01).start()
        assert rc.submit_stream([r.to_bytes() for r in reports[10:]])["accepted"] == 6
        svc.suspend_federation()
        with pytest.raises(E.Unavailable):
            rc.solve(0.25)
        promoted = standby.promote()
        assert promoted.num_clients == 16
        np.testing.assert_array_equal(promoted.solve(0.25), _oracle(reports).solve(0.25))
        svc.restore_federation("default", promoted)
        header, _, _ = _decode_response(
            InProcTransport(svc).request("submit", reports[12].to_bytes()))
        assert header["duplicate"] is True
        svc.close()

    def test_hosted_standby_promotes_over_the_wire(self, tmp_path):
        reports = _reports(6)
        svc = FederationService(AFLServer(**_CTOR), ledger_dir=tmp_path)
        RemoteCoordinator(svc).submit_many(reports)
        svc.close()
        standby_svc = FederationService()
        standby_svc.host_standby("default", WarmStandby(tmp_path, ctor_kw=_CTOR))
        with pytest.raises(E.Unavailable) as exc:
            RemoteCoordinator(standby_svc)
        assert exc.value.retryable
        header = promote_remote(standby_svc)
        assert header["promoted"] and header["num_clients"] == 6
        rc = RemoteCoordinator(standby_svc)
        np.testing.assert_array_equal(rc.solve(0.5), _oracle(reports).solve(0.5))
        rc.submit(_reports(1, start_id=50, seed=5)[0])
        assert standby_svc._fed("default").ledger.last_seq == 7
        standby_svc.close()


class TestWeightsReplica:
    def _primary(self, tmp_path):
        svc = FederationService(AFLServer(**_CTOR), ledger_dir=tmp_path)
        rc = RemoteCoordinator(svc)
        rc.submit_many(_reports(5))
        return svc, rc

    def test_replica_follows_the_primary_epoch(self, tmp_path):
        svc, rc = self._primary(tmp_path)
        rep = WeightsReplica(tmp_path, ctor_kw=_CTOR)
        assert rep.num_clients == 5 and rep.lag == 0
        np.testing.assert_array_equal(rep.solve(0.4), svc.coordinator().solve(0.4))
        rc.submit(_reports(1, start_id=9, seed=9)[0])
        assert rep.lag == 1
        np.testing.assert_array_equal(rep.solve(0.4), svc.coordinator().solve(0.4))
        assert rep.version == svc.coordinator().version
        rep.close()
        svc.close()

    def test_lagging_replica_answers_typed_unavailable(self, tmp_path):
        svc, rc = self._primary(tmp_path)
        rep = WeightsReplica(tmp_path, ctor_kw=_CTOR, auto_refresh=False)
        rep.weights(0.2)
        rc.submit(_reports(1, start_id=9, seed=9)[0])
        with pytest.raises(E.Unavailable) as exc:
            rep.weights(0.2)
        assert exc.value.retryable and rep.refresh() == 1
        rep.weights(0.2)
        rep.close()
        svc.close()

    def test_mutations_raise_typed_read_only(self, tmp_path):
        svc, _ = self._primary(tmp_path)
        rep = WeightsReplica(tmp_path, ctor_kw=_CTOR)
        for call in (lambda: rep.submit(_reports(1, start_id=9)[0]),
                     lambda: rep.grow(1), lambda: rep.shrink(1)):
            with pytest.raises(E.ReadOnlyFederation) as exc:
                call()
            assert not exc.value.retryable
        rep.close()
        svc.close()

    def test_replica_over_the_wire(self, tmp_path):
        svc, rc = self._primary(tmp_path)
        rep_svc = FederationService(WeightsReplica(tmp_path, ctor_kw=_CTOR))
        rrc = RemoteCoordinator(rep_svc)
        info = rrc.describe()
        assert info["read_only"] is True and info["replica_lag"] == 0
        np.testing.assert_array_equal(rrc.solve(0.4), rc.solve(0.4))
        with pytest.raises(E.ReadOnlyFederation):
            rrc.submit(_reports(1, start_id=9)[0])
        with pytest.raises(E.ReadOnlyFederation):
            rrc.grow(1)
        rep_svc.close()
        svc.close()


# --- across the two packages ------------------------------------------------------------

def test_segment_files_are_byte_for_byte_the_reference_s(tmp_path):
    """The same appends, syncs, rotations and compaction give the same
    files: segments byte for byte, and the compaction checkpoint."""
    payloads = [r.to_bytes() for r in _reports(6)]
    for cls, sub in ((ReportLedger, "port"), (RefLedger, "ref")):
        led = cls(tmp_path / sub, segment_bytes=3 * len(payloads[0]))
        for cid, p in enumerate(payloads):
            led.append(p, cid)
        led.sync()
        led.compact("snap-000000000002-000000", 2)
        led.close()
    port = sorted(p.name for p in (tmp_path / "port").iterdir())
    ref = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert port == ref and any(n.endswith(".seg") for n in port)
    for name in port:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_ledger_of_either_package_replays_in_the_other(writer, tmp_path):
    """A service of one package writes the ledger; the other package's
    tailer reads every record and its standby and replica replay them to
    the oracle's bits (and the position on disk agrees)."""
    from repro.fl import ClientReport as RefReport

    reports = _reports(10, seed=3)
    if writer == "port":
        svc, remote, send = (FederationService(AFLServer(**_CTOR), ledger_dir=tmp_path),
                             RemoteCoordinator, reports)
        tailer, standby, replica = RefTailer, RefStandby, RefReplica
        ctor = dict(_CTOR)
        ref_ctor = dict(cls=RefServer, ctor_kw=ctor)
    else:
        svc, remote = (RefService(RefServer(**_CTOR), ledger_dir=tmp_path), RefRemote)
        send = [RefReport.from_bytes(r.to_bytes()) for r in reports]
        tailer, standby, replica = LedgerTailer, WarmStandby, WeightsReplica
        ref_ctor = dict(cls=AFLServer, ctor_kw=dict(_CTOR))
    rc = remote(svc)
    for r in send[:6]:
        rc.submit(r)
    rc.submit_stream([r.to_bytes() for r in send[6:]])
    records = tailer(tmp_path).poll()
    assert [c for _, c, _ in records] == list(range(10))
    assert [p for _, _, p in records] == [r.to_bytes() for r in reports]
    assert last_seq_on_disk(tmp_path) == ref_last_seq(tmp_path) == 10
    oracle = _oracle(reports)
    promoted = standby(tmp_path, **ref_ctor).promote()
    assert promoted.num_clients == 10
    for g in (0.0, 0.5):
        np.testing.assert_array_equal(promoted.solve(g), oracle.solve(g))
    rep = replica(tmp_path, **ref_ctor)
    np.testing.assert_array_equal(rep.solve(0.5), oracle.solve(0.5))
    with pytest.raises(RE.ReadOnlyFederation if writer == "port" else E.ReadOnlyFederation):
        rep.submit(send[0])
    rep.close()
    svc.close()


def test_out_of_process_compaction_across_packages(tmp_path):
    """``compact_ledger_dir`` of the port on a ledger the reference writes
    leaves the live writer appending, and the reference's tailer follows."""
    led = RefLedger(tmp_path, segment_bytes=1)
    for cid in range(5):
        led.append(bytes([cid]), cid)
    led.sync()
    compact_ledger_dir(tmp_path, None, 3)
    led.append(b"x", 9)
    led.sync()
    assert [s for s, _, _ in RefTailer(tmp_path).poll()] == [4, 5, 6]
    assert [s for s, _, _ in LedgerTailer(tmp_path).poll()] == [4, 5, 6]
    led.close()
