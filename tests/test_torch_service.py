"""``repro_torch.fl.service`` against the reference's, and the federation CLIs.

The port's ``FederationService`` over ``InProcTransport`` and over loopback
HTTP: the error taxonomy on the wire (corrupt, oversized, queue full,
duplicate, γ mismatch: the right code, and coordinator state untouched),
framed streaming ingest, the personalized-solve math, transport
equivalence, multi-federation routing, idempotent ingest, and the
checkpoint of a remote state (the cases of tests/test_service.py that need
no sharded coordinator).

Interop both ways: a reference ``RemoteCoordinator`` against a port-hosted
service, and a port ``RemoteCoordinator`` against a reference-hosted
service, each over HTTP, solve bit for bit what an in-process port
``AFLServer`` solves from the same reports at f64 (as
tests/test_coordinator_conformance.py:528-548 holds the reference to its
own). The typed errors keep their class, code and HTTP status across the
packages: unauthorized, payload too large, duplicate client, γ mismatch
and backpressure. Every socket here carries its transport's timeout.
"""


import numpy as np
import pytest

from repro.fl import FederationService as RefService
from repro.fl import RemoteCoordinator as RefRemote
from repro.fl import errors as RE
from repro.fl import serve_http as ref_serve_http
from repro.fl.service import unpack_message as ref_unpack
from repro_torch.fl import (AFLServer, AsyncAFLServer, FederationService,
                            HttpTransport, InProcTransport,
                            RemoteCoordinator, make_report, serve_http)
from repro_torch.fl import errors as E
from repro_torch.fl.service import frame_reports, pack_message, unpack_message

DIM, C, GAMMA = 16, 4, 1.0


def _reports(n=6, rows=5, seed=0, start_id=0):
    rng = np.random.default_rng(seed)
    return [make_report(start_id + k, rng.standard_normal((rows, DIM)),
                        np.eye(C)[rng.integers(0, C, rows)], GAMMA)
            for k in range(n)]


def _service(**kw):
    return FederationService(AFLServer(DIM, C, gamma=GAMMA), **kw)


def _ref_service(**kw):
    from repro.fl import AFLServer as RefServer
    return RefService(RefServer(DIM, C, gamma=GAMMA), **kw)


# --- the port's service: tests/test_service.py's cases -----------------------------

class TestErrorTaxonomy:
    def test_corrupt_payload_maps_to_corrupt_report_and_keeps_state(self):
        svc = _service()
        rc = RemoteCoordinator(svc)
        rc.submit(_reports(1)[0])
        wire = bytearray(_reports(1, start_id=50)[0].to_bytes())
        wire[len(wire) // 2] ^= 0xFF
        with pytest.raises(E.CorruptReport) as exc:
            rc.submit_bytes(bytes(wire))
        assert exc.value.code == "corrupt_report"
        assert isinstance(exc.value, ValueError)
        assert rc.num_clients == 1 and svc.coordinator().num_clients == 1

    def test_oversized_report_rejected_before_parsing(self):
        svc = _service(max_report_bytes=256)
        rc = RemoteCoordinator(svc)
        with pytest.raises(E.OversizedReport) as exc:
            rc.submit_bytes(_reports(1)[0].to_bytes())
        assert exc.value.code == "oversized_report"
        assert rc.num_clients == 0

    def test_queue_full_maps_to_backpressure_and_keeps_state(self):
        svc = FederationService(AsyncAFLServer(DIM, C, gamma=GAMMA), max_pending=0)
        try:
            rc = RemoteCoordinator(svc)
            with pytest.raises(E.Backpressure) as exc:
                rc.submit(_reports(1)[0])
            assert exc.value.code == "backpressure" and exc.value.retryable
            assert rc.num_clients == 0
        finally:
            svc.close()

    def test_duplicate_and_gamma_mismatch_codes(self):
        rc = RemoteCoordinator(_service())
        reps = _reports(2)
        rc.submit(reps[0])
        rc.submit(reps[0])                   # byte-identical: idempotent
        with pytest.raises(E.DuplicateClient) as exc:
            rc.submit(_reports(1, seed=3)[0])
        assert exc.value.code == "duplicate_client"
        bad_gamma = make_report(99, np.zeros((3, DIM)), np.zeros((3, C)), 2.0)
        with pytest.raises(E.GammaMismatch) as exc:
            rc.submit(bad_gamma)
        assert exc.value.code == "gamma_mismatch"
        with pytest.raises(E.EmptyFederation):
            RemoteCoordinator(_service()).solve()

    def test_unknown_federation_and_route(self):
        svc = _service()
        with pytest.raises(E.UnknownFederation):
            RemoteCoordinator(svc, federation="nope")
        data, status = svc.handle("no_such_route", b"")
        header, _, _ = unpack_message(data)
        assert status == 400 and header["error"] == "bad_request"

    def test_internal_errors_never_leak_raw_exceptions(self):
        svc = _service()

        def explode(*a, **k):
            raise RuntimeError("kaboom")

        svc.coordinator().solve = explode
        svc.coordinator().submit_many(_reports(2))
        data, status = svc.handle("solve", b"")
        header, _, _ = unpack_message(data)
        assert status == 500 and header["error"] == "internal"
        assert "kaboom" in header["message"]


class TestSubmitStream:
    def test_mixed_batch_partial_acceptance(self):
        rc = RemoteCoordinator(_service())
        reps = _reports(3)
        conflict = _reports(1, seed=9)[0]
        out = rc.submit_stream([reps[0].to_bytes(), b"garbage", reps[1].to_bytes(),
                                conflict.to_bytes(), reps[2].to_bytes()])
        codes = [r.get("error") for r in out["results"]]
        assert out["accepted"] == 3
        assert codes == [None, "corrupt_report", None, "duplicate_client", None]
        assert rc.num_clients == 3

    def test_stream_into_async_queue_and_drain(self):
        svc = FederationService(AsyncAFLServer(DIM, C, gamma=GAMMA))
        try:
            with serve_http(svc) as http:
                rc = RemoteCoordinator(http.url)
                reps = _reports(8)
                out = rc.submit_stream([r.to_bytes() for r in reps])
                assert out["accepted"] == 8
                assert all(r.get("queued") for r in out["results"])
                for _ in range(200):
                    if rc.num_clients == 8 and rc.pending == 0:
                        break
                ref = AFLServer(DIM, C, gamma=GAMMA)
                ref.submit_many(reps)
                np.testing.assert_array_equal(rc.solve(), ref.solve())
                rc.close()
        finally:
            svc.close()

    def test_malformed_framing_is_bad_request(self):
        data, status = _service().handle("submit_stream", b"\x05\x00\x00\x00tiny")
        header, _, _ = unpack_message(data)
        assert status == 400 and header["error"] == "bad_request"


class TestPersonalizedSolve:
    def test_gamma_only_matches_plain_solve(self):
        rc = RemoteCoordinator(_service())
        rc.submit_many(_reports())
        np.testing.assert_array_equal(rc.personalized_solve(0.7), rc.solve(0.7))

    def test_local_stats_mixture_math(self):
        reps = _reports()
        rc = RemoteCoordinator(_service())
        rc.submit_many(reps)
        mine, beta, tg = reps[2], 3.0, 0.25
        w = rc.personalized_solve(tg, report=mine, mix_weight=beta)
        eye = np.eye(DIM)
        agg_g = sum(r.gram - GAMMA * eye for r in reps)
        agg_q = sum(r.moment for r in reps)
        expected = np.linalg.solve(agg_g + beta * (mine.gram - GAMMA * eye) + tg * eye,
                                   agg_q + beta * mine.moment)
        np.testing.assert_allclose(w, expected, rtol=1e-8, atol=1e-10)
        assert rc.num_clients == len(reps)
        np.testing.assert_array_equal(rc.personalized_solve(tg), rc.solve(tg))

    def test_mixture_tilts_toward_the_clients_local_solution(self):
        reps = _reports()
        mine = _reports(1, rows=4 * DIM, seed=9, start_id=42)[0]
        rc = RemoteCoordinator(_service())
        rc.submit_many(reps + [mine])
        w_local = np.linalg.solve(mine.gram - GAMMA * np.eye(DIM), mine.moment)
        devs = [np.abs(rc.personalized_solve(1.0, report=mine, mix_weight=b)
                       - w_local).max() for b in (0.0, 10.0, 1000.0)]
        assert devs[2] < devs[1] < devs[0]

    def test_empty_federation_rejected(self):
        with pytest.raises(E.EmptyFederation):
            RemoteCoordinator(_service()).personalized_solve(
                0.0, report=_reports(1)[0], mix_weight=1.0)


class TestTransports:
    def test_inproc_and_http_return_identical_bytes(self):
        svc = _service()
        svc.coordinator().submit_many(_reports())
        inproc = InProcTransport(svc)
        with serve_http(svc) as http:
            over_http = HttpTransport(http.url)
            try:
                for route, body in [("describe", b""),
                                    ("solve", pack_message({"target_gamma": 0.5})),
                                    ("state", b"")]:
                    assert inproc.request(route, body) == over_http.request(route, body)
            finally:
                over_http.close()

    def test_multiple_federations_are_isolated(self):
        svc = FederationService(AFLServer(DIM, C, gamma=GAMMA), federation_id="team-a")
        svc.add_federation("team-b", AFLServer(DIM, C, gamma=GAMMA))
        a = RemoteCoordinator(svc, federation="team-a")
        b = RemoteCoordinator(svc, federation="team-b")
        a.submit_many(_reports(4, seed=1))
        b.submit_many(_reports(2, seed=2, start_id=100))
        assert (a.num_clients, b.num_clients) == (4, 2)
        assert svc.federation_ids() == ["team-a", "team-b"]
        assert np.abs(a.solve() - b.solve()).max() > 0

    def test_remote_results_are_writable_like_local_ones(self):
        rc = RemoteCoordinator(_service())
        rc.submit_many(_reports(3))
        w = rc.solve()
        w *= 2.0
        rc.weights().weight[0, 0] += 1.0
        rc.state()["gram"][0, 0] += 1.0

    def test_http_get_works_for_reads(self):
        import urllib.request

        svc = _service()
        svc.coordinator().submit_many(_reports(2))
        with serve_http(svc) as http:
            with urllib.request.urlopen(f"{http.url}/v1/default/describe",
                                        timeout=30) as resp:
                header, _, _ = unpack_message(resp.read())
        assert header["ok"] and header["num_clients"] == 2

    def test_checkpoint_roundtrip_through_remote_state(self, tmp_path):
        from repro_torch import checkpoint as ckpt

        reps = _reports()
        rc = RemoteCoordinator(_service())
        rc.submit_many(reps[:4])
        ckpt.save_server(tmp_path / "fed", rc)
        back = ckpt.load_server(tmp_path / "fed")
        assert back.num_clients == 4
        back.submit_many(reps[4:])
        ref = AFLServer(DIM, C, gamma=GAMMA)
        ref.submit_many(reps)
        np.testing.assert_allclose(back.solve(), ref.solve(), rtol=1e-9, atol=1e-12)

    def test_grow_and_shrink_need_an_elastic_coordinator(self):
        """The whole route table is served; grow / shrink answer only a
        coordinator that has those methods."""
        rc = RemoteCoordinator(_service())
        assert rc.num_shards is None and rc.mesh_epoch == 0
        with pytest.raises(E.BadRequest):
            rc.grow(1)
        with pytest.raises(E.BadRequest):
            rc.shrink(1)


class TestIdempotentIngest:
    def test_identical_payload_retry_answers_success_once_applied(self):
        svc = _service()
        payload = _reports(1)[0].to_bytes()
        first, _, _ = unpack_message(svc.handle("submit", payload)[0])
        assert first["ok"] and first["duplicate"] is False
        again, _, _ = unpack_message(svc.handle("submit", payload)[0])
        assert again["ok"] and again["duplicate"] is True
        assert again["num_clients"] == 1 and svc.coordinator().num_clients == 1

    def test_submit_stream_frames_are_idempotent(self):
        svc = _service()
        rc = RemoteCoordinator(svc)
        payload = _reports(1)[0].to_bytes()
        out = rc.submit_stream([payload, payload])
        assert out["accepted"] == 2 and out["results"][1]["duplicate"] is True
        assert svc.coordinator().num_clients == 1
        assert rc.submit_stream([payload])["accepted"] == 1
        assert svc.coordinator().num_clients == 1

    def test_frame_reports_is_the_reference_framing(self):
        from repro.fl.service import frame_reports as ref_frame

        payloads = [r.to_bytes() for r in _reports(3)] + [b"garbage"]
        assert frame_reports(payloads) == ref_frame(payloads)


# --- interop: each package's client against the other's service --------------------

def _oracle(reps):
    srv = AFLServer(DIM, C, gamma=GAMMA)
    srv.submit_many(reps)
    return srv


@pytest.mark.parametrize("direction", ["ref_client_port_service",
                                       "port_client_ref_service"])
def test_remote_interop_over_http_bit_for_bit(direction):
    from repro.fl import ClientReport as RefReport

    reps = _reports(8, rows=6, seed=4)
    oracle = _oracle(reps)
    if direction == "ref_client_port_service":
        svc, serve, client, send = (_service(), serve_http, RefRemote,
                                    [RefReport.from_bytes(r.to_bytes()) for r in reps])
    else:
        svc, serve, client, send = _ref_service(), ref_serve_http, RemoteCoordinator, reps
    with serve(svc) as http:
        rc = client(http.url)
        try:
            assert (rc.dim, rc.num_classes, rc.gamma) == (DIM, C, GAMMA)
            for r in send[:5]:
                rc.submit(r)
            out = rc.submit_stream([r.to_bytes() for r in send[5:]])
            assert out["accepted"] == 3 and rc.num_clients == 8
            np.testing.assert_array_equal(rc.solve(), oracle.solve())
            np.testing.assert_array_equal(rc.solve(0.5), oracle.solve(0.5))
            for a, b in zip(rc.solve_multi_gamma([0.0, 0.1, 1.0]),
                            oracle.solve_multi_gamma([0.0, 0.1, 1.0])):
                np.testing.assert_array_equal(a, b)
            vw = rc.weights()
            assert rc.weights(if_etag=vw.etag).not_modified
            np.testing.assert_array_equal(vw.weight, oracle.solve())
            back = AFLServer.from_state(rc.state())
            np.testing.assert_array_equal(back.solve(), oracle.solve())
        finally:
            rc.close()


def _provoke(kind, pkg):
    """(service, client kwargs, action) that raises the ``kind`` error."""
    if pkg == "port":
        make_svc, async_cls = FederationService, AsyncAFLServer
        base = AFLServer
    else:
        from repro.fl import AFLServer as base
        from repro.fl import AsyncAFLServer as async_cls
        make_svc = RefService
    reps = _reports(2, seed=7)
    if kind == "unauthorized":
        return make_svc(base(DIM, C, gamma=GAMMA), auth_token="secret"), \
            dict(auth_token="wrong"), None
    if kind == "backpressure":
        return make_svc(async_cls(DIM, C, gamma=GAMMA), max_pending=0), {}, \
            lambda rc: rc.submit(reps[0])
    if kind == "oversized":
        return make_svc(base(DIM, C, gamma=GAMMA), max_report_bytes=256), {}, \
            lambda rc: rc.submit_bytes(reps[0].to_bytes())
    if kind == "duplicate":
        def act(rc):
            rc.submit(reps[0])
            rc.submit_bytes(make_report(reps[0].client_id, np.ones((3, DIM)),
                                        np.ones((3, C)), GAMMA).to_bytes())
        return make_svc(base(DIM, C, gamma=GAMMA)), {}, act
    assert kind == "gamma_mismatch"
    return make_svc(base(DIM, C, gamma=GAMMA)), {}, lambda rc: rc.submit_bytes(
        make_report(5, np.ones((3, DIM)), np.ones((3, C)), 2.0).to_bytes())


ERRORS = {"unauthorized": ("Unauthorized", "unauthorized", 401),
          "oversized": ("OversizedReport", "oversized_report", 413),
          "duplicate": ("DuplicateClient", "duplicate_client", 409),
          "gamma_mismatch": ("GammaMismatch", "gamma_mismatch", 409),
          "backpressure": ("Backpressure", "backpressure", 429)}


@pytest.mark.parametrize("kind", sorted(ERRORS))
@pytest.mark.parametrize("direction", ["ref_client_port_service",
                                       "port_client_ref_service"])
def test_typed_errors_keep_code_and_status_across_packages(kind, direction):
    name, code, status = ERRORS[kind]
    client_pkg, svc_pkg = (("ref", "port") if direction == "ref_client_port_service"
                           else ("port", "ref"))
    taxonomy, client = (RE, RefRemote) if client_pkg == "ref" else (E, RemoteCoordinator)
    assert (getattr(E, name).code, getattr(E, name).http_status) == (code, status)
    assert (getattr(RE, name).code, getattr(RE, name).http_status) == (code, status)
    svc, kw, act = _provoke(kind, svc_pkg)
    serve = serve_http if svc_pkg == "port" else ref_serve_http
    try:
        with serve(svc) as http:
            with pytest.raises(getattr(taxonomy, name)) as exc:
                rc = client(http.url, **kw)
                try:
                    act(rc)
                finally:
                    rc.close()
            assert (exc.value.code, exc.value.http_status) == (code, status)
    finally:
        svc.close()
    # the status on the wire: the same request to either package's service
    svc_p, kw_p, _ = _provoke(kind, "port")
    svc_r, _, _ = _provoke(kind, "ref")
    try:
        if kind == "unauthorized":
            args = ("describe", b"")
        elif kind == "duplicate":
            for s in (svc_p, svc_r):
                s.handle("submit", _reports(2, seed=7)[0].to_bytes())
            args = ("submit", make_report(0, np.ones((3, DIM)), np.ones((3, C)),
                                          GAMMA).to_bytes())
        elif kind == "gamma_mismatch":
            args = ("submit", make_report(5, np.ones((3, DIM)), np.ones((3, C)),
                                          2.0).to_bytes())
        else:
            args = ("submit", _reports(2, seed=7)[0].to_bytes())
        tok = {"token": kw_p.get("auth_token")}
        (d_p, s_p), (d_r, s_r) = svc_p.handle(*args, **tok), svc_r.handle(*args, **tok)
        assert s_p == s_r == status
        assert unpack_message(d_p)[0]["error"] == ref_unpack(d_r)[0]["error"] == code
    finally:
        svc_p.close()
        svc_r.close()


def test_async_service_coroutines_are_awaited():
    """The service drives an ``AsyncAFLServer``'s coroutines on its own
    loop: ``state()`` over the wire is the awaited coroutine's result."""
    reps = _reports(3, seed=2)
    svc = FederationService(AsyncAFLServer(DIM, C, gamma=GAMMA))
    try:
        rc = RemoteCoordinator(svc)
        rc.submit_many(reps)
        assert rc.kind == "AsyncAFLServer" and rc.num_clients == 3
        np.testing.assert_array_equal(AFLServer.from_state(rc.state()).solve(),
                                      _oracle(reps).solve())
    finally:
        svc.close()
