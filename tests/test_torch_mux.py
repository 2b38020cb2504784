"""``repro_torch.fl.mux`` against the reference's.

The port's mux transport and server: the Transport protocol, PING and the
liveness probe, a coordinator round trip bit for bit, the frame-level
refusals (bad preface, oversized frame answered with GOAWAY), bearer-token
auth (typed 401, state untouched), and the TLS cases of
tests/test_mux.py:442+ (pinning, an unpinned client failing cleanly while
the server survives, mutual TLS, HTTPS).

Interop both ways, with TLS and a bearer token: a reference
``RemoteCoordinator`` over ``muxs://`` against a port ``serve_mux``, and a
port one against the reference's, each solving bit for bit what an
in-process port ``AFLServer`` solves from the same reports; the frames are
byte-compatible.

The TLS race: a TLS 1.3 server sends its session tickets after the
handshake, and the reference's client reads them on its reader thread while
another thread writes the first frame; an OpenSSL connection is not safe
for that, and the write can be lost (the ping times out) or the process
can crash. The port's client takes one PING round trip before its reader
starts (``MuxTransport._drain_post_handshake``), and its server sends no
tickets. Many fresh connections in a row, against a server that does send
tickets, must all answer.
"""

import socket
import ssl
import tempfile
import time

import numpy as np
import pytest

from repro.fl import FederationService as RefService
from repro.fl import RemoteCoordinator as RefRemote
from repro.fl import mux as RM
from repro_torch.fl import (AFLServer, FederationService, HttpTransport,
                            MuxTransport, RemoteCoordinator, Transport,
                            client_ssl_context, generate_self_signed_cert,
                            make_report, mux_ping, probe_alive, serve_http,
                            serve_mux, server_ssl_context)
from repro_torch.fl import errors as E
from repro_torch.fl.mux import _HDR, PREFACE, T_GOAWAY, T_HEADERS, T_PING, F_ACK

DIM, C, GAMMA = 16, 4, 1.0
TIMEOUT = 10.0


def _reports(n=4, rows=5, seed=0, start_id=0):
    rng = np.random.default_rng(seed)
    return [make_report(start_id + k, rng.standard_normal((rows, DIM)),
                        np.eye(C)[rng.integers(0, C, rows)], GAMMA)
            for k in range(n)]


def _service(**kw):
    return FederationService(AFLServer(DIM, C, gamma=GAMMA), **kw)


def _oracle(reps):
    srv = AFLServer(DIM, C, gamma=GAMMA)
    srv.submit_many(reps)
    return srv


@pytest.fixture(scope="module")
def tls_files():
    with tempfile.TemporaryDirectory() as td:
        yield generate_self_signed_cert(td)


def _raw_conn(srv):
    sock = socket.create_connection((srv.host, srv.port), timeout=TIMEOUT)
    sock.sendall(PREFACE)
    return sock


def _read_frame(sock):
    hdr = b""
    while len(hdr) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    length, ftype, flags, sid = _HDR.unpack(hdr)
    payload = b""
    while len(payload) < length:
        payload += sock.recv(length - len(payload))
    return ftype, flags, sid, payload


class TestMuxBasics:
    def test_satisfies_transport_protocol(self):
        with serve_mux(_service()) as srv:
            tr = MuxTransport(srv.url, timeout=TIMEOUT)
            try:
                assert isinstance(tr, Transport)
                assert isinstance(HttpTransport("http://127.0.0.1:1"), Transport)
            finally:
                tr.close()
        with pytest.raises(ValueError):
            MuxTransport("http://127.0.0.1:8790")

    def test_ping_and_probe(self):
        with serve_mux(_service()) as srv:
            assert mux_ping(srv.url, timeout=TIMEOUT) >= 0.0
            assert probe_alive(srv.url, timeout=TIMEOUT)
        with serve_http(_service()) as srv:
            assert probe_alive(srv.url, timeout=TIMEOUT)
        lsock = socket.create_server(("127.0.0.1", 0))
        port = lsock.getsockname()[1]
        lsock.close()
        assert not probe_alive(f"mux://127.0.0.1:{port}", timeout=2.0)

    def test_full_coordinator_roundtrip_bit_for_bit(self):
        reps = _reports(6)
        with serve_mux(_service()) as srv:
            rc = RemoteCoordinator(srv.url)
            try:
                for r in reps:
                    rc.submit(r)
                np.testing.assert_array_equal(rc.solve(), _oracle(reps).solve())
                vw = rc.weights()
                assert rc.weights(if_etag=vw.etag).not_modified
            finally:
                rc.close()

    def test_ping_frames_are_answered_byte_for_byte(self):
        with serve_mux(_service()) as srv:
            sock = _raw_conn(srv)
            try:
                sock.sendall(_HDR.pack(8, T_PING, 0, 0) + b"12345678")
                assert _read_frame(sock) == (T_PING, F_ACK, 0, b"12345678")
            finally:
                sock.close()

    def test_bad_preface_and_oversized_frame_get_goaway(self):
        with serve_mux(_service(), max_frame_bytes=1024) as srv:
            sock = socket.create_connection((srv.host, srv.port), timeout=TIMEOUT)
            try:
                sock.sendall(b"GET / HTTP/1.1\r\n")
                assert _read_frame(sock)[0] == T_GOAWAY
            finally:
                sock.close()
            sock = _raw_conn(srv)
            try:
                sock.sendall(_HDR.pack(1 << 20, T_HEADERS, 0, 1))
                assert _read_frame(sock)[0] == T_GOAWAY
            finally:
                sock.close()
            assert mux_ping(srv.url, timeout=TIMEOUT) >= 0.0    # server survives


class TestTls:
    def test_handshake_and_pinning(self, tls_files):
        cert, key = tls_files
        with serve_mux(_service(), ssl_context=server_ssl_context(cert, key)) as srv:
            assert srv.url.startswith("muxs://")
            assert mux_ping(srv.url, cafile=cert, timeout=TIMEOUT) >= 0.0

    def test_unpinned_client_fails_cleanly_server_survives(self, tls_files):
        cert, key = tls_files
        with serve_mux(_service(), ssl_context=server_ssl_context(cert, key)) as srv:
            tr = MuxTransport(srv.url, timeout=TIMEOUT)     # no cafile
            with pytest.raises(ssl.SSLError):
                tr.request("describe", b"", "default")
            tr.close()
            deadline = time.monotonic() + 5.0
            while not srv.errors and time.monotonic() < deadline:
                time.sleep(0.01)
            assert any(where == "tls" for where, _ in srv.errors)
            assert probe_alive(srv.url, cafile=cert, timeout=TIMEOUT)

    def test_mutual_tls_requires_client_cert(self, tls_files):
        cert, key = tls_files
        ctx = server_ssl_context(cert, key, client_ca=cert)
        with serve_mux(_service(), ssl_context=ctx) as srv:
            bare = MuxTransport(srv.url, cafile=cert, timeout=TIMEOUT)
            with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
                bare.request("describe", b"", "default")
            bare.close()
            tr = MuxTransport(srv.url, timeout=TIMEOUT,
                              ssl_context=client_ssl_context(cert, certfile=cert,
                                                             keyfile=key))
            try:
                assert tr.request("describe", b"", "default")
            finally:
                tr.close()

    def test_https_transport_and_server(self, tls_files):
        cert, key = tls_files
        with serve_http(_service(), ssl_context=server_ssl_context(cert, key)) as srv:
            assert srv.url.startswith("https://")
            rc = RemoteCoordinator(srv.url, cafile=cert)
            try:
                assert rc.describe()["kind"] == "AFLServer"
            finally:
                rc.close()

    @pytest.mark.parametrize("server_pkg", ["port", "ref"])
    def test_fresh_tls_connections_never_lose_their_first_frame(self, tls_files,
                                                                server_pkg):
        cert, key = tls_files
        if server_pkg == "port":
            ctx = server_ssl_context(cert, key)
            assert ctx.num_tickets == 0
            serve = serve_mux
        else:
            ctx, serve = RM.server_ssl_context(cert, key), RM.serve_mux
            assert ctx.num_tickets > 0            # the reference's sends tickets
        with serve(_service(), ssl_context=ctx) as srv:
            for _ in range(40):
                assert mux_ping(srv.url, cafile=cert, timeout=TIMEOUT) >= 0.0


class TestAuth:
    @pytest.mark.parametrize("token", [None, "wrong"])
    def test_bad_token_rejected_state_untouched(self, token):
        svc = _service(auth_token="hunter2")
        with svc, serve_mux(svc) as srv:
            tr = MuxTransport(srv.url, auth_token=token, timeout=TIMEOUT)
            try:
                with pytest.raises(E.Unauthorized):
                    RemoteCoordinator(tr)
                tr.request("submit", _reports(1)[0].to_bytes(), "default")
            finally:
                tr.close()
            assert svc.coordinator().num_clients == 0
            good = RemoteCoordinator(srv.url, auth_token="hunter2")
            try:
                good.submit(_reports(1)[0])
                assert good.num_clients == 1 and good.describe()["auth_required"]
            finally:
                good.close()

    def test_promote_is_auth_gated(self):
        from repro_torch.fl.service import promote_remote

        svc = _service(auth_token="hunter2")
        with svc, serve_mux(svc) as srv:
            with pytest.raises(E.Unauthorized):
                promote_remote(srv.url)
            with pytest.raises(E.BadRequest, match="standby"):
                promote_remote(srv.url, auth_token="hunter2")


@pytest.mark.parametrize("direction", ["ref_client_port_server",
                                       "port_client_ref_server"])
@pytest.mark.parametrize("tls", [False, True])
def test_mux_interop_with_auth_bit_for_bit(direction, tls, tls_files):
    from repro.fl import AFLServer as RefServer
    from repro.fl import ClientReport as RefReport

    cert, key = tls_files
    reps = _reports(8, rows=6, seed=4)
    oracle = _oracle(reps)
    if direction == "ref_client_port_server":
        svc = FederationService(AFLServer(DIM, C, gamma=GAMMA), auth_token="tok")
        serve, ctx = serve_mux, (server_ssl_context(cert, key) if tls else None)
        client, send = RefRemote, [RefReport.from_bytes(r.to_bytes()) for r in reps]
        taxonomy = __import__("repro.fl.errors", fromlist=["x"])
    else:
        svc = RefService(RefServer(DIM, C, gamma=GAMMA), auth_token="tok")
        serve, ctx = RM.serve_mux, (RM.server_ssl_context(cert, key) if tls else None)
        client, send, taxonomy = RemoteCoordinator, reps, E
    with svc, serve(svc, ssl_context=ctx) as srv:
        kw = dict(cafile=cert) if tls else {}
        with pytest.raises(taxonomy.Unauthorized):
            client(srv.url, auth_token="wrong", **kw)
        rc = client(srv.url, auth_token="tok", **kw)
        try:
            for r in send[:5]:
                rc.submit(r)
            assert rc.submit_stream([r.to_bytes() for r in send[5:]])["accepted"] == 3
            np.testing.assert_array_equal(rc.solve(), oracle.solve())
            np.testing.assert_array_equal(rc.solve(0.5), oracle.solve(0.5))
            state = rc.state()       # the largest response: many DATA frames
            np.testing.assert_array_equal(AFLServer.from_state(state).solve(),
                                          oracle.solve())
        finally:
            rc.close()
        assert svc.coordinator().num_clients == 8
