"""Wire and checkpoint formats across the two packages.

A ``ClientReport`` written by either package parses in the other with the
same arrays, and an ``AFLServer.state()`` checkpoint restores across them
with the same solve (≤1e-12; both solve in host f64 with the same code).
"""

import numpy as np
import pytest

from repro.fl import api as R
from repro_torch.fl import api as P
from repro_torch.fl import errors as E

TOL = dict(rtol=1e-12, atol=1e-12)


def _report(mod, client_id, seed, n=5, d=12, c=3, gamma=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = np.eye(c)[rng.integers(0, c, n)]
    return mod.AFLClient(client_id, gamma=gamma).local_stage(x, y)


@pytest.mark.parametrize("writer,reader", [(R, P), (P, R)])
@pytest.mark.parametrize("wire", [
    dict(),                                          # f64, lossless
    dict(dtype=np.float32, compress_root=True),      # f32 with an f32 root
])
def test_report_bytes_parse_across_packages(writer, reader, wire):
    rep = _report(writer, 7, seed=0)
    assert rep.root is not None and rep.root.shape == (5, 12)
    data = rep.to_bytes(**wire)
    back = reader.ClientReport.from_bytes(data)
    same = writer.ClientReport.from_bytes(data)
    assert (back.client_id, back.gamma, back.count) == (7, 0.5, 5.0)
    for name in ("gram", "moment", "root"):
        np.testing.assert_array_equal(getattr(back, name), getattr(same, name))
    if not wire:
        np.testing.assert_array_equal(back.gram, rep.gram)
    # re-encoding what was parsed gives the same bytes in either package
    assert back.to_bytes(**wire) == same.to_bytes(**wire) == data


def test_corrupt_report_rejected_like_reference():
    data = bytearray(_report(R, 1, seed=1).to_bytes())
    data[-1] ^= 0xFF
    for mod in (R, P):
        with pytest.raises(ValueError, match="CRC"):
            mod.ClientReport.from_bytes(bytes(data))


@pytest.mark.parametrize("writer,reader", [(R, P), (P, R)])
def test_server_state_restores_across_packages(writer, reader):
    srv = writer.AFLServer(12, 3, gamma=0.5)
    for cid in range(4):
        srv.submit(_report(writer, cid, seed=10 + cid, n=6))
    restored = reader.AFLServer.from_state(srv.state())
    assert restored.num_clients == 4 and restored.version == 4
    for g in (0.0, 0.3):
        np.testing.assert_allclose(restored.solve(g), srv.solve(g), **TOL)
    for w, w_ref in zip(restored.solve_multi_gamma([0.1, 1.0]),
                        srv.solve_multi_gamma([0.1, 1.0])):
        np.testing.assert_allclose(w, w_ref, **TOL)
    # the restored server keeps ingesting: a later arrival in either package
    late = _report(reader, 9, seed=99)
    restored.submit(late)
    srv.submit(writer.ClientReport.from_bytes(late.to_bytes()))
    np.testing.assert_allclose(restored.solve(), srv.solve(), **TOL)


def test_port_server_matches_reference_with_straggler_rank_updates():
    """Cached factors rank-updated by low-rank arrivals (the straggler
    path), masked reports, and the typed errors, in both packages."""
    ref, port = R.AFLServer(12, 3, gamma=0.5), P.AFLServer(12, 3, gamma=0.5)
    reports = [_report(R, cid, seed=20 + cid, n=14 if cid == 0 else 1)
               for cid in range(4)]
    for rep in reports:
        data = rep.to_bytes()
        ref.submit(R.ClientReport.from_bytes(data))
        # one-row roots fit the d//16 budget: the cached factor survives
        assert port.submit(P.ClientReport.from_bytes(data))
        np.testing.assert_allclose(port.solve(), ref.solve(), **TOL)
    with pytest.raises(E.DuplicateClient):
        port.submit(P.ClientReport.from_bytes(reports[0].to_bytes()))
    masked = P.masked_reports([_report(P, 50 + i, seed=50 + i) for i in range(3)])
    masked_ref = R.masked_reports([_report(R, 50 + i, seed=50 + i) for i in range(3)])
    for m, m_ref in zip(masked, masked_ref):
        np.testing.assert_array_equal(m.gram, m_ref.gram)
        assert m.root is None
    with pytest.raises(E.EmptyFederation):
        P.AFLServer(12, 3).solve()
