"""The whole slice: reduced ``run_analytic`` in both packages, one set of
weights.

The reference runs with ``use_kernel=True`` (the Pallas Gram kernel in
interpret mode); the port runs on the CPU, where the Gram update takes the
kernel's plain version. Both start from the reference's
``T.init_params(jax.random.key(0), cfg)``, carried over by
``params_from_jax``. Tolerances: the client's gram and moment agree to
rtol 1e-4 (f32 forwards and f32 sums in another order; atol 1e-4 of the
largest entry, for entries that cancel to near zero); the server weight
solved from the same report bytes agrees to 1e-12 in both packages; the
test accuracy is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs.registry import get_config as ref_config
from repro.data import synthetic as RD
from repro.fl import api as RA
from repro.launch import mesh as RM
from repro.launch import train as RTrain
from repro.models import transformer as RT
from repro_torch.config import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic as D
from repro_torch.fl import api as PA
from repro_torch.launch import train as PTrain
from repro_torch.models.convert import params_from_jax

SAMPLES, SEQ, CLASSES, BATCH = 256, 16, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg_ref = ref_config("minicpm_2b").reduced(num_classes=CLASSES)
    cfg = get_config("minicpm_2b").reduced(num_classes=CLASSES)
    ds = D.token_classification(n=SAMPLES, seq=SEQ, vocab=cfg.vocab_size,
                                num_classes=CLASSES, seed=0)
    ds_ref = RD.token_classification(n=SAMPLES, seq=SEQ, vocab=cfg.vocab_size,
                                     num_classes=CLASSES, seed=0)
    np.testing.assert_array_equal(ds.x, ds_ref.x)     # same draws, same seed
    train, test = D.train_test_split(ds, 0.25, seed=0)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    return cfg_ref, cfg, train, test, p_ref, params


def _reference_report(cfg_ref, train, p_ref, gamma):
    """The reference's local stage, as its run_analytic drives it."""
    mesh = RM.make_host_mesh()
    embed = RTrain._embed_fn(p_ref, cfg_ref, mesh)
    client = RA.AFLClient(0, gamma=gamma, backend="jax", use_kernel=True)
    for toks, labels in RTrain._batches(train, BATCH):
        emb = embed(p_ref, jnp.asarray(toks))
        client.update(emb, jax.nn.one_hot(jnp.asarray(labels), cfg_ref.num_classes))
    return client.report()


def test_client_report_and_server_weight_match(setup):
    cfg_ref, cfg, train, _, p_ref, params = setup
    rep_ref = _reference_report(cfg_ref, train, p_ref, gamma=1.0)
    rep = PTrain.local_stage(params, cfg, train, FLConfig(gamma=1.0), BATCH,
                             device="cpu", use_kernel=True)
    assert rep.count == rep_ref.count == 192.0
    assert rep.root is None and rep_ref.root is None      # 192 rows ≥ d=128
    for a, b in [(rep.gram, rep_ref.gram), (rep.moment, rep_ref.moment)]:
        assert a.shape == b.shape and a.dtype == b.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    # one report's bytes, solved by each package's server
    data = rep.to_bytes()
    weights = []
    for mod in (RA, PA):
        srv = mod.AFLServer(cfg.d_model, cfg.num_classes, gamma=1.0)
        srv.submit(mod.ClientReport.from_bytes(data))
        weights.append(srv.solve(target_gamma=0.0))
    assert np.isfinite(weights[0]).all()
    np.testing.assert_allclose(weights[1], weights[0], rtol=1e-12, atol=1e-12)


def test_run_analytic_accuracy_matches_reference(setup):
    cfg_ref, cfg, train, test, _, params = setup
    acc_ref, _ = RTrain.run_analytic(cfg_ref, RM.make_host_mesh(), train, test,
                                     RefFLConfig(gamma=1.0), BATCH, use_kernel=True)
    acc, train_s = PTrain.run_analytic(cfg, train, test, FLConfig(gamma=1.0), BATCH,
                                       use_kernel=True, device="cpu", params=params)
    assert acc == acc_ref
    assert acc > 1.0 / CLASSES and train_s > 0


def test_run_analytic_submits_to_a_given_coordinator(setup):
    """A caller's coordinator receives the report, and solving it again at
    γ = 0 gives run_analytic's own accuracy (exactly: same weights, same
    test forward)."""
    _, cfg, train, test, _, params = setup
    server = PA.AFLServer(cfg.d_model, cfg.num_classes, gamma=1.0)
    acc, _ = PTrain.run_analytic(cfg, train, test, FLConfig(gamma=1.0), BATCH,
                                 use_kernel=True, device="cpu", params=params,
                                 coordinator=server)
    assert server.num_clients == 1 and len(test) == BATCH
    emb = PTrain.embed(params, cfg, test.x)
    assert PA.evaluate_weight(server.solve(target_gamma=0.0), emb, test.y) == acc


def test_entry_points_refuse_what_is_not_ported(setup, monkeypatch):
    _, cfg, train, test, _, params = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PTrain.run_analytic(cfg, train, test, FLConfig(), BATCH, params=params)
    for argv in (["--mode", "gradient"], ["--mode", "lm"],
                 ["--server-url", "http://localhost:1"]):
        monkeypatch.setattr("sys.argv", ["train", "--arch", "minicpm_2b", *argv])
        with pytest.raises(SystemExit, match="ROADMAP"):
            PTrain.main()
