"""``repro_torch.fl`` (partition, afl, baselines) and the analytic train step
against the reference's.

The partitioners and the gradient baselines are numpy copies: the same seed
gives the same index arrays, and the baselines the same accuracies and
curves (1e-12). ``run_afl`` is host f64 in both packages: its weight agrees
with the reference's to 1e-10 (relative to the largest weight, or absolute
below 1) and its accuracy is equal, over every partition scheme, the
paper-literal pairwise and no-RI branches, a feature map, K = 300 at
d = 64 (N_k < d; tests/test_fl.py:99-106) and Figure 2's K = 1000 NIID-1 (about
3 rows a client). Through a backbone — reduced
minicpm_2b on the CPU, on the reference's weights (``params_from_jax``) —
the embeddings agree with the reference's at tests/test_torch_backbone.py's
``FWD_TOL`` and ``run_afl`` equals its own ``joint_ridge`` in accuracy.
``make_analytic_train_step`` agrees with the reference's step (the Pallas
Gram in interpret mode on its kernel route) at tests/test_torch_slice.py's
rtol 1e-4, with atol 1e-4 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs.registry import get_config as ref_config
from repro.core import features as RFeat
from repro.core import streaming as RS
from repro.data import synthetic as RD
from repro.fl import afl as RAfl
from repro.fl import baselines as RB
from repro.fl import partition as RP
from repro.launch import steps as RSteps
from repro.models import transformer as RT
from repro_torch.config import FLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import features as PFeat
from repro_torch.core import streaming as PS
from repro_torch.data import synthetic as D
from repro_torch.fl import afl as PAfl
from repro_torch.fl import api as PApi
from repro_torch.fl import baselines as PB
from repro_torch.fl import partition as PP
from repro_torch.launch import steps as PSteps
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

WEIGHT_TOL = 1e-10
FWD_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_torch_backbone.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def data():
    """The features of tests/test_fl.py's end-to-end class, in both packages."""
    ds = D.gaussian_mixture(n=4000, dim=64, num_classes=10, seed=0)
    ds_ref = RD.gaussian_mixture(n=4000, dim=64, num_classes=10, seed=0)
    np.testing.assert_array_equal(ds.x, ds_ref.x)
    return D.train_test_split(ds, 0.25, seed=0), RD.train_test_split(ds_ref, 0.25, seed=0)


# --- partitions -----------------------------------------------------------------

@pytest.mark.parametrize("scheme,kw", [
    ("iid", {}),
    ("niid1", dict(alpha=0.01)),
    ("niid1", dict(alpha=0.1)),
    ("niid1", dict(alpha=10.0)),
    ("niid2", dict(shards_per_client=1)),
    ("niid2", dict(shards_per_client=2)),
])
@pytest.mark.parametrize("k,seed", [(7, 0), (100, 3)])
def test_partitions_equal_reference(scheme, kw, k, seed):
    labels = np.random.default_rng(seed).integers(0, 16, 1500)
    got = PP.make_partition(labels, k, scheme, seed=seed, **kw)
    want = RP.make_partition(labels, k, scheme, seed=seed, **kw)
    assert len(got) == len(want) == k
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(1500))


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown partition scheme"):
        PP.make_partition(np.zeros(10, int), 2, "nope")


# --- run_afl ---------------------------------------------------------------------

@pytest.mark.parametrize("k,scheme,kw,pairwise,use_ri", [
    (20, "iid", {}, False, True),
    (20, "niid1", dict(alpha=0.01), False, True),
    (20, "niid2", dict(shards_per_client=2), False, True),
    (20, "niid1", dict(alpha=0.1), True, True),       # the AA-law recursion
    (20, "niid1", dict(alpha=0.1), False, False),     # the biased no-RI aggregate
    (20, "niid2", dict(shards_per_client=2), True, False),
    (300, "iid", {}, False, True),                     # N_k = 10 < d = 64
    (1000, "niid1", dict(alpha=0.1), False, True),     # Figure 2's K = 1000, N_k ≈ 3
])
def test_run_afl_matches_reference(data, k, scheme, kw, pairwise, use_ri):
    (train, test), (train_r, test_r) = data
    fl = FLConfig(num_clients=k, gamma=1.0, partition=scheme, use_ri=use_ri, **kw)
    fl_r = RefFLConfig(num_clients=k, gamma=1.0, partition=scheme, use_ri=use_ri, **kw)
    res = PAfl.run_afl(train, test, fl, pairwise=pairwise)
    ref = RAfl.run_afl(train_r, test_r, fl_r, pairwise=pairwise)
    _close(res.weight, ref.weight, WEIGHT_TOL)
    assert res.accuracy == ref.accuracy
    assert res.client_sizes == ref.client_sizes and res.num_clients == k
    assert res.train_seconds > 0
    if use_ri:    # the paper's invariance: the joint solution, any partition
        w_joint, acc_joint = PAfl.joint_ridge(train, test, gamma=0.0)
        assert res.accuracy == acc_joint
        assert np.abs(res.weight - w_joint).max() < 1e-6


@pytest.mark.parametrize("gamma", [0.0, 2.5])
def test_joint_ridge_matches_reference(data, gamma):
    (train, test), (train_r, test_r) = data
    w, acc = PAfl.joint_ridge(train, test, gamma=gamma)
    w_ref, acc_ref = RAfl.joint_ridge(train_r, test_r, gamma=gamma)
    _close(w, w_ref, WEIGHT_TOL)
    assert acc == acc_ref


def test_run_afl_with_a_feature_map_matches_reference(data):
    (train, test), (train_r, test_r) = data
    fl = FLConfig(num_clients=10, partition="niid1", alpha=0.1)
    res = PAfl.run_afl(train, test, fl, feature_map=PFeat.rff_map(64, 96, seed=1))
    ref = RAfl.run_afl(train_r, test_r, RefFLConfig(num_clients=10, partition="niid1",
                                                    alpha=0.1),
                       feature_map=RFeat.rff_map(64, 96, seed=1))
    _close(res.weight, ref.weight, WEIGHT_TOL)
    assert res.accuracy == ref.accuracy


def test_run_afl_submits_to_a_given_coordinator(data):
    (train, test), _ = data
    fl = FLConfig(num_clients=8, partition="iid")
    server = PApi.AFLServer(64, 10, gamma=1.0)
    res = PAfl.run_afl(train, test, fl, coordinator=server)
    assert server.num_clients == 8
    np.testing.assert_array_equal(server.solve(target_gamma=0.0), res.weight)
    with pytest.raises(ValueError, match="does not match the run"):
        PAfl.run_afl(train, test, fl, coordinator=PApi.AFLServer(64, 10, gamma=2.0))


def test_run_afl_refuses_a_remote_coordinator(data):
    """A URL coordinator is a live port federation service over HTTP: the
    round through it gives the in-process round's weight bit for bit (f64
    reports are lossless on the wire), and a service of another width is
    refused before any client uploads."""
    from repro_torch.fl.service import FederationService, serve_http

    (train, test), _ = data
    fl = FLConfig(num_clients=8, partition="niid1", alpha=0.1)
    local = PAfl.run_afl(train, test, fl)
    hosted = PApi.AFLServer(64, 10, gamma=1.0)
    with serve_http(FederationService(hosted)) as srv:
        res = PAfl.run_afl(train, test, fl, coordinator=srv.url)
    assert hosted.num_clients == 8 and res.accuracy == local.accuracy
    np.testing.assert_array_equal(res.weight, local.weight)
    with serve_http(FederationService(PApi.AFLServer(32, 10))) as srv:
        with pytest.raises(ValueError, match="does not match the run"):
            PAfl.run_afl(train, test, fl, coordinator=srv.url)


def test_embed_with_backbone_batches_and_copies_to_host():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    calls = []

    def backbone(chunk):
        calls.append(len(chunk))
        return torch.from_numpy(chunk) * 2
    out = PAfl.embed_with_backbone(backbone, x, batch=4)
    assert calls == [4, 4, 2]
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, 2 * x)


# --- gradient baselines -------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ds = D.gaussian_mixture(n=1200, dim=32, num_classes=5, seed=3)
    ds_r = RD.gaussian_mixture(n=1200, dim=32, num_classes=5, seed=3)
    return D.train_test_split(ds, 0.25, seed=1), RD.train_test_split(ds_r, 0.25, seed=1)


FL_KW = dict(num_clients=10, partition="niid1", alpha=0.5)


@pytest.mark.parametrize("method", ["fedavg", "fedprox"])
def test_gradient_fl_matches_reference(small, method):
    (train, test), (train_r, test_r) = small
    res = PB.run_gradient_fl(train, test, FLConfig(**FL_KW), method=method, rounds=4)
    ref = RB.run_gradient_fl(train_r, test_r, RefFLConfig(**FL_KW), method=method,
                             rounds=4)
    _close(res.curve, ref.curve, 1e-12)
    assert (res.accuracy, res.rounds) == (ref.accuracy, ref.rounds)


def test_local_only_matches_reference(small):
    (train, test), (train_r, test_r) = small
    got = PB.run_local_only(train, test, FLConfig(**FL_KW), epochs=2)
    want = RB.run_local_only(train_r, test_r, RefFLConfig(**FL_KW), epochs=2)
    _close(got, want, 1e-12)


def test_fedfisher_matches_reference(small):
    (train, test), (train_r, test_r) = small
    got = PB.run_fedfisher_diag(train, test, FLConfig(**FL_KW))
    want = RB.run_fedfisher_diag(train_r, test_r, RefFLConfig(**FL_KW))
    _close(got.curve, want.curve, 1e-12)
    assert (got.accuracy, got.rounds) == (want.accuracy, want.rounds)


def test_local_sgd_step_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((70, 12))
    y = np.eye(4)[rng.integers(0, 4, 70)]
    w0 = rng.standard_normal((12, 4))
    got = PB._local_sgd(w0.copy(), x, y, 0.05, 16, np.random.default_rng(1),
                        mu=0.01, w_global=w0)
    want = RB._local_sgd(w0.copy(), x, y, 0.05, 16, np.random.default_rng(1),
                         mu=0.01, w_global=w0)
    _close(got, want, 1e-12)


# --- a frozen backbone: reduced minicpm_2b on the CPU ------------------------------

CLASSES = 8


@pytest.fixture(scope="module")
def minicpm():
    cfg_ref = ref_config("minicpm_2b").reduced(num_classes=CLASSES)
    cfg = get_config("minicpm_2b").reduced(num_classes=CLASSES)
    p_ref = RT.init_params(jax.random.key(0), cfg_ref)
    params = params_from_jax(jax.tree.map(np.asarray, p_ref), cfg, device="cpu")
    ds = D.token_classification(n=240, seq=16, vocab=cfg.vocab_size,
                                num_classes=CLASSES, skew=4.0, seed=0)
    train, test = D.train_test_split(ds, 0.25, seed=0)
    return cfg_ref, cfg, p_ref, params, train, test


def test_run_afl_through_a_backbone_equals_joint(minicpm):
    cfg_ref, cfg, p_ref, params, train, test = minicpm

    def backbone(tokens):
        return T.pool(T.forward(params, cfg, {"tokens": tokens}))

    emb = PAfl.embed_with_backbone(backbone, train.x[:64])
    emb_ref = np.asarray(RT.pool(RT.forward(p_ref, cfg_ref,
                                            {"tokens": jnp.asarray(train.x[:64])})))
    np.testing.assert_allclose(emb, emb_ref, **FWD_TOL)
    fl = FLConfig(num_clients=12, partition="niid2", shards_per_client=2)
    res = PAfl.run_afl(train, test, fl, backbone_fn=backbone)
    _, acc_joint = PAfl.joint_ridge(train, test, gamma=0.0, backbone_fn=backbone)
    assert res.accuracy == acc_joint
    assert res.accuracy > 1.5 / CLASSES       # clearly better than chance


@pytest.mark.parametrize("use_kernel", [False, True])
def test_analytic_train_step_matches_reference(minicpm, use_kernel):
    cfg_ref, cfg, p_ref, params, train, _ = minicpm
    step = PSteps.make_analytic_train_step(cfg, use_kernel=use_kernel)
    step_ref = RSteps.make_analytic_train_step(cfg_ref, use_kernel=use_kernel)
    state = PS.init_state(cfg.d_model, CLASSES, device="cpu")
    state_ref = RS.init_state(cfg.d_model, CLASSES)
    for i in (0, 64, 128):              # three batches, the last ragged
        toks, labels = train.x[i:i + 64], train.y[i:i + 64]
        state = step(params, state, {"tokens": toks, "labels": labels})
        state_ref = step_ref(p_ref, state_ref, {"tokens": jnp.asarray(toks),
                                                "labels": jnp.asarray(labels)})
    assert float(state.count) == float(state_ref.count) == 180.0
    for a, b in zip(state, state_ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))
