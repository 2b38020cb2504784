"""The port's Mamba2 (SSD) mixer against the reference, on the same weights.

``models.ssm`` against ``repro.models.ssm`` on the reference's
``init_mamba`` weights (as numpy, with ``a_log``, ``d_skip`` and
``dt_bias`` moved off their constant init so that the decay and skip
terms are exercised) and numpy-seeded inputs: ``mamba_apply`` at seq 40
with chunk 16 (two full chunks, a ragged third, the inter-chunk carry),
from a zero state and from a given one, with its returned state; and
``mamba_decode`` stepping through tokens after a prefill, against the
reference's steps and against the apply over the whole sequence.
Tolerances: rtol 1e-5 / atol 1e-5 for the block (f32, sums in another
order; the states are sums over 40 tokens), and the port's own decode
against its apply at rtol 1e-4 / atol 1e-5 (the recurrence against the
chunked form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as RefSSMConfig
from repro.models import ssm as RS
from repro_torch.config import SSMConfig
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, SEQ, B = 48, 40, 2
CFG = dict(d_state=16, d_conv=4, expand=2, chunk=16, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixer():
    p_ref = RS.init_mamba(jax.random.key(0), D_MODEL, RefSSMConfig(**CFG), jnp.float32)
    rng = np.random.default_rng(0)
    nh = CFG["num_heads"]
    p_ref = dict(p_ref, a_log=jnp.asarray(rng.normal(0, 0.5, nh), jnp.float32),
                 d_skip=jnp.asarray(rng.normal(1, 0.3, nh), jnp.float32),
                 dt_bias=jnp.asarray(rng.normal(0, 0.5, nh), jnp.float32))
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = rng.standard_normal((B, SEQ, D_MODEL)).astype(np.float32)
    return p_ref, p, x


def _state(rng, cfg):
    d_inner, nh, dh, conv_dim = S.dims(D_MODEL, cfg)
    return {"conv": rng.standard_normal((B, cfg.d_conv - 1, conv_dim)).astype(np.float32),
            "ssd": rng.standard_normal((B, nh, cfg.d_state, dh)).astype(np.float32)}


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_dims_match_reference():
    for d, cfg in [(48, CFG), (3584, dict(d_state=64, d_conv=4, expand=2, chunk=128,
                                          num_heads=32)), (96, dict(num_heads=0))]:
        assert S.dims(d, SSMConfig(**cfg)) == RS.dims(d, RefSSMConfig(**cfg))


@pytest.mark.parametrize("with_state", [False, True], ids=["zero state", "given state"])
def test_mamba_apply_matches_reference(mixer, with_state):
    p_ref, p, x = mixer
    cfg, cfg_ref = SSMConfig(**CFG), RefSSMConfig(**CFG)
    st = _state(np.random.default_rng(1), cfg) if with_state else None
    out_ref, st_ref = RS.mamba_apply(
        p_ref, jnp.asarray(x), cfg_ref, return_state=True,
        init_state=None if st is None else jax.tree.map(jnp.asarray, st))
    out, st_out = S.mamba_apply(
        p, torch.from_numpy(x), cfg, return_state=True,
        init_state=None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
    assert out.shape == (B, SEQ, D_MODEL) and st_out["ssd"].dtype == torch.float32
    _close(out, out_ref)
    _close(st_out, st_ref)
    # without return_state: the output alone, the same
    _close(S.mamba_apply(p, torch.from_numpy(x), cfg), RS.mamba_apply(p_ref, jnp.asarray(x),
                                                                       cfg_ref))


@pytest.mark.parametrize("prefix", [25, 32], ids=["ragged prefill", "whole chunks"])
def test_mamba_decode_steps_match_reference_and_apply(mixer, prefix):
    """Prefill ``prefix`` tokens, then decode the rest one at a time: each
    step's output and state equal the reference's, and the outputs equal
    the port's apply over the whole sequence."""
    p_ref, p, x = mixer
    cfg, cfg_ref = SSMConfig(**CFG), RefSSMConfig(**CFG)
    full = S.mamba_apply(p, torch.from_numpy(x), cfg)
    _, st_ref = RS.mamba_apply(p_ref, jnp.asarray(x[:, :prefix]), cfg_ref,
                               init_state=RS.init_mamba_state(B, D_MODEL, cfg_ref),
                               return_state=True)
    _, st = S.mamba_apply(p, torch.from_numpy(x[:, :prefix]), cfg,
                          init_state=S.init_mamba_state(B, D_MODEL, cfg), return_state=True)
    for t in range(prefix, SEQ):
        out_ref, st_ref = RS.mamba_decode(p_ref, jnp.asarray(x[:, t:t + 1]), st_ref, cfg_ref)
        out, st = S.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        _close(out, out_ref)
        _close(st, st_ref)
        np.testing.assert_allclose(out.numpy(), full[:, t:t + 1].numpy(), rtol=1e-4, atol=1e-5)


def test_init_state_matches_reference():
    cfg = SSMConfig(**CFG)
    st = S.init_mamba_state(3, D_MODEL, cfg, torch.bfloat16)
    ref = RS.init_mamba_state(3, D_MODEL, RefSSMConfig(**CFG), jnp.bfloat16)
    for k in ("conv", "ssd"):
        assert tuple(st[k].shape) == ref[k].shape and not st[k].any()
    assert st["conv"].dtype == torch.bfloat16 and st["ssd"].dtype == torch.float32
