"""The port's xLSTM mixers against the reference, on the same weights.

``models.xlstm``'s mLSTM and sLSTM against ``repro.models.xlstm`` on the
reference's ``init_mlstm`` / ``init_slstm`` weights (as numpy) and
numpy-seeded inputs: the apply over 24 tokens from the start state and
from a given one, with its returned state, and decode steps after a
prefill, each step's output and state against the reference's and the
outputs against the apply over the whole sequence. Tolerances: rtol 1e-4
/ atol 1e-5 (f32 recurrences with exponential gating over 24 steps,
sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as RX
from repro_torch.models import xlstm as X

TOL = dict(rtol=1e-4, atol=1e-5)
D_MODEL, HEADS, SEQ, B, PREFIX = 32, 4, 24, 2, 17

KINDS = {
    "mlstm": (RX.init_mlstm, RX.mlstm_apply, RX.mlstm_decode, RX.init_mlstm_state,
              X.mlstm_apply, X.mlstm_decode, X.init_mlstm_state),
    "slstm": (RX.init_slstm, RX.slstm_apply, RX.slstm_decode, RX.init_slstm_state,
              X.slstm_apply, X.slstm_decode, X.init_slstm_state),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(kind):
    init = KINDS[kind][0]
    p_ref = init(jax.random.key(1), D_MODEL, HEADS, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    x = np.random.default_rng(2).standard_normal((B, SEQ, D_MODEL)).astype(np.float32)
    return p_ref, p, x


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("with_state", [False, True], ids=["start state", "given state"])
def test_apply_matches_reference(kind, with_state):
    _, r_apply, _, r_init, apply, _, init_state = KINDS[kind]
    p_ref, p, x = _setup(kind)
    st_ref = st = None
    if with_state:      # the state after a first stretch of other tokens
        x0 = np.random.default_rng(3).standard_normal((B, 5, D_MODEL)).astype(np.float32)
        _, st_ref = r_apply(p_ref, jnp.asarray(x0), HEADS, return_state=True)
        _, st = apply(p, torch.from_numpy(x0), HEADS, return_state=True)
    out_ref, new_ref = r_apply(p_ref, jnp.asarray(x), HEADS, init_state=st_ref,
                               return_state=True)
    out, new = apply(p, torch.from_numpy(x), HEADS, init_state=st, return_state=True)
    assert out.shape == (B, SEQ, D_MODEL)
    _close(out, out_ref)
    _close(new, new_ref)
    _close(apply(p, torch.from_numpy(x), HEADS, init_state=st), out_ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_steps_match_reference_and_apply(kind):
    _, r_apply, r_decode, r_init, apply, decode, init_state = KINDS[kind]
    p_ref, p, x = _setup(kind)
    full = apply(p, torch.from_numpy(x), HEADS)
    _, st_ref = r_apply(p_ref, jnp.asarray(x[:, :PREFIX]), HEADS,
                        init_state=r_init(B, D_MODEL, HEADS), return_state=True)
    _, st = apply(p, torch.from_numpy(x[:, :PREFIX]), HEADS,
                  init_state=init_state(B, D_MODEL, HEADS), return_state=True)
    for t in range(PREFIX, SEQ):
        out_ref, st_ref = r_decode(p_ref, jnp.asarray(x[:, t:t + 1]), st_ref, HEADS)
        out, st = decode(p, torch.from_numpy(x[:, t:t + 1]), st, HEADS)
        _close(out, out_ref)
        _close(st, st_ref)
        np.testing.assert_allclose(out.numpy(), full[:, t:t + 1].numpy(), **TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_start_state_matches_reference(kind):
    r_init, init_state = KINDS[kind][3], KINDS[kind][6]
    want, got = r_init(3, D_MODEL, HEADS), init_state(3, D_MODEL, HEADS)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a))
    assert float(got["m"].max()) == float(np.float32(-1e30))
