"""``repro_torch.core.streaming`` on CPU tensors against ``repro.core.streaming``.

The same numpy-seeded batches go through the reference's jax path and the
port's torch path. The fold is f32 in both: the plain route is ``XᵀX`` in
each library, the kernel route the Pallas Gram in interpret mode against
the CUDA kernel's plain version (``kernels.ref.gram_ref``), as
tests/test_kernels_gram.py runs it. Tolerances are that file's f32 ones:
rtol 2e-4, atol 2e-3 (sums in another order). The f32 Cholesky solves agree
to 1e-4 of the largest weight on well-conditioned systems (κ < 1e2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as RS
from repro_torch.core import streaming as PS
from repro_torch.core.engine import SuffStats

RTOL, ATOL = 2e-4, 2e-3
D, C = 48, 7
BATCHES = (37, 64, 5, 64)       # ragged, one batch smaller than a tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes are small, and parallel test
    workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed, sizes=BATCHES, d=D, c=C):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, d)).astype(np.float32),
             np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]) for n in sizes]


def _fold_ref(batches, use_kernel):
    s = RS.init_state(D, C)
    for x, y in batches:
        s = RS.update_state(s, jnp.asarray(x), jnp.asarray(y), use_kernel=use_kernel)
    return s


def _fold(batches, use_kernel, state=None):
    s = PS.init_state(D, C, device="cpu") if state is None else state
    for x, y in batches:
        s = PS.update_state(s, torch.from_numpy(x), torch.from_numpy(y),
                            use_kernel=use_kernel)
    return s


def _check(state, ref):
    for a, b in zip(state, ref):
        assert a.device.type == "cpu" and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_init_state_matches_reference():
    s, r = PS.init_state(D, C, device="cpu"), RS.init_state(D, C)
    assert isinstance(s, PS.AnalyticState)
    assert [tuple(a.shape) for a in s] == [tuple(b.shape) for b in r]
    assert all(a.dtype == torch.float32 and not a.any() for a in s)
    s64 = PS.init_state(D, C, dtype=torch.float64, device="cpu")
    assert all(a.dtype == torch.float64 for a in s64)


def test_init_state_defaults_to_cuda():
    """No device named: CUDA, and a RuntimeError where there is no GPU."""
    if torch.cuda.is_available():
        assert PS.init_state(D, C).gram.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PS.init_state(D, C)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_update_state_matches_reference(use_kernel):
    batches = _batches(0)
    s = _fold(batches, use_kernel)
    _check(s, _fold_ref(batches, use_kernel))
    assert float(s.count) == sum(BATCHES)
    x = np.concatenate([b[0] for b in batches]).astype(np.float64)
    np.testing.assert_allclose(s.gram.numpy(), x.T @ x, rtol=RTOL, atol=ATOL)


def test_kernel_route_matches_plain_route():
    batches = _batches(1)
    torch.testing.assert_close(_fold(batches, True).gram, _fold(batches, False).gram,
                               rtol=RTOL, atol=ATOL)


def test_update_state_takes_numpy_and_leading_dims():
    """Inputs move to the state's device and dtype; (B, T, d) flattens."""
    x, y = _batches(2, sizes=(24,))[0]
    s = PS.update_state(PS.init_state(D, C, device="cpu"), x.reshape(4, 6, D),
                        y.reshape(4, 6, C))
    flat = _fold([(x, y)], False)
    for a, b in zip(s, flat):
        torch.testing.assert_close(a, b)


def test_merge_states_matches_reference_and_order_does_not_matter():
    clients = [_batches(10 + k, sizes=(20 + 7 * k, 9)) for k in range(4)]
    states = [_fold(b, True) for b in clients]
    refs = [_fold_ref(b, True) for b in clients]
    merged, merged_ref = states[0], refs[0]
    for s, r in zip(states[1:], refs[1:]):
        merged, merged_ref = PS.merge_states(merged, s), RS.merge_states(merged_ref, r)
    _check(merged, merged_ref)
    rev = states[-1]
    for s in states[-2::-1]:
        rev = PS.merge_states(rev, s)
    for a, b in zip(merged, rev):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    # two states: addition commutes exactly
    for a, b in zip(PS.merge_states(states[0], states[1]),
                    PS.merge_states(states[1], states[0])):
        assert torch.equal(a, b)
    # the merge of the parts is the fold of the whole
    whole = _fold([b for c in clients for b in c], True)
    for a, b in zip(merged, whole):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gamma", [0.5, 5.0, 50.0])
def test_solve_matches_reference(gamma):
    batches = _batches(3, sizes=(200, 200))
    s, r = _fold(batches, False), _fold_ref(batches, False)
    w = PS.solve(s, gamma)
    w_ref = np.asarray(RS.solve(r, gamma))
    assert w.dtype == torch.float32 and w.shape == (D, C)
    top = float(np.abs(w_ref).max())
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=0, atol=1e-4 * top)
    g = s.gram.double().numpy() + gamma * np.eye(D)
    w64 = np.linalg.solve(g, s.moment.double().numpy())
    np.testing.assert_allclose(w.numpy(), w64, rtol=0, atol=1e-4 * top)


def test_solve_takes_a_tensor_gamma():
    s = _fold(_batches(4, sizes=(120,)), False)
    torch.testing.assert_close(PS.solve(s, torch.tensor(2.0)), PS.solve(s, 2.0))


def test_to_stats_from_stats_round_trip():
    s = _fold(_batches(5, sizes=(30,)), False)
    stats = PS.to_stats(s, 3.0)
    assert isinstance(stats, SuffStats) and float(stats.clients) == 3.0
    assert stats.clients.dtype == s.gram.dtype
    back = PS.from_stats(stats)
    assert all(a is b for a, b in zip(back, s))
