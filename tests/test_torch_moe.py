"""The port's MoE layer against the reference, on the same weights.

``models.moe.moe_apply`` against ``repro.models.moe.moe_apply`` on the
reference's ``init_moe`` weights (as numpy) and numpy-seeded inputs, with
swiglu and gelu experts: the expert assignment first (each (token,
choice)'s slot, caught where the reference hands it to ``_ffn_dense``),
exactly; then the output and the load-balance aux loss at rtol 1e-5 /
atol 1e-6 (a single building block in f32, sums in another order). One
case drops no token (the reduced config: capacity ≥ group); the others
drop (capacity factor 1.25, a ragged last group, and decode's group of
the batch at granite's 40 experts top-8, where capacity is 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as RefMoEConfig
from repro.models import moe as RM
from repro_torch.config import MoEConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as M

BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(p_ref, x, moe, activation, monkeypatch):
    """The reference's (out, aux) and the slots and weights its routing
    handed to ``_ffn_dense``."""
    seen = {}
    ffn = RM._ffn_dense

    def spy(p, groups, slot, weight, e, cap, act):
        seen.update(slot=np.asarray(slot), weight=np.asarray(weight), cap=cap)
        return ffn(p, groups, slot, weight, e, cap, act)

    with monkeypatch.context() as m:
        m.setattr(RM, "_ffn_dense", spy)
        out, aux = RM.moe_apply(p_ref, jnp.asarray(x), RefMoEConfig(**dataclasses.asdict(moe)),
                                activation)
    return np.asarray(out), float(aux), seen


REDUCED = get_config("granite_moe_3b_a800m").reduced().moe
CASES = [
    # (name, MoEConfig, (B, S), d, d_ff, expected drops?)
    ("reduced, no drops", REDUCED, (2, 20), 32, 48, False),
    ("cf 1.25, ragged last group", MoEConfig(num_experts=4, top_k=2, capacity_factor=1.25,
                                             group_size=16), (2, 20), 32, 48, True),
    ("decode group of 4, granite's 40 top-8", MoEConfig(num_experts=40, top_k=8), (4, 1),
     32, 16, True),
]


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_matches_reference(case, activation, monkeypatch):
    _, moe, (b, s), d, f, drops = case
    p_ref = RM.init_moe(jax.random.key(3), d, f, RefMoEConfig(**dataclasses.asdict(moe)),
                        activation, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in p_ref.items()}
    assert p["w_up"].shape == (moe.num_experts, d, f)
    x = np.random.default_rng(b * s).standard_normal((b, s, d)).astype(np.float32)
    out_ref, aux_ref, seen = _reference(p_ref, x, moe, activation, monkeypatch)

    groups, t = M._groups(torch.from_numpy(x), moe)
    r = M.route(p, groups, moe)
    assert r.cap == seen["cap"] and t == b * s
    np.testing.assert_array_equal(r.slot.numpy(), seen["slot"])
    np.testing.assert_allclose(r.weight.numpy(), seen["weight"], **BLOCK_TOL)
    dropped = int((r.slot == moe.num_experts * r.cap).sum())
    assert (dropped > 0) == drops

    out, aux = M.moe_apply(p, torch.from_numpy(x), moe, activation)
    assert out.shape == (b, s, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), out_ref, **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), aux_ref, **BLOCK_TOL)


@pytest.mark.parametrize("g,k,e,cf,want", [
    (4, 2, 4, 1.25, 2),      # 2.5 rounds to even: 2
    (12, 2, 4, 1.25, 8),     # 7.5 rounds to even: 8
    (4, 8, 40, 1.25, 1),     # granite's decode: 1.0
    (16, 2, 4, 2.0, 16),     # the reduced config: capacity = group
])
def test_capacity_is_pythons_round(g, k, e, cf, want):
    """Capacity rounds half to even, as Python's round does in the
    reference; the groups are made so that the formula's value lands on
    a half."""
    moe = MoEConfig(num_experts=e, top_k=k, capacity_factor=cf, group_size=g)
    p = {"router": torch.zeros((8, e))}
    assert M.route(p, torch.zeros((1, g, 8)), moe).cap == want


def test_equal_probabilities_go_to_the_lower_expert():
    """A zero token sees a uniform router: its choices are experts 0..k-1
    in order, as lax.top_k orders ties (the padded rows of a ragged group
    are such tokens)."""
    moe = MoEConfig(num_experts=6, top_k=3, group_size=4)
    p = {"router": torch.randn((8, 6), generator=torch.Generator().manual_seed(0))}
    r = M.route(p, torch.zeros((1, 4, 8)), moe)
    assert r.top_i.tolist() == [[[0, 1, 2]] * 4]
