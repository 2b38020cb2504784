"""Optimizers & schedules for the gradient baselines and the LM driver.

The port of ``repro.optim``. AFL itself is gradient-free (that is the
paper's point): this package exists for the comparison arms, head-SGD
federated baselines (paper Supp. E) and the generic backbone pre-training
driver (WSD schedule, per minicpm [arXiv:2404.06395], the schedule its
config cites).

The updates work over the port's params trees (dicts and lists of tensors,
``models.transformer``'s layout) and change the tensors in place under
``torch.no_grad()``, where the reference's return new arrays; each still
returns the tree, so a caller may write ``params = update(params, grads)``
as with the reference. A parameter becomes ``p − (lr·g)``, the product
rounded first, as the reference computes it. The schedules compute in f32,
as the reference's ``jnp.float32``, and return a Python float.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["sgd", "momentum_sgd", "wsd_schedule", "cosine_schedule", "tree_leaves",
           "tree_map"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists and tuples)
    and the same places of the trees in ``rest``, in a tree of that shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def sgd(lr: float) -> Callable:
    """params, grads → params, in place. Plain SGD (paper Supp. E uses lr=0.05)."""

    @torch.no_grad()
    def update(params, grads, lr_t=lr):
        tree_map(lambda p, g: p.sub_(lr_t * g.to(p.dtype)), params, grads)
        return params

    return update


def momentum_sgd(lr: float, beta: float = 0.9):
    """Returns (init_fn, update_fn) with velocity state; ``update(params,
    grads, vel)`` → (params, vel), both updated in place."""

    def init(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(params, grads, vel, lr_t=lr):
        tree_map(lambda v, g: v.mul_(beta).add_(g.to(v.dtype)), vel, grads)
        tree_map(lambda p, v: p.sub_(lr_t * v.to(p.dtype)), params, vel)
        return params, vel

    return init, update


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def wsd_schedule(base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor: float = 0.0) -> Callable:
    """Warmup-Stable-Decay (minicpm): linear warmup → flat → 1-sqrt decay."""
    decay_steps = max(int(total * decay_frac), 1)
    stable_end = total - decay_steps

    def lr(step) -> float:
        step = _f32(step)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - stable_end) / decay_steps, 0.0, 1.0)
        decay = base_lr * (1.0 - (1.0 - floor) * torch.sqrt(frac))
        return float(torch.where(step < stable_end, warm, decay))

    return lr


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    def lr(step) -> float:
        step = _f32(step)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return float(torch.where(step < warmup, warm, base_lr * cos))

    return lr
