"""Carry the reference's weights and caches into the port.

Random weights from ``jax.random`` cannot be redrawn with a torch generator,
so a test that runs both packages on the same model hands the reference's
parameters over as numpy arrays. This module takes that tree as plain numpy
(it imports nothing of JAX): the caller converts, e.g.
``jax.tree.map(np.asarray, T.init_params(jax.random.key(0), cfg))``.
A bf16 config's leaves arrive as ``ml_dtypes.bfloat16`` arrays and leave
as ``torch.bfloat16`` tensors with the same bits.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Params


def _to_torch(tree, device):
    """A numpy leaf (or a tree of them) as fresh tensors on ``device``. A
    bf16 leaf (``ml_dtypes.bfloat16``, which torch cannot read) is carried
    bit for bit: its 16-bit words as ``int16``, viewed as ``torch.bfloat16``,
    never widened."""
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layer(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _lead(tree, n: int) -> tuple:
    """The first ``n`` dims of a tree's (first) leaf: its stacking dims."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tuple(np.shape(tree)[:n])


def _unstack(tree, depth: int, device):
    """A stacked layer tree → a list (of lists, at depth 2) of layer dicts."""
    n = _lead(tree, 1)[0]
    if depth == 1:
        return [_to_torch(_layer(tree, i), device) for i in range(n)]
    return [_unstack(_layer(tree, i), depth - 1, device) for i in range(n)]


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None) -> Params:
    """The reference's params (numpy leaves) of any family → the port's.

    The reference stacks like layers on leading axes (``jax.vmap`` over
    their init): ``layers`` and ``enc_layers`` (L, …), ``mamba_groups`` and
    ``mlstm_groups`` (n_groups, g − 1, …), ``slstm`` (n_groups, …) and the
    tails (tail, …). The port keeps one dict per layer, so each of these
    is unstacked into a list (of lists for the groups). Weight layouts stay
    as they are, ``(d_in, d_out)`` applied as ``x @ W`` and the experts'
    ``(E, d_in, d_out)``: nothing is transposed.
    """
    dev = resolve_device(device)
    want = T.stacked_layout(cfg)
    got = {name: _lead(tree[name], len(dims)) for name, dims in want.items() if name in tree}
    extra = sorted(name for name in T.STACKED if name in tree and name not in want)
    if extra or got != want:
        raise ValueError(f"tree does not match {cfg.name} ({cfg.arch_type}): stacked "
                         f"trees {got}, expected {want}")
    return {name: (_unstack(sub, len(want[name]), dev) if name in want
                   else _to_torch(sub, dev)) for name, sub in tree.items()}


def cache_from_jax(cache: Mapping[str, Any], cfg: ModelConfig, batch: int, max_seq: int,
                   device=None, mem_len=None) -> Dict[str, Any]:
    """The reference's decode cache of any family (numpy leaves), made for
    ``batch`` rows and ``max_seq`` slots (an enc-dec cache's
    cross-attention over ``mem_len`` memory frames) → the port's, as fresh
    tensors on ``device`` that ``decode_step`` may write in place. The
    layout is the port's own: every key and shape must be those of
    ``init_cache`` at the same sizes."""
    want = T.init_cache(cfg, batch, max_seq, device="meta", mem_len=mem_len)
    dev = resolve_device(device)

    def conv(tree, ref, path):
        if isinstance(ref, Mapping):
            if not isinstance(tree, Mapping) or set(tree) != set(ref):
                raise ValueError(f"cache{path} has keys {sorted(tree)}, expected {sorted(ref)}")
            return {k: conv(tree[k], ref[k], f"{path}[{k!r}]") for k in ref}
        if tuple(np.shape(tree)) != tuple(ref.shape):
            raise ValueError(f"cache{path} has shape {np.shape(tree)}, expected "
                             f"{tuple(ref.shape)}")
        return _to_torch(tree, dev)

    return conv(cache, want, "")
