"""Carry the reference's weights into the port.

Random weights from ``jax.random`` cannot be redrawn with a torch generator,
so a test that runs both packages on the same model hands the reference's
parameters over as numpy arrays. This module takes that tree as plain numpy
(it imports nothing of JAX): the caller converts, e.g.
``jax.tree.map(np.asarray, T.init_params(jax.random.key(0), cfg))``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Params


def _to_torch(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _layer(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None) -> Params:
    """The reference's dense-family params (numpy leaves) → the port's.

    The reference stacks every layer on a leading axis (``jax.vmap`` over
    ``_init_block``); the port keeps one dict per layer, so ``layers`` is
    unstacked. Weight layouts stay ``(d_in, d_out)``, applied as ``x @ W``:
    nothing is transposed.
    """
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"params_from_jax covers the dense family, not {cfg.arch_type!r}")
    dev = resolve_device(device)
    stacked = tree["layers"]
    n = int(np.shape(stacked["ln1"]["scale"])[0])
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.num_layers}")
    out = _to_torch({k: v for k, v in tree.items() if k != "layers"}, dev)
    out["layers"] = [_to_torch(_layer(stacked, i), dev) for i in range(n)]
    return out


def cache_from_jax(cache: Mapping[str, Any], cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    """The reference's dense-family KV cache (numpy leaves ``k`` and ``v``,
    each (L, B, Hkv, S, hd)) → the port's, the same layout, as fresh
    tensors on ``device`` that ``decode_step`` may write in place."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"cache_from_jax covers the dense family, not {cfg.arch_type!r}")
    want = (cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim)
    out = {}
    for name in ("k", "v"):
        shape = np.shape(cache[name])
        if len(shape) != 5 or (shape[0], shape[2], shape[4]) != want:
            raise ValueError(f"cache[{name!r}] has shape {shape}, expected "
                             f"(L, B, Hkv, S, hd) with (L, Hkv, hd) = {want}")
        out[name] = _to_torch(cache[name], resolve_device(device))
    return out
