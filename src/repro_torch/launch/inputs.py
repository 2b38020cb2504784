"""Abstract input specs (meta tensors) and concrete sample batches.

The port of ``repro.launch.inputs``. ``input_specs(cfg, shape)`` returns
the dry run's abstract inputs: meta tensors of the reference's
``ShapeDtypeStruct`` shapes and dtypes, with no storage. ``sample_batch``
makes the same numpy draws from ``default_rng(seed)`` in the same order as
the reference's, so both packages get equal tokens (and modality stubs) for
the same arguments; the tensors go on the caller's device.

Modality stubs: VLM archs get pre-computed patch embeddings
(``cfg.prefix_tokens`` of them), audio enc-dec archs pre-computed frame
embeddings for the encoder, both float features of width d_model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import InputShape, ModelConfig
from repro_torch.device import resolve_device


def _token_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text-token count so that prefix + tokens == seq_len total positions."""
    if cfg.prefix_tokens:
        return max(1, seq_len - cfg.prefix_tokens)
    return seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_specs(cfg: ModelConfig, shape: InputShape,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, _token_len(cfg, s)), torch.int32),
             "labels": _meta((b,), torch.int32)}
    if cfg.prefix_tokens:
        specs["prefix_embeds"] = _meta((b, cfg.prefix_tokens, cfg.d_model), dtype)
    if cfg.encoder_layers:
        specs["enc_feats"] = _meta((b, min(cfg.encoder_seq, s), cfg.d_model), dtype)
    return specs


def prefill_specs(cfg: ModelConfig, shape: InputShape,
                  dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    specs = train_specs(cfg, shape, dtype)
    del specs["labels"]
    return specs


def decode_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    return {"token": _meta((shape.global_batch,), torch.int32),
            "pos": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    if shape.kind == "train":
        return train_specs(cfg, shape, dtype)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape, dtype)
    return decode_specs(cfg, shape)


def sample_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 with_labels: bool = True, device=None) -> Dict[str, Any]:
    """Random batch: tokens (B, S') int32, labels (B,) int32, and the
    modality stubs in f32, on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    out: Dict[str, Any] = {
        "tokens": put(rng.integers(0, cfg.vocab_size, (batch, _token_len(cfg, seq))),
                      torch.int32)}
    if with_labels:
        out["labels"] = put(rng.integers(0, cfg.num_classes, (batch,)), torch.int32)
    if cfg.prefix_tokens:
        out["prefix_embeds"] = put(
            rng.standard_normal((batch, cfg.prefix_tokens, cfg.d_model)) * 0.1,
            torch.float32)
    if cfg.encoder_layers:
        out["enc_feats"] = put(
            rng.standard_normal((batch, min(cfg.encoder_seq, seq), cfg.d_model)) * 0.1,
            torch.float32)
    return out
