"""Step functions of the serving path: prefill and one decode step.

The ports of ``repro.launch.steps.make_prefill_step`` and
``make_serve_step``. The reference jit-compiles these; here they run
eagerly. The analytic, FedAvg and full-train step builders wait for
``core/streaming.py`` (ROADMAP Queue 1, items 2 and 4).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, max_seq: int) -> Callable:
    """(params, batch) → (last-token vocab logits (B, V), cache)."""

    def step(params, batch):
        hidden, cache = T.prefill(params, cfg, batch, max_seq)
        logits = T.lm_logits(params, cfg, hidden[:, -1:])
        return logits[:, 0], cache

    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: (params, cache, token (B,), pos) → (logits (B, V),
    cache), the cache updated in place."""

    def step(params, cache, token, pos):
        hidden, cache = T.decode_step(params, cfg, token, cache, pos)
        logits = T.lm_logits(params, cfg, hidden)
        return logits[:, 0], cache

    return step
