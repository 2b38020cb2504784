"""Step functions: analytic train (paper), prefill, decode.

The ports of ``repro.launch.steps.make_analytic_train_step``,
``make_prefill_step`` and ``make_serve_step``. The reference jit-compiles
these; here they run eagerly. The *analytic* train step is the paper's local
stage: a frozen-backbone forward + streaming Gram update — gradient-free
(AFL's point). The gradient step builders (``head_loss``,
``head_sgd_step``, ``make_fedavg_train_step``, ``make_full_train_step``)
are not ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.streaming import AnalyticState, update_state
from repro_torch.models import transformer as T


def make_analytic_train_step(cfg: ModelConfig, *, use_kernel: bool = False) -> Callable:
    """(params, AnalyticState, batch) → AnalyticState.

    batch: tokens (B, S) integer, labels (B,) integer in [0, num_classes).
    The forward runs on the params' device; the pooled embeddings are folded
    into the state on its own device (through the Gram kernel on a CUDA
    state with ``use_kernel``).
    """

    def step(params, state: AnalyticState, batch) -> AnalyticState:
        hidden = T.forward(params, cfg, batch)
        emb = T.pool(hidden)                                    # (B, D)
        labels = torch.as_tensor(batch["labels"], device=emb.device).long()
        y = F.one_hot(labels, cfg.num_classes).to(torch.float32)
        return update_state(state, emb, y, use_kernel=use_kernel)

    return step


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
