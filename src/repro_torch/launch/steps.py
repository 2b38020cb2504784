"""Step functions: analytic train (paper), gradient baseline, prefill, decode.

The ports of ``repro.launch.steps``. The reference jit-compiles these; here
they run eagerly. The *analytic* train step is the paper's local stage: a
frozen-backbone forward + streaming Gram update — gradient-free (AFL's
point). The gradient steps exist for the FedAvg/FedProx baselines the paper
compares against (head-only SGD, backbone frozen, paper Supp. E) and for
full-backbone training in the generic train driver; their gradients come
from ``torch.autograd`` where the reference's come from ``jax.grad``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.streaming import AnalyticState, update_state
from repro_torch.models import transformer as T
from repro_torch.optim import tree_leaves, tree_map


def make_analytic_train_step(cfg: ModelConfig, *, use_kernel: bool = False) -> Callable:
    """(params, AnalyticState, batch) → AnalyticState.

    batch: tokens (B, S) integer, labels (B,) integer in [0, num_classes).
    The forward runs on the params' device; the pooled embeddings are folded
    into the state on its own device (through the Gram kernel on a CUDA
    state with ``use_kernel``).
    """

    def step(params, state: AnalyticState, batch) -> AnalyticState:
        with torch.no_grad():
            emb = T.pool(T.forward(params, cfg, batch))             # (B, D)
        labels = torch.as_tensor(batch["labels"], device=emb.device).long()
        y = F.one_hot(labels, cfg.num_classes).to(torch.float32)
        return update_state(state, emb, y, use_kernel=use_kernel)

    return step


def head_loss(head: torch.Tensor, emb: torch.Tensor, labels) -> torch.Tensor:
    """Mean cross-entropy of the linear head ``head`` (D, C) on ``emb`` (B, D)."""
    logits = emb.to(torch.float32) @ head
    logp = torch.log_softmax(logits, -1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def _head_value_and_grad(head, emb, labels):
    with torch.enable_grad():
        h = head.detach().requires_grad_(True)
        loss = head_loss(h, emb.detach(), labels)
        (grad,) = torch.autograd.grad(loss, h)
    return loss.detach(), grad


def head_sgd_step(head: torch.Tensor, emb: torch.Tensor, labels,
                  lr: float = 0.05) -> torch.Tensor:
    """One SGD step on the linear head over precomputed embeddings: a new
    head ``head − lr·∇head_loss``."""
    return head - lr * _head_value_and_grad(head, emb, labels)[1]


def make_fedavg_train_step(cfg: ModelConfig, lr: float = 0.05) -> Callable:
    """Gradient-FL baseline local step: SGD on the classification head with a
    frozen backbone (paper Supp. E: batch 64, SGD lr 0.05).

    (params, head (D,C), batch) → (head', loss). The backbone's forward runs
    under ``torch.no_grad()``; only the head is differentiated.
    """

    def step(params, head, batch):
        with torch.no_grad():
            emb = T.pool(T.forward(params, cfg, batch))
        loss, grad = _head_value_and_grad(head, emb, batch["labels"])
        return head - lr * grad, loss

    return step


def make_full_train_step(cfg: ModelConfig, lr: float = 1e-3) -> Callable:
    """Generic end-to-end LM training step (next-token CE over the backbone) —
    the non-FL training driver (examples/torch_train_100m.py). SGD with the
    given lr (schedules composed by the caller via ``repro_torch.optim``).

    (params, batch, lr_t) → (params, loss): every floating-point leaf
    becomes ``p − lr_t·g`` in place (the reference returns new params), the
    loss a detached 0-d tensor. The gradients are autograd's of the forward
    (attention on the card: the flash kernel's forward, ``layers.FlashSDPA``).
    """

    def loss_fn(params, batch):
        hidden = T.forward(params, cfg, batch)
        logits = T.lm_logits(params, cfg, hidden)
        tokens = torch.as_tensor(batch["tokens"], device=logits.device).long()
        if cfg.prefix_tokens:
            logits = logits[:, cfg.prefix_tokens:]
        tgt = tokens[:, 1:]
        logp = torch.log_softmax(logits[:, :-1].to(torch.float32), -1)
        nll = -torch.gather(logp, -1, tgt[..., None])
        return torch.mean(nll)

    def step(params, batch, lr_t=lr):
        with torch.enable_grad():
            # views of the params that take part in the graph, the caller's
            # tensors untouched until the update
            live = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()),
                            params)
            leaves = [p for p in tree_leaves(live) if p.requires_grad]
            loss = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr_t * g.to(p.dtype))
        return params, loss.detach()

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
