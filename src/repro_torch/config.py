"""Central configuration dataclasses for models and FL runs.

The same fields and defaults as the JAX package's ``repro.config``, so a
configuration means the same model in both packages; ``param_dtype`` names a
``torch.dtype`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 512  # token grouping for one-hot dispatch


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256
    num_heads: int = 0       # 0 → derived from d_inner // 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One backbone. ``arch_type`` selects the block program:

    dense   — uniform [attn + MLP] stack (minicpm, qwen3, nemotron, llava,
              gemma3 via window_pattern)
    moe     — uniform [attn + MoE] stack (grok-1, granite)
    hybrid  — Mamba2 stack with a shared attention block every
              ``shared_attn_every`` layers (zamba2)
    xlstm   — mLSTM stack with an sLSTM block every ``slstm_every`` (xLSTM)
    encdec  — bidirectional encoder + causal decoder w/ cross-attn (seamless)

    Only ``dense`` has a forward pass in this package so far.
    """

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 → d_model // num_heads
    activation: str = "swiglu"             # swiglu | relu2 | gelu
    norm: str = "rms"                      # rms | layer
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0         # gemma3 global layers (0 → same)
    # Sliding-window attention. window>0 applies to "local" layers;
    # global_every=N → every Nth layer is global (full attn). gemma3: window
    # 1024, global_every=6 (5 local : 1 global).
    window: int = 0
    global_every: int = 0
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 6             # hybrid: shared attn cadence
    slstm_every: int = 8                   # xlstm: one sLSTM per N layers
    encoder_layers: int = 0                # encdec only
    encoder_seq: int = 4096                # encdec: encoder memory length
    prefix_tokens: int = 0                 # VLM patch / audio frame stub prefix
    num_classes: int = 1000                # AFL head width (downstream task)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "float32"                 # activations/params dtype
    source: str = ""                       # citation (paper / model card)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: ≤2-ish layers, d_model≤512, ≤4 experts."""
        small: dict = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // self.num_heads)),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32,
            window=min(self.window, 32) if self.window else 0,
            global_every=2 if self.global_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=32 if self.encoder_layers else self.encoder_seq,
            prefix_tokens=8 if self.prefix_tokens else 0,
            num_classes=16,
            shared_attn_every=2,
            slstm_every=2,
            dtype="float32",
        )
        if self.moe is not None:
            ne = min(4, self.moe.num_experts)
            tk = min(2, self.moe.top_k)
            # capacity ≥ group → no token dropping, so reduced-config decode
            # is exactly consistent with the full forward pass.
            small["moe"] = MoEConfig(
                num_experts=ne, top_k=tk, capacity_factor=float(ne) / tk,
                group_size=16,
            )
        if self.ssm is not None:
            small["ssm"] = SSMConfig(d_state=16, chunk=16, num_heads=4)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Federated-run configuration (paper §4 settings)."""

    num_clients: int = 100
    gamma: float = 1.0
    use_ri: bool = True
    partition: str = "niid1"   # iid | niid1 (Dirichlet) | niid2 (sharding)
    alpha: float = 0.1         # NIID-1 Dirichlet concentration
    shards_per_client: int = 4  # NIID-2
    seed: int = 0
