"""Grok-1 314B [hf:xai-org/grok-1] — MoE, 8 experts top-2, GQA(kv=8).

64L, d_model 6144, 48 heads / 8 kv, d_ff 32768 per expert, vocab 131072.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    activation="gelu",
    logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, top_k=2),
    source="hf:xai-org/grok-1",
)
