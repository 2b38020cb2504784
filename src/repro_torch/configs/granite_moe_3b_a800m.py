"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32L, d_model 1536, 24 heads / 8 kv, vocab 49155. MoE: 40 experts, top-8,
d_ff 512 per expert. (The assignment bracket note says "32 experts"; the
numeric field says 40e — we follow the numeric field, see DESIGN.md §6.)
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    activation="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
