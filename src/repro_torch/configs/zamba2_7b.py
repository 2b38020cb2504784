"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks.

81 Mamba2 layers (d_model 3584, ssm_state 64) with ONE shared transformer
block (32 heads, kv=32, d_ff 14336) applied every 6 layers (13 applications
for 81 layers; weights shared, per-application KV caches).
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    activation="swiglu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, chunk=128, num_heads=32),
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
