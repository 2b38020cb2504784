"""Qwen3-32B [hf:Qwen/Qwen3-8B family card] — dense, GQA(kv=8), qk-norm.

64L, d_model 5120, 64 heads / 8 kv heads, head_dim 128, d_ff 25600,
vocab 151936.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)
