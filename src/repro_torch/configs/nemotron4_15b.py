"""Nemotron-4 15B [arXiv:2402.16819] — dense, GQA(kv=8), squared-ReLU MLP.

32L, d_model 6144, 48 heads / 8 kv, d_ff 24576, vocab 256000, LayerNorm.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    activation="relu2",
    norm="layer",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)
