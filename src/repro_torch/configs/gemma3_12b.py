"""Gemma3-12B [hf:google/gemma-3-1b-pt family card] — 5:1 local:global.

48L, d_model 3840, 16 heads / 8 kv, head_dim 256, d_ff 15360, vocab 262144.
Local layers: sliding window 1024, rope theta 10k; every 6th layer global
(full attention, theta 1M). 128k context natively; long_500k uses the
all-window variant (see launch/dryrun.py --variant sliding_window).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    activation="gelu",
    qk_norm=True,
    window=1024,
    global_every=6,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
