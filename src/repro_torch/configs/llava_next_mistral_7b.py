"""LLaVA-NeXT (Mistral-7B) [hf:llava-hf/llava-v1.6-mistral-7b-hf] — VLM.

Language backbone: 32L, d_model 4096, 32 heads / 8 kv, d_ff 14336,
vocab 32000. AnyRes tiling: the vision frontend is a STUB — input_specs()
provides 2880 pre-computed patch embeddings (5 tiles x 576 patches) that are
projected and consumed as prefix tokens.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    activation="swiglu",
    rope_theta=1_000_000.0,
    prefix_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
