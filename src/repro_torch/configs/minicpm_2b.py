"""MiniCPM-2B [arXiv:2404.06395] — dense llama-like, trained with WSD.

40L, d_model 2304, 36 heads (kv=36, i.e. MHA), d_ff 5760, vocab 122753.
The WSD (warmup-stable-decay) schedule lives in the JAX package (repro.optim.wsd) for the
gradient-FL baseline path (AFL itself is gradient-free).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    activation="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2404.06395",
)
