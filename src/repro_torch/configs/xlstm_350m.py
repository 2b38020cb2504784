"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks, no FFN stack.

24L, d_model 1024, 4 heads, vocab 50304, d_ff=0 (projection-only blocks:
up-factor-2 + recurrent mixer + down). One sLSTM block per 8 layers
(7 mLSTM : 1 sLSTM), matching the paper's sparse-sLSTM placements.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="xlstm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=8,
    source="arXiv:2405.04517",
)
