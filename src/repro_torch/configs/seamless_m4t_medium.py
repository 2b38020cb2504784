"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder, multimodal.

12 decoder layers + 12 encoder layers, d_model 1024, 16 heads (kv=16),
d_ff 4096, vocab 256206. The audio frontend (mel + conformer feature
extractor) is a STUB: input_specs() provides pre-computed frame embeddings
(B, encoder_seq, d_model) consumed by the encoder; decode shapes use a fixed
4096-frame encoder memory. long_500k is SKIPPED for this arch (cross-attn to
the full encoder memory is irreducibly dense — DESIGN.md §6).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="encdec",
    num_layers=12,
    encoder_layers=12,
    encoder_seq=4096,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    activation="gelu",
    norm="layer",
    source="arXiv:2308.11596",
)
