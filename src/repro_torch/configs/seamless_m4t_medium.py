"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596].

[audio] 12L d_model=1024 16H (kv=16 MHA) d_ff=4096 vocab=256206.
Encoder 12L + decoder 12L transformer backbone; the speech frontend
(mel + conv feature extractor) is STUBBED per carve-out — input_specs
provide frame embeddings (B, seq/4, d_model), the /4 standing in for the
conformer downsampling. long_500k: SKIPPED (full-attention enc-dec; no
500k speech-decode use case).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    tie_embeddings=True,
)
