"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191].

[vlm] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. Vision
frontend (ViT + projector) is STUBBED per carve-out: input_specs provide
precomputed patch embeddings (early fusion over the first frontend_tokens
positions). M-RoPE sections (16, 24, 24) over head_dim 128 // 2.
long_500k runs via the window_500k sliding-window variant (window 8192).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    use_qkv_bias=True,
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
    frontend_tokens=1024,   # stub patch embeddings per sequence
    window_500k=8192,
    tie_embeddings=True,
)
