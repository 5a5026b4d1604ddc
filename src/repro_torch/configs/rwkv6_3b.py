"""rwkv6-3b — Finch, data-dependent decay [arXiv:2404.05892].

[ssm] 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536. Attention-free:
runs long_500k natively (O(1) state). num_heads below is d_model /
rwkv_head_dim = 40 WKV heads (head dim 64, the RWKV6 default).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # WKV heads = d_model / rwkv_head_dim
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,
    rope_style="none",
    norm="layernorm",
    tie_embeddings=False,
)
