"""qwen2-7b — GQA, QKV bias [arXiv:2407.10671].

[dense] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
long_500k via window_500k sliding-window variant (8192).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    use_qkv_bias=True,
    rope_theta=1e6,
    window_500k=8192,
)
