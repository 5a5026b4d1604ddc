"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

[dense] 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
head_dim 128 (so q/k/v project to 64*128 = 8192). qk_norm per head.
long_500k via window_500k sliding-window variant (8192).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    use_qk_norm=True,
    rope_theta=1e6,
    window_500k=8192,
)
