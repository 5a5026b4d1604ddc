"""internlm2-20b — GQA [arXiv:2403.17297].

[dense] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
long_500k via window_500k sliding-window variant (8192).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
    window_500k=8192,
)
