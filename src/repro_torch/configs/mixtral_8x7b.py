"""mixtral-8x7b — 8 experts top-2, sliding-window attention [arXiv:2401.04088].

[moe] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
SWA window 4096. Sub-quadratic decode via the SWA ring cache: runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1e6,
)
