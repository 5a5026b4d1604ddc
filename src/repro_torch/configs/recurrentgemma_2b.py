"""recurrentgemma-2b — RG-LRU + local attention, 2 recurrent : 1 attn
[arXiv:2402.19427].

[hybrid] 26L d_model=2560 10H (GQA kv=1 => MQA) d_ff=7680 vocab=256000.
Local attention window 2048. head_dim 256 (Griffin-2B). Sub-quadratic:
runs long_500k (LRU state + 2048-window cache).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="rglru_hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    rglru_width=2560,
    rglru_conv_width=4,
    local_attn_window=2048,
    hybrid_pattern=("rec", "rec", "attn"),
    tie_embeddings=True,
    scan_layers=False,      # heterogeneous pattern -> python loop
)
