"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16
experts top-1 (sigmoid gate) + shared expert, early-fusion multimodal
(vision frontend STUBBED per carve-out). long_500k via window_500k=8192
(Scout ships interleaved RoPE/NoPE chunked attention; the sliding-window
variant is our sub-quadratic stand-in).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_experts_per_tok=1,
    shared_expert=True,
    rope_theta=5e5,
    frontend="vision",
    frontend_tokens=1024,
    window_500k=8192,
)
