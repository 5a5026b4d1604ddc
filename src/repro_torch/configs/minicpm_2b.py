"""minicpm-2b — WSD schedule, llama-like arch [arXiv:2404.06395].

[dense] 40L d_model=2304 36H (GQA kv=36 => MHA) d_ff=5760 vocab=122753.
The WSD (warmup-stable-decay) schedule is provided by repro_torch.optim.schedules
and selected by the training recipe for this arch. head_dim 64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    window_500k=8192,
)
