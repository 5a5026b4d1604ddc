"""Model configuration shared by every architecture, on the port.

Counterpart of `repro.models.config`, field for field: one dataclass
covers the 6 assigned architecture families (dense / moe / vlm / ssm /
hybrid / audio enc-dec); family-specific fields default to "off". Each
assigned architecture instantiates this in
``src/repro_torch/configs/<id>.py`` with the exact published numbers.
``tdtype`` is the torch dtype of ``dtype`` (the reference's ``jdtype``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig", "ShapeConfig", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # 'dense' | 'moe' | 'rwkv6' | 'rglru_hybrid' | 'encdec'
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0            # 0 => == num_heads (MHA)
    head_dim: int = 0                # 0 => d_model // num_heads

    # ---- attention options ----
    rope_theta: float = 10_000.0
    rope_style: str = "standard"     # 'standard' | 'mrope' | 'none'
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # qwen2-vl (sum = head_dim//2)
    use_qkv_bias: bool = False       # qwen2 family
    use_qk_norm: bool = False        # qwen3
    sliding_window: Optional[int] = None   # SWA (mixtral 4096); None = full causal
    attn_logit_softcap: Optional[float] = None

    # ---- MoE ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4: one always-on shared expert
    router_aux_coef: float = 0.01    # load-balance loss coefficient

    # ---- RWKV6 (Finch) ----
    rwkv_head_dim: int = 64

    # ---- RG-LRU hybrid (RecurrentGemma) ----
    rglru_width: int = 0             # recurrence width (d_rnn); 0 => d_model
    rglru_conv_width: int = 4
    local_attn_window: int = 2048    # window of the 1-in-3 local attention blocks
    hybrid_pattern: tuple[str, ...] = ("rec", "rec", "attn")  # 1:2 attn:rec

    # ---- encoder-decoder (seamless-m4t backbone) ----
    encoder_layers: int = 0          # >0 => enc-dec; num_layers = decoder layers

    # ---- modality frontend STUB (carve-out) ----
    frontend: Optional[str] = None   # None | 'vision' | 'audio'
    frontend_tokens: int = 0         # embeddings prepended by the stub
    # ---- misc ----
    norm: str = "rmsnorm"            # 'rmsnorm' | 'layernorm'
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # long_500k support: window to use for the 500k decode variant; None and
    # sliding_window None and family dense => long_500k skipped.
    window_500k: Optional[int] = None
    # layer stacking strategy: homogeneous families keep stacked (L, ...)
    # layer params; heterogeneous ones a list of per-layer dicts.
    scan_layers: bool = True

    # remat each layer's forward in the backward pass (production default:
    # the saved attention probabilities of a long-sequence train step
    # would not fit otherwise)
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (16 model x 16 data) so the
        embedding/unembedding shard cleanly (Megatron-style padding).
        Padded logit columns are masked to -inf before the softmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def rnn_width(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_subquadratic(self) -> bool:
        """Can this config decode at 524k context without a 524k KV cache?"""
        if self.family in ("rwkv6", "rglru_hybrid"):
            return True
        if self.sliding_window is not None or self.window_500k is not None:
            return True
        return False

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs decode (enc-dec via its decoder)

    def reduced(self, layers: int = 2, d_model: int = 256, d_ff: int = 512,
                vocab: int = 512, experts: int = 4) -> "ModelConfig":
        """Smoke-test variant of the same family (<=512 width, <=4 experts)."""
        heads = max(2, min(4, self.num_heads))
        kvh = max(1, min(self.kv_heads, heads))
        while heads % kvh:
            kvh -= 1
        head_dim = max(16, d_model // heads)
        sec = None
        if self.rope_style == "mrope":
            half = head_dim // 2
            a = half // 4
            sec = (a, (half - a) // 2, half - a - (half - a) // 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=head_dim,
            d_ff=d_ff,
            vocab_size=vocab,
            num_experts=min(self.num_experts, experts) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.num_experts_per_tok else 0,
            # drop-free capacity at smoke scale so decode == apply exactly;
            # the 1.25 production factor (with drops) is covered by test_moe
            moe_capacity_factor=float(max(experts, 1)),
            encoder_layers=min(self.encoder_layers, layers) if self.encoder_layers else 0,
            sliding_window=min(self.sliding_window, 128) if self.sliding_window else None,
            local_attn_window=min(self.local_attn_window, 64),
            rglru_width=0,
            rwkv_head_dim=32,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            mrope_sections=sec if sec else self.mrope_sections,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
