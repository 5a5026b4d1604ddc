"""Gated MLP (SwiGLU family) — the dense FFN used by every assigned arch
(counterpart of `repro.models.mlp`)."""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

__all__ = ["mlp_init", "mlp"]


def mlp_init(key, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    return {
        "gate": layers.linear_init(key, cfg.d_model, d_ff, cfg.tdtype),
        "up": layers.linear_init(key, cfg.d_model, d_ff, cfg.tdtype),
        "down": layers.linear_init(key, d_ff, cfg.d_model, cfg.tdtype),
    }


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = layers.activation(cfg.act, layers.linear(p["gate"], x)) * \
        layers.linear(p["up"], x)
    return layers.linear(p["down"], h)
