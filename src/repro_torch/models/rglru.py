"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) on
the port (counterpart of `repro.models.rglru`).

Temporal block = gated branch * (conv1d -> RG-LRU recurrence), where
    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs as a sequential loop over time in f32. The
reference evaluates it with jax.lax.associative_scan, whose tree order adds
the same terms in another order: the two agree within f32 rounding, not
bit for bit. Decode is the O(1) single-step recurrence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

__all__ = ["RG_LRU_C", "rglru_init", "rglru_apply", "rglru_step",
           "conv1d_init", "conv1d_apply", "recurrent_block_init",
           "recurrent_block_apply", "recurrent_block_step",
           "init_recurrent_state"]

RG_LRU_C = 8.0
F32 = torch.float32


def rglru_init(key, cfg: ModelConfig) -> dict:
    R = cfg.rnn_width
    return {
        "wa": layers.linear_init(key, R, R, F32, bias=True),
        "wx": layers.linear_init(key, R, R, F32, bias=True),
        "lam": torch.full((R,), 2.0, dtype=F32),  # softplus(2) ~ 2.1 -> a ~ exp(-17r)
    }


def _gates(p, x):
    r = torch.sigmoid(layers.linear(p["wa"], x))
    i = torch.sigmoid(layers.linear(p["wx"], x))
    log_a = -RG_LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * x)


def rglru_apply(p: dict, x: torch.Tensor,
                h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, R) f32, h0 (B, R). Returns (h (B,T,R), h_last)."""
    a, b = _gates(p, x)
    h, hs = h0, []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_step(p: dict, x1: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Single decode step. x1 (B, R), h (B, R) -> new h."""
    a, b = _gates(p, x1[:, None, :])
    return a[:, 0] * h + b[:, 0]


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width cfg.rglru_conv_width)
# ---------------------------------------------------------------------------

def conv1d_init(key, cfg: ModelConfig) -> dict:
    R, W = cfg.rnn_width, cfg.rglru_conv_width
    return {
        "w": torch.randn((W, R), generator=key, dtype=F32) / math.sqrt(W),
        "b": torch.zeros((R,), dtype=F32),
    }


def conv1d_apply(p, x, state=None):
    """x (B, T, R); state (B, W-1, R) trailing inputs from the previous chunk.

    Returns (y (B,T,R), new_state (B, W-1, R)).
    """
    B, T, R = x.shape
    W = p["w"].shape[0]
    if state is None:
        state = x.new_zeros((B, W - 1, R))
    xp = torch.cat([state, x], dim=1)  # (B, T+W-1, R)
    y = sum(xp[:, i: i + T] * p["w"][i] for i in range(W)) + p["b"]
    return y, xp[:, -(W - 1):]


# ---------------------------------------------------------------------------
# full temporal block (recurrent flavor)
# ---------------------------------------------------------------------------

def recurrent_block_init(key, cfg: ModelConfig) -> dict:
    R = cfg.rnn_width
    dt = cfg.tdtype
    return {
        "gate": layers.linear_init(key, cfg.d_model, R, dt),
        "inp": layers.linear_init(key, cfg.d_model, R, dt),
        "conv": conv1d_init(key, cfg),
        "lru": rglru_init(key, cfg),
        "out": layers.linear_init(key, R, cfg.d_model, dt),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def recurrent_block_apply(p, cfg: ModelConfig, x, state):
    """x (B,T,D); state {'conv' (B,W-1,R), 'h' (B,R)} -> (y, new_state)."""
    u = _gelu(layers.linear(p["gate"], x).to(F32))
    z = layers.linear(p["inp"], x).to(F32)
    z, conv_state = conv1d_apply(p["conv"], z, state["conv"])
    h, h_last = rglru_apply(p["lru"], z, state["h"])
    y = layers.linear(p["out"], (u * h).to(cfg.tdtype))
    return y, {"conv": conv_state, "h": h_last}


def recurrent_block_step(p, cfg: ModelConfig, x1, state):
    """Decode: x1 (B, 1, D)."""
    u = _gelu(layers.linear(p["gate"], x1).to(F32))[:, 0]
    z = layers.linear(p["inp"], x1).to(F32)
    z, conv_state = conv1d_apply(p["conv"], z, state["conv"])
    h = rglru_step(p["lru"], z[:, 0], state["h"])
    y = layers.linear(p["out"], (u * h).to(cfg.tdtype)[:, None])
    return y, {"conv": conv_state, "h": h}


def init_recurrent_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    R, W = cfg.rnn_width, cfg.rglru_conv_width
    return {
        "conv": torch.zeros((batch, W - 1, R), dtype=F32, device=device),
        "h": torch.zeros((batch, R), dtype=F32, device=device),
    }
