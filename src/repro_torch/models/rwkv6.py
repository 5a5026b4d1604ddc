"""RWKV6 "Finch" block (arXiv:2404.05892) on the port (counterpart of
`repro.models.rwkv6`) — attention-free, data-dependent decay.

Time mixing: token-shift interpolation with data-dependent (LoRA) mix
coefficients, multi-head WKV recurrence with per-channel *input-dependent*
decay w_t = exp(-exp(w0 + lora(x))) and a bonus term u for the current
token. Channel mixing: squared-ReLU FFN with token shift.

The WKV recurrence is a loop over time in f32 (the reference's lax.scan,
step for step). Decode carries (wkv_state (B,H,K,V), shift states) — O(1)
per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

__all__ = ["LORA_RANK", "time_mix_init", "time_mix", "channel_mix_init",
           "channel_mix", "block_init", "block_apply", "init_block_state"]

LORA_RANK = 32
F32 = torch.float32


def _lora_init(key, d_in, d_out, rank, dtype):
    return {
        "a": (torch.randn((d_in, rank), generator=key, dtype=F32)
              * 0.01).to(dtype),
        "b": torch.zeros((rank, d_out), dtype=dtype),
    }


def _lora(p, x):
    return layers.matmul(torch.tanh(layers.matmul(x, p["a"])), p["b"])


def time_mix_init(key, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    K = cfg.rwkv_head_dim
    H = D // K
    dt = cfg.tdtype
    return {
        "mu": torch.full((5, D), 0.5, dtype=F32),          # base mix for w,k,v,r,g
        "lora_mix": _lora_init(key, D, 5 * D, LORA_RANK, F32),
        "w0": torch.zeros((D,), dtype=F32) - 0.5,           # base decay
        "lora_w": _lora_init(key, D, D, 2 * LORA_RANK, F32),
        "u": torch.zeros((H, K), dtype=F32) + 0.1,          # bonus
        "wr": layers.linear_init(key, D, D, dt),
        "wk": layers.linear_init(key, D, D, dt),
        "wv": layers.linear_init(key, D, D, dt),
        "wg": layers.linear_init(key, D, D, dt),
        "wo": layers.linear_init(key, D, D, dt),
        "ln_x": torch.ones((D,), dtype=F32),                # per-head group norm scale
    }


def _wkv_scan(r, k, v, w, u, state0):
    """Multi-head WKV. r,k,w (B,T,H,K); v (B,T,H,K); u (H,K); state0 (B,H,K,K_v).

    y_t = r_t^T (S + u ⊙ k_t v_t^T);  S <- diag(w_t) S + k_t v_t^T
    (all in f32; head value dim == key dim K).
    """
    S = state0
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B,H,K)
        kv = k_t[..., :, None] * v_t[..., None, :]              # (B,H,K,K)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               S + u[None, :, :, None] * kv))
        S = w_t[..., :, None] * S + kv
    return torch.stack(ys, dim=1), S                            # (B,T,H,K), (B,H,K,K)


def _shift(x, x_prev):
    """Token shift: concat last-step feature, drop final. x (B,T,D)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, x, x_prev, wkv_state):
    """x (B,T,D); x_prev (B,D) shift carry; wkv_state (B,H,K,K)."""
    B, T, D = x.shape
    K = cfg.rwkv_head_dim
    H = D // K
    xf = x.to(F32)
    xx = _shift(xf, x_prev) - xf                               # (B,T,D)

    base = xf + xx * p["mu"][0]
    mixes = _lora(p["lora_mix"], base).reshape(B, T, 5, D)

    def mixed(i):
        return (xf + xx * (p["mu"][i] + mixes[:, :, i])).to(cfg.tdtype)
    x_w, x_k, x_v, x_r, x_g = (mixed(i) for i in range(5))

    r = layers.linear(p["wr"], x_r).reshape(B, T, H, K).to(F32)
    k = layers.linear(p["wk"], x_k).reshape(B, T, H, K).to(F32)
    v = layers.linear(p["wv"], x_v).reshape(B, T, H, K).to(F32)
    g = F.silu(layers.linear(p["wg"], x_g).to(F32))

    # data-dependent decay (the Finch contribution)
    w_log = p["w0"] + _lora(p["lora_w"], x_w.to(F32))
    w = torch.exp(-torch.exp(w_log)).reshape(B, T, H, K)

    y, new_state = _wkv_scan(r, k, v, w, p["u"], wkv_state)
    # per-head group norm
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True)
                        + 64e-5)
    y = (y.reshape(B, T, D) * p["ln_x"]) * g
    out = layers.linear(p["wo"], y.to(cfg.tdtype))
    return out, xf[:, -1], new_state


def channel_mix_init(key, cfg: ModelConfig) -> dict:
    dt = cfg.tdtype
    return {
        "mu_k": torch.full((cfg.d_model,), 0.5, dtype=F32),
        "mu_r": torch.full((cfg.d_model,), 0.5, dtype=F32),
        "wk": layers.linear_init(key, cfg.d_model, cfg.d_ff, dt),
        "wr": layers.linear_init(key, cfg.d_model, cfg.d_model, dt),
        "wv": layers.linear_init(key, cfg.d_ff, cfg.d_model, dt),
    }


def channel_mix(p, cfg: ModelConfig, x, x_prev):
    xf = x.to(F32)
    xx = _shift(xf, x_prev) - xf
    xk = (xf + xx * p["mu_k"]).to(cfg.tdtype)
    xr = (xf + xx * p["mu_r"]).to(cfg.tdtype)
    k = torch.square(F.relu(layers.linear(p["wk"], xk)))
    kv = layers.linear(p["wv"], k)
    out = torch.sigmoid(layers.linear(p["wr"], xr).to(F32)).to(cfg.tdtype) * kv
    return out, xf[:, -1]


# ---------------------------------------------------------------------------
# block init / apply (train + decode share code paths: decode is T == 1)
# ---------------------------------------------------------------------------

def block_init(key, cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.norm_init("layernorm", cfg.d_model),
        "tm": time_mix_init(key, cfg),
        "ln2": layers.norm_init("layernorm", cfg.d_model),
        "cm": channel_mix_init(key, cfg),
    }


def block_apply(p, cfg: ModelConfig, x, state):
    """state = {'tm_shift' (B,D), 'cm_shift' (B,D), 'wkv' (B,H,K,K)}."""
    h, tm_shift, wkv = time_mix(
        p["tm"], cfg, layers.apply_norm("layernorm", p["ln1"], x, cfg.norm_eps),
        state["tm_shift"], state["wkv"],
    )
    x = x + h
    h, cm_shift = channel_mix(
        p["cm"], cfg, layers.apply_norm("layernorm", p["ln2"], x, cfg.norm_eps),
        state["cm_shift"],
    )
    x = x + h
    return x, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}


def init_block_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    D = cfg.d_model
    K = cfg.rwkv_head_dim
    H = D // K
    return {
        "tm_shift": torch.zeros((batch, D), dtype=F32, device=device),
        "cm_shift": torch.zeros((batch, D), dtype=F32, device=device),
        "wkv": torch.zeros((batch, H, K, K), dtype=F32, device=device),
    }
