"""Encoder-decoder backbone (seamless-m4t-medium, arXiv:2308.11596) on the
port (counterpart of `repro.models.encdec`).

Transformer backbone ONLY: the speech frontend (mel-spectrogram + conv
feature extractor) is stubbed — ``apply`` consumes precomputed frame
embeddings (B, S_enc, D). Encoder = bidirectional self-attention; decoder
= causal self-attention + cross-attention over the encoder memory + FFN.
M4T's relative positional scheme is approximated by RoPE on
self-attention, as the reference does.

Decode: self-attn ring cache + cross-attn K/V precomputed once from memory.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import shape_device
from repro_torch.core import loops
from repro_torch.models import attention, layers, mlp
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Model, ce_loss, generator, layer,
                                            remat, stack, stacked_init)
from repro_torch.core.tree import tree_map

__all__ = ["cross_attn_init", "cross_kv", "cross_attend", "build_encdec"]

NEG_INF = attention.NEG_INF
F32 = torch.float32


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

def cross_attn_init(key, cfg: ModelConfig) -> dict:
    hd = cfg.dims_per_head
    dt = cfg.tdtype
    return {
        "wq": layers.linear_init(key, cfg.d_model, cfg.num_heads * hd, dt),
        "wk": layers.linear_init(key, cfg.d_model, cfg.kv_heads * hd, dt),
        "wv": layers.linear_init(key, cfg.d_model, cfg.kv_heads * hd, dt),
        "wo": layers.linear_init(key, cfg.num_heads * hd, cfg.d_model, dt),
    }


def cross_kv(p, cfg: ModelConfig, memory):
    B, S, _ = memory.shape
    hd = cfg.dims_per_head
    k = layers.linear(p["wk"], memory).reshape(B, S, cfg.kv_heads, hd)
    v = layers.linear(p["wv"], memory).reshape(B, S, cfg.kv_heads, hd)
    return k, v


def cross_attend(p, cfg: ModelConfig, x, k, v):
    """x (B, T, D) queries over precomputed memory K/V (B, S, Kv, hd)."""
    B, T, _ = x.shape
    hd = cfg.dims_per_head
    Kv, g = cfg.kv_heads, cfg.num_heads // cfg.kv_heads
    q = layers.linear(p["wq"], x).reshape(B, T, Kv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("btkgh,bskh->bkgts", q.to(F32), k.to(F32)) * scale
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", prob, v.to(F32))
    o = o.reshape(B, T, cfg.num_heads * hd).to(x.dtype)
    return layers.linear(p["wo"], o)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _enc_layer_init(key, cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.norm_init(cfg.norm, cfg.d_model),
        "attn": attention.attn_init(key, cfg),
        "ln2": layers.norm_init(cfg.norm, cfg.d_model),
        "ffn": mlp.mlp_init(key, cfg),
    }


def _dec_layer_init(key, cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.norm_init(cfg.norm, cfg.d_model),
        "attn": attention.attn_init(key, cfg),
        "ln_x": layers.norm_init(cfg.norm, cfg.d_model),
        "cross": cross_attn_init(key, cfg),
        "ln2": layers.norm_init(cfg.norm, cfg.d_model),
        "ffn": mlp.mlp_init(key, cfg),
    }


def _enc_layer(p, cfg: ModelConfig, x, positions):
    xn = layers.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    # bidirectional: full attention without causal mask
    B, T, _ = x.shape
    q, k, v = attention._project_qkv(p["attn"], cfg, xn, positions)
    pos = torch.arange(T, device=x.device)
    h = attention._full_attention(q, k, v, pos, pos, None, None, causal=False)
    x = x + layers.linear(p["attn"]["wo"], h.reshape(B, T, -1))
    xn = layers.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp.mlp(p["ffn"], cfg, xn)


def _dec_layer(p, cfg: ModelConfig, x, positions, mem_k, mem_v):
    xn = layers.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    x = x + attention.attention_full(p["attn"], cfg, xn, positions)
    xn = layers.apply_norm(cfg.norm, p["ln_x"], x, cfg.norm_eps)
    x = x + cross_attend(p["cross"], cfg, xn, mem_k, mem_v)
    xn = layers.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp.mlp(p["ffn"], cfg, xn)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def build_encdec(cfg: ModelConfig, device="cuda") -> Model:
    assert cfg.encoder_layers > 0
    dev = shape_device(device)

    def init(key):
        gen = generator(key, dev)
        with torch.device(dev):
            return {
                "embed": layers.embed_init(gen, cfg.vocab_padded,
                                           cfg.d_model, cfg.tdtype),
                "enc_layers": stacked_init(
                    cfg.encoder_layers, lambda: _enc_layer_init(gen, cfg)),
                "enc_norm": layers.norm_init(cfg.norm, cfg.d_model),
                "dec_layers": stacked_init(
                    cfg.num_layers, lambda: _dec_layer_init(gen, cfg)),
                "final_norm": layers.norm_init(cfg.norm, cfg.d_model),
            }

    def encode(params, frames):
        """frames (B, S_enc, D) — stub frontend embeddings."""
        B, S, _ = frames.shape
        positions = attention.default_positions(B, S, cfg,
                                                device=frames.device)
        x = frames.to(cfg.tdtype)

        def enc_fn(lp, x):
            return _enc_layer(lp, cfg, x, positions)

        for i in loops.loop(cfg.encoder_layers, x):
            x = remat(cfg, enc_fn, layer(params["enc_layers"], i), x)
        return layers.apply_norm(cfg.norm, params["enc_norm"], x, cfg.norm_eps)

    def _logits(params, x):
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return layers.mask_padded_vocab(layers.unembed(params["embed"], x),
                                        cfg.vocab_size)

    def apply(params, tokens, frontend: Optional[torch.Tensor] = None,
              last_only: bool = False):
        """frontend = encoder frame embeddings (required)."""
        memory = encode(params, frontend)
        B, T = tokens.shape
        positions = attention.default_positions(B, T, cfg,
                                                device=tokens.device)
        x = layers.embed(params["embed"], tokens)

        def dec_fn(lp, x):
            k, v = cross_kv(lp["cross"], cfg, memory)
            return _dec_layer(lp, cfg, x, positions, k, v)

        for i in loops.loop(cfg.num_layers, x):
            x = remat(cfg, dec_fn, layer(params["dec_layers"], i), x)
        if last_only:
            x = x[:, -1:]
        return _logits(params, x), torch.zeros((), dtype=F32,
                                               device=x.device)

    def loss_fn(params, batch):
        logits, aux = apply(params, batch["tokens"], batch["frontend"])
        ce = ce_loss(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(batch: int, cache_len: int):
        with torch.device(dev):
            one = attention.init_attn_cache(cfg, batch, cache_len, cfg.tdtype)
            self_cache = tree_map(lambda l: l[None].expand(
                (cfg.num_layers,) + tuple(l.shape)).clone(), one)
            # cross K/V filled by prime_cache from the encoder memory
            hd = cfg.dims_per_head
            S = max(cache_len // 4, 8)  # encoder frames (see configs/seamless)
            zeros = torch.zeros((cfg.num_layers, batch, S, cfg.kv_heads, hd),
                                dtype=cfg.tdtype)
        return {"self": self_cache, "cross_k": zeros, "cross_v": zeros}

    def prime_cache(params, cache, frames):
        """Run the encoder once and fill the cross-attention K/V."""
        memory = encode(params, frames)
        kvs = [cross_kv(layer(params["dec_layers"], i)["cross"], cfg, memory)
               for i in range(cfg.num_layers)]
        return {**cache, "cross_k": torch.stack([k for k, _ in kvs]),
                "cross_v": torch.stack([v for _, v in kvs])}

    def decode_step(params, cache, tokens, pos):
        x = layers.embed(params["embed"], tokens)
        new_self = []
        layer_loop = loops.loop(cfg.num_layers, x)
        for i in layer_loop:
            lp, self_c = layer(params["dec_layers"], i), layer(cache["self"], i)
            xn = layers.apply_norm(cfg.norm, lp["ln1"], x, cfg.norm_eps)
            h, self_c = attention.attention_decode(lp["attn"], cfg, xn, pos,
                                                   self_c)
            x = x + h
            xn = layers.apply_norm(cfg.norm, lp["ln_x"], x, cfg.norm_eps)
            x = x + cross_attend(lp["cross"], cfg, xn, cache["cross_k"][i],
                                 cache["cross_v"][i])
            xn = layers.apply_norm(cfg.norm, lp["ln2"], x, cfg.norm_eps)
            x = x + mlp.mlp(lp["ffn"], cfg, xn)
            new_self.append(self_c)
        return _logits(params, x), {**cache,
                                    "self": stack(layer_loop.full(new_self))}

    return Model(cfg=cfg, init=init, apply=apply, loss_fn=loss_fn,
                 init_cache=init_cache, decode_step=decode_step,
                 prime_cache=prime_cache)
