"""Decoder-only model assembly for every non-enc-dec family, on the port
(counterpart of `repro.models.transformer`).

Families:
  dense        — attn + SwiGLU          (qwen2-7b, minicpm, internlm2, qwen3, qwen2-vl)
  moe          — attn + MoE             (mixtral, llama4-scout)
  rwkv6        — RWKV6 blocks           (rwkv6-3b)
  rglru_hybrid — (rec, rec, attn) + MLP (recurrentgemma)

Parameters are nested dicts of tensors whose paths are the reference's
pytree paths. Homogeneous families keep stacked (L, ...) layer leaves and
apply them layer by layer; the hybrid pattern keeps a list of per-layer
dicts. Multimodal archs (vlm/audio decoder-only) consume stub frontend
embeddings via early fusion: the first ``frontend_tokens`` positions of
the sequence are replaced by the provided embeddings.

The public surface is ``build_model(cfg, device) -> Model`` with pure
functions:
  init(key) -> params        (key: an int seed or a torch.Generator on
                              the model's device)
  apply(params, tokens, frontend=None, last_only=False) -> (logits, aux_loss)
  loss_fn(params, batch) -> (loss, metrics)
  init_cache(batch, cache_len) -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)

``cfg.remat`` recomputes each layer's forward in the backward pass
(`torch.utils.checkpoint`) while autograd records; it changes no value.
The layer loops are `repro_torch.core.loops.loop`s (a dry-run counts
the first, the last and one of each kind of middle layer, weighted).

``sp_residual(axis)`` is the reference's sequence-parallel residual
stream, which shards the between-layer activations' time dim over
``axis``. The port's one-process LM runs on one device: the axis is
checked against the active mesh (`repro_torch.sharding.rules.check_axis`)
and changes no value.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import loops
from repro_torch.device import shape_device
from repro_torch.models import attention, layers, mlp, moe, rglru, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.sharding.rules import check_axis

__all__ = ["Model", "layer_kinds", "build_model", "sp_residual"]

F32 = torch.float32


class Model(NamedTuple):
    cfg: ModelConfig
    init: Any
    apply: Any
    loss_fn: Any
    init_cache: Any
    decode_step: Any
    prime_cache: Any = None  # enc-dec only: fill cross-attn K/V from encoder


def generator(key, device: torch.device) -> torch.Generator:
    """``key`` as a generator that draws on ``device``: an int seeds a new
    one (a CPU generator serves the "meta" device)."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device if device.type == "cuda" else "cpu")
    gen.manual_seed(int(key))
    return gen


def stacked_init(n: int, init_one) -> dict:
    """``n`` draws of ``init_one()`` stacked on a leading axis, leaf by leaf
    (the reference's ``jax.vmap`` of a layer init), holding one layer at a
    time beside the stack."""
    first = init_one()
    out = tree_map(lambda l: l.new_empty((n,) + tuple(l.shape)), first)
    for i in range(n):
        tree_map(lambda s, l: s[i].copy_(l), out,
                 first if i == 0 else init_one())
    return out


def layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) tree (views)."""
    return tree_map(lambda l: l[i], tree)


def stack(trees: list):
    """Per-layer trees stacked on a leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), trees[0], *trees[1:])


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward pass under cfg.remat."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(loops.replayed(fn), *args, use_reentrant=False)
    return fn(*args)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the labels >= 0 (the reference's loss_fn)."""
    mask = labels >= 0
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1)


# ---------------------------------------------------------------------------
# per-layer init/apply by family
# ---------------------------------------------------------------------------

def _layer_init(key, cfg: ModelConfig, kind: str) -> dict:
    if kind == "rwkv":
        return rwkv6.block_init(key, cfg)
    p = {"ln1": layers.norm_init(cfg.norm, cfg.d_model),
         "ln2": layers.norm_init(cfg.norm, cfg.d_model)}
    if kind in ("attn", "local_attn"):
        p["attn"] = attention.attn_init(key, cfg)
        p["ffn"] = mlp.mlp_init(key, cfg)
    elif kind == "moe":
        p["attn"] = attention.attn_init(key, cfg)
        p["moe"] = moe.moe_init(key, cfg)
    elif kind == "rec":
        p["rec"] = rglru.recurrent_block_init(key, cfg)
        p["ffn"] = mlp.mlp_init(key, cfg)
    else:
        raise ValueError(kind)
    return p


_SP_RESIDUAL_AXIS: list = [None]


@contextlib.contextmanager
def sp_residual(axis: str | None):
    _SP_RESIDUAL_AXIS.append(axis)
    try:
        yield
    finally:
        _SP_RESIDUAL_AXIS.pop()


def _layer_apply(p, cfg: ModelConfig, kind: str, x, positions):
    """Full-sequence (train/prefill) layer. Returns (x, aux)."""
    check_axis(_SP_RESIDUAL_AXIS[-1], "sp_residual")
    aux = torch.zeros((), dtype=F32, device=x.device)
    if kind == "rwkv":
        state = rwkv6.init_block_state(cfg, x.shape[0], x.device)
        x, _ = rwkv6.block_apply(p, cfg, x, state)
        return x, aux
    xn = layers.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if kind in ("attn", "moe"):
        h = attention.attention_full(p["attn"], cfg, xn, positions)
    elif kind == "local_attn":
        h = attention.attention_full(p["attn"], cfg, xn, positions,
                                     window=cfg.local_attn_window)
    elif kind == "rec":
        st = rglru.init_recurrent_state(cfg, x.shape[0], x.device)
        h, _ = rglru.recurrent_block_apply(p["rec"], cfg, xn, st)
    x = x + h
    xn = layers.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        h, aux = moe.moe_apply(p["moe"], cfg, xn,
                               dispatch_groups=moe.current_dispatch_groups())
    else:
        h = mlp.mlp(p["ffn"], cfg, xn)
    return x + h, aux


def _layer_decode(p, cfg: ModelConfig, kind: str, x, pos, cache):
    """One-token decode layer. Returns (x, new_cache)."""
    if kind == "rwkv":
        return rwkv6.block_apply(p, cfg, x, cache)  # T == 1 works natively
    xn = layers.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if kind in ("attn", "moe"):
        h, cache_attn = attention.attention_decode(p["attn"], cfg, xn, pos,
                                                   cache["attn"])
        cache = {**cache, "attn": cache_attn}
    elif kind == "local_attn":
        h, cache_attn = attention.attention_decode(
            p["attn"], cfg, xn, pos, cache["attn"],
            window=cfg.local_attn_window)
        cache = {**cache, "attn": cache_attn}
    elif kind == "rec":
        h, rec_state = rglru.recurrent_block_step(p["rec"], cfg, xn,
                                                  cache["rec"])
        cache = {**cache, "rec": rec_state}
    x = x + h
    xn = layers.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    if kind == "moe":
        h, _ = moe.moe_apply(p["moe"], cfg, xn)
    else:
        h = mlp.mlp(p["ffn"], cfg, xn)
    return x + h, cache


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int):
    if kind == "rwkv":
        return rwkv6.init_block_state(cfg, batch)
    c = {}
    if kind in ("attn", "moe"):
        c["attn"] = attention.init_attn_cache(cfg, batch, cache_len,
                                              cfg.tdtype)
    elif kind == "local_attn":
        c["attn"] = attention.init_attn_cache(
            cfg, batch, min(cache_len, cfg.local_attn_window), cfg.tdtype)
    elif kind == "rec":
        c["rec"] = rglru.init_recurrent_state(cfg, batch)
    return c


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "dense":
        return ["attn"] * cfg.num_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    if cfg.family == "rwkv6":
        return ["rwkv"] * cfg.num_layers
    if cfg.family == "rglru_hybrid":
        pat = cfg.hybrid_pattern
        return [("rec" if pat[i % len(pat)] == "rec" else "local_attn")
                for i in range(cfg.num_layers)]
    raise ValueError(cfg.family)


def _is_homogeneous(cfg: ModelConfig) -> bool:
    kinds = layer_kinds(cfg)
    return cfg.scan_layers and all(k == kinds[0] for k in kinds)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def build_model(cfg: ModelConfig, device="cuda") -> Model:
    kinds = layer_kinds(cfg)
    homogeneous = _is_homogeneous(cfg)
    dev = shape_device(device)

    # ---- init ----
    def init(key) -> dict:
        gen = generator(key, dev)
        with torch.device(dev):
            params = {
                "embed": layers.embed_init(gen, cfg.vocab_padded,
                                           cfg.d_model, cfg.tdtype),
                "final_norm": layers.norm_init(cfg.norm, cfg.d_model),
            }
            if not cfg.tie_embeddings:
                params["unembed"] = layers.linear_init(
                    gen, cfg.d_model, cfg.vocab_padded, cfg.tdtype)
            if homogeneous:
                params["layers"] = stacked_init(
                    cfg.num_layers, lambda: _layer_init(gen, cfg, kinds[0]))
            else:
                params["layers"] = [_layer_init(gen, cfg, kinds[i])
                                    for i in range(cfg.num_layers)]
        return params

    def _logits(params, x):
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = layers.unembed(params["embed"], x)
        else:
            logits = layers.linear(params["unembed"], x).to(F32)
        return layers.mask_padded_vocab(logits, cfg.vocab_size)

    def _embed_inputs(params, tokens, frontend):
        x = layers.embed(params["embed"], tokens)
        if cfg.frontend is not None and frontend is not None:
            ft = frontend.shape[1]
            x = torch.cat([frontend.to(x.dtype), x[:, ft:]], dim=1)
        return x

    # ---- full-sequence apply ----
    def apply(params, tokens, frontend: Optional[torch.Tensor] = None,
              last_only: bool = False):
        """last_only: return logits for the final position only — prefill
        never needs the (B, T, V) logits tensor."""
        B, T = tokens.shape
        x = _embed_inputs(params, tokens, frontend)
        positions = attention.default_positions(B, T, cfg, device=x.device)

        def layer_fn(lp, kind, x):
            return _layer_apply(lp, cfg, kind, x, positions)

        auxes = []
        layer_loop = loops.loop(cfg.num_layers, x, key=kinds.__getitem__)
        if not homogeneous:
            layer_loop.stand_in(params["layers"])
        for i in layer_loop:
            lp = layer(params["layers"], i) if homogeneous \
                else params["layers"][i]
            x, a = remat(cfg, layer_fn, lp, kinds[i], x)
            auxes.append(a)
        aux = torch.sum(torch.stack(layer_loop.full(auxes)))
        if last_only:
            x = x[:, -1:]
        return _logits(params, x), aux

    # ---- loss ----
    def loss_fn(params, batch):
        logits, aux = apply(params, batch["tokens"], batch.get("frontend"))
        ce = ce_loss(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    # ---- decode ----
    def init_cache(batch: int, cache_len: int):
        with torch.device(dev):
            if homogeneous:
                one = _layer_cache(cfg, kinds[0], batch, cache_len)
                return tree_map(lambda l: l[None].expand(
                    (cfg.num_layers,) + tuple(l.shape)).clone(), one)
            return [_layer_cache(cfg, kinds[i], batch, cache_len)
                    for i in range(cfg.num_layers)]

    def decode_step(params, cache, tokens, pos):
        """tokens (B, 1) int; pos (B,) absolute positions."""
        x = layers.embed(params["embed"], tokens)
        new_cache = []
        layer_loop = loops.loop(cfg.num_layers, x, key=kinds.__getitem__)
        for i in layer_loop:
            if homogeneous:
                lp, lc = layer(params["layers"], i), layer(cache, i)
            else:
                lp, lc = params["layers"][i], cache[i]
            x, c = _layer_decode(lp, cfg, kinds[i], x, pos, lc)
            new_cache.append(c)
        new_cache = layer_loop.full(new_cache)
        return _logits(params, x), (stack(new_cache) if homogeneous
                                    else new_cache)

    return Model(cfg=cfg, init=init, apply=apply, loss_fn=loss_fn,
                 init_cache=init_cache, decode_step=decode_step)
