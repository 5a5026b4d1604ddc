"""Attention on the port (counterpart of `repro.models.attention`): GQA/MHA,
RoPE + M-RoPE, qk-norm, QKV bias, sliding window, blockwise
(memory-efficient) prefill with a flash-style backward, and ring-buffer
KV-cache decode.

Design notes
------------
* GQA is computed grouped — queries reshaped to (B, T, kv_heads, group, hd)
  and contracted against un-repeated K/V.
* Sequences longer than ``BLOCKWISE_THRESHOLD`` use the reference's
  two-level blockwise softmax (query chunks, then key chunks, online
  max/denominator). Scores and the p @ v product accumulate in f32 (the
  reference's ``preferred_element_type``); the probabilities are cast to
  the input dtype before p @ v, as the reference casts them. A key chunk
  wholly after a query chunk is skipped: there the reference's update
  multiplies by exp(0) = 1 and adds exp(-1e30 - m) = 0, so skipping it
  changes no value. The chunk loops are `repro_torch.core.loops.loop`s:
  a dry-run counts one query chunk of each key-chunk count, and a few key
  chunks of each.
* ``flash_vjp(True)`` routes blockwise attention through `_FlashAttention`,
  whose forward saves only (o, m, l) and whose backward recomputes the
  score tiles chunk by chunk (the reference's ``_flash_bwd``).
* The decode cache is a ring buffer of ``cache_len`` slots with an explicit
  per-slot absolute-position array: full causal, sliding-window and the
  window_500k long-context variant all fall out of one mask rule
  (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - window).
* Not scaled_dot_product_attention: the reference's order of operations
  is what the tests hold the port to.
* The sharding context managers of the reference: ``head_padding`` changes
  the computation (zero query heads per kv group for GQA, dummy q/k/v
  heads for MHA, sliced away before ``wo``; exact) and is ported as such.
  ``sequence_parallel``, ``batch_parallel`` and the axis of
  ``head_padding`` only constrain placement in the reference. The port's
  one-process LM runs on one device, so the axis each names is recorded
  and checked against the active mesh (`repro_torch.sharding.rules.
  check_axis`), not placed; they change no value.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch

from repro_torch.core import loops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import check_axis

__all__ = ["BLOCKWISE_THRESHOLD", "Q_CHUNK", "K_CHUNK", "NEG_INF",
           "sequence_parallel", "head_padding", "batch_parallel",
           "flash_vjp", "flash_query_chunk", "rope_inv_freq",
           "default_positions", "apply_rope",
           "attn_init", "attention_full", "init_attn_cache",
           "attention_decode"]

BLOCKWISE_THRESHOLD = 2048
Q_CHUNK = 512
K_CHUNK = 1024
NEG_INF = -1e30

F32 = torch.float32

# sequence-parallel attention: the reference shards blockwise attention's
# time dim over this axis; here the axis is recorded and checked
_SEQ_PARALLEL_AXIS: list = [None]


@contextlib.contextmanager
def sequence_parallel(axis: str | None):
    _SEQ_PARALLEL_AXIS.append(axis)
    try:
        yield
    finally:
        _SEQ_PARALLEL_AXIS.pop()


# head padding: pad each kv group's query heads (GQA) or every head (MHA)
# so the head count divides ``multiple``; exact (padded outputs are sliced
# away before wo). The axis is the reference's head-sharding axis.
_HEAD_PAD_MULTIPLE: list = [None]
_HEAD_PAD_AXIS: list = [None]


@contextlib.contextmanager
def head_padding(multiple: int | None, axis: str | None = None):
    _HEAD_PAD_MULTIPLE.append(multiple)
    _HEAD_PAD_AXIS.append(axis)
    try:
        yield
    finally:
        _HEAD_PAD_MULTIPLE.pop()
        _HEAD_PAD_AXIS.pop()


def _padded_group(cfg, H: int, Kv: int) -> int:
    mult = _HEAD_PAD_MULTIPLE[-1]
    if mult is None or H % mult == 0:
        return H // Kv
    g = H // Kv
    # smallest g' >= g with Kv*g' % mult == 0
    g2 = g
    while (Kv * g2) % mult:
        g2 += 1
    return g2


def _pad_dim(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero slices appended along ``dim``."""
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _maybe_pad_heads(q, k, v, cfg):
    """Pad heads so the head dim divides the active multiple.

    GQA (g > 1): pad each kv group with zero QUERY heads (k/v untouched).
    MHA/per-head (g == 1): pad BOTH q and k/v with dummy heads — each real
    head still attends only its own kv, dummy outputs are sliced away.
    Returns (q, k, v, H_orig, kv_padded: bool).
    """
    B, T, H, hd = q.shape
    Kv = cfg.kv_heads
    g = H // Kv
    mult = _HEAD_PAD_MULTIPLE[-1]
    if mult is None or H % mult == 0:
        return q, k, v, H, False
    if g > 1:
        g2 = _padded_group(cfg, H, Kv)
        qg = _pad_dim(q.reshape(B, T, Kv, g, hd), 3, g2 - g)
        return qg.reshape(B, T, Kv * g2, hd), k, v, H, False
    # MHA: pad q AND kv heads to the next multiple
    H2 = -(-H // mult) * mult
    return (_pad_dim(q, 2, H2 - H), _pad_dim(k, 2, H2 - H),
            _pad_dim(v, 2, H2 - H), H, True)


def _maybe_unpad_heads(o, cfg, H_orig, kv_padded):
    B, T, H2, hd = o.shape
    if H2 == H_orig:
        return o
    if kv_padded:  # MHA padding: plain head slice
        return o[:, :, :H_orig]
    Kv = cfg.kv_heads
    g = H_orig // Kv
    og = o.reshape(B, T, Kv, H2 // Kv, hd)[:, :, :, :g]
    return og.reshape(B, T, H_orig, hd)


# batch-parallel attention: the reference shards q/k/v's batch dim over
# this axis (training); here the axis is recorded and checked
_BATCH_PARALLEL_AXIS: list = [None]


@contextlib.contextmanager
def batch_parallel(axis: str | None):
    _BATCH_PARALLEL_AXIS.append(axis)
    try:
        yield
    finally:
        _BATCH_PARALLEL_AXIS.pop()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    hd = cfg.dims_per_head
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=F32, device=device) / hd))


def default_positions(batch: int, seq: int, cfg: ModelConfig, offset=0,
                      device=None) -> torch.Tensor:
    """Text positions. For M-RoPE, the 3 channels (t, h, w) coincide for text."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.rope_style == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x (B, T, H, hd); positions (B, T) or (B, T, 3) for mrope."""
    if cfg.rope_style == "none":
        return x
    inv_freq = rope_inv_freq(cfg, x.device)  # (hd/2,)
    if cfg.rope_style == "mrope":
        # Each frequency belongs to a section; section s reads positions[..., s].
        sections = cfg.mrope_sections
        assert sum(sections) == inv_freq.shape[0], (sections, inv_freq.shape)
        sec_id = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(sections, device=x.device),
            output_size=inv_freq.shape[0])                        # (hd/2,)
        pos = positions.to(F32)[..., sec_id]    # (B, T, hd/2): per-frequency
        angles = pos * inv_freq[None, None, :]
    else:
        angles = positions.to(F32)[..., None] * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # (B, T, 1, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.to(F32)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_init(key, cfg: ModelConfig) -> dict:
    hd = cfg.dims_per_head
    dt, bias = cfg.tdtype, cfg.use_qkv_bias
    p = {
        "wq": layers.linear_init(key, cfg.d_model, cfg.num_heads * hd, dt, bias),
        "wk": layers.linear_init(key, cfg.d_model, cfg.kv_heads * hd, dt, bias),
        "wv": layers.linear_init(key, cfg.d_model, cfg.kv_heads * hd, dt, bias),
        "wo": layers.linear_init(key, cfg.num_heads * hd, cfg.d_model, dt),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=F32)
        p["k_norm"] = torch.ones((hd,), dtype=F32)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    B, T, _ = x.shape
    hd = cfg.dims_per_head
    q = layers.linear(p["wq"], x).reshape(B, T, cfg.num_heads, hd)
    k = layers.linear(p["wk"], x).reshape(B, T, cfg.kv_heads, hd)
    v = layers.linear(p["wv"], x).reshape(B, T, cfg.kv_heads, hd)
    if cfg.use_qk_norm:
        q = layers.rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def _dot32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum accumulated and returned in f32 (the reference's
    ``preferred_element_type=jnp.float32``)."""
    return torch.einsum(eq, a.to(F32), b.to(F32))


# ---------------------------------------------------------------------------
# full (quadratic) attention — short sequences
# ---------------------------------------------------------------------------

def _full_attention(q, k, v, pos_q, pos_k, window, softcap, causal=True):
    """q (B,T,H,hd), k/v (B,S,Kv,hd). Grouped GQA. Returns (B,T,H,hd)."""
    B, T, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, Kv, g, hd)
    s = _dot32("btkgh,bskh->bkgts", qg, k) * scale
    s = _softcap(s, softcap)
    mask = (torch.ones((T, S), dtype=torch.bool, device=q.device)
            if not causal else pos_k[None, :] <= pos_q[:, None])
    if window is not None:
        mask = mask & (pos_k[None, :] > (pos_q[:, None] - window))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", p, v.to(F32))
    return o.reshape(B, T, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# blockwise attention — long sequences (online softmax over KV chunks)
# ---------------------------------------------------------------------------

def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, T, ...) tensor by ``pad`` rows."""
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                     dim=1) if pad else x


def _tile_mask(qi, kj, q_chunk, k_chunk, S, window, device):
    pos_q = qi * q_chunk + torch.arange(q_chunk, device=device)
    pos_k = kj * k_chunk + torch.arange(k_chunk, device=device)
    mask = (pos_k[None, :] <= pos_q[:, None]) & (pos_k[None, :] < S)
    if window is not None:
        mask = mask & (pos_k[None, :] > (pos_q[:, None] - window))
    return mask


def _key_chunks(qi: int, q_chunk: int, k_chunk: int, nk: int) -> int:
    """How many key chunks query chunk ``qi`` reads: those not wholly in
    its future (the rest would be exact no-ops, see the module notes)."""
    return min(nk, ((qi + 1) * q_chunk - 1) // k_chunk + 1)


def _blockwise_fwd_stats(q, k, v, window, softcap, q_chunk, k_chunk):
    """Causal blockwise attention (positions are arange: self-attention),
    with the per-row (m, l) stats: o (B,T,H,hd), m and l (nq,B,Kv,g,qc)."""
    B, T, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    scale = 1.0 / math.sqrt(hd)
    pad_q = (-T) % q_chunk
    pad_k = (-S) % k_chunk
    Tq, Sk = T + pad_q, S + pad_k
    nq, nk = Tq // q_chunk, Sk // k_chunk
    io_dtype = q.dtype
    qp = _pad_time(q, pad_q).reshape(B, nq, q_chunk, Kv, g, hd)
    kp = _pad_time(k, pad_k).reshape(B, nk, k_chunk, Kv, hd)
    vp = _pad_time(v, pad_k).reshape(B, nk, k_chunk, Kv, hd)
    outs, ms, ls = [], [], []
    n_k = functools.partial(_key_chunks, q_chunk=q_chunk, k_chunk=k_chunk,
                            nk=nk)
    q_loop = loops.loop(nq, q, key=n_k)
    for qi in q_loop:
        q_blk = qp[:, qi]                           # (B, qc, Kv, g, hd)
        m = torch.full((B, Kv, g, q_chunk), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros((B, Kv, g, q_chunk), dtype=F32, device=q.device)
        acc = torch.zeros((B, Kv, g, q_chunk, hd), dtype=F32,
                          device=q.device)
        for kj in loops.loop(n_k(qi), q):
            s = _dot32("bqkgh,bskh->bkgqs", q_blk, kp[:, kj]) * scale
            s = _softcap(s, softcap)
            mask = _tile_mask(qi, kj, q_chunk, k_chunk, S, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + _dot32(
                "bkgqs,bskh->bkgqh", p.to(io_dtype), vp[:, kj])
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)  # (B, Kv, g, qc, hd)
        outs.append(o.permute(0, 3, 1, 2, 4))           # (B, qc, Kv, g, hd)
        ms.append(m)
        ls.append(l)
    o = torch.cat(q_loop.full(outs), dim=1).reshape(B, Tq, Kv * g,
                                                    hd)[:, :T]
    return (o.to(q.dtype), torch.stack(q_loop.full(ms)),
            torch.stack(q_loop.full(ls)))


def _blockwise_attention(q, k, v, window, softcap, q_chunk=Q_CHUNK,
                         k_chunk=K_CHUNK):
    """Causal blockwise attention; positions are arange (self-attention)."""
    check_axis(_SEQ_PARALLEL_AXIS[-1], "sequence_parallel")
    return _blockwise_fwd_stats(q, k, v, window, softcap, q_chunk,
                                k_chunk)[0]


def _flash_bwd(window, softcap, q_chunk, k_chunk, res, do):
    """The reference's flash backward: the score tiles recomputed chunk by
    chunk from (q, k, v, o, m, l); returns (dq, dk, dv)."""
    q, k, v, o, ms, ls = res
    B, T, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    scale = 1.0 / math.sqrt(hd)
    io_dtype = q.dtype
    pad_q = (-T) % q_chunk
    pad_k = (-S) % k_chunk
    Tq, Sk = T + pad_q, S + pad_k
    nq, nk = Tq // q_chunk, Sk // k_chunk
    qp = _pad_time(q, pad_q).reshape(B, nq, q_chunk, Kv, g, hd)
    kp = _pad_time(k, pad_k).reshape(B, nk, k_chunk, Kv, hd)
    vp = _pad_time(v, pad_k).reshape(B, nk, k_chunk, Kv, hd)
    dop = _pad_time(do, pad_q).reshape(B, nq, q_chunk, Kv, g, hd).to(F32)
    op = _pad_time(o, pad_q).reshape(B, nq, q_chunk, Kv, g, hd).to(F32)
    # D_i = rowsum(do * o) per query row — (nq, B, Kv, g, qc)
    D = torch.einsum("bnqkgh,bnqkgh->nbkgq", dop, op)
    dk = torch.zeros((B, nk, k_chunk, Kv, hd), dtype=F32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    n_k = functools.partial(_key_chunks, q_chunk=q_chunk, k_chunk=k_chunk,
                            nk=nk)
    q_loop = loops.loop(nq, q, key=n_k)
    for qi in q_loop:
        q_blk, do_blk = qp[:, qi], dop[:, qi].to(io_dtype)
        m_blk, l_blk, D_blk = ms[qi], ls[qi], D[qi]
        dq = torch.zeros((B, q_chunk, Kv, g, hd), dtype=F32, device=q.device)
        for kj in loops.loop(n_k(qi), q):     # wholly future: p = 0
            k_blk, v_blk = kp[:, kj], vp[:, kj]
            s = _dot32("bqkgh,bskh->bkgqs", q_blk, k_blk) * scale
            s = _softcap(s, softcap)
            mask = _tile_mask(qi, kj, q_chunk, k_chunk, S, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - m_blk[..., None]) / torch.clamp(
                l_blk[..., None], min=1e-30)                  # (B,Kv,g,qc,kc)
            dp = _dot32("bqkgh,bskh->bkgqs", do_blk, v_blk)
            ds = p * (dp - D_blk[..., None])
            dv[:, kj] += _dot32("bkgqs,bqkgh->bskh", p.to(io_dtype), do_blk)
            dk[:, kj] += _dot32("bkgqs,bqkgh->bskh", ds.to(io_dtype),
                                q_blk) * scale
            dq = dq + _dot32("bkgqs,bskh->bqkgh", ds.to(io_dtype),
                             k_blk) * scale
        dqs.append(dq)
    dq = torch.cat(q_loop.full(dqs), dim=1).reshape(B, Tq, H, hd)[:, :T]
    dk = dk.reshape(B, Sk, Kv, hd)[:, :S]
    dv = dv.reshape(B, Sk, Kv, hd)[:, :S]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Blockwise attention whose backward is `_flash_bwd` (the reference's
    ``_flash_attention_jax`` custom VJP): the forward keeps (o, m, l)
    only, never the probability tiles."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap, q_chunk, k_chunk):
        o, m, l = _blockwise_fwd_stats(q, k, v, window, softcap, q_chunk,
                                       k_chunk)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.static = (window, softcap, q_chunk, k_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.static, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None


def _flash_attention(q, k, v, window, softcap, q_chunk=Q_CHUNK,
                     k_chunk=K_CHUNK):
    return _FlashAttention.apply(q, k, v, window, softcap, q_chunk, k_chunk)


# flip to route blockwise attention through the flash backward
_FLASH_VJP: list = [False]

# the flash path's query chunk: the reference's dry-run flag ``bigq`` sets
# its module's Q_CHUNK, which only its flash path reads at call time; the
# port scopes the change
_FLASH_Q_CHUNK: list = [Q_CHUNK]


@contextlib.contextmanager
def flash_query_chunk(q_chunk: int):
    _FLASH_Q_CHUNK.append(q_chunk)
    try:
        yield
    finally:
        _FLASH_Q_CHUNK.pop()


@contextlib.contextmanager
def flash_vjp(enabled: bool = True):
    _FLASH_VJP.append(enabled)
    try:
        yield
    finally:
        _FLASH_VJP.pop()


# ---------------------------------------------------------------------------
# public: training / prefill
# ---------------------------------------------------------------------------

def attention_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   window: Optional[int] = "cfg") -> torch.Tensor:
    """Causal self-attention over a whole sequence (training & prefill)."""
    B, T, _ = x.shape
    if positions is None:
        positions = default_positions(B, T, cfg, device=x.device)
    if window == "cfg":
        window = cfg.sliding_window
    q, k, v = _project_qkv(p, cfg, x, positions)
    check_axis(_BATCH_PARALLEL_AXIS[-1], "batch_parallel")
    check_axis(_HEAD_PAD_AXIS[-1], "head_padding")
    q, k, v, H_orig, kv_padded = _maybe_pad_heads(q, k, v, cfg)
    if T <= BLOCKWISE_THRESHOLD:
        pos = torch.arange(T, device=x.device)
        o = _full_attention(q, k, v, pos, pos, window, cfg.attn_logit_softcap)
    elif _FLASH_VJP[-1]:
        o = _flash_attention(q, k, v, window, cfg.attn_logit_softcap,
                             _FLASH_Q_CHUNK[-1])
    else:
        o = _blockwise_attention(q, k, v, window, cfg.attn_logit_softcap)
    o = _maybe_unpad_heads(o, cfg, H_orig, kv_padded)
    return layers.linear(p["wo"], o.reshape(B, T, -1))


# ---------------------------------------------------------------------------
# decode with ring-buffer KV cache
# ---------------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                    device=None) -> dict:
    hd = cfg.dims_per_head
    shape = (batch, cache_len, cfg.kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                               device=device),
    }


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache: dict,
                     window: Optional[int] = "cfg") -> tuple[torch.Tensor, dict]:
    """One-token decode. x (B, 1, D); pos (B,) absolute positions.

    The cache is a ring buffer: slot = pos % cache_len. Works for full causal
    (cache_len >= max_len) and windowed decode (cache_len >= window).
    Returns the output and a new cache (the given one is not written).
    """
    B, one, _ = x.shape
    assert one == 1
    if window == "cfg":
        window = cfg.sliding_window
    C = cache["k"].shape[1]
    hd = cfg.dims_per_head
    if cfg.rope_style == "mrope":
        positions = pos[:, None, None].expand(B, 1, 3)
    else:
        positions = pos[:, None]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)

    slot = (pos % C).long()  # (B,)
    rows = torch.arange(B, device=x.device)
    k_cache = cache["k"].clone()
    v_cache = cache["v"].clone()
    slot_pos = cache["slot_pos"].clone()
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    slot_pos[rows, slot] = pos.to(torch.int32)

    Kv, g = cfg.kv_heads, cfg.num_heads // cfg.kv_heads
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Kv, g, hd)
    s = _dot32("bkgh,bckh->bkgc", qg, k_cache) * scale
    s = _softcap(s, cfg.attn_logit_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid = valid & (slot_pos > (pos[:, None] - window))
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", prob, v_cache.to(F32))
    o = o.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    y = layers.linear(p["wo"], o)
    return y, {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}
