"""Functional NN primitives on the port (counterpart of
`repro.models.layers`): params are plain nested dicts of tensors.

Initializers draw from ``key``, a `torch.Generator`, on the current default
device (the model's `init` sets it: see `repro_torch.models.transformer`);
apply functions are pure. All matmul params are created in cfg.dtype (bf16
for full configs), norms in f32 for stability. Mixed-dtype products take
JAX's promotion (bf16 with f32 computes in f32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import unembed_gemm
from repro_torch.obs import active

__all__ = ["linear_init", "linear", "embed_init", "embed", "unembed",
           "norm_init", "apply_norm", "rms_head_norm", "activation",
           "mask_padded_vocab", "softmax_cross_entropy", "matmul"]

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(key, shape, dtype, stddev):
    return (torch.randn(shape, generator=key, dtype=torch.float32)
            * stddev).to(dtype)


def linear_init(key, d_in: int, d_out: int, dtype, bias: bool = False) -> dict:
    p = {"w": _normal(key, (d_in, d_out), dtype, 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's dtype promotion (torch refuses mixed dtypes)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(key, vocab: int, d_model: int, dtype) -> dict:
    # 1/sqrt(d) keeps tied-unembedding logits O(1) at init
    return {"table": _normal(key, (vocab, d_model), dtype,
                             1.0 / math.sqrt(d_model))}


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


def kernel_path(x: torch.Tensor, table: torch.Tensor) -> bool:
    """Whether `unembed` takes `unembed_gemm.TiedUnembed`: bf16 x and
    table (a bf16 product is exact in f32, so the kernels' bf16 passes
    compute the f32 product), rows of 16 bytes and a vocabulary of whole
    16-byte logit groups. The wrapper launches the kernels on a CUDA
    device and runs their plain versions on CPU and meta tensors."""
    return (x.dtype == table.dtype == torch.bfloat16
            and x.shape[-1] % 8 == 0 and table.shape[0] % 4 == 0)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding (logits in f32 for a stable softmax/CE): ``x.to(f32)
    @ table.to(f32).T``, through `unembed_gemm.TiedUnembed` where
    `kernel_path` holds. Counters ``unembed.kernel_calls`` and
    ``unembed.plain_calls`` say which path each call took."""
    table = p["table"]
    kernel = kernel_path(x, table)
    tel = active()
    if tel.enabled:
        tel.metrics.counter("unembed.kernel_calls" if kernel
                            else "unembed.plain_calls").inc()
    if kernel:
        return unembed_gemm.TiedUnembed.apply(x, table)
    return x.to(torch.float32) @ table.to(torch.float32).T


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, dim: int) -> dict:
    p = {"scale": torch.ones((dim,), dtype=torch.float32)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32)
    return p


def apply_norm(kind: str, p: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1,
                                         keepdim=True) + eps)
        return (xf * p["scale"]).to(x.dtype)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        return (xf * p["scale"] + p["bias"]).to(x.dtype)
    raise ValueError(kind)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over the last (head_dim) axis — qwen3 qk_norm."""
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1,
                                     keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# activations / losses
# ---------------------------------------------------------------------------

def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def mask_padded_vocab(logits: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """-1e30 in the padded vocab columns (see ModelConfig.vocab_padded)."""
    V = logits.shape[-1]
    if V == vocab_real:
        return logits
    col = torch.arange(V, device=logits.device)
    return torch.where(col < vocab_real, logits, -1e30)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits (..., V) f32, labels (...) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
