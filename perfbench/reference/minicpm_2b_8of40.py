"""Plain reference of the LM training steps on MiniCPM-2B's widths.

The model is a pre-norm decoder with tied embeddings, as the configuration
file states (the port's equations; MiniCPM's own embedding, depth and
logit scalings are not among them, see the configuration's
``not_modelled``). Per layer::

    h = x + Attn(RMSNorm(x) * s1)      q, k, v = h_n Wq, h_n Wk, h_n Wv
    x = h + Wdown(silu(Wgate h_n) * Wup h_n),   h_n = RMSNorm(h) * s2

with RoPE on q and k (each head's two halves rotated by position * theta
^(-2i/hd)), causal softmax(q k / sqrt(hd)) v, then RMSNorm(x) * s_f and
logits x E^T over the padded vocabulary, the padded columns masked, and
the mean cross entropy over the labels that are not -1.

Parameters are a flat dict path -> tensor, the paths' sorted order being
the leaf order every per-leaf draw and sum follows::

    embed/table (V_pad, d)          final_norm/scale (d,)
    layers/attn/{wk,wo,wq,wv}/w     (L, d, H hd) / (L, H hd, d)
    layers/ffn/{down,gate,up}/w     (L, f, d) / (L, d, f)
    layers/{ln1,ln2}/scale          (L, d)

Two training steps:

* ``gossip``: Algorithm 1 over ``nodes`` replicas on a ring. Each step t
  recovers w = soft_threshold(theta, alpha_t lam), takes each node's loss
  and gradient at its own w and batch, clips each node's gradient to L2
  norm L over all leaves, draws Laplace(2 alpha_t L / eps) noise leaf by
  leaf (one uniform per coordinate, inverse CDF, over the whole (nodes,
  ...) leaf) from the noise generator, mixes theta + noise with ring
  weights 1/2, 1/4, 1/4 and steps theta <- mixed - alpha_t g.
* ``allreduce``: AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1,
  a linear warm-up over 200 steps, then cosine to a tenth of the peak) on
  one replica, from zero moments at step ``start_step``, the parameters
  stored in the configuration's dtype and updated in float32.

Plain torch in float32 with TF32 off; ``precision="fp8"`` rounds every
matrix product's operands through float8 e4m3 (per-tensor scale) for the
control. It imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["leaf_specs", "padded_vocab", "loss_of", "gossip_steps",
           "allreduce_steps", "schedule", "no_tf32"]

F32 = torch.float32
U_MIN = np.float32(-0.5 + 1e-7)


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def padded_vocab(cfg: dict) -> int:
    """The vocabulary padded to a multiple of 256."""
    return -(-cfg["vocab_size"] // 256) * 256


def leaf_specs(cfg: dict) -> list:
    """[(path, shape, kind)] in leaf order; kind is "matrix" (normal, std
    1/sqrt(rows)), "table" (normal, std 1/sqrt(d)) or "scale" (ones)."""
    L, d, f = cfg["num_layers"], cfg["d_model"], cfg["d_ff"]
    hq = cfg["num_heads"] * cfg["head_dim"]
    hk = cfg["num_kv_heads"] * cfg["head_dim"]
    specs = [
        ("embed/table", (padded_vocab(cfg), d), "table"),
        ("final_norm/scale", (d,), "scale"),
        ("layers/attn/wk/w", (L, d, hk), "matrix"),
        ("layers/attn/wo/w", (L, hq, d), "matrix"),
        ("layers/attn/wq/w", (L, d, hq), "matrix"),
        ("layers/attn/wv/w", (L, d, hk), "matrix"),
        ("layers/ffn/down/w", (L, f, d), "matrix"),
        ("layers/ffn/gate/w", (L, d, f), "matrix"),
        ("layers/ffn/up/w", (L, d, f), "matrix"),
        ("layers/ln1/scale", (L, d), "scale"),
        ("layers/ln2/scale", (L, d), "scale"),
    ]
    assert [s[0] for s in specs] == sorted(s[0] for s in specs)
    return specs


# -- the model --------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with a per-tensor scale; gradients
    pass straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(F32) / s
    return x + (q - x).detach()


def _mm(a, b, precision):
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x, theta):
    """x (B, T, H, hd): each head's halves rotated by position."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                        device=x.device) / hd))
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss_of(p: dict, tokens, labels, cfg: dict, precision: str = "fp32"):
    """Mean cross entropy of one replica's params ``p`` (float32) on
    tokens (B, T) against labels (B, T) (-1 is no label)."""
    B, T = tokens.shape
    H, hd = cfg["num_heads"], cfg["head_dim"]
    Hk = cfg["num_kv_heads"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    x = p["embed/table"][tokens.long()]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for li in range(cfg["num_layers"]):
        def w(name):
            return p[f"layers/{name}"][li]
        h = _rms(x, w("ln1/scale"), eps)
        q = _mm(h, w("attn/wq/w"), precision).reshape(B, T, H, hd)
        k = _mm(h, w("attn/wk/w"), precision).reshape(B, T, Hk, hd)
        v = _mm(h, w("attn/wv/w"), precision).reshape(B, T, Hk, hd)
        q, k = _rope(q, theta), _rope(k, theta)
        if Hk != H:
            k = k.repeat_interleave(H // Hk, dim=2)
            v = v.repeat_interleave(H // Hk, dim=2)
        s = _mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), precision) \
            / math.sqrt(hd)
        s = torch.where(causal, s, -1e30)
        o = _mm(torch.softmax(s, dim=-1), v.transpose(1, 2), precision)
        x = x + _mm(o.transpose(1, 2).reshape(B, T, H * hd),
                    w("attn/wo/w"), precision)
        h = _rms(x, w("ln2/scale"), eps)
        ff = F.silu(_mm(h, w("ffn/gate/w"), precision)) \
            * _mm(h, w("ffn/up/w"), precision)
        x = x + _mm(ff, w("ffn/down/w"), precision)
    x = _rms(x, p["final_norm/scale"], eps)
    logits = _mm(x, p["embed/table"].T, precision)
    V = cfg["vocab_size"]
    if logits.shape[-1] > V:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < V, logits, -1e30)
    mask = labels >= 0
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
    nll = torch.logsumexp(logits, dim=-1) - gold[..., 0]
    return torch.sum(nll * mask) / mask.sum().clamp_min(1)


def _loss_and_grads(p, tokens, labels, cfg, precision):
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = loss_of(live, tokens, labels, cfg, precision)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


# -- gossip ------------------------------------------------------------------

def _unit_laplace(gen, shape):
    span = float(np.float32(0.5) - U_MIN)
    u = torch.rand(shape, generator=gen, dtype=F32, device=gen.device)
    u = torch.clamp_min(u * span + float(U_MIN), float(U_MIN))
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def schedule(train: dict, t: int):
    """alpha_t, lam_t and the noise scale of 1-based step t, in float32."""
    f32 = np.float32
    a = f32(train["alpha0"]) / np.sqrt(f32(max(t, 1)))
    lam_t = f32(a) * f32(train["lam"])
    scale = f32(2.0) * f32(a) * f32(train["clip_norm"]) / f32(train["eps"])
    return float(a), float(lam_t), float(scale)


def _ring_mix(x, self_weight=0.5):
    nw = (1.0 - self_weight) / 2.0
    return (self_weight * x + nw * torch.roll(x, 1, dims=0)
            + nw * torch.roll(x, -1, dims=0))


def gossip_steps(cfg: dict, train: dict, theta0: dict, batches: list,
                 noise_seed: int, precision: str = "fp32",
                 on_first=None) -> dict:
    """Run len(batches) gossip steps from theta0 (path -> (nodes, ...)
    float32); batches[t] = (tokens, labels), each (nodes, B, T). Returns
    each step's loss (mean over nodes), step 1's clipped gradient norm per
    leaf and each leaf's theta after the last step minus theta0 as a norm.
    ``on_first(path, mixed, g)`` sees, leaf by leaf, step 1's ring mix of
    theta0 + noise and clipped gradient, the two that step 1's dual step
    combines."""
    with no_tf32():
        theta = {k: v.clone() for k, v in theta0.items()}
        gen = torch.Generator(device=next(iter(theta.values())).device)
        gen.manual_seed(int(noise_seed))
        nodes = next(iter(theta.values())).shape[0]
        L = float(train["clip_norm"])
        losses, grad1 = [], None
        for t, (tokens, labels) in enumerate(batches, start=1):
            alpha, lam_t, scale = schedule(train, t)
            grads = {k: torch.empty_like(v) for k, v in theta.items()}
            step_loss = []
            for i in range(nodes):
                p = {k: torch.sign(v[i]) * torch.clamp_min(v[i].abs() - lam_t,
                                                           0.0)
                     for k, v in theta.items()}
                loss, g = _loss_and_grads(p, tokens[i], labels[i], cfg,
                                          precision)
                del p
                norm = torch.sqrt(sum(torch.sum(gk * gk) for gk in g.values()))
                factor = torch.clamp_max(L / torch.clamp_min(norm, 1e-12), 1.0)
                for k in grads:
                    grads[k][i] = g[k] * factor
                del g
                step_loss.append(loss)
            losses.append(float(torch.stack(step_loss).mean()))
            if t == 1:
                grad1 = {k: float(torch.linalg.vector_norm(v))
                         for k, v in grads.items()}
            for k in sorted(theta):
                tilde = theta[k] + scale * _unit_laplace(gen, theta[k].shape)
                mixed = _ring_mix(tilde)
                del tilde
                if t == 1 and on_first is not None:
                    on_first(k, mixed, grads[k])
                theta[k] = mixed - alpha * grads[k]
                del mixed
                grads[k] = None
        change = {k: float(torch.linalg.vector_norm(theta[k] - theta0[k]))
                  for k in theta}
    return {"losses": losses, "grad1": grad1, "change": change}


# -- all-reduce AdamW ----------------------------------------------------------

B1, B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1
WARMUP, FINAL_FRAC = 200, 0.1


def adamw_lr(train: dict, step: int) -> float:
    """Linear warm-up to lr over WARMUP steps, then cosine to FINAL_FRAC
    of it at ``total_steps``; ``step`` counts from 0."""
    lr = train["lr"]
    if step < WARMUP:
        return lr * step / WARMUP
    frac = min((step - WARMUP) / max(train["total_steps"] - WARMUP, 1), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return lr * (FINAL_FRAC + (1 - FINAL_FRAC) * cos)


def allreduce_steps(cfg: dict, train: dict, params0: dict, batches: list,
                    dtypes: dict, precision: str = "fp32",
                    on_first=None) -> dict:
    """Run len(batches) AdamW steps from params0 (path -> one replica's
    params in their stored dtype) and zero moments, the optimizer's step
    count starting at ``train["start_step"]``; batches[t] = (tokens,
    labels), each (B, T). Returns each step's loss, step 1's gradient norm
    per leaf and each leaf's change after the last step as a norm.
    ``on_first(path, None, g)`` sees step 1's gradient leaf by leaf."""
    b1, b2, eps, wd = B1, B2, ADAM_EPS, WEIGHT_DECAY
    start = int(train["start_step"])
    with no_tf32():
        params = {k: v.clone() for k, v in params0.items()}
        m = {k: torch.zeros_like(v, dtype=F32) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v, dtype=F32) for k, v in params.items()}
        losses, grad1 = [], None
        for step, (tokens, labels) in enumerate(batches):
            p32 = {k: v.to(F32) for k, v in params.items()}
            loss, g = _loss_and_grads(p32, tokens, labels, cfg, precision)
            losses.append(float(loss))
            if step == 0:
                grad1 = {k: float(torch.linalg.vector_norm(g[k])) for k in g}
                for k in (sorted(g) if on_first is not None else ()):
                    on_first(k, None, g[k])
            lr = adamw_lr(train, start + step)
            n = start + step + 1
            bc1, bc2 = 1 - b1 ** n, 1 - b2 ** n
            for k in params:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
                upd = -lr * ((m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps)
                             + wd * p32[k])
                params[k] = (p32[k] + upd).to(dtypes[k])
            del p32, g
        change = {k: float(torch.linalg.vector_norm(
            params[k].to(F32) - params0[k].to(F32))) for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}
