"""Mixture-of-Experts layer on the port (counterpart of `repro.models.moe`):
top-k router + sort-based capacity dispatch.

Used by mixtral-8x7b (8 experts, top-2, softmax gate) and llama4-scout
(16 experts, top-1, sigmoid gate + always-on shared expert).

Assignments are sorted by expert id (a stable sort, so an expert's
assignments keep token order), each expert processes a fixed-capacity
(E, C, D) buffer with a batched matmul, and overflowed assignments
(position >= C in their expert's group) go to a discarded slot C — the
reference's drop rule, so the same assignments are dropped. The combine
adds each token's kept outputs in the sorted order (`index_add_`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core import loops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import check_axis

__all__ = ["grouped_dispatch", "current_dispatch_groups", "moe_init",
           "moe_apply"]

F32 = torch.float32

# grouped-dispatch context (the reference's serving/dry-run perf variants)
_DISPATCH_GROUPS: list = [1]
_DISPATCH_AXIS: list = [None]


@contextlib.contextmanager
def grouped_dispatch(groups: int, axis: str | None = None):
    """Split each MoE layer's tokens into ``groups`` dispatch groups (the
    capacity per group is C/G). ``axis`` shards the group dim over a mesh
    axis in the reference; the port's one-process LM runs on one device,
    so the axis is checked against the active mesh
    (`repro_torch.sharding.rules.check_axis`) and changes no value."""
    _DISPATCH_GROUPS.append(groups)
    _DISPATCH_AXIS.append(axis)
    try:
        yield
    finally:
        _DISPATCH_GROUPS.pop()
        _DISPATCH_AXIS.pop()


def current_dispatch_groups() -> int:
    return _DISPATCH_GROUPS[-1]


def moe_init(key, cfg: ModelConfig) -> dict:
    E = cfg.num_experts
    d, f = cfg.d_model, cfg.d_ff
    std_in = 1.0 / torch.sqrt(torch.tensor(float(d)))
    std_out = 1.0 / torch.sqrt(torch.tensor(float(f)))

    def normal(shape, std):
        return (torch.randn(shape, generator=key, dtype=F32)
                * std).to(cfg.tdtype)

    p = {
        "router": layers.linear_init(key, d, E, F32),  # router in f32
        "gate": normal((E, d, f), std_in),
        "up": normal((E, d, f), std_in),
        "down": normal((E, f, d), std_out),
    }
    if cfg.shared_expert:
        from repro_torch.models import mlp as mlp_mod
        p["shared"] = mlp_mod.mlp_init(key, cfg)
    return p


def _router(p, cfg: ModelConfig, xf: torch.Tensor):
    """Returns (weights (N, k), expert_idx (N, k), aux_loss scalar)."""
    logits = layers.linear(p["router"], xf.to(F32))  # (N, E)
    k = cfg.num_experts_per_tok
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    if k == 1:
        weights = torch.sigmoid(top_logits)  # llama4-style gate
    else:
        weights = torch.softmax(top_logits, dim=-1)  # mixtral renormalized

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    probs = torch.softmax(logits, dim=-1)
    E = cfg.num_experts
    # primary assignment fraction (F.one_hot's values; one_hot itself
    # takes other ops on each backend, this one the same ops on all)
    assign = (top_idx[:, 0, None] == torch.arange(
        E, device=top_idx.device)).to(F32)
    f_e = assign.mean(dim=0)
    P_e = probs.mean(dim=0)
    aux = E * torch.sum(f_e * P_e)
    return weights, top_idx, aux


def capacity(cfg: ModelConfig, N: int) -> int:
    """Capacity per expert (static): the reference's rounding."""
    C = int(max(1, round(N * cfg.num_experts_per_tok / cfg.num_experts
                         * cfg.moe_capacity_factor)))
    return min(C, N)


def _dispatch(top_idx: torch.Tensor, E: int, C: int):
    """The sorted assignments: (order, eid_s, tok_s, slot, keep) — slot C
    holds every assignment past its expert's capacity."""
    N, k = top_idx.shape
    Nk = N * k
    eid = top_idx.reshape(Nk)
    tok = torch.arange(N, device=top_idx.device).repeat_interleave(k)
    order = torch.argsort(eid, stable=True)
    eid_s, tok_s = eid[order], tok[order]
    # position of each assignment within its expert group
    starts = torch.searchsorted(eid_s, torch.arange(E, device=eid.device),
                                side="left")
    pos_s = torch.arange(Nk, device=eid.device) - starts[eid_s]
    keep = pos_s < C
    slot = torch.where(keep, pos_s, C)  # overflow slot C is discarded
    return order, eid_s, tok_s, slot, keep


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              dispatch_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (y (B, T, D), aux_loss).

    dispatch_groups > 1 splits tokens into G independent dispatch groups
    (capacity per group C/G, same total); aux is the mean of the groups'.
    """
    if dispatch_groups > 1:
        B, T, D = x.shape
        N = B * T
        G = dispatch_groups
        assert N % G == 0, (N, G)
        xg = x.reshape(G, 1, N // G, D)
        check_axis(_DISPATCH_AXIS[-1], "grouped_dispatch")
        groups = loops.loop(G, x)
        outs = groups.full([moe_apply(p, cfg, xg[i], 1) for i in groups])
        y = torch.stack([o[0] for o in outs]).reshape(B, T, D)
        return y, torch.mean(torch.stack([o[1] for o in outs]))

    B, T, D = x.shape
    N = B * T
    E = cfg.num_experts
    xf = x.reshape(N, D)

    weights, top_idx, aux = _router(p, cfg, xf)
    C = capacity(cfg, N)
    order, eid_s, tok_s, slot, keep = _dispatch(top_idx, E, C)
    wgt_s = weights.reshape(-1)[order]

    # ---- scatter tokens into (E, C+1, D) buffers ----
    buf = x.new_zeros((E, C + 1, D))
    buf = buf.index_put((eid_s, slot), xf[tok_s])
    buf = buf[:, :C]  # (E, C, D)

    # ---- expert FFN: batched SwiGLU over the expert axis ----
    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    y_buf = torch.bmm(h, p["down"])  # (E, C, D)

    # ---- gather back + weighted combine ----
    y_assign = y_buf[eid_s, torch.clamp(slot, max=C - 1)]
    y_assign = torch.where(keep[:, None], y_assign, 0.0) * \
        wgt_s[:, None].to(x.dtype)
    y = x.new_zeros((N, D)).index_add(0, tok_s, y_assign)

    if cfg.shared_expert:
        from repro_torch.models import mlp as mlp_mod
        y = y + mlp_mod.mlp(p["shared"], cfg, xf)
    return y.reshape(B, T, D), aux * cfg.router_aux_coef
