"""Minimal optax-style optimizers on the port: functional init/update
pairs over pytrees of tensors (`repro_torch.core.tree`: JAX's leaf order),
the counterpart of `repro.optim.optimizers`.

Used for the non-private all-reduce baseline runs; the paper's OMD/GossipDP
optimizer lives in `repro_torch.core` (it needs the mixing/noise stage
between the gradient and the parameter update). Not `torch.optim`: the
state is a tree the caller holds (``step``, and ``mu`` or ``m``/``v`` in
float32 whatever the parameters' dtype), so it can be compared leaf by
leaf, and ``update`` returns the updates, which `apply_updates` adds.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree import leaves, tree_map

__all__ = ["Optimizer", "apply_updates", "sgd", "adamw"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params) -> (updates, state)


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def _first(tree) -> torch.Tensor:
    return leaves(tree)[0]


def _f32(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.float32)


def sgd(lr_schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params) \
            if momentum else None
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_first(params).device), "mu": mu}

    def update(grads, state, params=None):
        lr = lr_schedule(state["step"])
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + _f32(g), state["mu"],
                          grads)
            upd = tree_map(lambda m: -lr * m, mu)
            return upd, {"step": state["step"] + 1, "mu": mu}
        upd = tree_map(lambda g: -lr * _f32(g), grads)
        return upd, {"step": state["step"] + 1, "mu": None}

    return Optimizer(init, update)


def adamw(lr_schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {
            "step": torch.zeros((), dtype=torch.int32,
                                device=_first(params).device),
            "m": tree_map(z, params),
            "v": tree_map(z, params),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_schedule(state["step"])
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * _f32(g), state["m"],
                     grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(_f32(g)),
                     state["v"], grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=step.device),
                            step.to(torch.float32))
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=step.device),
                            step.to(torch.float32))
        upd = tree_map(
            lambda m, v, p: -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                                   + weight_decay * p.to(torch.float32)),
            m, v, params)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
