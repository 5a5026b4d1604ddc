"""LR schedules: each a function of the step (an int or an integer tensor)
that returns a float32 0-d tensor, as `repro.optim.schedules`' do.
``wsd`` is the MiniCPM warmup-stable-decay schedule [arXiv:2404.06395]
used by the minicpm-2b recipe.

>>> float(wsd(1.0, warmup=10, stable=50, decay=40)(5))
0.5
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine", "warmup_cosine", "wsd"]


def _step(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.as_tensor(step)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step(step).device)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clip(_step(step) / total_steps, 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = _step(step)
        w = torch.clip(step / max(warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, lr * w, cos(step - warmup))
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat stable phase,
    exponential-ish decay over the last `decay` steps."""
    def f(step):
        step = _step(step).to(torch.float32)
        warm = lr * step / max(warmup, 1)
        t = torch.clip((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = lr * torch.pow(torch.tensor(final_frac, dtype=torch.float32,
                                          device=step.device), t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, lr), dec))
    return f
