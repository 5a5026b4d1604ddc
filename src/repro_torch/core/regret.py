"""Regret measurement (paper Definition 3 + Theorem 2 bound), in torch.

Counterpart of `repro.core.regret`:

    R = sum_t sum_i f_t^i(w_bar_t)  -  min_w sum_t sum_i f_t^i(w)

The comparator min_w is the best FIXED parameter in hindsight, found by
full-batch subgradient descent over the replayed stream. The stream stays
on the device; the two full-batch products per step are ``torch.matmul``
(the reference leaves them to XLA outside any kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["best_fixed_hinge", "cumulative_regret", "theorem2_bound"]


def best_fixed_hinge(xs: torch.Tensor, ys: torch.Tensor, steps: int = 1500,
                     lr: float = 2.0, lam: float = 0.0) -> torch.Tensor:
    """argmin_w mean hinge loss over the whole stream (full batch).

    xs (..., n), ys (...). Subgradient descent with lr/sqrt(k+1) steps.
    The subgradient is written out: at a margin of exactly 1 the
    reference's ``jax.grad`` of ``maximum(1 - margin, 0)`` splits the tie
    and takes half of -y x, so this does too (torch autograd's tie rule
    differs).
    """
    X = xs.reshape(-1, xs.shape[-1])
    Y = ys.reshape(-1)
    N = X.shape[0]
    k1 = np.arange(1, steps + 1, dtype=np.float32)
    step_sizes = (np.float32(lr) / np.sqrt(k1)).astype(np.float32)
    inv_n = torch.full((), float(np.float32(1.0) / np.float32(N)),
                       dtype=torch.float32, device=X.device)
    w = torch.zeros(X.shape[-1], dtype=torch.float32, device=X.device)
    for k in range(steps):
        margins = Y * (X @ w)
        weight = ((margins < 1.0).to(torch.float32)
                  + 0.5 * (margins == 1.0).to(torch.float32))
        g = X.T @ (Y * -(weight * inv_n))
        if lam:
            g = g + lam * torch.sign(w)
        w = w - float(step_sizes[k]) * g
    return w


def cumulative_regret(per_round_wbar_loss, xs: torch.Tensor, ys: torch.Tensor,
                      m: int, w_star: torch.Tensor | None = None) -> np.ndarray:
    """Cumulative regret curve (length T), per Definition 3.

    per_round_wbar_loss: (T,) mean-over-nodes loss of w_bar_t (so *m gives
    the sum over i). xs (T, m, n), ys (T, m) on the device.
    """
    if w_star is None:
        w_star = best_fixed_hinge(xs, ys)
    margins = ys * (xs @ w_star)
    star_loss = torch.sum(torch.clamp_min(1.0 - margins, 0.0), dim=1)
    alg_loss = torch.as_tensor(per_round_wbar_loss, dtype=torch.float32,
                               device=xs.device) * m
    return torch.cumsum(alg_loss - star_loss, dim=0).cpu().numpy()


def theorem2_bound(T: int, m: int, n: int, L: float, lam: float,
                   R_diam: float, eps: float) -> float:
    """Paper Eq. (17):  R <= R*sqrt((L+lam) m T L)
    + (2*sqrt2 m^2 n T L / eps)(sqrt T - 1/2).

    Host math in Python floats, term for term the reference's. Returned
    for reporting: the noise term's constant is extremely loose for the
    paper's own m and n.
    """
    s1 = R_diam * math.sqrt((L + lam) * m * T * L)
    if math.isinf(eps):
        return s1
    s2 = (2.0 * math.sqrt(2.0) * m * m * n * T * L / eps) * (math.sqrt(T)
                                                              - 0.5)
    return s1 + s2
