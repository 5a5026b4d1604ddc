"""OMD schedules — the paper's alpha_t and lambda_t = alpha_t * lambda.

Counterpart of `repro.core.omd` (the schedules and the primal recovery
``omd_primal``; the optax-style wrapper waits in ROADMAP queue 1). The
round loop runs on the host in Python, so the per-round schedule values are
host scalars. They are computed in numpy
float32 with the same operations, in the same order, as the reference's
jnp float32 arithmetic, so alpha_t, lam_t and the noise scale equal the
reference's values bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from repro_torch.core import prox, tree

__all__ = ["OMDConfig", "alpha_schedule", "omd_primal"]

f32 = np.float32
Schedule = Callable[[int], np.float32]


def alpha_schedule(kind: str, alpha0: float, T: int | None = None) -> Schedule:
    """Step-size schedules, as float32 functions of the 1-based round t.

    'theorem2'  : constant alpha = alpha0 / sqrt(T)  (paper Theorem 2).
    'sqrt_t'    : alpha_t = alpha0 / sqrt(t)         (anytime variant).
    'constant'  : alpha_t = alpha0.
    """
    if kind == "theorem2":
        if T is None:
            raise ValueError("theorem2 schedule needs horizon T")
        a = f32(alpha0 / math.sqrt(T))
        return lambda t: a
    if kind == "sqrt_t":
        a0 = f32(alpha0)
        return lambda t: a0 / np.sqrt(f32(max(int(t), 1)))
    if kind == "constant":
        a0 = f32(alpha0)
        return lambda t: a0
    raise ValueError(f"unknown schedule {kind!r}")


@dataclasses.dataclass(frozen=True)
class OMDConfig:
    """Local-optimizer knobs (paper Theorem 2 defaults)."""

    alpha0: float = 0.1
    schedule: str = "sqrt_t"
    lam: float = 0.01          # lambda; lambda_t = alpha_t * lambda (Thm 2)
    T: int | None = None       # horizon, needed by 'theorem2'
    prox_kind: str = "l1"      # 'l1' | 'none' | 'group'

    def alpha(self) -> Schedule:
        return alpha_schedule(self.schedule, self.alpha0, self.T)

    def lam_t(self, alpha_t) -> np.float32:
        return f32(alpha_t) * f32(self.lam)

    def step_context(self, t: int):
        """Schedule values for 1-based round t (the Theorem-2 coupling
        lam_t = alpha_t * lam lives only here)."""
        # deferred: repro_torch.api imports the engine, which imports this
        from repro_torch.api.rules import StepContext
        alpha_t = self.alpha()(t)
        return StepContext(t=int(t), alpha_t=float(alpha_t),
                           lam_t=float(self.lam_t(alpha_t)), lam=self.lam)


def omd_primal(theta: Any, lam_t, prox_kind: str = "l1") -> Any:
    """Steps 6-7 on a pytree: w = prox(grad phi*(theta)) with the l1, group
    or identity prox."""
    p = tree.tree_map(prox.l2_mirror_map, theta)
    if prox_kind == "none":
        return p
    if prox_kind == "l1":
        return prox.soft_threshold_tree(p, lam_t)
    if prox_kind == "group":
        return tree.tree_map(lambda x: prox.group_soft_threshold(x, lam_t), p)
    raise ValueError(prox_kind)
