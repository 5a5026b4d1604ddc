"""Online Mirror Descent with composite L1 term — the paper's local update.

Counterpart of `repro.core.omd`: the schedules alpha_t and lambda_t =
alpha_t * lambda (Theorem 2), the primal recovery ``omd_primal``, the dual
step ``omd_dual_step`` and the optax-style `OnlineMirrorDescent`
(init/primal/dual_step on tensor pytrees; the mixing lives in
`core.gossip` and `core.algorithm1`). The round loop runs on the host in
Python, so the per-round schedule values and the round counter are host
scalars. They are computed in numpy float32 with the same operations, in
the same order, as the reference's jnp float32 arithmetic, so alpha_t,
lam_t and the noise scale equal the reference's values bit for bit.

>>> import torch
>>> omd = OnlineMirrorDescent(OMDConfig(alpha0=0.1, schedule="constant",
...                                     lam=0.0, prox_kind="none"))
>>> state = omd.init({"w": torch.tensor([1.0, 2.0])})
>>> state = omd.dual_step(state, state.theta, {"w": torch.tensor([0.5, -0.5])})
>>> state.t, omd.primal(state)["w"].tolist()
(1, [0.949999988079071, 2.049999952316284])
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prox, tree

__all__ = ["OMDConfig", "OMDState", "omd_primal", "omd_dual_step",
           "alpha_schedule", "OnlineMirrorDescent"]

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


class OMDState(NamedTuple):
    theta: Any        # dual parameter pytree (same structure as params)
    t: int            # rounds done


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


def omd_dual_step(theta_mixed: Any, grads: Any, alpha_t) -> Any:
    """Step 10 minus the mixing: theta' = theta_mixed - alpha_t * g."""
    return tree.tree_map(
        lambda th, g: (th - float(alpha_t) * g.to(th.dtype)).to(th.dtype),
        theta_mixed, grads)


class OnlineMirrorDescent:
    """optax-style wrapper: init(params) -> state; the gossip strategy calls
    primal()/dual_step() around its own mixing+noise stage."""

    def __init__(self, config: OMDConfig):
        self.config = config
        self._alpha = config.alpha()

    def init(self, params: Any) -> OMDState:
        theta = tree.tree_map(lambda p: torch.as_tensor(p).to(torch.float32),
                              params)
        return OMDState(theta=theta, t=0)

    def alpha_t(self, state: OMDState) -> np.float32:
        return self._alpha(state.t + 1)

    def primal(self, state: OMDState) -> Any:
        a = self.alpha_t(state)
        return omd_primal(state.theta, self.config.lam_t(a),
                          self.config.prox_kind)

    def dual_step(self, state: OMDState, theta_mixed: Any,
                  grads: Any) -> OMDState:
        a = self.alpha_t(state)
        return OMDState(theta=omd_dual_step(theta_mixed, grads, a),
                        t=state.t + 1)
