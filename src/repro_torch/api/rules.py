"""LocalRule — the node-local sparse-online-learning stage.

Counterpart of `repro.api.rules`. A rule defines the two halves of steps
6-10 that are not mixing: primal recovery (state -> prediction weights) and
the dual step (mixed state + clipped gradient -> next state). Rules act on
single (m, ...) tensors; the distributed engine maps them over node-stacked
leaves, so one implementation serves both engines.

Families (paper §I):
  'omd' — the paper's rule: mirror descent + Lasso prox (Algorithm 1),
          prox 'l1', 'group' or 'none'.
  'tg'  — truncated gradient (Langford, Li & Zhang '09, ref [11]):
          gossip mixes w itself; w <- shrink(w_mixed - a g, a lam).
  'rda' — L1 regularized dual averaging (Xiao '10, ref [12]): gossip mixes
          the cumulative gradient G; w = -(sqrt(t)/gamma) shrink(G/t, lam).

>>> import torch
>>> from repro_torch.api import LOCAL_RULES, StepContext
>>> rule = LOCAL_RULES.build("omd", prox_kind="l1")
>>> ctx = StepContext(t=1, alpha_t=1.0, lam_t=1.0, lam=1.0)
>>> rule.primal(torch.tensor([[0.5, -2.0, 0.1]]), ctx).tolist()
[[0.0, -1.0, 0.0]]
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.registry import LOCAL_RULES
from repro_torch.core import prox

__all__ = ["StepContext", "LocalRule", "OMDLassoRule",
           "TruncatedGradientRule", "RDARule"]


class StepContext(NamedTuple):
    """Per-round schedule values (host scalars).

    t is the 1-based round index; alpha_t and lam_t = alpha_t * lam are
    float32 values held as Python floats; lam is the raw strength.
    """

    t: int
    alpha_t: float
    lam_t: float
    lam: float


@runtime_checkable
class LocalRule(Protocol):
    """Local update stage: primal recovery + dual step, mixing-agnostic."""

    def init_state(self, params: torch.Tensor) -> torch.Tensor:
        """Initial dual state for one leaf of model parameters."""
        ...

    def primal(self, theta: torch.Tensor, ctx: StepContext) -> torch.Tensor:
        """State -> prediction weights w_t (steps 6-7)."""
        ...

    def dual_step(self, mixed: torch.Tensor, grad: torch.Tensor,
                  ctx: StepContext) -> torch.Tensor:
        """Post-mixing state + clipped grad -> next state (step 10)."""
        ...


_PROX = {
    "l1": lambda p, lam_t: prox.soft_threshold(p, lam_t),
    "none": lambda p, lam_t: p,
    "group": lambda p, lam_t: prox.group_soft_threshold(p, lam_t),
}


@dataclasses.dataclass(frozen=True)
class OMDLassoRule:
    """The paper's rule: identity mirror map + composite prox (Thm 2)."""

    prox_kind: str = "l1"

    def __post_init__(self):
        if self.prox_kind not in _PROX:
            raise ValueError(f"unknown prox_kind {self.prox_kind!r}")

    def init_state(self, params):
        return params  # theta_1 = model init (identity mirror map)

    def primal(self, theta, ctx):
        return _PROX[self.prox_kind](prox.l2_mirror_map(theta), ctx.lam_t)

    def dual_step(self, mixed, grad, ctx):
        return mixed - ctx.alpha_t * grad.to(mixed.dtype)


@dataclasses.dataclass(frozen=True)
class TruncatedGradientRule:
    """Ref [11]: the state IS w; shrink after every gradient step."""

    def init_state(self, params):
        return params  # state is w itself

    def primal(self, theta, ctx):
        return theta

    def dual_step(self, mixed, grad, ctx):
        return prox.soft_threshold(
            mixed - ctx.alpha_t * grad.to(mixed.dtype), ctx.lam_t)


@dataclasses.dataclass(frozen=True)
class RDARule:
    """Ref [12]: the state is the running gradient sum G; w from the
    l1-RDA closed form with the sqrt(t)/gamma schedule (scalars in f32, as
    the reference computes them; G/t a true division on any device)."""

    gamma: float = 1.0

    def init_state(self, params):
        # the state is the cumulative gradient sum G, not the weights —
        # seeding it with a model init would corrupt the RDA iterate
        return torch.zeros_like(params)

    def primal(self, theta, ctx):
        tf = np.float32(max(int(ctx.t), 1))
        gbar = theta / torch.tensor(tf, dtype=theta.dtype,
                                    device=theta.device)
        coef = -(np.sqrt(tf) / np.float32(self.gamma))
        return float(coef) * prox.soft_threshold(gbar, ctx.lam)

    def dual_step(self, mixed, grad, ctx):
        return mixed + grad.to(mixed.dtype)


@LOCAL_RULES.register("omd")
def _omd(prox_kind: str = "l1") -> LocalRule:
    """The paper's OMD + Lasso prox rule."""
    return OMDLassoRule(prox_kind=prox_kind)


@LOCAL_RULES.register("tg", "truncated_gradient")
def _tg() -> LocalRule:
    """Truncated gradient (ref [11])."""
    return TruncatedGradientRule()


@LOCAL_RULES.register("rda")
def _rda(gamma: float = 1.0) -> LocalRule:
    """L1 regularized dual averaging (ref [12])."""
    return RDARule(gamma=gamma)
