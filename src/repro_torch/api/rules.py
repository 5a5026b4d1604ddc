"""LocalRule — the node-local sparse-online-learning stage.

Counterpart of `repro.api.rules`. A rule defines the two halves of steps
6-10 that are not mixing: primal recovery (state -> prediction weights) and
the dual step (mixed state + clipped gradient -> next state). This slice
ports the paper's rule, 'omd' (mirror descent + Lasso prox) with prox 'l1'
or 'none'; 'tg', 'rda' and the group prox wait in ROADMAP queue 1.

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

import torch

from repro_torch.api.registry import LOCAL_RULES
from repro_torch.core import prox

__all__ = ["StepContext", "LocalRule", "OMDLassoRule"]


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
}


@dataclasses.dataclass(frozen=True)
class OMDLassoRule:
    """The paper's rule: identity mirror map + composite prox (Thm 2)."""

    prox_kind: str = "l1"

    def __post_init__(self):
        if self.prox_kind not in _PROX:
            raise NotImplementedError(
                f"prox_kind {self.prox_kind!r} is not ported to repro_torch "
                f"(ported: {sorted(_PROX)}); the rest waits in ROADMAP "
                "queue 1")

    def init_state(self, params):
        return params  # theta_1 = model init (identity mirror map)

    def primal(self, theta, ctx):
        return _PROX[self.prox_kind](prox.l2_mirror_map(theta), ctx.lam_t)

    def dual_step(self, mixed, grad, ctx):
        return mixed - ctx.alpha_t * grad.to(mixed.dtype)


@LOCAL_RULES.register("omd")
def _omd(prox_kind: str = "l1") -> LocalRule:
    """The paper's OMD + Lasso prox rule."""
    return OMDLassoRule(prox_kind=prox_kind)
