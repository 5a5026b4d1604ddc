"""Mechanism — the privacy stage of the round pipeline.

Counterpart of `repro.api.mechanisms`. A Mechanism owns (a) the per-round
noise scale, calibrated to the Lemma-1 sensitivity of the broadcast theta~,
and (b) the sampler that perturbs the egress copies, drawn from an explicit
`torch.Generator`. ``sample`` is ``scale * unit(...)``: a subclass that
overrides ``unit`` (the tests replay the reference's draws that way) keeps
the port's own scale.

Calibrations (Laplace):
  'global'     — the paper's exact Lemma-1 L1 sensitivity 2*alpha_t*sqrt(n)*L
  'coordinate' — per-coordinate sensitivity 2*alpha_t*L.
Gaussian: (eps, delta)-DP with sigma = sqrt(2 ln(1.25/delta)) * 2*alpha_t*L
/ eps.

>>> from repro_torch.api import MECHANISMS
>>> mech = MECHANISMS.build("laplace", eps=2.0, L=1.0,
...                         calibration="coordinate")
>>> mech.scale(0.5, n=100)                      # 2 * alpha_t * L / eps
0.5
>>> MECHANISMS.build("none").is_private
False
>>> gauss = MECHANISMS.build("gaussian", eps=1.0, delta=1e-5)
>>> round(gauss.scale(0.5, n=100), 4)      # sqrt(2 ln 1.25e5) * 2 * 0.5
4.8448
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.registry import MECHANISMS
from repro_torch.core.privacy import laplace_scale, unit_laplace

__all__ = ["Mechanism", "LaplaceMechanism", "GaussianMechanism", "NoNoise"]

f32 = np.float32


@runtime_checkable
class Mechanism(Protocol):
    """Privacy stage: per-round scale + sampler for the broadcast noise."""

    noise_self: bool  # faithful Algorithm 1 mixes noisy theta~ for j == i too

    @property
    def is_private(self) -> bool: ...

    def scale(self, alpha_t, n: int) -> float:
        """Noise scale for a round with step size alpha_t and dimension n."""
        ...

    def sample(self, generator: torch.Generator, shape,
               scale: float) -> torch.Tensor:
        """Draw the egress perturbation (zeros when scale == 0)."""
        ...


@dataclasses.dataclass(frozen=True)
class LaplaceMechanism:
    """The paper's mechanism: Laplace(S(t)/eps) on every broadcast (Eq. 8).

    eps = inf is exactly the non-private path: scale 0 and zero noise.
    """

    eps: float = 1.0
    L: float = 1.0
    calibration: str = "global"   # 'global' (Lemma 1) | 'coordinate'
    noise_self: bool = True

    def __post_init__(self):
        if self.calibration not in ("global", "coordinate"):
            raise ValueError(f"unknown calibration {self.calibration!r}")

    @property
    def is_private(self) -> bool:
        return not math.isinf(self.eps)

    def scale(self, alpha_t, n: int) -> float:
        if not self.is_private:
            return 0.0
        if self.calibration == "coordinate":
            return float(f32(2.0) * f32(alpha_t) * f32(self.L)
                         / f32(self.eps))
        return float(laplace_scale(alpha_t, n, self.L, self.eps))

    def unit(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Laplace(0, 1) draws that ``sample`` scales."""
        return unit_laplace(generator, shape)

    def sample(self, generator, shape, scale):
        if float(scale) == 0.0:
            return torch.zeros(shape, dtype=torch.float32,
                               device=generator.device)
        return float(scale) * self.unit(generator, shape)


@dataclasses.dataclass(frozen=True)
class GaussianMechanism:
    """(eps, delta)-DP Gaussian noise with the classic analytic calibration
    sigma = sqrt(2 ln(1.25/delta)) * S2(t) / eps, where the L2 sensitivity
    of theta~ is S2(t) = 2 * alpha_t * L (no sqrt(n): the L2 ball of
    Assumption 2.3 is dimension-free). eps = inf gives zero noise."""

    eps: float = 1.0
    delta: float = 1e-5
    L: float = 1.0
    noise_self: bool = True

    @property
    def is_private(self) -> bool:
        return not math.isinf(self.eps)

    def scale(self, alpha_t, n: int) -> float:
        if not self.is_private:
            return 0.0
        c = math.sqrt(2.0 * math.log(1.25 / self.delta))
        return float(f32(c * 2.0) * f32(alpha_t) * f32(self.L)
                     / f32(self.eps))

    def unit(self, generator: torch.Generator, shape) -> torch.Tensor:
        """N(0, 1) draws that ``sample`` scales."""
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)

    def sample(self, generator, shape, scale):
        if float(scale) == 0.0:
            return torch.zeros(shape, dtype=torch.float32,
                               device=generator.device)
        return float(scale) * self.unit(generator, shape)


@dataclasses.dataclass(frozen=True)
class NoNoise:
    """Explicit non-private mechanism (plain gossip averaging baseline)."""

    noise_self: bool = True

    @property
    def is_private(self) -> bool:
        return False

    def scale(self, alpha_t, n: int) -> float:
        return 0.0

    def sample(self, generator, shape, scale):
        return torch.zeros(shape, dtype=torch.float32,
                           device=generator.device)


@MECHANISMS.register("laplace")
def _laplace(eps: float = 1.0, L: float = 1.0, calibration: str = "global",
             noise_self: bool = True) -> Mechanism:
    """The paper's Laplace mechanism (Eq. 8)."""
    return LaplaceMechanism(eps=eps, L=L, calibration=calibration,
                            noise_self=noise_self)


@MECHANISMS.register("gaussian")
def _gaussian(eps: float = 1.0, L: float = 1.0, delta: float = 1e-5,
              noise_self: bool = True) -> Mechanism:
    """(eps, delta)-DP Gaussian mechanism (analytic calibration)."""
    return GaussianMechanism(eps=eps, delta=delta, L=L,
                             noise_self=noise_self)


@MECHANISMS.register("none")
def _none(noise_self: bool = True) -> Mechanism:
    """No noise (non-private baseline)."""
    return NoNoise(noise_self=noise_self)
