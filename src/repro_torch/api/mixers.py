"""Mixer — the gossip topology stage of the round pipeline.

Counterpart of `repro.api.mixers`. A Mixer applies the doubly-stochastic
A(t) of Assumption 1 along axis 0 (the node axis) of an (m, n) tensor. The
mix signature carries both the clean theta and the noised broadcast copy
theta~, so the mixer owns the noise-placement algebra: with
``noise_self=True`` (Algorithm 1 line 10) the self-term uses theta~; with
False the own-noise contribution ``diag(A) * (theta~ - theta)`` is removed.

Delayed (WAN) mixing: the engine keeps a (depth, m, n) ring of past theta~
broadcasts and hands it to :meth:`MixerBase.mix_history`. Round t writes
slot t % depth, so the copy from d rounds ago lives at slot (t - d) % depth.
The round counter is a host int here, so the ring primitives index
directly; ``ring_write`` writes in place (the ring belongs to the engine
state, which the round replaces).

This slice ports the ring (`RingRollMixer`, with ``torch.roll``) and the
uniform delay wrapper; the other topologies wait in ROADMAP queue 1.

>>> import torch
>>> from repro_torch.api.mixers import MIXERS
>>> mixer = MIXERS.build("ring", m=4, self_weight=0.5)
>>> mixer.apply(torch.arange(4.0).reshape(4, 1), 0)[:, 0].tolist()
[1.0, 1.0, 2.0, 2.0]
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.api.registry import MIXERS

__all__ = ["Mixer", "MixerBase", "RingRollMixer", "DelayedMixer",
           "ring_write", "ring_read"]


def _bcast(d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The (m,) per-node vector ``d`` shaped to broadcast over ``like``'s
    trailing axes (a node-stacked pytree leaf may have any of them)."""
    return d.to(like.device).reshape((-1,) + (1,) * (like.dim() - 1))


def ring_write(hist: torch.Tensor, t: int, value: torch.Tensor) -> torch.Tensor:
    """Write this round's broadcast copy into slot t % depth, in place."""
    hist[t % hist.shape[0]] = value
    return hist


def ring_read(hist: torch.Tensor, t: int, d: int,
              fallback: torch.Tensor) -> torch.Tensor:
    """The broadcast copy from ``d`` rounds ago, AFTER this round's write.

    During warm-up (t < d) returns ``fallback`` (the current theta~), so the
    engine mixes synchronously until the pipe is full; d == 0 reads back the
    slot ``ring_write`` just filled.
    """
    if t < d:
        return fallback
    return hist[(t - d) % hist.shape[0]]


@runtime_checkable
class Mixer(Protocol):
    """Topology stage: mixes (m, ...) tensors with A(t) along axis 0."""

    m: int
    delay: int  # rounds of staleness for neighbor terms (0 = synchronous)

    def apply(self, x: torch.Tensor, t: int) -> torch.Tensor: ...

    def diag(self, t: int) -> torch.Tensor: ...

    def mix(self, clean, tilde, noise_self: bool, t: int) -> torch.Tensor: ...

    def mix_delayed(self, clean, tilde, recv, noise_self: bool,
                    t: int) -> torch.Tensor: ...

    def mix_history(self, clean, tilde, hist, noise_self: bool,
                    t: int) -> torch.Tensor: ...


class MixerBase:
    """Noise-placement algebra shared by all mixers (subclasses implement
    :meth:`apply` and :meth:`diag`):

      mix         = A x~                      (noise_self)
                  = A x~ - diag * (x~ - x)    (own-noise removed)
      mix_delayed = A r - diag * r + diag * s where s = x~ or x
      mix_history = mix_delayed with r read from the ring at self.delay
    """

    m: int = 0
    delay: int = 0

    def apply(self, x, t):
        raise NotImplementedError

    def diag(self, t):
        raise NotImplementedError

    def mix(self, clean, tilde, noise_self, t):
        mixed = self.apply(tilde, t)
        if not noise_self:
            mixed = mixed - _bcast(self.diag(t), tilde) * (tilde - clean)
        return mixed

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        d = _bcast(self.diag(t), recv)
        self_term = tilde if noise_self else clean
        return self.apply(recv, t) - d * recv + d * self_term

    def mix_history(self, clean, tilde, hist, noise_self, t):
        if not self.delay:
            return self.mix(clean, tilde, noise_self, t)
        if hist is None:
            raise ValueError(
                f"{type(self).__name__} declares delay={self.delay} but no "
                "history ring was provided (engine state missing .history)")
        recv = ring_read(hist, t, self.delay, tilde)
        return self.mix_delayed(clean, tilde, recv, noise_self, t)


@dataclasses.dataclass(frozen=True)
class RingRollMixer(MixerBase):
    """Bidirectional ring via torch.roll; numerically the same map as
    ``core.graph.ring_matrix``."""

    m: int
    self_weight: float = 0.5
    delay: int = 0

    def apply(self, x, t):
        nw = (1.0 - self.self_weight) / 2.0
        return (self.self_weight * x
                + nw * torch.roll(x, 1, dims=0)
                + nw * torch.roll(x, -1, dims=0))

    def diag(self, t):
        return torch.full((self.m,), self.self_weight, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DelayedMixer(MixerBase):
    """Any mixer with a uniform WAN delay: neighbor terms arrive ``delay``
    rounds late; the algebra is the inner mixer's."""

    inner: Mixer
    delay: int = 1

    def __post_init__(self):
        if self.delay < 1:
            raise ValueError("DelayedMixer needs delay >= 1")

    @property
    def m(self) -> int:
        return self.inner.m

    def apply(self, x, t):
        return self.inner.apply(x, t)

    def diag(self, t):
        return self.inner.diag(t)

    def mix(self, clean, tilde, noise_self, t):
        return self.inner.mix(clean, tilde, noise_self, t)

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        return self.inner.mix_delayed(clean, tilde, recv, noise_self, t)


@MIXERS.register("ring")
def _ring(m: int, self_weight: float = 0.5, delay: int = 0) -> Mixer:
    """Bidirectional ring of data centres (torch.roll)."""
    return RingRollMixer(m=m, self_weight=self_weight, delay=delay)
