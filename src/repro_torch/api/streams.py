"""Stream — the data-scenario stage of the experiment pipeline.

Counterpart of `repro.api.streams`. A Stream owns where the per-round
samples come from; everything downstream (clip -> noise -> mix -> local
rule) is scenario-agnostic. Every stream emits fixed-shape chunks::

    xs, ys = stream.chunk(t0, t1)     # xs (t1-t0, m, n), ys (t1-t0, m)

keyed per ABSOLUTE round. A Stream instance may be passed to
``RunSpec(stream=...)`` in place of a name; the runner moves its chunks to
the run's device.

Built-in scenarios:

  social_sparse  — the paper's §V workload: fixed sparse w*, normalized
                   gaussian features, optional label flips.
  drift          — w* is NON-stationary: its sparse support reshuffles
                   (or rotates) every ``period`` rounds.
  heterogeneous  — per-node feature scales and label-noise rates drawn
                   from a seeded distribution; w* shared.
  bursty         — per-(t, i) sample counts from a capped discrete Pareto;
                   a round's sample is the mean of its burst.

The streams' random draws come from seeded `torch.Generator`s (numbers
other than the reference's `jax.random` ones) behind a few methods — the
ground truths (``base_w_true``, ``phase_w_true``), the per-round normals
and uniforms (``round_draws``, ``burst_normals``, ``burst_uniforms``) and
the per-node draws (``node_scales``, ``node_noise_rates``). Everything
else a chunk does (the phase, the rotation, the labels, the burst counts
and means) is the reference's arithmetic, so a stream given the
reference's draws gives the reference's chunks.

>>> from repro_torch.api.streams import STREAMS
>>> s = STREAMS.build("social_sparse", n=32, nodes=4, rounds=64,
...                   device="cpu")
>>> xs, ys = s.chunk(0, 8)
>>> tuple(xs.shape), tuple(ys.shape)
((8, 4, 32), (8, 4))
>>> b = STREAMS.build("bursty", n=16, nodes=2, rounds=32, seed=1,
...                   device="cpu")
>>> c = b.counts(0, 32)
>>> 1 <= int(c.min()) and int(c.max()) <= b.burst_max
True
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.registry import STREAMS
from repro_torch.data.social import (SocialStream, labels_from_logits,
                                     seeded_generator, sparse_unit_w)
from repro_torch.device import resolve_device

__all__ = ["Stream", "STREAMS", "SocialStream", "DriftStream",
           "HeterogeneousStream", "BurstyStream"]


@runtime_checkable
class Stream(Protocol):
    """Data-scenario stage: per-round samples for every node.

    ``disjoint`` declares whether round t touches only samples that arrive
    at round t — the Theorem-1 parallel-composition condition the runner
    hands to the PrivacyAccountant.
    """

    n: int        # feature dimension
    nodes: int    # m data centers
    rounds: int   # stream length (the run horizon)
    disjoint: bool

    def chunk(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Rounds [t0, t1): xs (t1-t0, m, n), ys (t1-t0, m) with y in ±1."""
        ...


class _SeededDraws:
    """The draws the synthetic streams share. Each is a method, so a test
    can replace it with the reference's draws."""

    @functools.cached_property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def _root_n(self) -> float:
        """sqrt(n) in float32, as the reference's ``jnp.sqrt(n)``."""
        return float(np.sqrt(np.float32(self.n)))

    def base_w_true(self) -> torch.Tensor:
        """The social_sparse ground truth of this seed (phase 0 of drift)."""
        return SocialStream(n=self.n, nodes=self.nodes, rounds=self.rounds,
                            sparsity_true=self.sparsity_true, seed=self.seed,
                            device=self.device).w_true

    def round_draws(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Round t's (m, n) standard normals (the features) and (m,)
        uniforms on [0, 1) (the label flips): the generator social_sparse
        seeds for round t, so the features are that stream's."""
        g = seeded_generator(self._device, self.seed + 1, t)
        return (torch.randn((self.nodes, self.n), generator=g,
                            device=self._device),
                torch.rand(self.nodes, generator=g, device=self._device))

    def _normals_uniforms(self, t0: int, t1: int):
        draws = [self.round_draws(t) for t in range(t0, t1)]
        return (torch.stack([d[0] for d in draws]),
                torch.stack([d[1] for d in draws]))


@dataclasses.dataclass(frozen=True)
class DriftStream(_SeededDraws):
    """Non-stationary ground truth: w* changes every ``period`` rounds.

    mode='reshuffle' draws a fresh sparse w* per phase (abrupt concept
    drift); mode='rotate' rolls the phase-0 w* by phase-proportional
    offsets, so the support wanders through the feature space but keeps its
    geometry (gradual drift). Labels always come from the CURRENT phase's
    w*.
    """

    n: int
    nodes: int
    rounds: int
    period: int = 64
    mode: str = "reshuffle"      # 'reshuffle' | 'rotate'
    sparsity_true: float = 0.05
    label_noise: float = 0.0
    seed: int = 0
    device: str = "cuda"
    disjoint: bool = True

    def __post_init__(self):
        if self.period < 1:
            raise ValueError("drift period must be >= 1")
        if self.mode not in ("reshuffle", "rotate"):
            raise ValueError(f"unknown drift mode {self.mode!r}")

    def phase_w_true(self, phase: int) -> torch.Tensor:
        """A fresh sparse unit w* for a reshuffle phase."""
        return sparse_unit_w(seeded_generator(self._device, self.seed, phase),
                             self.n, self.sparsity_true)

    def w_true_at(self, t: int) -> torch.Tensor:
        """Ground truth in effect at round t."""
        phase = t // self.period
        if self.mode == "rotate":
            # a phase-proportional offset, coprime-ish with n, so the
            # support visits the whole feature space before repeating
            shift = (phase * (self.n // 4 + 1)) % self.n
            return torch.roll(self.base_w_true(), shift)
        return self.phase_w_true(phase)

    def chunk(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        normals, uniforms = self._normals_uniforms(t0, t1)
        x = normals / self._root_n
        phases = {}
        for t in range(t0, t1):
            phases.setdefault(t // self.period, self.w_true_at(t))
        W = torch.stack([phases[t // self.period] for t in range(t0, t1)])
        y = labels_from_logits(torch.einsum("tn,tmn->tm", W, x))
        if self.label_noise > 0:
            y = torch.where(uniforms < self.label_noise, -y, y)
        return x.to(torch.float32), y


@dataclasses.dataclass(frozen=True)
class HeterogeneousStream(_SeededDraws):
    """Per-node populations: each data center has its own feature scale and
    label-noise rate, drawn once from a seeded distribution.

    Feature scales are lognormal (sigma = ``scale_spread``) around the
    social_sparse normalization; per-node flip rates are Uniform(0,
    ``noise_max``). The ground truth w* is SHARED — the consensus the
    gossip step is supposed to recover despite the heterogeneity.
    """

    n: int
    nodes: int
    rounds: int
    scale_spread: float = 0.5
    noise_max: float = 0.2
    sparsity_true: float = 0.05
    seed: int = 0
    device: str = "cuda"
    disjoint: bool = True

    def node_scales(self) -> torch.Tensor:
        """(m,) per-node lognormal feature scales."""
        g = seeded_generator(self._device, self.seed, 7)
        return torch.exp(self.scale_spread * torch.randn(
            self.nodes, generator=g, device=self._device)).to(torch.float32)

    def node_noise_rates(self) -> torch.Tensor:
        """(m,) per-node label-flip probabilities in [0, noise_max)."""
        g = seeded_generator(self._device, self.seed, 8)
        return (self.noise_max * torch.rand(
            self.nodes, generator=g, device=self._device)).to(torch.float32)

    def chunk(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.base_w_true()
        scales, rates = self.node_scales(), self.node_noise_rates()
        normals, uniforms = self._normals_uniforms(t0, t1)
        x = normals * scales[None, :, None] / self._root_n
        y = labels_from_logits(torch.einsum("n,tmn->tm", w, x))
        y = torch.where(uniforms < rates[None, :], -y, y)
        return x.to(torch.float32), y


@dataclasses.dataclass(frozen=True)
class BurstyStream(_SeededDraws):
    """Heavy-tailed per-round sample counts (big-data arrival bursts).

    For every (round, node) a count c = min(floor(u^(-1/tail)), burst_max)
    with u ~ Uniform(1e-7, 1), so c >= 1 always and P(c >= k) ~ k^-tail.
    The emitted sample is the MEAN of the c fresh samples in the burst
    (labels come from the mean feature), so busy rounds deliver
    lower-variance, smaller-norm evidence in the same (T, m, n) shape.
    ``counts`` exposes the burst sizes.
    """

    n: int
    nodes: int
    rounds: int
    burst_max: int = 8
    tail: float = 1.5            # Pareto tail index; smaller = heavier
    sparsity_true: float = 0.05
    seed: int = 0
    device: str = "cuda"
    disjoint: bool = True

    def __post_init__(self):
        if self.burst_max < 1:
            raise ValueError("burst_max must be >= 1")
        if self.tail <= 0:
            raise ValueError("tail must be > 0")

    def burst_uniforms(self, t: int) -> torch.Tensor:
        """(m,) uniforms on [1e-7, 1) behind round t's burst sizes."""
        g = seeded_generator(self._device, self.seed + 2, t)
        lo = np.float32(1e-7)
        u = torch.rand(self.nodes, generator=g, device=self._device)
        return torch.clamp_min(u * float(np.float32(1.0) - lo) + float(lo),
                               float(lo))

    def burst_normals(self, t: int, k: int) -> torch.Tensor:
        """The (m, n) standard normals of sample k of round t's bursts."""
        g = seeded_generator(self._device, self.seed + 1, t, k)
        return torch.randn((self.nodes, self.n), generator=g,
                           device=self._device)

    def counts(self, t0: int, t1: int) -> torch.Tensor:
        """(t1-t0, m) burst sizes in [1, burst_max], heavy-tailed."""
        u = torch.stack([self.burst_uniforms(t) for t in range(t0, t1)])
        c = torch.floor(u ** float(np.float32(-1.0 / self.tail)))
        return torch.clamp(c, 1, self.burst_max).to(torch.int32)

    def chunk(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.base_w_true()
        c = self.counts(t0, t1)                                 # (T, m)
        total = torch.zeros((t1 - t0, self.nodes, self.n),
                            dtype=torch.float32, device=self._device)
        for k in range(self.burst_max):
            sample = torch.stack([self.burst_normals(t, k)
                                  for t in range(t0, t1)])
            total = total + torch.where((k < c)[:, :, None], sample, 0.0)
        x = total / c[:, :, None].to(torch.float32) / self._root_n
        y = labels_from_logits(torch.einsum("n,tmn->tm", w, x))
        return x, y


@STREAMS.register("social_sparse")
def _social(n: int, nodes: int, rounds: int, seed: int = 0,
            sparsity_true: float = 0.05, label_noise: float = 0.0,
            device: str = "cuda") -> Stream:
    """The paper's §V workload: sparse w*, normalized gaussian features."""
    return SocialStream(n=n, nodes=nodes, rounds=rounds, seed=seed,
                        sparsity_true=sparsity_true, label_noise=label_noise,
                        device=str(device))


@STREAMS.register("drift")
def _drift(n: int, nodes: int, rounds: int, seed: int = 0,
           period: int = 64, mode: str = "reshuffle",
           sparsity_true: float = 0.05, label_noise: float = 0.0,
           device: str = "cuda") -> Stream:
    """w* reshuffles (or rotates) every `period` rounds."""
    return DriftStream(n=n, nodes=nodes, rounds=rounds, seed=seed,
                       period=period, mode=mode, sparsity_true=sparsity_true,
                       label_noise=label_noise, device=str(device))


@STREAMS.register("heterogeneous")
def _het(n: int, nodes: int, rounds: int, seed: int = 0,
         scale_spread: float = 0.5, noise_max: float = 0.2,
         sparsity_true: float = 0.05, device: str = "cuda") -> Stream:
    """Per-node lognormal feature scales and label-noise rates."""
    return HeterogeneousStream(n=n, nodes=nodes, rounds=rounds, seed=seed,
                               scale_spread=scale_spread, noise_max=noise_max,
                               sparsity_true=sparsity_true,
                               device=str(device))


@STREAMS.register("bursty")
def _bursty(n: int, nodes: int, rounds: int, seed: int = 0,
            burst_max: int = 8, tail: float = 1.5,
            sparsity_true: float = 0.05, device: str = "cuda") -> Stream:
    """Capped-Pareto burst sizes; a round's sample is its burst's mean."""
    return BurstyStream(n=n, nodes=nodes, rounds=rounds, seed=seed,
                        burst_max=burst_max, tail=tail,
                        sparsity_true=sparsity_true, device=str(device))
