"""Synthetic social-data stream at the paper's simulation scale, in torch.

Counterpart of `repro.data.social`. A sparse ground-truth w* (only
``sparsity_true`` of the features carry signal), gaussian features
normalized by sqrt(n), labels y = sign(<w*, x>) with optional flips. Each
node's per-round sample is fresh randomness per (t, i), disjoint from all
others — the condition for Theorem 1's parallel composition.

Draws come from `torch.Generator`s on the stream's device, so the data is
made where it is used. Sampling is keyed per ABSOLUTE round: round t's
generator is seeded from (seed + 1, t), so ``chunk(a, b)`` returns the same
rounds however the horizon is split — what checkpoint resume relies on.
The numbers differ from the reference's `jax.random` stream; the tests
hand the reference's chunks to the port through a Stream instance.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SocialStream", "labels_from_logits", "round_seed",
           "seeded_generator", "sparse_unit_w"]


def labels_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """y = +1 iff <w*, x> >= 0 — an exact-zero logit maps to +1, never to
    the invalid label 0 (sign(0) == 0 would zero the hinge gradient)."""
    return torch.where(logits >= 0, 1.0, -1.0).to(torch.float32)


def round_seed(*key: int) -> int:
    """A 63-bit generator seed from non-negative ints: ``(seed,)`` for the
    ground truth, ``(seed + 1, t)`` for absolute round t."""
    state = np.random.SeedSequence(tuple(int(k) for k in key)).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2**63 - 1)


def seeded_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``round_seed(*key)``."""
    g = torch.Generator(device=device)
    g.manual_seed(round_seed(*key))
    return g


def sparse_unit_w(generator: torch.Generator, n: int,
                  sparsity_true: float) -> torch.Tensor:
    """(n,) unit-norm ground truth whose support holds each feature with
    probability ``sparsity_true``: a uniform draw for the mask, then a
    normal one for the values, both from ``generator``."""
    dev = generator.device
    mask = torch.rand(n, generator=generator, device=dev) < sparsity_true
    w = torch.randn(n, generator=generator, device=dev) * mask
    return (w / torch.clamp_min(torch.linalg.norm(w), 1e-9)).to(
        torch.float32)


@dataclasses.dataclass(frozen=True)
class SocialStream:
    n: int
    nodes: int
    rounds: int
    sparsity_true: float = 0.05
    label_noise: float = 0.0
    seed: int = 0
    device: str = "cuda"

    # every round touches only samples that arrive at that round — the
    # Theorem-1 parallel-composition condition the PrivacyAccountant reads
    disjoint: bool = True

    @functools.cached_property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def w_true(self) -> torch.Tensor:
        """(n,) unit-norm sparse ground truth, a function of the seed."""
        return sparse_unit_w(seeded_generator(self._device, self.seed),
                             self.n, self.sparsity_true)

    def chunk(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Rounds [t0, t1): xs (t1-t0, m, n), ys (t1-t0, m) on the device."""
        dev = self._device
        xs = torch.empty((t1 - t0, self.nodes, self.n), dtype=torch.float32,
                         device=dev)
        flips = []
        g = torch.Generator(device=dev)
        for k, t in enumerate(range(t0, t1)):
            g.manual_seed(round_seed(self.seed + 1, t))
            torch.randn((self.nodes, self.n), generator=g, out=xs[k])
            if self.label_noise > 0:
                flips.append(torch.rand(self.nodes, generator=g, device=dev)
                             < self.label_noise)
        xs /= math.sqrt(self.n)
        ys = labels_from_logits(xs @ self.w_true)
        if flips:
            ys = torch.where(torch.stack(flips), -ys, ys)
        return xs, ys
