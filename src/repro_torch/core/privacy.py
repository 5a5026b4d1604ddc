"""Differential privacy machinery (paper §III), on torch tensors.

Counterpart of `repro.core.privacy`:
  * Lemma 1 sensitivity:  S(t) <= 2 * alpha_t * sqrt(n) * L
  * Laplace noise with scale mu = S(t) / eps       (Eq. 8)
  * per-round eps-DP (Lemma 2) + parallel composition across rounds
    (Theorem 1, valid because each round consumes disjoint stream entries).

  * gradient clipping that enforces the bound ||g||_2 <= L the paper
    assumes (Assumption 2.3): `clip_by_l2` on a whole pytree.

Scales are host scalars computed in numpy float32 in the reference's order,
so they equal the reference's jnp values bit for bit. Laplace draws use the
same inverse-CDF transform of a uniform sample, drawn from an explicit
`torch.Generator` in place of a `jax.random` key; the numbers differ from
JAX's, so the tests compare by distribution or replay JAX's draws.

>>> cfg = PrivacyConfig(eps=1.0, L=1.0, clip_style="coordinate")
>>> float(cfg.scale_for(0.5, n=100))
1.0
>>> clipped, norm = clip_by_l2({"w": torch.tensor([3.0, 4.0])}, 1.0)
>>> float(norm), clipped["w"].tolist()
(5.0, [0.6000000238418579, 0.800000011920929])
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree

__all__ = ["sensitivity", "laplace_scale", "sample_laplace",
           "sample_laplace_tree", "clip_by_l2", "PrivacyConfig",
           "unit_laplace", "PrivacyAccountant"]

f32 = np.float32
U_MIN = -0.5 + 1e-7   # lower bound on u keeps log1p(-2|u|) finite


def sensitivity(alpha_t, n: int, L: float) -> np.float32:
    """Lemma 1: S(t) <= 2 * alpha_t * sqrt(n) * L  (L1 sensitivity)."""
    return f32(2.0) * f32(alpha_t) * f32(math.sqrt(n)) * f32(L)


def laplace_scale(alpha_t, n: int, L: float, eps: float) -> np.float32:
    """mu = S(t) / eps (Eq. 8). eps = inf => scale 0 (non-private)."""
    if math.isinf(eps):
        return f32(0.0)
    return sensitivity(alpha_t, n, L) / f32(eps)


def unit_laplace(generator: torch.Generator, shape) -> torch.Tensor:
    """Laplace(0, 1) draws on the generator's device, via inverse CDF:
    -sign(u) * log1p(-2|u|) with u ~ Uniform[-1/2 + 1e-7, 1/2)."""
    lo, hi = torch.tensor(U_MIN, dtype=torch.float32), 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    u = torch.clamp_min(u * float(hi - lo) + float(lo), float(lo))
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def sample_laplace(generator: torch.Generator, shape,
                   scale) -> torch.Tensor:
    """Laplace(0, scale) draws; exact zeros (and no draw) for scale == 0."""
    if float(scale) == 0.0:
        return torch.zeros(shape, dtype=torch.float32,
                           device=generator.device)
    return float(scale) * unit_laplace(generator, shape)


def sample_laplace_tree(generator: torch.Generator, params: Any, scale,
                        dtype=None) -> Any:
    """One independent Laplace(0, scale) sample per leaf of a pytree, drawn
    from ``generator`` leaf after leaf in `core.tree`'s (JAX's) leaf order,
    each of its leaf's shape, in ``dtype`` or the leaf's own."""
    leaves, spec = tree.flatten(params)
    return tree.unflatten(spec, [
        sample_laplace(generator, tuple(leaf.shape), scale).to(
            dtype or leaf.dtype) for leaf in leaves])


def clip_by_l2(params: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale the whole pytree so its global L2 norm is <= max_norm.

    Enforces Assumption 2.3 (||g|| <= L); returns (clipped, pre-clip norm).
    The leaves' sums of squares add in leaf order, the factor is a true
    f32 division, as the reference's.
    """
    norm = torch.sqrt(functools.reduce(operator.add, [
        torch.sum(torch.square(leaf.to(torch.float32)))
        for leaf in tree.leaves(params)]))
    bound = torch.full((), float(max_norm), dtype=torch.float32,
                       device=norm.device)
    factor = torch.clamp_max(bound / torch.clamp_min(norm, 1e-12), 1.0)
    return tree.tree_map(lambda x: (x * factor).to(x.dtype), params), norm


@dataclasses.dataclass(frozen=True)
class PrivacyConfig:
    """All knobs of the paper's privacy mechanism.

    eps:        per-round privacy budget (paper sweeps 0.1 / 1 / 10 / inf).
    L:          subgradient bound (Assumption 2.3), enforced by clipping.
    noise_self: faithful default True — Algorithm 1 mixes the *noisy* theta
                for every j including j == i. False is the beyond-paper
                variant (own theta needs no network hop => no noise).
    clip_style: 'global' = paper's Lemma 1 scale 2*alpha*sqrt(n)*L on the
                whole vector; 'coordinate' = beyond-paper per-coordinate
                sensitivity 2*alpha*L_inf (tighter when gradients are dense).
    """

    eps: float = 1.0
    L: float = 1.0
    noise_self: bool = True
    clip_style: str = "global"

    @property
    def is_private(self) -> bool:
        return not math.isinf(self.eps)

    def scale_for(self, alpha_t, n: int) -> np.float32:
        """The noise scale at step size ``alpha_t``, in numpy float32 (the
        reference's jnp value bit for bit)."""
        if not self.is_private:
            return f32(0.0)
        if self.clip_style == "coordinate":
            return f32(2.0) * f32(alpha_t) * f32(self.L) / f32(self.eps)
        return laplace_scale(alpha_t, n, self.L, self.eps)


@dataclasses.dataclass
class PrivacyAccountant:
    """Tracks the cumulative guarantee.

    Theorem 1 (parallel composition): because round t touches only the
    stream entries that arrive at round t (disjoint across rounds), the
    T-round algorithm is eps-DP overall, NOT T*eps. The pessimistic
    sequential composition applies to streams that do not declare disjoint
    rounds. ``step(k)`` after each chunk of k rounds, ``ledger(T)`` for the
    per-round eps trajectory, ``summary()`` for the final record.
    """

    eps_per_round: float
    rounds: int = 0
    disjoint_streams: bool = True
    node_rounds: Any = None   # optional (m,) per-node participated rounds

    def __post_init__(self):
        if self.eps_per_round < 0:
            raise ValueError("eps_per_round must be >= 0")
        if self.rounds < 0:
            raise ValueError("rounds must be >= 0")

    def step(self, k: int = 1, participation: Any = None) -> None:
        """Advance ``k`` rounds; ``participation`` (optional, (m,) ints)
        says how many of them each node actually spent eps in. The first
        masked call starts per-node tracking, back-filling earlier rounds
        as full participation."""
        if k < 0:
            raise ValueError("cannot step a negative number of rounds")
        prior = self.rounds
        self.rounds += k
        if participation is not None:
            part = np.asarray(participation, np.int64).ravel()
            if part.size and ((part < 0).any() or (part > k).any()):
                raise ValueError(
                    f"participation counts must be in [0, {k}] for a "
                    f"{k}-round step; got range "
                    f"[{part.min()}, {part.max()}]")
            if self.node_rounds is None:
                self.node_rounds = np.full(part.shape, prior, np.int64)
            self.node_rounds = self.node_rounds + part
        elif self.node_rounds is not None:
            self.node_rounds = self.node_rounds + k

    def guarantee_at(self, rounds: int) -> float:
        """Cumulative eps after ``rounds`` rounds (0.0 before any)."""
        if rounds == 0:
            return 0.0
        if self.disjoint_streams:
            return self.eps_per_round  # Thm 1
        return self.eps_per_round * rounds  # sequential fallback

    @property
    def guarantee(self) -> float:
        return self.guarantee_at(self.rounds)

    def ledger(self, rounds: int | None = None) -> list[float]:
        """Per-round cumulative eps [guarantee_at(1) .. guarantee_at(T)]."""
        T = self.rounds if rounds is None else rounds
        return [self.guarantee_at(t) for t in range(1, T + 1)]

    def per_node_guarantee(self):
        """(m,) cumulative eps per node, or None without participation
        tracking."""
        if self.node_rounds is None:
            return None
        counts = np.asarray(self.node_rounds, np.int64)
        if self.disjoint_streams:
            return np.where(counts > 0, self.eps_per_round, 0.0)
        return self.eps_per_round * counts.astype(np.float64)

    def summary(self) -> dict:
        out = {
            "eps_per_round": self.eps_per_round,
            "rounds": self.rounds,
            "eps_total": self.guarantee,
            "composition": ("parallel (disjoint)" if self.disjoint_streams
                            else "sequential"),
        }
        if self.node_rounds is not None:
            per_node = self.per_node_guarantee()
            out["participated_rounds"] = [int(v) for v in self.node_rounds]
            out["eps_per_node_max"] = float(per_node.max())
            out["eps_per_node_min"] = float(per_node.min())
        return out
