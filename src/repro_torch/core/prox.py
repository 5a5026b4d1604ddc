"""Proximal operators (paper steps 6-7 of Algorithm 1), on torch tensors.

Counterpart of `repro.core.prox`. Step 7's Lasso prox has the closed form
w = sign(p) * max(|p| - lambda, 0); with phi_t = 1/2 ||.||^2 the mirror map
is the identity, so primal recovery is the soft threshold of theta.
"""
from __future__ import annotations

import functools
import operator
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree

__all__ = ["soft_threshold", "soft_threshold_tree", "l2_mirror_map",
           "sparsity", "sparsity_tree", "zero_fraction"]


def soft_threshold(p: torch.Tensor, lam) -> torch.Tensor:
    """Closed-form Lasso prox: sign(p) * relu(|p| - lam)."""
    return torch.sign(p) * torch.clamp_min(p.abs() - float(lam), 0.0)


def soft_threshold_tree(params: Any, lam) -> Any:
    """`soft_threshold` of every leaf of a pytree."""
    return tree.tree_map(lambda p: soft_threshold(p, lam), params)


def l2_mirror_map(theta: torch.Tensor) -> torch.Tensor:
    """grad phi*(theta) for phi = 1/2||.||_2^2 : identity (Thm 2 setting)."""
    return theta


def zero_fraction(zeros: torch.Tensor, total: int) -> torch.Tensor:
    """f32 ``zeros / total`` computed as the reference computes it.

    The count is exact (an integer tensor). XLA turns the reference's
    division by the constant ``total`` into a multiplication by its f32
    reciprocal, so this multiplies by ``f32(1) / f32(total)`` too — on
    every device, and sparsity is held bit-exact.
    """
    inv = float(np.float32(1.0) / np.float32(total))
    return zeros.to(torch.float32) * inv


def sparsity(w: torch.Tensor, atol: float = 0.0) -> torch.Tensor:
    """Fraction of exactly-zero (or |.|<=atol) coordinates, as f32."""
    return zero_fraction((w.abs() <= atol).sum(), w.numel())


def sparsity_tree(params: Any, atol: float = 0.0) -> torch.Tensor:
    """Fraction of exactly-zero (or |.|<=atol) coordinates over all leaves:
    the zeros counted exactly, leaf by leaf, then one f32 division."""
    leaves = tree.leaves(params)
    zeros = functools.reduce(operator.add,
                             [(leaf.abs() <= atol).sum() for leaf in leaves])
    return zero_fraction(zeros, sum(leaf.numel() for leaf in leaves))
