"""Clipper — enforces Assumption 2.3 (||g|| <= L) before noising.

Counterpart of `repro.api.clippers`. Clippers act per node (axis 0 of
every leaf) on either the simulator's bare (m, n) gradient block or the
distributed engine's node-stacked pytree: a bare tensor is a one-leaf tree
(`core.tree`), so one implementation serves both engines. Without clipping
the DP guarantee is vacuous for unbounded losses. This slice ports 'l2' and
'none'; 'value' waits in ROADMAP queue 1.

>>> import torch
>>> from repro_torch.api import CLIPPERS
>>> clipped, norms = CLIPPERS.build("l2", max_norm=1.0).clip(
...     torch.full((2, 4), 2.0))                # per-node norm = 4
>>> norms.tolist()
[4.0, 4.0]
>>> round(float(torch.linalg.norm(clipped[0])), 4)
1.0
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.api.registry import CLIPPERS
from repro_torch.core import tree

__all__ = ["Clipper", "PerNodeL2Clipper", "NoClipper", "per_node_norms",
           "clip_factor"]


def per_node_norms(grads: Any) -> torch.Tensor:
    """(m,) global L2 norm of each node's slice across all leaves: the
    per-leaf sums of squares, added in leaf order."""
    sq = [torch.sum(torch.square(leaf.to(torch.float32)),
                    dim=tuple(range(1, leaf.dim())))
          for leaf in tree.leaves(grads)]
    return torch.sqrt(functools.reduce(operator.add, sq))


def clip_factor(norms: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-12)) per node, with a true f32
    division (a CUDA tensor divided into a Python number would multiply by
    a reciprocal instead)."""
    bound = torch.full((), float(max_norm), dtype=norms.dtype,
                       device=norms.device)
    return torch.clamp_max(bound / torch.clamp_min(norms, 1e-12), 1.0)


@runtime_checkable
class Clipper(Protocol):
    """Gradient-bounding stage. Returns (clipped, (m,) pre-clip norms)."""

    def clip(self, grads: Any) -> tuple[Any, torch.Tensor]: ...


@dataclasses.dataclass(frozen=True)
class PerNodeL2Clipper:
    """Scale each node's gradient row to L2 norm <= max_norm (the bound L
    the Lemma-1 sensitivity is calibrated against)."""

    max_norm: float = 1.0

    def clip(self, grads):
        norms = per_node_norms(grads)
        factor = clip_factor(norms, self.max_norm)

        def scale(leaf):
            f = factor.reshape((-1,) + (1,) * (leaf.dim() - 1))
            return (leaf * f).to(leaf.dtype)

        return tree.tree_map(scale, grads), norms


@dataclasses.dataclass(frozen=True)
class NoClipper:
    """Pass-through (non-private baselines only: voids Assumption 2.3)."""

    def clip(self, grads):
        return grads, per_node_norms(grads)


@CLIPPERS.register("l2")
def _l2(max_norm: float = 1.0) -> Clipper:
    """Per-node L2 clip to max_norm."""
    return PerNodeL2Clipper(max_norm=max_norm)


@CLIPPERS.register("none")
def _noclip() -> Clipper:
    """No clipping."""
    return NoClipper()
