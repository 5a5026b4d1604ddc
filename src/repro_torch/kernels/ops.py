"""Public wrappers of the seed kernels on parameter pytrees.

Counterpart of `repro.kernels.ops`: the (rows, 128) tile plumbing that
turns any node-stacked parameter pytree into the layout of
``pdomd_update`` and back, and the two kernels' public entry points. The
reference's TPU tiling knobs (``block_rows``, ``block_b``, ``interpret``)
are not carried: the CUDA kernels pick their own launch shapes, and a CPU
tensor takes the plain PyTorch version.

>>> import torch
>>> from repro_torch.kernels import ops
>>> tree = {"b": torch.ones(3), "a": torch.arange(4.0).reshape(2, 2)}
>>> tiles = ops.tree_to_tiles(tree)            # leaves in sorted-key order
>>> tuple(tiles.shape), tiles[0, :7].tolist()
((8, 128), [0.0, 1.0, 2.0, 3.0, 1.0, 1.0, 1.0])
>>> ops.tiles_to_tree(tiles, tree)["a"].tolist()
[[0.0, 1.0], [2.0, 3.0]]
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tree as tree_util
from repro_torch.kernels import hinge_grad as _hinge
from repro_torch.kernels import pdomd_update as _pdomd

__all__ = ["LANE", "SUBLANE", "flat_size", "padded_rows", "tree_to_tiles",
           "tiles_to_tree", "pdomd_update", "hinge_grad"]

LANE = _pdomd.LANE
SUBLANE = _pdomd.SUBLANE


def flat_size(tree: Any) -> int:
    return sum(int(leaf.numel()) for leaf in tree_util.leaves(tree))


def padded_rows(size: int) -> int:
    rows = -(-size // LANE)
    return -(-rows // SUBLANE) * SUBLANE


def tree_to_tiles(tree: Any) -> torch.Tensor:
    """Flatten a pytree into one (rows, 128) float32 tensor, zero padded,
    leaves in JAX's order (dict keys sorted), on the leaves' device."""
    leaves = [leaf.reshape(-1).to(torch.float32)
              for leaf in tree_util.leaves(tree)]
    flat = torch.cat(leaves) if len(leaves) > 1 else leaves[0]
    rows = padded_rows(flat.numel())
    flat = torch.nn.functional.pad(flat, (0, rows * LANE - flat.numel()))
    return flat.reshape(rows, LANE)


def tiles_to_tree(tiles: torch.Tensor, tree_like: Any) -> Any:
    """Inverse of :func:`tree_to_tiles` (casts back to each leaf's dtype)."""
    leaves, spec = tree_util.flatten(tree_like)
    flat = tiles.reshape(-1)
    out, off = [], 0
    for leaf in leaves:
        size = int(leaf.numel())
        out.append(flat[off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_util.unflatten(spec, out)


def pdomd_update(theta_self, theta_prev, theta_next, grad, alpha, lam,
                 self_weight=0.5, nbr_weight=0.25):
    """Fused mix + OMD step + L1 prox on (rows, 128) tiles: (w, theta_new)."""
    return _pdomd.pdomd_update(theta_self, theta_prev, theta_next, grad,
                               alpha, lam, self_weight, nbr_weight)


def hinge_grad(x, y, w):
    """Fused hinge loss + subgradient. Returns (loss, grad, margin)."""
    return _hinge.hinge_grad(x, y, w)
