"""Pytrees of tensors, flattened in JAX's leaf order.

The distributed engine (`core.gossip`), the clippers, the prox and the
``(rows, 128)`` tiles of `kernels.ops` all walk a parameter pytree leaf by
leaf, and the leaf order decides the noise draw order, the cross-leaf norm
sum and the tile layout. JAX sorts dict keys; `torch.utils._pytree` keeps
insertion order. This module follows JAX, so a port run agrees with the
reference on any dict, whatever order its keys were inserted in.

Nodes are ``dict`` (keys sorted), ``list``, ``tuple`` and NamedTuples
(fields in order); ``None`` is a node with no leaves, as in JAX. Anything
else is a leaf.

>>> from repro_torch.core import tree
>>> t = {"b": 1, "a": [2, (3, None)]}
>>> tree.leaves(t)
[2, 3, 1]
>>> leaves, spec = tree.flatten(t)
>>> tree.unflatten(spec, [x * 10 for x in leaves])
{'a': [20, (30, None)], 'b': 10}
>>> [k for k, _ in tree.flatten_with_path({"w": 0, "h": {"x": 1}})]
['h/x', 'w']
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

__all__ = ["TreeSpec", "flatten", "unflatten", "leaves", "tree_map",
           "flatten_with_path"]


class TreeSpec(NamedTuple):
    """The structure of a pytree without its leaves."""

    kind: str                 # "leaf" | "none" | "dict" | "list" | "tuple" | "namedtuple"
    meta: Any = None          # sorted dict keys, or the NamedTuple class
    children: tuple = ()


def _children(node: Any) -> tuple[str, Any, list[tuple[str, Any]]] | None:
    """(kind, meta, [(path part, child)]) of a node; None for a leaf."""
    if node is None:
        return "none", None, []
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", tuple(keys), [(str(k), node[k]) for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return "namedtuple", type(node), [(f, getattr(node, f))
                                          for f in node._fields]
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return kind, None, [(str(i), c) for i, c in enumerate(node)]
    return None


def flatten_with_path(node: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in leaf order; a path joins the dict keys, field
    names and sequence indices on the way down with "/" (the key names
    `repro.checkpoint` gives a pytree's leaves)."""
    found = _children(node)
    if found is None:
        return [(prefix, node)]
    out = []
    for part, child in found[2]:
        out.extend(flatten_with_path(child, f"{prefix}/{part}" if prefix
                                     else part))
    return out


def flatten(node: Any) -> tuple[list, TreeSpec]:
    """(leaves in JAX's order, structure)."""
    found = _children(node)
    if found is None:
        return [node], TreeSpec("leaf")
    kind, meta, kids = found
    leaves_out, specs = [], []
    for _, child in kids:
        sub, spec = flatten(child)
        leaves_out.extend(sub)
        specs.append(spec)
    return leaves_out, TreeSpec(kind, meta, tuple(specs))


def _build(spec: TreeSpec, it) -> Any:
    if spec.kind == "leaf":
        return next(it)
    if spec.kind == "none":
        return None
    kids = [_build(s, it) for s in spec.children]
    if spec.kind == "dict":
        return dict(zip(spec.meta, kids))
    if spec.kind == "namedtuple":
        return spec.meta(*kids)
    return kids if spec.kind == "list" else tuple(kids)


def unflatten(spec: TreeSpec, leaves_in) -> Any:
    """The pytree of structure ``spec`` holding ``leaves_in`` in order."""
    it = iter(leaves_in)
    out = _build(spec, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def leaves(node: Any) -> list:
    return flatten(node)[0]


def tree_map(fn: Callable, node: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf across trees of one structure."""
    first, spec = flatten(node)
    others = []
    for other in rest:
        lv, other_spec = flatten(other)
        if other_spec != spec:
            raise ValueError("tree_map: trees differ in structure")
        others.append(lv)
    return unflatten(spec, [fn(*args) for args in zip(first, *others)])
