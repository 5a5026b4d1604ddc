"""Sharding rules: parameter-path regex -> PartitionSpec.

Counterpart of `repro.sharding.rules`. 2D layout on the ("data", "model")
mesh (+"pod" in front on the multi-pod mesh). Tensor parallelism over
"model":
  * embed/unembed: vocab axis sharded (Megatron-style)
  * attention: head projections sharded on the head (output) axis, wo on
    its input axis
  * FFN: up/gate sharded on d_ff out, down on d_ff in
  * MoE expert stacks: sharded on the d_ff axis within each expert
  * norms / small vectors: replicated
Under GossipDP every param leaf gains a LEADING node axis, sharded over the
gossip mesh axes ("data", or ("pod",) multi-pod).

The rules read only paths and shapes, so they work on ``device="meta"``
parameters (`repro_torch.models.build_model(cfg, "meta")`): a full config's
placement is computed without its memory. `PartitionSpec` is the port's
own value type (the axis name, a tuple of names, or None per dim); it is
a leaf of `repro_torch.core.tree`, not a tuple node.

The port's one-process LM runs on one device: a spec says where a leaf
WOULD live on a mesh, and nothing here moves a tensor. ``with mesh:``
makes a `repro_torch.launch.mesh.Mesh` the active one, and `check_axis`
holds the axis a sharding context manager of `repro_torch.models` names
against it.

>>> from repro_torch.launch.mesh import make_mesh
>>> mesh = make_mesh((4, 16), ("data", "model"), device="meta")
>>> _sanitize(P("model", None), (10, 64), mesh)    # 10 % 16: moved
P(None, 'model')
"""
from __future__ import annotations

import re
from typing import Any

from repro_torch.core import tree

__all__ = ["PartitionSpec", "P", "NamedSharding", "MODEL_AXIS", "NODE_AXES",
           "spec_for", "param_pspecs", "batch_pspec", "cache_pspecs",
           "with_node_axis", "active_mesh", "check_axis"]


class PartitionSpec:
    """Per-dimension placement: a mesh axis name, a tuple of names, or
    None (replicated) for each leading dim; the dims past its length are
    replicated. Compares equal to the tuple of its entries."""

    __slots__ = ("_dims",)

    def __init__(self, *dims):
        self._dims = tuple(dims)

    def __iter__(self):
        return iter(self._dims)

    def __len__(self) -> int:
        return len(self._dims)

    def __getitem__(self, i):
        return self._dims[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._dims == other._dims
        return isinstance(other, tuple) and self._dims == other

    def __hash__(self) -> int:
        return hash(self._dims)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self._dims)) + ")"


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    a record, placing nothing."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    __hash__ = None

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


MODEL_AXIS = "model"
NODE_AXES = {"single": ("data",), "multi": ("pod",)}

# (regex over flattened path, spec builder given leaf ndim)
_RULES: list[tuple[str, Any]] = [
    # embedding / unembedding — shard the vocab axis
    (r"embed/table$", lambda nd: P(MODEL_AXIS, None)),
    (r"unembed/w$", lambda nd: P(None, MODEL_AXIS)),
    # attention projections
    (r"(attn|cross)/w[qkv]/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"(attn|cross)/w[qkv]/b$", lambda nd: P(MODEL_AXIS)),
    (r"(attn|cross)/wo/w$", lambda nd: P(MODEL_AXIS, None)),
    # dense FFN
    (r"(ffn|shared)/(gate|up)/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"(ffn|shared)/down/w$", lambda nd: P(MODEL_AXIS, None)),
    # MoE expert stacks (E, d, f) / (E, f, d): shard f
    (r"moe/(gate|up)$", lambda nd: P(None, None, MODEL_AXIS)),
    (r"moe/down$", lambda nd: P(None, MODEL_AXIS, None)),
    (r"moe/router/w$", lambda nd: P(None, None)),
    # RWKV6 matrices (D, D) / (D, F)
    (r"tm/w[rkvgo]/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"cm/wk/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"cm/wv/w$", lambda nd: P(MODEL_AXIS, None)),
    (r"cm/wr/w$", lambda nd: P(None, MODEL_AXIS)),
    # RG-LRU blocks
    (r"rec/(gate|inp)/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"rec/out/w$", lambda nd: P(MODEL_AXIS, None)),
    (r"rec/lru/w[ax]/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"rec/lru/w[ax]/b$", lambda nd: P(MODEL_AXIS)),
    (r"rec/lru/lam$", lambda nd: P(MODEL_AXIS)),
    (r"rec/conv/w$", lambda nd: P(None, MODEL_AXIS)),
    (r"rec/conv/b$", lambda nd: P(MODEL_AXIS)),
]


def _path_str(path) -> str:
    """A leaf's path as the rules read it: `core.tree.flatten_with_path`'s
    string as it is, or a sequence of keys joined with "/"."""
    if isinstance(path, str):
        return path
    return "/".join(re.sub(r"[^\w]", "", str(p)) for p in path)


def _map_with_path(fn, node) -> Any:
    """``fn(path, leaf)`` over a tree, keeping its structure."""
    spec = tree.flatten(node)[1]
    return tree.unflatten(spec, [fn(p, leaf) for p, leaf
                                 in tree.flatten_with_path(node)])


def spec_for(path_str: str, leaf) -> PartitionSpec:
    for pattern, builder in _RULES:
        if re.search(pattern, path_str):
            spec = builder(leaf.ndim)
            # layer-stacked params have a leading L axis -> prepend None
            extra = leaf.ndim - len(spec)
            if extra > 0:
                spec = P(*([None] * extra + list(spec)))
            return spec
    return P()  # replicate


def _axis_size(mesh, axis) -> int:
    if mesh is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def _sanitize(spec: PartitionSpec, shape: tuple[int, ...],
              mesh) -> PartitionSpec:
    """Drop (or relocate) mesh axes whose size doesn't divide the dim.

    Non-divisible cases (odd vocabs like 122753) first try the OTHER dim of
    a 2D param; otherwise the dim is replicated. An axis moves to a later
    free dim first (e.g. kv_heads 8 % 16 != 0 -> shard head_dim), never to
    a leading layer-stack dim.
    """
    if mesh is None:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, ax in enumerate(dims):
        if ax is None:
            continue
        if shape[i] % _axis_size(mesh, ax) != 0:
            dims[i] = None
            for j in list(range(i + 1, len(dims))) + list(range(i - 1, -1, -1)):
                if dims[j] is None and shape[j] % _axis_size(mesh, ax) == 0 \
                        and shape[j] >= _axis_size(mesh, ax):
                    dims[j] = ax
                    break
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


def param_pspecs(params: Any, node_axes: tuple[str, ...] = (),
                 mesh=None) -> Any:
    """PartitionSpec tree for a param tree. node_axes prepends the gossip
    node dimension's axes (params must already carry the leading node dim).
    Pass ``mesh`` to validate divisibility (falls back per _sanitize)."""
    if node_axes:
        lead = node_axes if len(node_axes) > 1 else node_axes[0]

        def one_node(path, leaf):
            class _V:  # shim: rules see the per-node ndim
                ndim = leaf.ndim - 1
            spec = _sanitize(spec_for(_path_str(path), _V),
                             tuple(leaf.shape[1:]), mesh)
            inner = list(spec) + [None] * (leaf.ndim - 1 - len(spec))
            return P(lead, *inner)
        return _map_with_path(one_node, params)

    def one(path, leaf):
        return _sanitize(spec_for(_path_str(path), leaf), tuple(leaf.shape),
                         mesh)

    return _map_with_path(one, params)


def batch_pspec(batch_axes: tuple[str, ...], ndim: int) -> PartitionSpec:
    """Batch arrays: leading axis over the data axes, rest replicated."""
    lead = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return P(lead, *([None] * (ndim - 1)))


def cache_pspecs(cache: Any, batch_axes: tuple[str, ...], mesh=None) -> Any:
    """KV caches: (L, B, ...) or (B, ...) — shard the batch dim over data
    axes; attention head dims over model where shaped like (.., kv, hd).
    Pass ``mesh`` to drop non-divisible axes (e.g. 40 WKV heads on a
    16-way model axis)."""
    lead = batch_axes if len(batch_axes) > 1 else batch_axes[0]

    def at(leaf, where: dict) -> PartitionSpec:
        spec = [None] * leaf.ndim
        for i, ax in where.items():
            spec[i] = ax
        return _sanitize(P(*spec), tuple(leaf.shape), mesh)

    def one(path, leaf):
        ps = _path_str(path)
        # stacked (L, B, ...) for scan models, plain (B, ...) inside
        # per-layer lists: the negative indexing serves both
        if re.search(r"(^|/)(k|v|cross_k|cross_v)$", ps) and leaf.ndim >= 4:
            return at(leaf, {-4: lead, -2: MODEL_AXIS})  # (.., B, C, kv, hd)
        if re.search(r"wkv$", ps) and leaf.ndim >= 4:
            return at(leaf, {-4: lead, -3: MODEL_AXIS})  # heads
        if re.search(r"/conv$", ps) and leaf.ndim >= 3:
            return at(leaf, {-3: lead})                  # (.., B, W-1, R)
        if re.search(r"(slot_pos|tm_shift|cm_shift|^h$|/h$)", ps) \
                and leaf.ndim >= 2:
            return at(leaf, {-2: lead})                  # (.., B, X)
        return P()

    return _map_with_path(one, cache)


def with_node_axis(tree_: Any, nodes: int) -> Any:
    """Tile a param tree with a leading node axis (replicated start state):
    each leaf a broadcast view, as ``jnp.broadcast_to`` gives; copy it
    before writing to it."""
    return tree.tree_map(
        lambda leaf: leaf[None].expand((nodes,) + tuple(leaf.shape)), tree_)


# -- the active mesh ----------------------------------------------------------

_ACTIVE_MESH: list = []        # pushed and popped by ``with mesh:``


def active_mesh():
    """The innermost active mesh, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def check_axis(axis, what: str) -> None:
    """Refuse a mesh ``axis`` (a name or a tuple of names) that the active
    mesh lacks, as a sharding constraint on a missing axis fails in the
    reference; with no active mesh any name is recorded as given."""
    mesh = active_mesh()
    if axis is None or mesh is None:
        return
    for name in axis if isinstance(axis, tuple) else (axis,):
        if name not in mesh.axis_names:
            raise ValueError(f"{what}: axis {name!r} is not an axis of the "
                             f"active mesh {tuple(mesh.axis_names)}")
