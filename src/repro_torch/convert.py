"""Carry a reference (JAX) engine state, or a served snapshot, into the port.

`state_from_jax` turns the arrays of a reference engine state — given as
numpy arrays keyed as `repro.checkpoint.save_checkpoint` names them, or as
the npz file it writes — into the port's state on ``device``:

- a `repro.core.algorithm1.SimState` (keys ``theta``, ``t`` and, for a
  delayed run, ``history``) becomes the port's `SimState`;
- a `repro.core.gossip.GossipState` (keys ``theta/<path>``, ``t`` and
  ``history/<path>``, e.g. ``theta/w``) becomes the port's `GossipState`,
  its theta and history rebuilt as nested dicts from the key paths.

The JAX PRNG key is not carried: the two frameworks draw different numbers
from the same key, so the port's noise generator is seeded from ``seed``
(pass the run's ``RunSpec.seed``).

`model_params_from_jax` turns the parameters of a reference LM
(`repro.models.build_model(cfg).init(key)`), flattened to numpy arrays
keyed by their pytree paths (``"layers/attn/wq/w"``, and ``"layers/0/..."``
for a per-layer list), into the port's nested dicts on ``device``, each
leaf in the dtype the port's own init gives it (bf16 arrays may come as
float32 numpy, which holds every bf16 value exactly).

`snapshot_from_jax` turns a reference serving snapshot
(`repro.serve.Snapshot`, or a mapping of its fields) into the port's
`repro_torch.serve.Snapshot` on ``device``: the same version, round and
eps, and theta, w and w_bar as float32 tensors — so the reference's model
can be published into the port's `ServeState` and served there.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["state_from_jax", "snapshot_from_jax", "model_params_from_jax"]


def _nested(flat: dict[str, torch.Tensor]):
    """Nested dicts of ``field/a/b``-keyed leaves (the field dropped), or
    None when there are none."""
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")[1:]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out or None


def state_from_jax(arrays: Mapping[str, np.ndarray] | str | os.PathLike,
                   device: str | torch.device = "cuda", *, seed: int = 0):
    """The port's state holding a reference state's theta, t and history
    (a mapping of numpy arrays, or the path of a reference npz checkpoint):
    a `SimState` for a simulator state, a `GossipState` for a distributed
    one."""
    from repro_torch.core.algorithm1 import SimState
    from repro_torch.core.gossip import GossipState
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as data:
            arrays = {k: data[k] for k in data.files}
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    t = int(np.asarray(arrays["t"]))

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=dev).contiguous()

    if "theta" not in arrays:
        leaves = {f: {k: tensor(v) for k, v in arrays.items()
                      if k.startswith(f + "/")}
                  for f in ("theta", "history")}
        if not leaves["theta"]:
            raise ValueError("no 'theta' or 'theta/...' arrays: not a "
                             "reference engine state")
        for key, th in leaves["theta"].items():
            hist = leaves["history"].get("history" + key[len("theta"):])
            if hist is not None and tuple(hist.shape[1:]) != tuple(th.shape):
                raise ValueError(f"history of {key} must be (depth,) + "
                                 f"{tuple(th.shape)}, got {tuple(hist.shape)}")
        return GossipState(theta=_nested(leaves["theta"]), t=t,
                           generator=gen,
                           history=_nested(leaves["history"]))

    theta = np.asarray(arrays["theta"], np.float32)
    if theta.ndim != 2:
        raise ValueError(f"theta must be (m, n), got {theta.shape}")
    history = arrays.get("history")
    if history is not None:
        history = np.asarray(history, np.float32)
        if history.ndim != 3 or history.shape[1:] != theta.shape:
            raise ValueError(f"history must be (depth, m, n) with (m, n) = "
                             f"{theta.shape}, got {history.shape}")
        history = tensor(history)
    return SimState(theta=tensor(theta), t=t, generator=gen, history=history)


_SNAPSHOT_FIELDS = ("version", "round", "theta", "w", "w_bar", "eps_spent")


def snapshot_from_jax(snapshot, device: str | torch.device = "cuda"):
    """The port's Snapshot of a reference one (an object with the fields
    version, round, theta, w, w_bar and eps_spent — arrays as anything
    numpy converts — or a mapping of them), its tensors on ``device``."""
    from repro_torch.serve.state import Snapshot
    get = (snapshot.__getitem__ if isinstance(snapshot, Mapping)
           else lambda f: getattr(snapshot, f))
    fields = {f: get(f) for f in _SNAPSHOT_FIELDS}
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    w = tensor(fields["w"])
    if w.dim() != 2 or tuple(np.shape(fields["w_bar"])) != (w.shape[1],):
        raise ValueError(f"w must be (m, n) and w_bar (n,), got "
                         f"{tuple(w.shape)} and {np.shape(fields['w_bar'])}")
    return Snapshot(version=int(fields["version"]),
                    round=int(fields["round"]),
                    theta=tensor(fields["theta"]), w=w,
                    w_bar=tensor(fields["w_bar"]),
                    eps_spent=float(fields["eps_spent"]))


def _tree_of_paths(flat: Mapping[str, np.ndarray]):
    """Nested dicts from ``a/b/c``-keyed leaves; a level whose keys are all
    integers becomes a list (the reference's per-layer list)."""
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def model_params_from_jax(cfg, params: Mapping[str, np.ndarray],
                          device: str | torch.device = "cuda"):
    """The port's parameters of ``cfg``'s model holding a reference
    model's: ``params`` maps each pytree path to its array. The keys and
    shapes must be those of the port's init (checked); each leaf takes the
    port's dtype for it."""
    from repro_torch.core.tree import flatten_with_path, tree_map
    from repro_torch.models import build_model
    want = build_model(cfg, device="meta").init(0)
    got = _tree_of_paths(params)
    dev = resolve_device(device)

    def leaf(w: torch.Tensor, a) -> torch.Tensor:
        a = np.array(a, np.float32 if w.is_floating_point() else None)
        if tuple(a.shape) != tuple(w.shape):
            raise ValueError(f"shape {a.shape}, the port's is "
                             f"{tuple(w.shape)}")
        return torch.from_numpy(a).to(device=dev, dtype=w.dtype)

    paths = {p for p, _ in flatten_with_path(want)}
    given = {p for p, _ in flatten_with_path(got)}
    if paths != given:
        raise ValueError(
            f"not {cfg.name}'s parameters: missing {sorted(paths - given)}, "
            f"unexpected {sorted(given - paths)}")
    return tree_map(leaf, want, got)
