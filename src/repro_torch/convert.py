"""Carry a reference (JAX) engine state into the port.

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
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["state_from_jax"]


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
