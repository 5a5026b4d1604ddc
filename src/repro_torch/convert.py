"""Carry a reference (JAX) engine state into the port.

`state_from_jax` turns the arrays of a `repro.core.algorithm1.SimState` —
``theta``, ``t`` and, for a delayed run, ``history`` — given as numpy arrays
or as the npz file `repro.checkpoint.save_checkpoint` writes, into the
port's `SimState` on ``device``. The JAX PRNG key is not carried: the two
frameworks draw different numbers from the same key, so the port's noise
generator is seeded from ``seed`` (pass the run's ``RunSpec.seed``).
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["state_from_jax"]


def state_from_jax(arrays: Mapping[str, np.ndarray] | str | os.PathLike,
                   device: str | torch.device = "cuda", *, seed: int = 0):
    """The port's SimState holding a reference SimState's theta, t and
    history (a mapping of numpy arrays, or the path of a reference npz
    checkpoint)."""
    from repro_torch.core.algorithm1 import SimState
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as data:
            arrays = {k: data[k] for k in data.files}
    dev = resolve_device(device)
    theta = np.asarray(arrays["theta"], np.float32)
    if theta.ndim != 2:
        raise ValueError(f"theta must be (m, n), got {theta.shape}")
    history = arrays.get("history")
    if history is not None:
        history = np.asarray(history, np.float32)
        if history.ndim != 3 or history.shape[1:] != theta.shape:
            raise ValueError(f"history must be (depth, m, n) with (m, n) = "
                             f"{theta.shape}, got {history.shape}")
        history = torch.as_tensor(history, device=dev).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return SimState(theta=torch.as_tensor(theta, device=dev).contiguous(),
                    t=int(np.asarray(arrays["t"])), generator=gen,
                    history=history)
