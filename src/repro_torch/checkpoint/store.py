"""Checkpointing of the engine state: one npz file per step.

Counterpart of `repro.checkpoint.store`. A `SimState` is saved as
``ckpt_<step:08d>.npz`` holding ``theta``, ``t``, ``history`` (when the run
carries a delay ring) and ``generator`` (the noise generator's state), so a
resumed run continues bit-identically: the stream is keyed per absolute
round, and the generator picks up where it stopped.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def save_checkpoint(directory: str, step: int, state) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {"theta": state.theta.cpu().numpy(),
              "t": np.asarray(state.t, np.int32),
              "generator": state.generator.get_state().numpy()}
    if state.history is not None:
        arrays["history"] = state.history.cpu().numpy()
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, like, step: int | None = None):
    """The SimState saved at ``step`` (default: the latest), on the device
    of ``like`` (a freshly initialised state of the same run)."""
    from repro_torch.core.algorithm1 import SimState
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    dev = like.theta.device
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        theta = torch.as_tensor(data["theta"], device=dev)
        if theta.shape != like.theta.shape:
            raise ValueError(f"checkpoint theta {tuple(theta.shape)} does "
                             f"not match the run's {tuple(like.theta.shape)}")
        history = (torch.as_tensor(data["history"], device=dev)
                   if "history" in data.files else None)
        if (history is None) != (like.history is None):
            raise ValueError("checkpoint and run disagree on the delay ring")
        gen = torch.Generator(device=dev)
        gen.set_state(torch.as_tensor(data["generator"]))
        return SimState(theta=theta, t=int(data["t"]), generator=gen,
                        history=history)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
