"""Checkpointing of the engine state: one npz file per step.

Counterpart of `repro.checkpoint.store`. A state — the simulator's
`SimState` or the distributed engine's `GossipState` — is saved as
``ckpt_<step:08d>.npz``. Leaves are named by their flattened tree path, as
the reference names them: ``theta``, ``t`` and ``history`` for a SimState;
``theta/w``, ``t`` and ``history/w`` for a GossipState over ``{"w": ...}``.
The noise generator's state goes under ``generator`` (where the reference
keeps its PRNG key under ``key``), so a resumed run continues
bit-identically: the stream is keyed per absolute round, and the generator
picks up where it stopped. A seed batch's `BatchState` (`run_batch`) is
saved the same way with a leading seed axis on every leaf, ``generator``
holding one row per seed.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.core import tree

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _leaf_arrays(state) -> dict[str, torch.Tensor]:
    """{path: tensor} of the state's theta and history leaves."""
    out = {}
    for field in ("theta", "history"):
        out.update(tree.flatten_with_path(getattr(state, field), field))
    return out


def save_checkpoint(directory: str, step: int, state) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {key: leaf.cpu().numpy()
              for key, leaf in _leaf_arrays(state).items()}
    arrays["t"] = np.asarray(state.t, np.int32)
    gens = getattr(state, "generators", None)
    arrays["generator"] = (
        np.stack([g.get_state().numpy() for g in gens]) if gens is not None
        else state.generator.get_state().numpy())
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, like, step: int | None = None):
    """The state saved at ``step`` (default: the latest), of the same type
    and structure as ``like`` (a freshly initialised state of the same run,
    or batch) and on its device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    like_gens = getattr(like, "generators", None)
    dev = (like_gens[0] if like_gens is not None else like.generator).device
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        def load(key: str, want: torch.Tensor) -> torch.Tensor:
            if key not in data.files:
                raise ValueError(f"checkpoint has no {key!r} (the run's "
                                 "state has it: delay ring or tree differ)")
            t = torch.as_tensor(data[key])
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"checkpoint {key} {tuple(t.shape)} does "
                                 f"not match the run's {tuple(want.shape)}")
            return t.to(dev)

        fields = {}
        for field in ("theta", "history"):
            like_tree = getattr(like, field)
            fields[field] = tree.unflatten(
                tree.flatten(like_tree)[1],
                [load(k, w) for k, w in tree.flatten_with_path(like_tree,
                                                              field)])
        saved_hist = any(k == "history" or k.startswith("history/")
                         for k in data.files)
        if saved_hist != (like.history is not None):
            raise ValueError("checkpoint and run disagree on the delay ring")
        saved = data["generator"]

        def generator(row: np.ndarray) -> torch.Generator:
            gen = torch.Generator(device=dev)
            gen.set_state(torch.as_tensor(row))
            return gen

        # theta's shape check above has matched the seed count already
        gens = ({"generator": generator(saved)} if like_gens is None
                else {"generators": tuple(map(generator, saved))})
        return type(like)(theta=fields["theta"], t=int(data["t"]),
                          history=fields["history"], **gens)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
