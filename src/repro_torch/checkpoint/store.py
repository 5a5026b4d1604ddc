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

Any other tree — a dict, list or tuple of tensors or arrays, such as the
serving layer's ``{"theta": tensor}`` (`repro_torch.serve`) or the LM
train states of `repro_torch.launch.steps` — is saved leaf by leaf under
the same path names (``theta``; ``a/b`` for nested keys; a bfloat16
tensor as float32, which holds it exactly; a generator as its state) and
restored into the structure, dtypes and devices of a like tree.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.core import tree

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _is_engine_state(state) -> bool:
    """A SimState, GossipState or BatchState (theta, t and generators)."""
    fields = getattr(state, "_fields", ())
    return "theta" in fields and ("generator" in fields
                                  or "generators" in fields)


def _leaf_arrays(state) -> dict[str, torch.Tensor]:
    """{path: tensor} of the state's theta and history leaves."""
    out = {}
    for field in ("theta", "history"):
        out.update(tree.flatten_with_path(getattr(state, field), field))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, state) -> str:
    """Write ``state`` (an engine state, or any tree of tensors and
    arrays) as ``ckpt_<step>.npz`` in ``directory``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    if not _is_engine_state(state):
        return _write(directory, step, {key: _host(leaf) for key, leaf
                                        in tree.flatten_with_path(state)})
    arrays = {key: leaf.cpu().numpy()
              for key, leaf in _leaf_arrays(state).items()}
    arrays["t"] = np.asarray(state.t, np.int32)
    gens = getattr(state, "generators", None)
    arrays["generator"] = (
        np.stack([g.get_state().numpy() for g in gens]) if gens is not None
        else state.generator.get_state().numpy())
    return _write(directory, step, arrays)


def _write(directory: str, step: int, arrays: dict) -> str:
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, like, step: int | None = None):
    """The state saved at ``step`` (default: the latest), of the same type
    and structure as ``like`` (a freshly initialised state of the same run,
    or batch, or a tree like the one saved) and on its device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    if not _is_engine_state(like):
        return _restore_tree(os.path.join(directory, f"ckpt_{step:08d}.npz"),
                             like)
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


def _restore_tree(path: str, like):
    """The tree saved at ``path``, in the structure of ``like``: a tensor
    leaf comes back as a tensor of its dtype on its device, a generator as
    a generator in the saved state, an int or float as one, any other
    leaf as a numpy array."""
    with np.load(path) as data:
        leaves = []
        for key, want in tree.flatten_with_path(like):
            if key not in data.files:
                raise ValueError(f"checkpoint has no {key!r}")
            arr = data[key]
            if isinstance(want, torch.Generator):
                gen = torch.Generator(device=want.device)
                gen.set_state(torch.as_tensor(arr))
                leaves.append(gen)
                continue
            if tuple(arr.shape) != tuple(np.shape(want)):
                raise ValueError(f"checkpoint {key} {tuple(arr.shape)} does "
                                 f"not match {tuple(np.shape(want))}")
            if isinstance(want, torch.Tensor):
                leaves.append(torch.as_tensor(arr).to(want.device,
                                                      want.dtype))
            elif isinstance(want, (int, float)):
                leaves.append(type(want)(arr))
            else:
                leaves.append(arr)
    return tree.unflatten(tree.flatten(like)[1], leaves)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
