"""Faults planted underneath the timed path, for showing that the
comparison fails what it must. Neither the measuring runs nor `run.py` use
them: the tests do, at a toy size, and ``calibrate.py`` on the chip at the
cells' own size. (The control, the reference one precision lower in the
program's place, is the drivers' ``ctx.control``.)

`fault` patches every entry the drivers build their timed path from, so
one context serves every cell:

* ``unchanged``: a chunk of rounds (`repro_torch.api.runner.
  make_chunk_program`) or a training step (`repro_torch.launch.steps`)
  returns the state it was given;
* ``half_batch``: the second half of each round's nodes, or of each
  step's rows, see the first half's, so the batch's mean is taken over
  half of it;
* ``no_exchange``: the ring's neighbour weights are 0, nothing is mixed;
* ``altered``: one answer is changed where it is produced: a node's loss
  in a round of the first chunk, or the second training step's loss.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "fault"]

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def _halve(x: torch.Tensor, dim: int) -> torch.Tensor:
    h = x.shape[dim] // 2
    first = x.narrow(dim, 0, h)
    return torch.cat([first, first], dim=dim)


def _chunk_program(real, name):
    def patched(spec, engine="sim", device="cuda"):
        if name == "no_exchange":
            return real(spec.replace(mixer_options={"self_weight": 1.0}),
                        engine, device)
        chunk_fn, init_fn = real(spec, engine, device)
        first = [True]

        def broken(state, xs, ys):
            if name == "half_batch":
                xs, ys = _halve(xs, 1), _halve(ys, 1)
            new, out = chunk_fn(state, xs, ys)
            if name == "unchanged":
                new = state
            if name == "altered" and first[0] and xs.shape[0] > 1:
                first[0] = False
                out = out._replace(loss=out.loss.clone())
                out.loss[-1, 0] += 0.5
            return new, out

        return broken, init_fn
    return patched


def _train_step(step, name):
    calls = [0]

    def broken(state, batch):
        calls[0] += 1
        if name == "half_batch":
            batch = {k: _halve(v, v.dim() - 2) for k, v in batch.items()}
        new, out = step(state, batch)
        if name == "unchanged":
            new = state
        if name == "altered" and calls[0] == 2:
            out = dict(out, loss=out["loss"] + 0.5)
        return new, out
    return broken


@contextlib.contextmanager
def fault(name: str):
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; expected one of {FAULTS}")
    from repro_torch.api import runner
    from repro_torch.launch import steps
    real = (runner.make_chunk_program, steps.make_gossip_train_step,
            steps.make_allreduce_train_step, steps.make_gossip_dp)

    def gossip_step(model, gdp, *a, **kw):
        return _train_step(real[1](model, gdp, *a, **kw), name)

    def allreduce_step(model, recipe, *a, **kw):
        step, init = real[2](model, recipe, *a, **kw)
        return _train_step(step, name), init

    def gossip_dp(nodes, recipe):
        spec = recipe.to_runspec(nodes)
        if name == "no_exchange":
            spec = spec.replace(mixer_options={"self_weight": 1.0})
        return spec.build_distributed()

    runner.make_chunk_program = _chunk_program(real[0], name)
    if name == "no_exchange":
        steps.make_gossip_dp = gossip_dp
    else:
        steps.make_gossip_train_step = gossip_step
        steps.make_allreduce_train_step = allreduce_step
    try:
        yield
    finally:
        (runner.make_chunk_program, steps.make_gossip_train_step,
         steps.make_allreduce_train_step, steps.make_gossip_dp) = real
