"""`repro_torch.run` — one call from RunSpec to RunResult.

Counterpart of `repro.api.runner.run` for the simulator engine. It resolves
the spec's Stream, drives the horizon chunk by chunk through the spec's
backend (a Python loop over rounds in place of ``lax.scan``), threads a
`PrivacyAccountant` into a per-round eps ledger, records the loss,
accuracy and sparsity trajectories, computes the Definition-3 regret, and
supports periodic checkpoints with bit-identical resume.

The run happens on ``device`` — CUDA unless the caller passes
``device="cpu"``. The stream's chunks, the per-round outputs and the regret
inputs stay on the device until the run ends (at the paper's scale the whole
stream is 4.0 GB); the host reads them once, at the end.

>>> from repro_torch import ExecConfig, RunSpec, run
>>> spec = RunSpec(nodes=2, dim=8, horizon=6, eps=1.0, alpha0=0.5, lam=0.01)
>>> cfg = ExecConfig(chunk_rounds=3, compute_regret=False, warmup=False)
>>> res = run(spec, exec=cfg, device="cpu")
>>> res.rounds, res.correct.shape, float(res.eps_ledger[-1])
(6, (6, 2), 1.0)
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.spec import RunSpec
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.device import resolve_device, synchronize

__all__ = ["run", "RunResult", "make_chunk_program"]


@dataclasses.dataclass
class RunResult:
    """Everything a finished run knows about itself.

    Trajectories are per round, covering [start_round, rounds), as numpy
    arrays. ``eps_ledger[t]`` is the cumulative privacy guarantee after
    round start_round + t + 1.
    """

    engine: str
    rounds: int
    wall_clock: float            # seconds of the round loop (see warmup)
    rounds_per_sec: float
    device: str = "cuda"
    stream: str | None = None
    start_round: int = 0         # > 0 when resumed from a checkpoint
    eps_ledger: np.ndarray | None = None
    privacy: dict = dataclasses.field(default_factory=dict)
    loss: np.ndarray | None = None        # (T, m) per-node hinge losses
    w_bar_loss: np.ndarray | None = None  # (T,) loss of the averaged w
    correct: np.ndarray | None = None     # (T, m) prediction correctness
    sparsity: np.ndarray | None = None    # (T,) zero-fraction of w
    regret: np.ndarray | None = None      # (T,) cumulative (Definition 3)
    accuracy: float | None = None         # mean correctness, last 20%
    final_w: np.ndarray | None = None     # (m, n) final primal parameters
    final_state: Any = None               # engine state (checkpointable)


def make_chunk_program(spec: RunSpec, engine: str = "sim",
                       device: str | torch.device = "cuda"):
    """(chunk_fn, init_fn) through the spec's backend.

    chunk_fn(state, xs, ys) runs a chunk of rounds and returns (state,
    RoundOutput of stacked per-round tensors); init_fn(seed) builds the
    engine state on ``device``.
    """
    return spec.resolve_backend().make_chunk_program(
        spec, engine, resolve_device(device))


def _boundaries(start: int, T: int, chunk_rounds: int,
                checkpoint_every: int | None) -> list[int]:
    """Chunk split points: every chunk_rounds, also landing on every
    checkpoint_every multiple so checkpoints capture exact round states."""
    ts = [start]
    t = start
    while t < T:
        nxt = t + chunk_rounds
        if checkpoint_every:
            nxt = min(nxt, ((t // checkpoint_every) + 1) * checkpoint_every)
        ts.append(min(nxt, T))
        t = ts[-1]
    return ts


def _copy_state(state):
    """An independent copy (the round writes the delay ring in place and
    advances the generator)."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    hist = None if state.history is None else state.history.clone()
    return state._replace(theta=state.theta.clone(), generator=gen,
                          history=hist)


def _final_primal(spec: RunSpec, state) -> np.ndarray:
    """(m, n) primal parameters of the final state (the schedule context
    of its last round, as the reference's runner)."""
    rule = spec.resolve_local_rule()
    ctx = spec.omd_config().step_context(state.t)
    return rule.primal(state.theta, ctx).cpu().numpy()


def run(spec: RunSpec, engine: str = "sim", *,
        exec: ExecConfig | None = None, horizon: int | None = None,
        device: str | torch.device = "cuda") -> RunResult:
    """Drive one run end to end and return a RunResult.

    ``exec=ExecConfig(...)`` carries the execution knobs. ``horizon`` cuts
    the run short of ``spec.horizon``. ``device`` defaults to CUDA and
    raises without it; pass ``device="cpu"`` for the plain PyTorch path.
    ``checkpoint_every`` saves the engine state every N rounds into
    ``checkpoint_dir``; ``resume=True`` restores the latest checkpoint and
    continues bit-identically.
    """
    cfg = exec if exec is not None else ExecConfig()
    if not isinstance(cfg, ExecConfig):
        raise TypeError(f"run() exec= expects an ExecConfig, got "
                        f"{type(cfg).__name__}")
    dev = resolve_device(device)
    stream = spec.resolve_stream(device=dev)
    T = horizon or spec.horizon or stream.rounds
    m = spec.nodes

    mech = spec.resolve_mechanism()
    # a custom stream that does not DECLARE disjoint rounds gets the
    # pessimistic sequential composition — never overstate a DP guarantee
    accountant = PrivacyAccountant(
        eps_per_round=spec.eps if mech.is_private else math.inf,
        disjoint_streams=getattr(stream, "disjoint", False))

    chunk_fn, init_fn = make_chunk_program(spec, engine, dev)
    state = init_fn(spec.seed)
    start = 0
    if cfg.resume:
        if not cfg.checkpoint_dir:
            raise ValueError("resume=True needs checkpoint_dir=")
        found = latest_step(cfg.checkpoint_dir)
        if found is not None:
            state = restore_checkpoint(cfg.checkpoint_dir, state, step=found)
            start = found
    accountant.rounds = start

    def chunk(a: int, b: int):
        xs, ys = stream.chunk(a, b)
        return (torch.as_tensor(xs, dtype=torch.float32).to(dev),
                torch.as_tensor(ys, dtype=torch.float32).to(dev))

    bounds = _boundaries(start, T, cfg.chunk_rounds, cfg.checkpoint_every)
    first_chunk = None
    if cfg.warmup and len(bounds) > 1:
        first_chunk = chunk(bounds[0], bounds[1])
        chunk_fn(_copy_state(state), first_chunk[0][:1], first_chunk[1][:1])
        synchronize(dev)

    outs, xs_all, ys_all = [], [], []
    t0 = time.perf_counter()
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a == bounds[0] and first_chunk is not None:
            xs, ys = first_chunk   # don't regenerate the warmup chunk
        else:
            xs, ys = chunk(a, b)
        state, out = chunk_fn(state, xs, ys)
        accountant.step(b - a)
        outs.append(out)
        if cfg.compute_regret:
            xs_all.append(xs)
            ys_all.append(ys)
        if (cfg.checkpoint_every and cfg.checkpoint_dir
                and b % cfg.checkpoint_every == 0):
            save_checkpoint(cfg.checkpoint_dir, b, state)
    synchronize(dev)
    wall = time.perf_counter() - t0

    def gather(field: str):
        if not outs:
            return None
        return torch.cat([getattr(o, field) for o in outs]).cpu().numpy()

    correct = gather("correct")
    w_bar_loss = gather("w_bar_loss")
    regret = None
    if cfg.compute_regret and start == 0 and xs_all:
        from repro_torch.core.regret import cumulative_regret
        xs_cat, ys_cat = torch.cat(xs_all), torch.cat(ys_all)
        del xs_all, ys_all
        regret = cumulative_regret(w_bar_loss, xs_cat, ys_cat, m)

    done = T - start
    tail = max(1, int(correct.shape[0] * 0.2)) if correct is not None else 1
    return RunResult(
        engine=engine,
        rounds=T,
        start_round=start,
        wall_clock=wall,
        rounds_per_sec=(done / wall) if wall > 0 else float("inf"),
        device=str(dev),
        stream=(spec.stream if isinstance(spec.stream, str)
                else type(stream).__name__),
        eps_ledger=np.asarray(accountant.ledger(T)[start:]),
        privacy=accountant.summary(),
        loss=gather("loss"),
        w_bar_loss=w_bar_loss,
        correct=correct,
        sparsity=gather("sparsity"),
        regret=regret,
        accuracy=(float(correct[-tail:].mean()) if correct is not None
                  else None),
        final_w=_final_primal(spec, state),
        final_state=state,
    )
