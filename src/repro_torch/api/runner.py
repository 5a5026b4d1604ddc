"""`repro_torch.run` — one call from RunSpec to RunResult, for either engine.

Counterpart of `repro.api.runner.run`. It resolves the spec's Stream,
drives the horizon chunk by chunk on either engine — the dense simulator
(``engine="sim"``, `core.algorithm1`) or the node-stacked distributed
strategy (``engine="dist"``, `core.gossip.GossipDP`) — through the spec's
backend (a Python loop over rounds in place of ``lax.scan``), threads a
`PrivacyAccountant` into a per-round eps ledger, records the loss,
accuracy and sparsity trajectories, computes the Definition-3 regret, and
supports periodic checkpoints with bit-identical resume. Under a fault
scenario (``RunSpec.faults``) crashed rounds are not charged to a node's
eps, and the result carries the run's per-round connectivity and
``metrics["faults"]``.

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
>>> dist = run(spec, engine="dist", exec=cfg, device="cpu")
>>> bool((res.final_w == dist.final_w).all())     # seeded, bit-identical
True

Both engines draw the same stream chunks and the same noise from a
generator seeded alike, in the same order, so their iterates are
bit-identical (see `core.gossip`).

`run_batch` drives S seeds of one configuration in step (`BatchState`):
each seed's RunResult equals its own `run` bit for bit, and on the cuda
backend one launch of each round kernel a round serves all S seeds.

>>> from repro_torch import run_batch
>>> batch = run_batch(spec, (0, 1), exec=cfg, device="cpu")
>>> bool((batch[1].final_w == run(spec.replace(seed=1), exec=cfg,
...                                  device="cpu").final_w).all())
True
>>> batch[0].metrics["batch"]["seeds"]
[0, 1]
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.spec import RunSpec
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core import tree
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.device import resolve_device, synchronize

__all__ = ["run", "run_batch", "seed_vectorizable", "RunResult",
           "BatchState", "make_chunk_program", "make_batch_chunk_program",
           "reference_round_program", "reference_chunk_program",
           "reference_batch_chunk_program", "chunk_loop", "per_seed_round",
           "batch_init", "stack_states", "seed_state"]


# -- JSON round-trip ---------------------------------------------------------
#
# A record must give back the RunResult EXACTLY: trajectories, eps ledger,
# final parameters and (optionally) the engine state. float32 values
# survive the trip through Python floats untouched (float32 is a subset of
# float64, and repr round-trips), so equality is bit equality.

def _encode(obj: Any) -> Any:
    """JSON-able encoding of an array, a tensor or an engine state."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        return {"__ndarray__": arr.tolist(), "dtype": str(arr.dtype),
                "shape": list(arr.shape)}
    if isinstance(obj, torch.Tensor):
        arr = obj.detach().cpu().numpy()
        return {"__tensor__": arr.tolist(), "dtype": str(arr.dtype),
                "shape": list(arr.shape)}
    if isinstance(obj, torch.Generator):
        return {"__generator__": obj.get_state().tolist(),
                "device": str(obj.device)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # NamedTuple
        return {"__namedtuple__": type(obj).__name__,
                "fields": {f: _encode(getattr(obj, f)) for f in obj._fields}}
    if isinstance(obj, dict):
        return {"__dict__": {str(k): _encode(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__list__": [_encode(v) for v in obj],
                "tuple": isinstance(obj, tuple)}
    raise TypeError(f"cannot encode {type(obj).__name__} for the JSON record")


def _state_types() -> dict:
    from repro_torch.core.algorithm1 import SimState
    from repro_torch.core.gossip import GossipState
    return {"SimState": SimState, "GossipState": GossipState}


def _decode(obj: Any, device: torch.device) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if "__ndarray__" in obj:
        return np.asarray(obj["__ndarray__"],
                          dtype=obj["dtype"]).reshape(obj["shape"])
    if "__tensor__" in obj:
        arr = np.asarray(obj["__tensor__"], dtype=obj["dtype"])
        return torch.as_tensor(arr.reshape(obj["shape"]), device=device)
    if "__generator__" in obj:
        gen = torch.Generator(device=device)
        gen.set_state(torch.tensor(obj["__generator__"], dtype=torch.uint8))
        return gen
    if "__namedtuple__" in obj:
        cls = _state_types()[obj["__namedtuple__"]]
        return cls(**{k: _decode(v, device)
                      for k, v in obj["fields"].items()})
    if "__dict__" in obj:
        return {k: _decode(v, device) for k, v in obj["__dict__"].items()}
    if "__list__" in obj:
        seq = [_decode(v, device) for v in obj["__list__"]]
        return tuple(seq) if obj.get("tuple") else seq
    raise TypeError(f"cannot decode record node {obj!r}")


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
    connectivity: np.ndarray | None = None  # (T,) surviving off-diagonal
    #                                         mixing weight (faulty runs)
    accuracy: float | None = None         # mean correctness, last 20%
    final_w: np.ndarray | None = None     # (m, n) final primal parameters
    final_state: Any = None               # engine state (checkpointable)
    metrics: dict = dataclasses.field(default_factory=dict)

    def accuracy_curve(self, window: int = 50) -> np.ndarray:
        """Moving-window mean accuracy over the horizon."""
        correct = self.correct.mean(axis=1)
        c = np.cumsum(np.insert(correct, 0, 0.0))
        return (c[window:] - c[:-window]) / window

    def summary(self) -> dict:
        return {
            "engine": self.engine,
            "stream": self.stream,
            "rounds": self.rounds,
            "wall_clock_s": round(self.wall_clock, 3),
            "rounds_per_sec": round(self.rounds_per_sec, 2),
            "accuracy": self.accuracy,
            "regret_final": (None if self.regret is None
                             else float(self.regret[-1])),
            "eps_total": self.privacy.get("eps_total"),
        }

    _ARRAY_FIELDS = ("eps_ledger", "loss", "w_bar_loss", "correct",
                     "sparsity", "regret", "connectivity", "final_w")

    def to_record(self, include_state: bool = False) -> dict:
        """JSON-able dict that `from_record` reconstructs exactly.

        Every trajectory array, the eps ledger and final_w round-trip bit
        for bit. ``include_state=True`` also encodes the engine state
        (`SimState` or `GossipState`: its tensors, round counter, noise
        generator state and history ring), so a stored record can seed a
        resumed run.
        """
        rec: dict[str, Any] = {
            "engine": self.engine,
            "rounds": self.rounds,
            "start_round": self.start_round,
            "wall_clock": self.wall_clock,
            "rounds_per_sec": self.rounds_per_sec,
            "device": self.device,
            "stream": self.stream,
            "accuracy": self.accuracy,
            "privacy": dict(self.privacy),
            "metrics": dict(self.metrics),
        }
        for f in self._ARRAY_FIELDS:
            v = getattr(self, f)
            rec[f] = None if v is None else _encode(np.asarray(v))
        rec["final_state"] = (_encode(self.final_state)
                              if include_state and self.final_state
                              is not None else None)
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "RunResult":
        """The RunResult of a record; an encoded engine state comes back on
        the device the run was on (and raises if that is a card and there
        is none)."""
        kw = {k: rec[k] for k in ("engine", "rounds", "start_round",
                                  "wall_clock", "rounds_per_sec", "device",
                                  "stream", "accuracy")}
        kw["privacy"] = dict(rec.get("privacy") or {})
        kw["metrics"] = dict(rec.get("metrics") or {})
        for f in cls._ARRAY_FIELDS:
            v = rec.get(f)
            kw[f] = None if v is None else _decode(v, torch.device("cpu"))
        fs = rec.get("final_state")
        kw["final_state"] = (None if fs is None else _decode(
            fs, resolve_device(rec["device"])))
        return cls(**kw)


def make_chunk_program(spec: RunSpec, engine: str = "sim",
                       device: str | torch.device = "cuda"):
    """(chunk_fn, init_fn) for one engine, through the spec's backend.

    chunk_fn(state, xs, ys) runs a chunk of rounds and returns (state,
    RoundOutput of stacked per-round tensors); init_fn(seed) builds the
    engine state on ``device``.
    """
    return spec.resolve_backend().make_chunk_program(
        spec, engine, resolve_device(device))


def make_batch_chunk_program(spec: RunSpec, engine: str = "sim",
                             device: str | torch.device = "cuda"):
    """(chunk_fn, init_fn) of a seed batch, through the spec's backend.

    chunk_fn(state, xs, ys) runs a chunk of rounds of every seed: xs is
    (C, S, m, n), ys (C, S, m), and the RoundOutput fields are stacked
    (C, S, ...). init_fn(seeds) builds the `BatchState` on ``device``.
    """
    return spec.resolve_backend().make_batch_chunk_program(
        spec, engine, resolve_device(device))


def chunk_loop(round_fn: Callable) -> Callable:
    """chunk_fn(state, xs, ys) -> (state, stacked RoundOutput): the Python
    loop over rounds that takes the place of the reference's lax.scan."""
    from repro_torch.core.algorithm1 import RoundOutput

    def chunk_fn(state, xs, ys):
        outs = []
        for k in range(xs.shape[0]):
            state, out = round_fn(state, (xs[k], ys[k]))
            outs.append(out)
        return state, RoundOutput(*(torch.stack(f) for f in zip(*outs)))

    return chunk_fn


def reference_round_program(spec: RunSpec, engine: str,
                            device: torch.device):
    """(round_fn, init_fn) of the torch-op engines — the reference backend
    (and the init_fn every backend shares)."""
    from repro_torch.core import prox
    from repro_torch.core.algorithm1 import RoundOutput, hinge_loss_and_grad

    m, n = spec.nodes, spec.dim
    if n is None:
        raise ValueError("RunSpec.dim is required by repro_torch.run")

    if engine == "sim":
        alg = spec.build_simulator()
        return alg.round, lambda seed: alg.init(seed, device)

    if engine == "dist":
        gdp = spec.build_distributed()
        loss_and_grad = spec.loss_and_grad or hinge_loss_and_grad

        def round_fn(st, batch):
            x, y = batch
            w = gdp.primal(st)["w"]
            loss, grad = loss_and_grad(w, x, y)
            correct = (torch.sign(torch.sum(w * x, dim=1)) == y).to(
                torch.float32)
            st, _ = gdp.update(st, {"w": grad})
            # the metric algebra of Algorithm1.round, so the two engines'
            # trajectories compare element for element
            w_bar = torch.mean(w, dim=0, keepdim=True)
            wb_loss = torch.mean(torch.clamp_min(
                1.0 - y * torch.sum(w_bar * x, dim=-1), 0.0))
            return st, RoundOutput(loss=loss, w_bar_loss=wb_loss,
                                   sparsity=prox.sparsity(w),
                                   correct=correct)

        def init_fn(seed):
            return gdp.init({"w": torch.zeros((m, n), dtype=torch.float32)},
                            seed, device)

        return round_fn, init_fn

    raise ValueError(f"unknown engine {engine!r}; expected 'sim' or 'dist'")


def reference_chunk_program(spec: RunSpec, engine: str,
                            device: torch.device):
    """(chunk_fn, init_fn) of the reference backend."""
    round_fn, init_fn = reference_round_program(spec, engine, device)
    return chunk_loop(round_fn), init_fn


# -- seed batches ------------------------------------------------------------

class BatchState(NamedTuple):
    """S runs of one configuration in step (`run_batch`): the engine's
    theta and delay ring — a tensor (sim) or ``{"w": tensor}`` (dist) —
    with a leading seed axis, the round counter they share, and each seed's
    own noise generator."""

    theta: Any                    # (S, m, n) or {"w": (S, m, n)}
    t: int                        # rounds done
    generators: tuple             # one torch.Generator per seed
    history: Any = None           # (S, delay+1, m, n) ring, or None


def stack_states(states) -> BatchState:
    """The `BatchState` of per-seed engine states (all at one round); one
    state becomes a batch of one as views of its tensors (its delay ring
    is then written in place, as the one-seed round writes it)."""
    stack = ((lambda t: t[None]) if len(states) == 1  # noqa: E731
             else lambda *ts: torch.stack(ts))
    first = states[0]
    return BatchState(
        theta=tree.tree_map(stack, *(s.theta for s in states)), t=first.t,
        generators=tuple(s.generator for s in states),
        history=(None if first.history is None else
                 tree.tree_map(stack, *(s.history for s in states))))


def seed_state(engine: str, state: BatchState, i: int):
    """Seed ``i``'s engine state (`SimState` or `GossipState`) in a batch:
    views of its slices, and its own generator."""
    cls = _state_types()["SimState" if engine == "sim" else "GossipState"]
    pick = lambda a: a[i]  # noqa: E731
    return cls(theta=tree.tree_map(pick, state.theta), t=state.t,
               generator=state.generators[i],
               history=(None if state.history is None
                        else tree.tree_map(pick, state.history)))


def per_seed_round(round_fn: Callable, engine: str) -> Callable:
    """A batch round that steps ``round_fn`` once per seed, in seed order,
    on that seed's slices (the reference backend's batch: the plain
    per-seed algebra, the oracle of the fused batch)."""
    from repro_torch.core.algorithm1 import RoundOutput

    def batch_round(state: BatchState, batch):
        xs, ys = batch
        steps = [round_fn(seed_state(engine, state, i), (xs[i], ys[i]))
                 for i in range(len(state.generators))]
        return (stack_states([st for st, _ in steps]),
                RoundOutput(*(torch.stack(f)
                              for f in zip(*(out for _, out in steps)))))

    return batch_round


def batch_init(init_fn: Callable) -> Callable:
    """init_fn(seeds) -> the `BatchState` of the seeds' initial states."""
    return lambda seeds: stack_states([init_fn(s) for s in seeds])


def reference_batch_chunk_program(spec: RunSpec, engine: str,
                                  device: torch.device):
    """(chunk_fn, init_fn) of a seed batch on the reference backend."""
    round_fn, init_fn = reference_round_program(spec, engine, device)
    return chunk_loop(per_seed_round(round_fn, engine)), batch_init(init_fn)


def _config_eq(a: Any, b: Any) -> bool:
    """Structural equality for resolved protocol stages (mixers etc.)."""
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return (np.shape(a) == np.shape(b)
                and bool(np.array_equal(np.asarray(a), np.asarray(b))))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return all(_config_eq(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return (a.keys() == b.keys()
                and all(_config_eq(v, b[k]) for k, v in a.items()))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_config_eq(x, y) for x, y in zip(a, b)))
    if hasattr(a, "__dict__") and not callable(a):
        return _config_eq(vars(a), vars(b))
    try:
        return bool(a == b)
    except Exception:
        return False


def seed_vectorizable(spec: RunSpec, seeds) -> bool:
    """True when a seed batch can share ONE chunk program.

    The batched round builds the resolved mixer (and the rest of the stage
    pipeline) once, from the first seed; only the noise generator and the
    stream data vary per seed. Seeded topologies ('random',
    'time_varying', per-edge `delay_dist` draws) resolve to DIFFERENT mixing
    matrices per seed, so they must fall back to sequential `run()` calls —
    `repro_torch.sweep` consults this predicate to pick the path.
    """
    seeds = list(seeds)
    if len(seeds) <= 1:
        return True
    base = spec.replace(seed=seeds[0]).resolve_mixer()
    return all(_config_eq(spec.replace(seed=s).resolve_mixer(), base)
               for s in seeds[1:])


# -- the drive loop shared by run and run_batch --------------------------------

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


def _copy_gen(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _copy_state(state):
    """An independent copy of an engine state or a `BatchState` (the round
    writes the delay ring in place and advances the generators)."""
    clone = lambda t: t.clone()  # noqa: E731
    gens = ({"generators": tuple(map(_copy_gen, state.generators))}
            if isinstance(state, BatchState)
            else {"generator": _copy_gen(state.generator)})
    return state._replace(theta=tree.tree_map(clone, state.theta),
                          history=tree.tree_map(clone, state.history),
                          **gens)


def _final_primal(spec: RunSpec, engine: str, state) -> np.ndarray:
    """(m, n) primal parameters of the final state — the same schedule
    context for both engines (that of the last round, as the reference's
    runner)."""
    rule = spec.resolve_local_rule()
    ctx = spec.omd_config().step_context(state.t)
    theta = state.theta if engine == "sim" else state.theta["w"]
    return rule.primal(theta, ctx).cpu().numpy()


def _stream_chunk(stream, a: int, b: int, dev: torch.device):
    """Rounds [a, b) of a stream as float32 tensors on ``dev``."""
    xs, ys = stream.chunk(a, b)
    return (torch.as_tensor(xs, dtype=torch.float32).to(dev),
            torch.as_tensor(ys, dtype=torch.float32).to(dev))


def _accountant(spec: RunSpec, stream) -> PrivacyAccountant:
    # a custom stream that does not DECLARE disjoint rounds gets the
    # pessimistic sequential composition — never overstate a DP guarantee
    mech = spec.resolve_mechanism()
    return PrivacyAccountant(
        eps_per_round=spec.eps if mech.is_private else math.inf,
        disjoint_streams=getattr(stream, "disjoint", False))


def _restore(cfg: ExecConfig, state):
    """(state, start): the latest checkpoint when resuming, else as given."""
    if not cfg.resume:
        return state, 0
    if not cfg.checkpoint_dir:
        raise ValueError("resume=True needs checkpoint_dir=")
    found = latest_step(cfg.checkpoint_dir)
    if found is None:
        return state, 0
    return restore_checkpoint(cfg.checkpoint_dir, state, step=found), found


def _drive(cfg: ExecConfig, chunk_fn: Callable, chunk: Callable, state,
           start: int, T: int, accountant: PrivacyAccountant, fault_sched,
           dev: torch.device):
    """The timed chunk loop of rounds [start, T): (state, per-chunk
    outputs, per-chunk xs and ys kept for the regret, loop wall seconds).
    ``chunk(a, b)`` makes the stream's rounds [a, b) on ``dev``."""
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
        if fault_sched is not None and fault_sched.has_crashes:
            # crashed rounds release no noised broadcast — not charged
            accountant.step(b - a,
                            participation=fault_sched.participation(a, b))
        else:
            accountant.step(b - a)
        outs.append(out)
        if cfg.compute_regret:
            xs_all.append(xs)
            ys_all.append(ys)
        if (cfg.checkpoint_every and cfg.checkpoint_dir
                and b % cfg.checkpoint_every == 0):
            save_checkpoint(cfg.checkpoint_dir, b, state)
    synchronize(dev)
    return state, outs, xs_all, ys_all, time.perf_counter() - t0


def _gather(outs: list, field: str) -> np.ndarray | None:
    """One RoundOutput field over every chunk, on the host (None when no
    round ran)."""
    if not outs:
        return None
    return torch.cat([getattr(o, field) for o in outs]).cpu().numpy()


_TRAJECTORIES = ("loss", "w_bar_loss", "correct", "sparsity")


def _result(spec: RunSpec, engine: str, stream, state, traj: dict, regret,
            *, T: int, start: int, wall: float, rate: float,
            dev: torch.device, accountant: PrivacyAccountant, fault_sched,
            conn) -> RunResult:
    """One run's RunResult from its trajectories and final state."""
    correct = traj["correct"]
    tail = max(1, int(correct.shape[0] * 0.2)) if correct is not None else 1
    result = RunResult(
        engine=engine,
        rounds=T,
        start_round=start,
        wall_clock=wall,
        rounds_per_sec=rate,
        device=str(dev),
        stream=(spec.stream if isinstance(spec.stream, str)
                else type(stream).__name__),
        eps_ledger=np.asarray(accountant.ledger(T)[start:]),
        privacy=accountant.summary(),
        regret=regret,
        accuracy=(float(correct[-tail:].mean()) if correct is not None
                  else None),
        final_w=_final_primal(spec, engine, state),
        final_state=state,
        **traj,
    )
    result.metrics = result.summary()
    if conn is not None:
        result.connectivity = conn.copy()
        result.metrics["faults"] = _fault_metrics(spec, fault_sched, conn)
    return result


def _connectivity(fault_mixer, T: int, start: int, dev: torch.device):
    """A faulty run's per-round connectivity over [start, T), else None."""
    if fault_mixer is None or T - start <= 0:
        return None
    return fault_mixer.connectivity(T, dev)[start:]


def _exec_config(exec: ExecConfig | None, caller: str) -> ExecConfig:
    cfg = exec if exec is not None else ExecConfig()
    if not isinstance(cfg, ExecConfig):
        raise TypeError(f"{caller}() exec= expects an ExecConfig, got "
                        f"{type(cfg).__name__}")
    return cfg


def run(spec: RunSpec, engine: str = "sim", *,
        exec: ExecConfig | None = None, horizon: int | None = None,
        device: str | torch.device = "cuda") -> RunResult:
    """Drive one run end to end on ``engine`` ("sim" or "dist") and return
    a RunResult.

    ``exec=ExecConfig(...)`` carries the execution knobs. ``horizon`` cuts
    the run short of ``spec.horizon``. ``device`` defaults to CUDA and
    raises without it; pass ``device="cpu"`` for the plain PyTorch path.
    ``checkpoint_every`` saves the engine state every N rounds into
    ``checkpoint_dir``; ``resume=True`` restores the latest checkpoint and
    continues bit-identically.
    """
    cfg = _exec_config(exec, "run")
    dev = resolve_device(device)
    stream = spec.resolve_stream(device=dev)
    T = horizon or spec.horizon or stream.rounds
    accountant = _accountant(spec, stream)

    # repro_torch.faults: one resolved faulty mixer for accounting and
    # metrics — its pattern is a function of FaultSpec.seed and the round,
    # so it agrees with the one the chunk program mixes with
    fault_mixer = spec.resolve_mixer() if spec.faults is not None else None
    fault_sched = getattr(fault_mixer, "schedule", None)

    chunk_fn, init_fn = make_chunk_program(spec, engine, dev)
    state, start = _restore(cfg, init_fn(spec.seed))
    accountant.rounds = start
    state, outs, xs_all, ys_all, wall = _drive(
        cfg, chunk_fn, lambda a, b: _stream_chunk(stream, a, b, dev), state,
        start, T, accountant, fault_sched, dev)

    traj = {f: _gather(outs, f) for f in _TRAJECTORIES}
    regret = None
    if cfg.compute_regret and start == 0 and xs_all:
        from repro_torch.core.regret import cumulative_regret
        xs_cat, ys_cat = torch.cat(xs_all), torch.cat(ys_all)
        del xs_all, ys_all
        regret = cumulative_regret(traj["w_bar_loss"], xs_cat, ys_cat,
                                   spec.nodes)

    done = T - start
    return _result(spec, engine, stream, state, traj, regret, T=T,
                   start=start, wall=wall,
                   rate=(done / wall) if wall > 0 else float("inf"),
                   dev=dev, accountant=accountant, fault_sched=fault_sched,
                   conn=_connectivity(fault_mixer, T, start, dev))


def run_batch(spec: RunSpec, seeds, engine: str = "sim", *,
              exec: ExecConfig | None = None, horizon: int | None = None,
              device: str | torch.device = "cuda") -> list[RunResult]:
    """Run one configuration under S seeds in step; S RunResults.

    Counterpart of `repro.api.run_batch`, whose `jax.vmap` of the chunk
    program lifts every kernel into one launch with a seed grid axis. Here
    the seed axis is written out: the engine state carries a leading seed
    axis on theta and the delay ring (`BatchState`), each seed keeps its
    own noise generator, and the stream chunks of the seeds are stacked
    (C, S, m, n). On ``backend="cuda"`` a round is ONE ``round_stats`` and
    ONE ``round_update`` (or ``dual_step``) launch for all S seeds; the
    reference backend steps each seed's round in seed order.

    Each returned RunResult equals ``run(spec.replace(seed=s), engine,
    device=device)`` field by field, bit for bit; only ``wall_clock`` (the
    batch wall / S), ``rounds_per_sec`` (S * rounds / wall) and the timing
    keys of ``metrics`` differ, and ``metrics["batch"]`` holds the batch's
    totals. Under a fault scenario every seed runs the same fault pattern
    (``FaultSpec.seed`` belongs to the scenario, not the run).

    Checkpoints (``checkpoint_every``/``checkpoint_dir``/``resume``) hold
    every seed's state — tensors, round, generator state, delay ring — and
    resume bit-identically; a batch resumed at its horizon returns empty
    trajectories, as `run` does.

    Raises ValueError when the spec's resolved mixer depends on the seed
    (see `seed_vectorizable`) and ``exec.check_vectorizable`` is set —
    `repro_torch.sweep` falls back to sequential per-seed runs then.
    """
    cfg = _exec_config(exec, "run_batch")
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("run_batch needs at least one seed")
    if cfg.check_vectorizable and not seed_vectorizable(spec, seeds):
        raise ValueError(
            "the resolved mixer depends on RunSpec.seed (seeded topology or "
            "delay_dist); a batch would share one mixing matrix across "
            "seeds — run sequentially per seed instead (repro_torch.sweep "
            "does this fallback automatically)")
    dev = resolve_device(device)
    specs = [spec.replace(seed=s) for s in seeds]
    base, S = specs[0], len(seeds)
    streams = [sp.resolve_stream(device=dev) for sp in specs]
    T = horizon or base.horizon or streams[0].rounds
    accountant = _accountant(base, streams[0])
    fault_mixer = base.resolve_mixer() if base.faults is not None else None
    fault_sched = getattr(fault_mixer, "schedule", None)

    def chunk(a: int, b: int):
        pairs = [_stream_chunk(st, a, b, dev) for st in streams]
        return (torch.stack([p[0] for p in pairs], dim=1),
                torch.stack([p[1] for p in pairs], dim=1))

    chunk_fn, init_fn = make_batch_chunk_program(base, engine, dev)
    state, start = _restore(cfg, init_fn(seeds))
    accountant.rounds = start
    state, outs, xs_all, ys_all, wall = _drive(
        cfg, chunk_fn, chunk, state, start, T, accountant, fault_sched, dev)

    stacked = {f: _gather(outs, f) for f in _TRAJECTORIES}   # (T', S, ...)
    done = T - start
    rate = S * done / wall if wall > 0 else float("inf")
    conn = _connectivity(fault_mixer, T, start, dev)
    batch_info = {"seeds": seeds, "wall_clock_s": wall, "devices": 1,
                  "pad_seeds": 0, "seed_rounds_per_sec": rate}
    results = []
    for i, (sp, st) in enumerate(zip(specs, streams)):
        traj = {f: None if v is None else np.ascontiguousarray(v[:, i])
                for f, v in stacked.items()}
        regret = None
        if cfg.compute_regret and start == 0 and xs_all:
            from repro_torch.core.regret import cumulative_regret
            xs_cat = torch.cat([xs[:, i] for xs in xs_all])
            ys_cat = torch.cat([ys[:, i] for ys in ys_all])
            regret = cumulative_regret(traj["w_bar_loss"], xs_cat, ys_cat,
                                       sp.nodes)
            del xs_cat, ys_cat
        res = _result(sp, engine, st, seed_state(engine, state, i), traj,
                      regret, T=T, start=start, wall=wall / S, rate=rate,
                      dev=dev, accountant=accountant,
                      fault_sched=fault_sched, conn=conn)
        res.metrics["batch"] = dict(batch_info)
        results.append(res)
    return results


def _fault_metrics(spec: RunSpec, fault_sched, conn: np.ndarray) -> dict:
    """Per-run degradation summary attached as ``metrics['faults']``."""
    name = (spec.faults if isinstance(spec.faults, str)
            else getattr(spec.faults, "name", "faults"))
    return {
        "spec": name,
        "mean_connectivity": float(conn.mean()),
        "min_connectivity": float(conn.min()),
        "crash_windows": len(fault_sched.crash_windows),
        "partitions": len(fault_sched.partitions),
    }
