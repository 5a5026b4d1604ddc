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
``metrics["faults"]``. ``on_chunk`` hands the state at every chunk
boundary to a caller (the serving layer publishes snapshots from it), and
``ExecConfig.obs`` (`repro_torch.obs`) records spans, metrics and run
events of the loop without touching its math.

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
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch import obs as obslib
from repro_torch.api.exec_config import ExecConfig, resolve_exec
from repro_torch.api.spec import RunSpec
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core import tree
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.device import resolve_device, synchronize
from repro_torch.metrics import CSVLogger, MetricTracker

__all__ = ["run", "run_batch", "seed_vectorizable", "RunResult",
           "BatchState", "make_chunk_fn", "make_chunk_program",
           "make_batch_chunk_program",
           "reference_round_program", "reference_chunk_program",
           "reference_batch_chunk_program", "chunk_loop", "per_seed_round",
           "batch_init", "stack_states", "seed_state", "seed_rows_program"]


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
    round start_round + t + 1. Custom ``step_fn`` runs fill ``history``
    (one dict of float metrics a step) instead.
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
    history: list | None = None           # custom-mode per-step metrics
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
            "history": self.history,
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
        kw["history"] = rec.get("history")
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


def make_chunk_fn(spec: RunSpec, engine: str,
                  device: str | torch.device | None = None):
    """(chunk_fn, initial_state) for one engine — `make_chunk_program` with
    the state built from ``spec.seed`` on ``device`` (None: the card).
    Exposed so `launch.dryrun` measures the exact program `run` executes."""
    chunk_fn, init_fn = make_chunk_program(spec, engine,
                                           resolve_device(device))
    return chunk_fn, init_fn(spec.seed)


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


def _gen_to(gen: torch.Generator, dev: torch.device) -> torch.Generator:
    """``gen`` itself on its device, else a generator on ``dev`` in the
    same state (a CUDA generator's state — seed and offset — draws the
    same numbers on any card)."""
    if gen.device == dev:
        return gen
    out = torch.Generator(device=dev)
    out.set_state(gen.get_state())
    return out


def _take_seeds(state: BatchState, idx: list, dev: torch.device,
                real: int) -> BatchState:
    """The seeds ``idx`` of a batch as a batch on ``dev``; an index past
    the first ``real`` positions is a pad seed, with a generator of its
    own (its draws are thrown away)."""
    sel = torch.as_tensor(idx)
    take = lambda a: a[sel.to(a.device)].to(dev)  # noqa: E731
    gens = [_gen_to(state.generators[i], dev) if k < real
            else _copy_gen(_gen_to(state.generators[i], dev))
            for k, i in enumerate(idx)]
    return BatchState(theta=tree.tree_map(take, state.theta), t=state.t,
                      generators=tuple(gens),
                      history=tree.tree_map(take, state.history))


def seed_rows_program(programs: list, devices: list,
                      device: torch.device) -> Callable:
    """chunk_fn of a seed batch sharded over mesh rows: row r runs
    ``programs[r]`` (a batch chunk program) on its share of the seeds, on
    ``devices[r]``.

    State and data cross it global and unpadded on ``device``: inside, the
    S seeds are padded to a multiple of the rows with duplicates of the
    last seed (each with its own generator copy), split into equal blocks
    in seed order, run row by row, and gathered back with the pad seeds
    dropped. The seeds are independent runs, so every seed's trajectory is
    its one-device batch's, bit for bit."""
    from repro_torch.core.algorithm1 import RoundOutput

    R = len(programs)

    def chunk_fn(state: BatchState, xs, ys):
        S = len(state.generators)
        pad = (-S) % R
        per = (S + pad) // R
        order = list(range(S)) + [S - 1] * pad
        states, outs = [], []
        for r, (program, dev) in enumerate(zip(programs, devices)):
            idx = order[r * per:(r + 1) * per]
            real = max(0, min(per, S - r * per))
            sel = torch.as_tensor(idx, device=xs.device)
            st, out = program(_take_seeds(state, idx, dev, real),
                              xs[:, sel].to(dev), ys[:, sel].to(dev))
            states.append((st, real))
            outs.append(out)
        cat = lambda *ts: torch.cat(  # noqa: E731
            [t.to(device) for t in ts])[:S]
        gens = tuple(_gen_to(g, device) for st, real in states
                     for g in st.generators[:real])
        merged = BatchState(
            theta=tree.tree_map(cat, *(st.theta for st, _ in states)),
            t=states[0][0].t, generators=gens,
            history=tree.tree_map(cat, *(st.history for st, _ in states)))
        return merged, RoundOutput(*(
            torch.cat([f.to(device) for f in fs], dim=1)[:, :S]
            for fs in zip(*outs)))

    return chunk_fn


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
           dev: torch.device, *, tel, run_id: str | None, kind: str,
           span_args: dict, on_chunk: Callable | None = None):
    """The timed chunk loop of rounds [start, T): (state, per-chunk
    outputs, per-chunk xs and ys kept for the regret, loop wall seconds,
    the round it stopped at). ``chunk(a, b)`` makes the stream's rounds
    [a, b) on ``dev``.

    The loop synchronises with the card only at its end, unless something
    reads a chunk boundary: ``on_chunk(b, state, accountant)`` (a truthy
    return stops the loop there), an enabled ``tel``, whose ``<kind>.chunk``
    span times each chunk to its end, or ``cfg.log_path``, whose per-round
    rows read each chunk's outputs to the host. Telemetry only observes:
    spans, metrics and events never touch the state.

    With ``tel.cost_enabled`` one round of the first chunk is counted
    (`obs.analyze_chunk`) on a copy of the state and its generators before
    the timed loop, scaled by the first chunk's rounds, and every chunk's
    measured time is recorded beside the prediction, in the ``ChunkCost``
    returned last (None with the cost loop off)."""
    bounds = _boundaries(start, T, cfg.chunk_rounds, cfg.checkpoint_every)
    cost_on = tel.cost_enabled and len(bounds) > 1
    first_chunk = None
    if (cfg.warmup or cost_on) and len(bounds) > 1:
        # made once and reused by the loop: the cost count adds no draw
        first_chunk = chunk(bounds[0], bounds[1])
    if cfg.warmup and first_chunk is not None:
        with tel.span(f"{kind}.compile", run_id=run_id, **span_args):
            chunk_fn(_copy_state(state), first_chunk[0][:1],
                     first_chunk[1][:1])
            synchronize(dev)
    chunk_cost = None
    if cost_on:
        chunk_cost = obslib.analyze_chunk(
            chunk_fn, _copy_state(state), first_chunk[0][:1],
            first_chunk[1][:1], model=tel.cost_model,
            rounds=bounds[1] - bounds[0])
        synchronize(dev)
    logger = CSVLogger(cfg.log_path) if cfg.log_path else None

    sync_chunks = on_chunk is not None or tel.enabled
    seeds = span_args.get("seeds")
    chunk_args = {} if seeds is None else {"seeds": seeds}
    outs, xs_all, ys_all = [], [], []
    done_to = start
    with tel.profile():
        t0 = time.perf_counter()
        for a, b in zip(bounds[:-1], bounds[1:]):
            if a == bounds[0] and first_chunk is not None:
                xs, ys = first_chunk   # don't regenerate the warmup chunk
            else:
                xs, ys = chunk(a, b)
            with tel.span(f"{kind}.chunk", round_start=a, round_end=b,
                          **chunk_args) as sp:
                state, out = chunk_fn(state, xs, ys)
                if sync_chunks:
                    synchronize(dev)
            if fault_sched is not None and fault_sched.has_crashes:
                # crashed rounds release no noised broadcast — not charged
                accountant.step(b - a,
                                participation=fault_sched.participation(a, b))
            else:
                accountant.step(b - a)
            done_to = b
            if tel.enabled:
                secs = sp.duration_s
                eps_now = accountant.guarantee_at(b)
                tel.metrics.counter(f"{kind}.rounds").inc(b - a)
                tel.metrics.histogram(f"{kind}.chunk_seconds").observe(secs)
                tel.metrics.gauge(f"{kind}.eps_total").set(eps_now)
                if chunk_cost is not None:
                    chunk_cost.record(secs)
                tel.emit("chunk", run_id=run_id, round_start=a, round_end=b,
                         seconds=secs,
                         rounds_per_sec=((b - a) / secs if secs > 0
                                         else None),
                         eps=eps_now)
            outs.append(out)
            if cfg.compute_regret:
                xs_all.append(xs)
                ys_all.append(ys)
            if logger is not None:
                _log_rounds(logger, out, a, b, accountant)
            if (cfg.checkpoint_every and cfg.checkpoint_dir
                    and b % cfg.checkpoint_every == 0):
                with tel.span(f"{kind}.checkpoint", step=b):
                    save_checkpoint(cfg.checkpoint_dir, b, state)
                tel.emit("checkpoint", run_id=run_id, step=b)
            if on_chunk is not None and on_chunk(b, state, accountant):
                break
        synchronize(dev)
        wall = time.perf_counter() - t0
    if logger is not None:
        logger.close()
    return state, outs, xs_all, ys_all, wall, done_to, chunk_cost


def _log_rounds(logger: CSVLogger, out, a: int, b: int,
                accountant: PrivacyAccountant) -> None:
    """The reference's per-round CSV rows of rounds [a, b): the node-mean
    loss, w_bar's loss, sparsity, accuracy and the eps after the round,
    from the chunk's outputs read to the host once."""
    loss, wb_loss, sparsity, correct = (
        getattr(out, f).cpu().numpy()
        for f in ("loss", "w_bar_loss", "sparsity", "correct"))
    for i, t in enumerate(range(a, b)):
        logger.log(t, {
            "loss": float(loss[i].mean()),
            "w_bar_loss": float(wb_loss[i]),
            "sparsity": float(sparsity[i]),
            "accuracy": float(correct[i].mean()),
            "eps": accountant.guarantee_at(t + 1),
        })


def _cost_info(obs_info: dict, chunk_cost, tel, run_id) -> None:
    """The cost loop's record: ``metrics["obs"]["cost"]`` and the
    ``chunk_cost`` event, with the reference's keys."""
    if chunk_cost is None:
        return
    cs = chunk_cost.summary()
    obs_info["cost"] = cs
    tel.emit("chunk_cost", run_id=run_id,
             **{k: cs[k] for k in ("predicted_s", "measured_mean_s",
                                   "error_ratio", "flops", "hbm_bytes")})


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
        stream=_stream_name(spec, stream),
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


def _stream_name(spec: RunSpec, stream) -> str:
    return (spec.stream if isinstance(spec.stream, str)
            else type(stream).__name__)


def run(spec: RunSpec | None, engine: str = "sim", *,
        exec: ExecConfig | None = None, horizon: int | None = None,
        on_chunk: Callable | None = None, step_fn: Callable | None = None,
        state: Any = None, batches: Iterator | None = None,
        device: str | torch.device = "cuda", **legacy: Any) -> RunResult:
    """Drive one run end to end on ``engine`` ("sim" or "dist") and return
    a RunResult.

    ``exec=ExecConfig(...)`` carries the execution knobs (see
    `repro_torch.api.exec_config` for every field and the legacy-kwarg
    migration table); the old keyword arguments (``chunk_rounds=``,
    ``log_path=``, ...) still work through ``**legacy`` with a
    once-per-process DeprecationWarning. ``horizon`` cuts the run short of
    ``spec.horizon``. ``device`` defaults to CUDA and raises without it;
    pass ``device="cpu"`` for the plain PyTorch path. ``checkpoint_every``
    saves the engine state every N rounds into ``checkpoint_dir``;
    ``resume=True`` restores the latest checkpoint and continues
    bit-identically. ``log_path`` writes one CSV row a round (node-mean
    loss, w_bar_loss, sparsity, accuracy, eps), reading each chunk's
    outputs to the host.

    Custom mode (``step_fn=``): drives ``state, metrics = step_fn(state,
    next(batches))`` for ``horizon`` steps with the same tracking, CSV
    logging (``log_path``), eps accounting (when a spec is given),
    checkpoints of the state and ``print_every`` progress lines, and
    returns the per-step metrics as ``history``; the state and the step
    are the caller's, on whatever device they live.

    ``on_chunk(round_end, state, accountant)`` fires after every chunk with
    the ABSOLUTE round it ended on, the engine state at that round (the
    card synchronised: safe to publish or copy) and the live accountant; a
    truthy return stops the run at that boundary, and the trajectories,
    the eps ledger and ``rounds`` then cover only the completed rounds.
    The serving layer (`repro_torch.serve`) publishes its snapshots from
    this hook: a state at round r equals a fresh ``run(spec, horizon=r)``'s
    bit for bit, since streams are keyed per absolute round and chunking
    never changes a round's math.

    ``node_devices=`` (or a prebuilt ``node_mesh=`` with a "node" axis,
    `repro_torch.launch.mesh`) SHARDS the node axis: the spec's topology is
    lowered to its sparse edge-list form and each round runs per shard,
    with halo copies between shards for the cross-shard edges
    (`repro_torch.api.shard_node`). The mesh decides where each shard
    lives; an int D takes D devices of ``device``'s type (D shards on the
    CPU), and ``node_devices=1`` is the plain path. State entering and
    leaving each chunk stays global and unpadded, so checkpoints
    interchange with any device count and with the unsharded path.

    ``exec.obs`` (default: the ambient `repro_torch.obs.active()`) is the
    telemetry: when enabled, the run's warm-up, chunks, checkpoints and
    regret are spans (``run.compile``, ``run.chunk``, ``run.checkpoint``,
    ``run.regret``), ``run.rounds``, ``run.chunk_seconds``,
    ``run.eps_total`` (and ``faults.mean_connectivity``) go into its
    metrics, ``run_start``/``chunk``/``checkpoint``/``run_end`` into its
    event stream, the chunk loop runs under its profiler, and
    ``metrics["obs"]`` holds the run id. With ``Telemetry(cost=True)`` one
    round of the chunk program is counted before the timed loop and the
    predicted-vs-measured chunk cost lands in ``metrics["obs"]["cost"]``
    and a ``chunk_cost`` event. A run with telemetry on equals one with it
    off bit for bit.
    """
    cfg = resolve_exec(exec, legacy, caller="run")
    if step_fn is not None:
        return _run_custom(spec, engine, step_fn=step_fn, state=state,
                           batches=batches, horizon=horizon,
                           log_path=cfg.log_path, print_every=cfg.print_every,
                           checkpoint_every=cfg.checkpoint_every,
                           checkpoint_dir=cfg.checkpoint_dir)
    if spec is None:
        raise ValueError("run() needs a RunSpec (or step_fn= for custom mode)")
    dev = resolve_device(device)
    nmesh = None
    if cfg.node_devices is not None or cfg.node_mesh is not None:
        from repro_torch.api.shard_node import resolve_node_mesh
        from repro_torch.launch.mesh import mesh_device
        nmesh = resolve_node_mesh(cfg.node_devices, cfg.node_mesh,
                                  device=dev.type)
        if nmesh is not None:
            dev = mesh_device(nmesh, dev)
    stream = spec.resolve_stream(device=dev)
    T = horizon or spec.horizon or stream.rounds
    accountant = _accountant(spec, stream)

    # repro_torch.faults: one resolved faulty mixer for accounting and
    # metrics — its pattern is a function of FaultSpec.seed and the round,
    # so it agrees with the one the chunk program mixes with
    fault_mixer = spec.resolve_mixer() if spec.faults is not None else None
    fault_sched = getattr(fault_mixer, "schedule", None)
    tel = cfg.obs if cfg.obs is not None else obslib.active()
    run_id = tel.new_run_id() if tel.enabled else None

    if nmesh is None:
        chunk_fn, init_fn = make_chunk_program(spec, engine, dev)
    else:
        from repro_torch.api.shard_node import make_node_chunk_fn
        chunk_fn, init_fn = make_node_chunk_fn(spec, engine, nmesh)
    state, start = _restore(cfg, init_fn(spec.seed))
    accountant.rounds = start
    if tel.enabled:
        tel.emit("run_start", run_id=run_id, kind="run", engine=engine,
                 stream=_stream_name(spec, stream), nodes=spec.nodes,
                 dim=spec.dim, horizon=T, start_round=start)
    state, outs, xs_all, ys_all, wall, T, chunk_cost = _drive(
        cfg, chunk_fn, lambda a, b: _stream_chunk(stream, a, b, dev), state,
        start, T, accountant, fault_sched, dev, tel=tel, run_id=run_id,
        kind="run", span_args={"engine": engine}, on_chunk=on_chunk)

    traj = {f: _gather(outs, f) for f in _TRAJECTORIES}
    regret = None
    if cfg.compute_regret and start == 0 and xs_all:
        from repro_torch.core.regret import cumulative_regret
        xs_cat, ys_cat = torch.cat(xs_all), torch.cat(ys_all)
        del xs_all, ys_all
        with tel.span("run.regret", rounds=int(xs_cat.shape[0])):
            regret = cumulative_regret(traj["w_bar_loss"], xs_cat, ys_cat,
                                       spec.nodes)

    done = T - start
    result = _result(spec, engine, stream, state, traj, regret, T=T,
                     start=start, wall=wall,
                     rate=(done / wall) if wall > 0 else float("inf"),
                     dev=dev, accountant=accountant, fault_sched=fault_sched,
                     conn=_connectivity(fault_mixer, T, start, dev))
    if tel.enabled:
        if "faults" in result.metrics:
            tel.metrics.gauge("faults.mean_connectivity").set(
                result.metrics["faults"]["mean_connectivity"])
        result.metrics["obs"] = {"run_id": run_id}
        _cost_info(result.metrics["obs"], chunk_cost, tel, run_id)
        tel.emit("run_end", run_id=run_id, rounds=T, wall_clock_s=wall,
                 rounds_per_sec=result.rounds_per_sec,
                 accuracy=result.accuracy,
                 eps_total=result.privacy.get("eps_total"))
    return result


def _resolve_seed_mesh(devices, mesh, dev: torch.device):
    """The ("seed",) mesh to shard the batch over, or None for the
    one-device batch: ``devices=None`` keeps it, ``"auto"`` takes every
    visible device (the one-device batch on a one-device host), an int
    asks for exactly that many; a prebuilt mesh must carry a "seed" axis."""
    if mesh is not None:
        if "seed" not in mesh.axis_names:
            raise ValueError(
                f"run_batch needs a mesh with a 'seed' axis, got axes "
                f"{tuple(mesh.axis_names)}")
        return mesh if int(mesh.shape["seed"]) > 1 else None
    if devices is None:
        return None
    from repro_torch.launch.mesh import seed_mesh
    return seed_mesh(devices, device=dev.type)


def _batch_program(spec: RunSpec, engine: str, cfg: ExecConfig,
                   dev: torch.device, S: int):
    """(chunk_fn, init_fn, seed shards D, pad seeds, device) of a batch:
    the ("seed", "node") grid when ``node_devices`` or a mesh with a
    "node" axis asks for one, else the ("seed",) mesh of
    ``devices``/``mesh``, else one device. The global state sits on the
    mesh's first device."""
    from repro_torch.launch.mesh import mesh_device, seed_node_mesh
    devices, mesh = cfg.devices, cfg.mesh
    if cfg.node_devices is not None or (
            mesh is not None and "node" in mesh.axis_names):
        if mesh is not None:
            if "seed" not in mesh.axis_names:
                raise ValueError(
                    "run_batch node sharding needs a ('seed','node') mesh")
            grid = mesh
        else:
            seed_dev = 1 if devices in (None, "auto") else int(devices)
            grid = seed_node_mesh(seed_dev, cfg.node_devices,
                                  device=dev.type)
        if grid is not None:
            from repro_torch.api.shard_node import make_node_chunk_fn
            dev = mesh_device(grid, dev)
            D = int(grid.shape["seed"])
            return (*make_node_chunk_fn(spec, engine, grid, batched=True),
                    D, (-S) % D, dev)
        mesh = None
    mesh = _resolve_seed_mesh(devices, mesh, dev)
    if mesh is None:
        return (*make_batch_chunk_program(spec, engine, dev), 1, 0, dev)
    dev = mesh_device(mesh, dev)
    row = mesh.rows("seed")[0]           # row[0] is the first device, dev
    D = len(row)
    programs = {d: make_batch_chunk_program(spec, engine, d)
                for d in set(row)}
    return (seed_rows_program([programs[d][0] for d in row], list(row), dev),
            programs[dev][1], D, (-S) % D, dev)


def run_batch(spec: RunSpec, seeds, engine: str = "sim", *,
              exec: ExecConfig | None = None, horizon: int | None = None,
              device: str | torch.device = "cuda",
              **legacy: Any) -> list[RunResult]:
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

    ``devices=`` (or a prebuilt ``mesh=`` with a "seed" axis,
    `repro_torch.launch.mesh`) SHARDS the seed axis: S is padded to a
    multiple of the D seed shards with duplicates of the last seed, each
    shard steps its block of seeds on its device on the seed-batched
    kernels, and the pad seeds are dropped from every trajectory,
    checkpoint and aggregate (``metrics["batch"]`` reports ``devices`` and
    ``pad_seeds``); seeds are independent runs, so the results equal the
    one-device batch's bit for bit. ``node_devices=`` (or a mesh with both
    axes) makes a ("seed", "node") grid: each seed row runs the
    node-sharded program (`repro_torch.api.shard_node`) over its seeds;
    ``devices`` then counts the seed rows (default 1).

    ``exec.obs`` instruments the batch as `run` (``run_batch.*`` spans and
    metrics, one ``run_id`` for the batch); with ``Telemetry(cost=True)``
    the predicted-vs-measured cost is that of the whole S-seed chunk
    program. Legacy execution kwargs work as for `run`; the run-only fields
    (``log_path``, ``print_every``, ``node_mesh``) raise ValueError here.

    Raises ValueError when the spec's resolved mixer depends on the seed
    (see `seed_vectorizable`) and ``exec.check_vectorizable`` is set —
    `repro_torch.sweep` falls back to sequential per-seed runs then.
    """
    cfg = resolve_exec(exec, legacy, caller="run_batch")
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
    # the mesh (if any) decides the device the batch's global state sits on
    chunk_fn, init_fn, D, pad, dev = _batch_program(base, engine, cfg, dev,
                                                    S)
    streams = [sp.resolve_stream(device=dev) for sp in specs]
    T = horizon or base.horizon or streams[0].rounds
    accountant = _accountant(base, streams[0])
    fault_mixer = base.resolve_mixer() if base.faults is not None else None
    fault_sched = getattr(fault_mixer, "schedule", None)
    tel = cfg.obs if cfg.obs is not None else obslib.active()
    run_id = tel.new_run_id() if tel.enabled else None

    def chunk(a: int, b: int):
        pairs = [_stream_chunk(st, a, b, dev) for st in streams]
        return (torch.stack([p[0] for p in pairs], dim=1),
                torch.stack([p[1] for p in pairs], dim=1))

    state, start = _restore(cfg, init_fn(seeds))
    accountant.rounds = start
    if tel.enabled:
        tel.emit("run_start", run_id=run_id, kind="run_batch", engine=engine,
                 stream=_stream_name(spec, streams[0]), nodes=spec.nodes,
                 dim=spec.dim, horizon=T, start_round=start, seeds=seeds,
                 devices=D)
    state, outs, xs_all, ys_all, wall, _, chunk_cost = _drive(
        cfg, chunk_fn, chunk, state, start, T, accountant, fault_sched, dev,
        tel=tel, run_id=run_id, kind="run_batch",
        span_args={"engine": engine, "seeds": S})

    stacked = {f: _gather(outs, f) for f in _TRAJECTORIES}   # (T', S, ...)
    done = T - start
    rate = S * done / wall if wall > 0 else float("inf")
    conn = _connectivity(fault_mixer, T, start, dev)
    batch_info = {"seeds": seeds, "wall_clock_s": wall, "devices": D,
                  "pad_seeds": pad, "seed_rounds_per_sec": rate}
    obs_info = None
    if tel.enabled:
        obs_info = {"run_id": run_id}
        _cost_info(obs_info, chunk_cost, tel, run_id)
    results = []
    for i, (sp, st) in enumerate(zip(specs, streams)):
        traj = {f: None if v is None else np.ascontiguousarray(v[:, i])
                for f, v in stacked.items()}
        regret = None
        if cfg.compute_regret and start == 0 and xs_all:
            from repro_torch.core.regret import cumulative_regret
            xs_cat = torch.cat([xs[:, i] for xs in xs_all])
            ys_cat = torch.cat([ys[:, i] for ys in ys_all])
            with tel.span("run_batch.regret", seed=seeds[i]):
                regret = cumulative_regret(traj["w_bar_loss"], xs_cat,
                                           ys_cat, sp.nodes)
            del xs_cat, ys_cat
        res = _result(sp, engine, st, seed_state(engine, state, i), traj,
                      regret, T=T, start=start, wall=wall / S, rate=rate,
                      dev=dev, accountant=accountant,
                      fault_sched=fault_sched, conn=conn)
        res.metrics["batch"] = dict(batch_info)
        if obs_info is not None:
            res.metrics["obs"] = dict(obs_info)
        results.append(res)
    if tel.enabled:
        if conn is not None:
            tel.metrics.gauge("faults.mean_connectivity").set(
                results[0].metrics["faults"]["mean_connectivity"])
        tel.emit("run_end", run_id=run_id, rounds=T, wall_clock_s=wall,
                 rounds_per_sec=rate if wall > 0 else None,
                 eps_total=accountant.summary().get("eps_total"),
                 seeds=seeds)
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


def _run_custom(spec, engine, *, step_fn, state, batches, horizon,
                log_path, print_every, checkpoint_every,
                checkpoint_dir) -> RunResult:
    """Custom mode: ``horizon`` steps of ``step_fn`` (see `run`)."""
    if horizon is None:
        raise ValueError("custom mode needs horizon= (number of steps)")
    accountant = None
    if spec is not None:
        mech = spec.resolve_mechanism()
        accountant = PrivacyAccountant(
            eps_per_round=spec.eps if mech.is_private else math.inf)
    tracker = MetricTracker()
    logger = CSVLogger(log_path) if log_path else None
    history = []
    t0 = time.perf_counter()
    for i in range(horizon):
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        tracker.update(metrics)
        history.append(metrics)
        if accountant is not None:
            accountant.step()
        if logger:
            logger.log(i, metrics)
        if checkpoint_every and checkpoint_dir and \
                (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, i + 1, state)
        if print_every and (i % print_every == 0 or i == horizon - 1):
            means = tracker.means()
            print(f"step {i:4d} loss={means.get('loss', 0):.4f} "
                  f"ce={means.get('ce', 0):.4f} "
                  f"sparsity={means.get('theta_sparsity', 0):.3f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    wall = time.perf_counter() - t0
    if logger:
        logger.close()
    return RunResult(
        engine=engine,
        rounds=horizon,
        wall_clock=wall,
        rounds_per_sec=(horizon / wall) if wall > 0 else float("inf"),
        eps_ledger=(None if accountant is None
                    else np.asarray(accountant.ledger())),
        privacy={} if accountant is None else accountant.summary(),
        final_state=state,
        history=history,
        metrics=tracker.means(),
    )
