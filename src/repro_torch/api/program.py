"""The round's program layer, below `runner` and the backends.

A backend builds rounds and nothing else (`backends`): the round of S
seeds in step over a `BatchState`, and the node-sharded round
(`shard_node`). Here the rounds become the chunk programs `runner` drives:
`chunk_loop` (the Python loop in place of the reference's ``lax.scan``,
replaying a `round_graph.RoundGraph` where the backend built one),
`batch_init`, `one_seed` (a run as a batch of one, as views) and
`seed_rows_program` (seeds sharded over mesh rows). It also holds the
reference round with the init every backend shares
(`reference_round_program`), and what the cuda backend's two rounds
share (`fused_stages`, `hinge_coeff`).

>>> from repro_torch.api import RunSpec
>>> spec = RunSpec(nodes=2, dim=3, horizon=2, eps=1.0, alpha0=0.5, lam=0.01)
>>> round_fn, init_fn = reference_round_program(spec, "sim", "cpu")
>>> chunk_fn = one_seed(chunk_loop(per_seed_round(round_fn, "sim")), "sim")
>>> xs, ys = spec.resolve_stream(device="cpu").chunk(0, 2)
>>> state, out = chunk_fn(init_fn(0), xs, ys)
>>> state.t, tuple(out.loss.shape), tuple(state.theta.shape)
(2, (2, 2), (2, 3))
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.api.clippers import (NoClipper, PerNodeL2Clipper,
                                      clip_factor)
from repro_torch.api.rules import OMDLassoRule
from repro_torch.core import tree

__all__ = ["BatchState", "stack_seeds", "per_seed", "seed_rows",
           "stack_states", "seed_state", "unpack", "pack",
           "reference_round_program", "per_seed_round", "batch_init",
           "chunk_loop", "one_seed", "seed_rows_program", "fused_stages",
           "hinge_coeff"]


# -- seed batches ------------------------------------------------------------

class BatchState(NamedTuple):
    """S runs of one configuration in step (`runner.run_batch`): the
    engine's theta and delay ring — a tensor (sim) or ``{"w": tensor}``
    (dist) — with a leading seed axis, the round counter they share, and
    each seed's own noise generator."""

    theta: Any                    # (S, m, n) or {"w": (S, m, n)}
    t: int                        # rounds done
    generators: tuple             # one torch.Generator per seed
    history: Any = None           # (S, delay+1, m, n) ring, or None


def stack_seeds(outs: list) -> torch.Tensor:
    """Per-seed tensors on a leading seed axis (one seed: a view)."""
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def per_seed(fn: Callable, t) -> torch.Tensor:
    """``fn`` on each seed's slice of ``t``, stacked on a leading seed axis.
    A reduction on an (S, ...) tensor may take another order than on one
    seed's slice (torch picks its split from the output count), so the
    batch reduces seed by seed, exactly as a one-seed run does."""
    return stack_seeds([fn(row) for row in t])


def seed_rows(t: torch.Tensor) -> torch.Tensor:
    """An (S, m, ...) tensor as (S*m, ...) rows (no copy)."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


def stack_states(states) -> BatchState:
    """The `BatchState` of per-seed engine states (all at one round); one
    state becomes a batch of one as views of its tensors (its delay ring
    is then written in place, as the one-seed round writes it)."""
    stack = lambda *ts: stack_seeds(ts)  # noqa: E731
    first = states[0]
    return BatchState(
        theta=tree.tree_map(stack, *(s.theta for s in states)), t=first.t,
        generators=tuple(s.generator for s in states),
        history=(None if first.history is None else
                 tree.tree_map(stack, *(s.history for s in states))))


def seed_state(engine: str, state: BatchState, i: int):
    """Seed ``i``'s engine state (`SimState` or `GossipState`) in a batch:
    views of its slices, and its own generator."""
    from repro_torch.core.algorithm1 import SimState
    from repro_torch.core.gossip import GossipState
    cls = SimState if engine == "sim" else GossipState
    pick = lambda a: a[i]  # noqa: E731
    return cls(theta=tree.tree_map(pick, state.theta), t=state.t,
               generator=state.generators[i],
               history=(None if state.history is None
                        else tree.tree_map(pick, state.history)))


def unpack(engine: str, state):
    """(theta, history) of an engine state or a batch: its tensors (sim)
    or their ``"w"`` leaves (dist)."""
    if engine == "sim":
        return state.theta, state.history
    return state.theta["w"], (None if state.history is None
                              else state.history["w"])


def pack(engine: str, state, theta, hist, rounds: int = 1):
    """``state`` ``rounds`` rounds on, holding ``theta`` and ``hist``
    (`unpack`'s inverse)."""
    if engine != "sim":
        theta = {"w": theta}
        hist = None if hist is None else {"w": hist}
    return state._replace(theta=theta, t=state.t + rounds, history=hist)


# -- the reference round ---------------------------------------------------

def reference_round_program(spec, engine: str, device: torch.device):
    """(round_fn, init_fn) of one seed in torch ops: the reference
    backend's round, the oracle of the fused one, and init_fn(seed), the
    engine state every backend starts from (zeros and a generator seeded
    from ``seed`` on ``device``), so checkpoints interchange across
    backends and device counts."""
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


def per_seed_round(round_fn: Callable, engine: str) -> Callable:
    """A batch round that steps ``round_fn`` once per seed, in seed order,
    on that seed's slices (the reference backend's batch: the plain
    per-seed algebra, the oracle of the fused batch). A batch of one
    stays views of the one seed's tensors."""
    from repro_torch.core.algorithm1 import RoundOutput

    def batch_round(state: BatchState, batch):
        xs, ys = batch
        steps = [round_fn(seed_state(engine, state, i), (xs[i], ys[i]))
                 for i in range(len(state.generators))]
        return (stack_states([st for st, _ in steps]),
                RoundOutput(*(stack_seeds(f)
                              for f in zip(*(out for _, out in steps)))))

    return batch_round


# -- chunk programs ----------------------------------------------------------

def batch_init(init_fn: Callable) -> Callable:
    """init_fn(seeds) -> the `BatchState` of the seeds' initial states."""
    return lambda seeds: stack_states([init_fn(s) for s in seeds])


def chunk_loop(round_fn: Callable, graph=None) -> Callable:
    """chunk_fn(state, xs, ys) -> (state, stacked RoundOutput): the Python
    loop over rounds that takes the place of the reference's lax.scan.

    With ``graph`` (a `round_graph.RoundGraph` of the same round), a chunk
    the graph takes (`RoundGraph.takes`) replays the captured round, one
    graph launch a round, with the same outputs bit for bit. The chunk
    program's graphs are ``chunk_fn.graphs``: `runner` plans them for the
    run's rounds and counts the rounds they replay."""
    from repro_torch.core.algorithm1 import RoundOutput

    def chunk_fn(state, xs, ys):
        if graph is not None and graph.takes(state, xs):
            return graph(state, xs, ys)
        outs = []
        for k in range(xs.shape[0]):
            state, out = round_fn(state, (xs[k], ys[k]))
            outs.append(out)
        return state, RoundOutput(*(torch.stack(f) for f in zip(*outs)))

    chunk_fn.graphs = () if graph is None else (graph,)
    return chunk_fn


def one_seed(chunk_fn: Callable, engine: str) -> Callable:
    """The chunk program of one run from a batch chunk program: the run's
    engine state goes in as a batch of one and comes out as seed 0's, and
    its xs (C, m, n) and ys (C, m) as (C, 1, ...) — views, nothing is
    copied."""
    def one(state, xs, ys):
        bstate, out = chunk_fn(stack_states([state]), xs[:, None],
                               ys[:, None])
        return seed_state(engine, bstate, 0), type(out)(
            *(f[:, 0] for f in out))

    one.graphs = getattr(chunk_fn, "graphs", ())
    return one


def _gen_to(gen: torch.Generator, dev: torch.device,
            copy: bool = False) -> torch.Generator:
    """``gen`` itself on its device (unless ``copy``), else a generator on
    ``dev`` in the same state (a CUDA generator's state — seed and offset —
    draws the same numbers on any card)."""
    if gen.device == dev and not copy:
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
    gens = [_gen_to(state.generators[i], dev, copy=k >= real)
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

    chunk_fn.graphs = tuple(g for p in programs
                            for g in getattr(p, "graphs", ()))
    return chunk_fn


# -- what the cuda backend's rounds share ------------------------------------

def fused_stages(spec) -> tuple:
    """(mechanism, `OMDConfig`, L1 prox (else the identity), the per-node
    L2 clip's norm or None): the spec's stages for the cuda backend's
    rounds, unsharded and node-sharded. They hard-code the paper's OMD with
    an L1 or identity prox, the per-node L2 clipper (or none) and the hinge
    loss; anything else raises with the escape hatch named
    (backend='reference')."""
    rule = spec.resolve_local_rule()
    if not isinstance(rule, OMDLassoRule) or rule.prox_kind not in ("l1",
                                                                    "none"):
        raise ValueError(
            f"backend='cuda' fuses the paper's OMD + L1/identity prox "
            f"round body; got local_rule={type(rule).__name__}"
            f"{getattr(rule, 'prox_kind', '')!r} — use backend='reference'")
    clipper = spec.resolve_clipper()
    if not isinstance(clipper, (PerNodeL2Clipper, NoClipper)):
        raise ValueError(
            f"backend='cuda' folds clipping into a per-node coefficient, "
            f"which needs the per-node L2 clipper (or none); got "
            f"{type(clipper).__name__} — use backend='reference'")
    if spec.loss_and_grad is not None:
        raise ValueError(
            "backend='cuda' fuses the hinge loss/subgradient; a custom "
            "loss_and_grad needs backend='reference'")
    return (spec.resolve_mechanism(), spec.omd_config(),
            rule.prox_kind == "l1",
            clipper.max_norm if isinstance(clipper, PerNodeL2Clipper)
            else None)


def hinge_coeff(dot: torch.Tensor, y: torch.Tensor, clip_norm,
                norms: Callable[[], torch.Tensor]):
    """(coeff, loss, correct) of each node from its w.x and label: the
    hinge loss and c of its clipped subgradient c * x. That subgradient,
    -active*y*x, is rank-1, so its norm is active * ||x|| and the clip a
    per-node factor. ``norms()``, called only with a clip, gives ||x|| as
    the reference backend's clipper sums ||grad|| (the kernel's xsq adds
    in another order, and an ulp in the factor moves theta)."""
    margin = y * dot
    loss = torch.clamp_min(1.0 - margin, 0.0)
    correct = (torch.sign(dot) == y).to(torch.float32)
    active = (margin < 1.0).to(torch.float32)
    coeff = -(active * y)
    if clip_norm is not None:
        coeff = coeff * clip_factor(active * norms(), clip_norm)
    return coeff, loss, correct
