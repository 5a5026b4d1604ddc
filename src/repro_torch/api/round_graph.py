"""The cuda backend's fused round as a CUDA graph, replayed round by round.

A run of the fused round (`backends.CudaBackend`: ``round_update`` mixing
through a CSR or dense A) at delay 0 with no crash schedule changes only
four things from one round to the next: alpha_t, lam_t, the noise scale and
the round's slice of the stream. `RoundGraph` captures the round once per
run — one ``round_stats``, the torch ops around it, each seed's noise draw,
one ``round_update`` — and replays it for every round, so the host issues
one graph launch a round where the eager loop issues ~41 launches.

* Constants. `round_constants` computes, on the host and exactly as the
  eager round does (``omd.step_context(t)``'s alpha_t and lam_t, and
  ``mech.scale(alpha_t, n)``), one float32 row per round of the run. Each
  is an f32 value already, so the table holds what the eager round's
  kernels and ops use. The table goes to the card once a run
  (`RoundGraph.plan`), and each chunk's rows are copied on the card beside
  its labels. The kernels read lam_t and alpha_t through a pointer into
  the round's row, and the noise is scaled by the row's scale. Whether the
  noise is drawn at all (scale 0: eps = inf, the ``none`` mechanism) is
  decided once a run from the table.
* The round counter. A device int64 that the graph advances picks the
  round's x from a static copy of the chunk and its row of labels and
  constants, and writes the round's outputs into the chunk's output rows.
  No per-round host work is left but the launch.
* Noise. The graph draws from generators of its own, registered with it
  (``torch.cuda.CUDAGraph.register_generator_state``). Before a chunk's
  replays each seed's generator state goes into the graph's generator, and
  after them it comes back. So the replays draw from `unit_laplace` (or the
  gaussian's ``randn``) exactly what the eager calls draw, and leave each
  seed's generator where the eager loop leaves it.
* State. Theta lives in a static buffer that the graph updates in place.
  The state a chunk returns is a fresh copy, so a state someone holds (a
  serving snapshot, a checkpoint, ``on_chunk``'s) never changes under later
  replays.

The backend builds a `RoundGraph` only where `capturable` says so
(`backends.CudaBackend.make_round_program`), and `program.chunk_loop`
replays it for a chunk when `RoundGraph.takes` says so: the chunk's rounds
lie in the run's plan (`plan`, which `runner` makes before its warm-up)
and no op count (`obs.analyze_chunk`) is in progress. Every other chunk
runs the eager loop.

Telemetry: the capture is a ``round.capture`` span and each replay a
``round.replay`` span; the round body's own spans (``round.stats``,
``.noise``, ``.mix``, ``kernel.*``) fire during the capture only. Each
replay adds the launches the capture recorded to the round kernels' launch
counts (``round_stats.launches`` and the others); the capture itself, and
the eager round run before it, leave the counts as they were.
"""
from __future__ import annotations

import types
from typing import Callable

import numpy as np
import torch

from repro_torch.api.program import BatchState, pack, unpack
from repro_torch.core.algorithm1 import RoundOutput
from repro_torch.kernels import round_fused as rf
from repro_torch.kernels import work
from repro_torch.obs import span

__all__ = ["RoundGraph", "round_constants", "graphable_mechanism",
           "capturable", "ALPHA", "LAM", "SCALE"]

ALPHA, LAM, SCALE = range(3)    # the columns of a constants row
# (omd config, mechanism, n) -> rows from round 0: a paper run's table
# takes ~19 ms of host to compute on an H100 machine, ~10 % of the run, and
# a later run of the same configuration reads it in 0.01 ms (PERF.md §5)
_TABLES: dict = {}
_MAX_TABLES = 16
# the round kernels' launch counters a replay adds to
_COUNTERS = ((rf.round_stats, "launches"), (rf.round_update, "launches"),
             (rf.round_update, "sparse_launches"), (rf.dual_step, "launches"))


def graphable_mechanism(mech) -> bool:
    """Whether the graph can draw ``mech``'s noise: the port's own Laplace,
    gaussian and no-noise mechanisms, whose ``sample`` is ``scale *
    unit(...)`` on the card. A subclass may draw another way (the tests
    replay host-side draws through ``unit``), so it runs eagerly."""
    from repro_torch.api.mechanisms import (GaussianMechanism,
                                            LaplaceMechanism, NoNoise)
    return type(mech) in (LaplaceMechanism, GaussianMechanism, NoNoise)


def _rows(omd, mech, n: int, start: int, stop: int) -> np.ndarray:
    out = np.empty((stop - start, 3), dtype=np.float32)
    for i, t in enumerate(range(start, stop)):
        ctx = omd.step_context(t + 1)
        out[i] = (ctx.alpha_t, ctx.lam_t, mech.scale(ctx.alpha_t, n))
    return out


def round_constants(omd, mech, n: int, start: int, stop: int) -> np.ndarray:
    """(stop - start, 3) float32: for each round t in [start, stop) (0-based,
    as `BatchState.t`), the alpha_t and lam_t of ``omd.step_context(t + 1)``
    and ``mech.scale(alpha_t, n)``, columns `ALPHA`, `LAM`, `SCALE`. The
    rows of a configuration are kept for later runs of it."""
    try:
        key = (omd, mech, int(n))
        rows = _TABLES.get(key)
    except TypeError:                   # an unhashable mechanism
        return _rows(omd, mech, n, start, stop)
    if rows is None or len(rows) < stop:
        rows = _rows(omd, mech, n, 0, stop)
        if len(_TABLES) >= _MAX_TABLES:
            _TABLES.clear()
        _TABLES[key] = rows
    return rows[start:stop]


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t`` (R, ...) float32 as (R, words) of the widest word (16, 8 or 4
    bytes) its rows divide into: a row picked by `index_select` then moves
    in 16-byte loads, not 4-byte ones (a bit copy, whatever the view)."""
    row = t[0].numel()
    for words, dtype in ((4, torch.complex128), (2, torch.int64)):
        if row % words == 0:
            return t.view(t.shape[0], row).view(dtype)
    return t.view(t.shape[0], row)


def _card(device: torch.device) -> bool:
    """Whether ``device`` is one a round can be captured on."""
    return torch.device(device).type == "cuda"


def capturable(mech, device: torch.device) -> bool:
    """Whether a round that draws ``mech``'s noise on ``device`` can be
    captured: a mechanism `graphable_mechanism` takes, on a card."""
    return graphable_mechanism(mech) and _card(device)


def _launch_counts() -> list:
    return [getattr(fn, attr) for fn, attr in _COUNTERS]


def _set_launch_counts(counts: list) -> None:
    for (fn, attr), v in zip(_COUNTERS, counts):
        setattr(fn, attr, v)


def _capture(body: Callable[[], None], gens: list,
             device: torch.device) -> tuple[Callable[[], None], list]:
    """(replay, the launch counts one replay adds): ``body`` run once on a
    side stream of its own (so every kernel and allocation it makes is
    loaded before the capture), then captured there into a CUDA graph with
    ``gens`` registered. Neither the eager run's launches nor the
    capture's stay in the counts."""
    before = _launch_counts()
    graph = torch.cuda.CUDAGraph()
    for g in gens:
        graph.register_generator_state(g)
    stream = torch.cuda.Stream(device=device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        body()
        start = _launch_counts()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
        captured = _launch_counts()
    current.wait_stream(stream)
    _set_launch_counts(before)
    return graph.replay, [c - s for c, s in zip(captured, start)]


class RoundGraph:
    """One chunk program's captured round (see the module docstring).

    ``core(theta, x, y, lam_t, alpha_t, noise, counter)`` is the backend's
    round body at delay 0 with no crash schedule: theta (S, m, n), x
    (S, m, n), y (S, m), lam_t and alpha_t one-element device tensors,
    ``noise()`` the round's (S, m, n) noise, ``counter`` ``round_stats``'s
    ticket counters; it returns (theta_next, `RoundOutput` of (S, m) and
    (S,) fields). ``unit_noise(gens, scale)`` draws each seed's unscaled
    noise from ``gens`` and scales it. The chunks are a seed batch's
    (`BatchState`, xs (K, S, m, n), ys (K, S, m)).
    """

    def __init__(self, core: Callable, unit_noise: Callable, *, engine: str,
                 omd, mech, m: int, n: int, device: torch.device):
        self.core, self.unit_noise = core, unit_noise
        self.engine = engine
        self.omd, self.mech = omd, mech
        self.m, self.n = m, n
        self.device = device
        self.replayed = 0               # rounds replayed, all chunks
        self._start = self._stop = None
        self._rounds = 0
        self._table = None
        self._draws = None              # whether the rounds draw noise
        self._cap = None                # the capture and its buffers

    # -- planning ------------------------------------------------------------

    def plan(self, start: int, stop: int, rounds: int) -> None:
        """Ready the rounds [start, stop) (start < stop) in chunks of at most
        ``rounds``: their constants table on the card (a capture of fewer
        rounds a chunk is dropped)."""
        table = round_constants(self.omd, self.mech, self.n, start, stop)
        self._start, self._stop = start, stop
        self._table = torch.as_tensor(table, device=self.device)
        # the port's mechanisms scale by 0 every round (eps = inf, `none`)
        # or in none: the draw is decided once a run
        self._draws = bool(table[:, SCALE].any())
        if rounds > self._rounds:
            self._cap = None
        self._rounds = max(self._rounds, rounds)

    def takes(self, state, xs: torch.Tensor) -> bool:
        """Whether the chunk ``xs`` from ``state`` replays: its rounds lie
        in the plan, and no op count is in progress."""
        t, K = state.t, int(xs.shape[0])
        return (work.active() is None and self._start is not None
                and 0 < K <= self._rounds
                and self._start <= t and t + K <= self._stop)

    # -- capture -----------------------------------------------------------

    def _capture(self, S: int):
        """The round captured for S seeds, chunks of ``self._rounds``."""
        m, n, R, dev = self.m, self.n, self._rounds, self.device
        f32 = torch.float32
        b = types.SimpleNamespace(
            S=S, rounds=R,
            theta=torch.zeros((S, m, n), dtype=f32, device=dev),
            xs=torch.zeros((R, S, m, n), dtype=f32, device=dev),
            # a round's labels, then its alpha_t, lam_t and scale
            rows=torch.zeros((R, S * m + 3), dtype=f32, device=dev),
            # a round's loss, correct, w_bar_loss and sparsity
            out=torch.zeros((R, 2 * S * m + 2 * S), dtype=f32, device=dev),
            k=torch.zeros(1, dtype=torch.int64, device=dev),
            counter=torch.zeros(S, dtype=torch.int32, device=dev),
            zeros=(None if self._draws else
                   torch.zeros((S, m, n), dtype=f32, device=dev)),
            gens=[torch.Generator(device=dev) for _ in range(S)])
        consts = S * m
        xs_words = _words(b.xs)

        def body():
            row = b.rows.index_select(0, b.k)[0]
            x = xs_words.index_select(0, b.k).view(torch.float32).view(
                S, m, n)
            y = row[:consts].view(S, m)
            alpha_t, lam_t = row[consts + ALPHA], row[consts + LAM]
            scale = row[consts + SCALE]
            noise = ((lambda: self.unit_noise(b.gens, scale)) if self._draws
                     else (lambda: b.zeros))
            theta_next, out = self.core(b.theta, x, y, lam_t, alpha_t,
                                        noise, b.counter)
            b.out.index_copy_(0, b.k, torch.cat([
                out.loss.reshape(-1), out.correct.reshape(-1),
                out.w_bar_loss.reshape(-1), out.sparsity.reshape(-1)])[None])
            b.theta.copy_(theta_next)
            b.k.add_(1)

        with span("round.capture", seeds=S, rounds=R):
            b.replay, b.launches = _capture(body, b.gens, dev)
        return b

    # -- a chunk -------------------------------------------------------------

    def __call__(self, state: BatchState, xs: torch.Tensor, ys: torch.Tensor):
        """The chunk's (state, stacked RoundOutput), as the eager loop
        gives them, bit for bit (`takes` must have said yes)."""
        theta, hist = unpack(self.engine, state)
        S, m, K, t = theta.shape[0], self.m, int(xs.shape[0]), state.t
        b = self._cap
        if b is None or b.S != S:
            b = self._cap = self._capture(S)
        r0 = t - self._start
        b.theta.copy_(theta)
        b.xs[:K].copy_(xs)
        b.rows[:K, :S * m].copy_(ys.reshape(K, S * m))
        b.rows[:K, S * m:].copy_(self._table[r0:r0 + K])
        b.k.zero_()
        for mine, theirs in zip(b.gens, state.generators):
            mine.set_state(theirs.get_state())
        for _ in range(K):
            with span("round.replay"):
                b.replay()
                _set_launch_counts([c + d for c, d in
                                    zip(_launch_counts(), b.launches)])
        for mine, theirs in zip(b.gens, state.generators):
            theirs.set_state(mine.get_state())
        self.replayed += K

        theta_next = b.theta.clone()
        o = b.out[:K]
        fields = [o[:, i * S * m:(i + 1) * S * m].reshape(K, S, m)
                  for i in range(2)] + \
                 [o[:, 2 * S * m + i * S:2 * S * m + (i + 1) * S]
                  for i in range(2)]
        loss, correct, wb_loss, sparsity = (
            f.clone(memory_format=torch.contiguous_format) for f in fields)
        return pack(self.engine, state, theta_next, hist, K), RoundOutput(
            loss=loss, w_bar_loss=wb_loss, sparsity=sparsity, correct=correct)
