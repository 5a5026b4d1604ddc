"""Compiled fault schedules — seeded per-round fault masks.

Counterpart of `repro.faults.schedule`. A `repro_torch.faults.FaultSpec`
compiled against a node count (and, for seeded crash draws, a horizon)
yields a :class:`FaultSchedule` whose per-round queries are pure functions
of the round counter ``t``:

* ``link_keep(t, num_links)`` — one Bernoulli keep per undirected LINK,
  drawn on the host from ``numpy.random.default_rng([seed, 3, t])``: every
  round has its own i.i.d. mask, the same ``t`` always gives the same
  mask, and a run cut short keeps the pattern of a longer one. Both
  directions of a link share one coin. (The reference draws it with
  ``jax.random``, which this port cannot reproduce; everything else here
  is numpy and equals the reference bit for bit.)
* ``alive_mask(t, device)`` — (m,) node liveness from the compiled crash
  windows (explicit windows plus windows drawn at compile time from
  ``crash_rate``).
* ``partitions`` — static (start, end, cut) windows; the mixers drop edges
  crossing the cut while ``start <= t < end``.

A round reads its keeps and liveness on the run's device from a table of
``BLOCK_ROUNDS`` rounds that the schedule copies there once (``keep``,
``alive_f32``): one host-to-device copy per block, none per round. The
schedule also replays itself on the HOST (`alive_table` /
`participation`) so the privacy accountant can skip charging eps for
crashed rounds.

Zero-rate contract: at ``link_rate == 0`` the comparison ``u >= 0.0`` is
always True, so the keep vector is exactly 1.0 and every downstream
multiply/add is bit-exact against the fault-free path.

>>> import numpy as np
>>> from repro_torch.faults.schedule import link_table, edge_link_idx
>>> uniq, n = link_table(np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]), 2)
>>> n                          # one undirected link {0, 1}; loops excluded
1
>>> idx, valid = edge_link_idx(uniq, np.array([0, 1]), np.array([1, 0]), 2)
>>> idx.tolist(), valid.tolist()       # both directions share the link id
([0, 0], [True, True])
>>> from repro_torch.faults import FaultSpec
>>> sched = FaultSpec(link_rate=0.0).compile(m=4)
>>> sched.link_keep(7, 3).tolist()
[1.0, 1.0, 1.0]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["FaultSchedule", "link_table", "edge_link_idx", "BLOCK_ROUNDS"]

# rounds of keeps / liveness copied to a device at a time
BLOCK_ROUNDS = 256


def link_table(dst, src, m: int) -> tuple[np.ndarray, int]:
    """Canonical undirected link numbering for an edge list.

    Returns ``(uniq_pairs, num_links)``: the sorted unordered-pair ids
    ``min(i,j) * m + max(i,j)`` of every off-diagonal edge, and their count
    (at least 1 so the per-round draw never has shape (0,)). Both
    directions of an edge map to the same link id, which is what makes the
    per-round Bernoulli masks symmetric.
    """
    dst = np.asarray(dst, np.int64).ravel()
    src = np.asarray(src, np.int64).ravel()
    lo = np.minimum(dst, src)
    hi = np.maximum(dst, src)
    pair = lo * int(m) + hi
    uniq = np.unique(pair[dst != src])
    return uniq, max(int(uniq.size), 1)


def edge_link_idx(uniq_pairs: np.ndarray, dst, src,
                  m: int) -> tuple[np.ndarray, np.ndarray]:
    """(link index, found) per edge under a `link_table` numbering.

    ``found`` is False for self-loops and for pairs absent from the table;
    their index is clipped in range so a gather stays safe — consumers
    force ``keep = 1`` wherever ``found`` is False.
    """
    dst = np.asarray(dst, np.int64).ravel()
    src = np.asarray(src, np.int64).ravel()
    lo = np.minimum(dst, src)
    hi = np.maximum(dst, src)
    pair = lo * int(m) + hi
    if uniq_pairs.size == 0:
        return (np.zeros(pair.shape, np.int32),
                np.zeros(pair.shape, bool))
    pos = np.clip(np.searchsorted(uniq_pairs, pair), 0,
                  uniq_pairs.size - 1)
    found = (uniq_pairs[pos] == pair) & (dst != src)
    return pos.astype(np.int32), found


def _as_windows(rows, width: int, what: str) -> tuple:
    out = []
    for row in rows:
        row = tuple(int(v) for v in row)
        if len(row) != width:
            raise ValueError(f"each {what} entry needs {width} ints, "
                             f"got {row}")
        out.append(row)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A FaultSpec compiled against a node count (and optional horizon).

    Construction resolves everything data-dependent — seeded crash windows,
    straggler assignments, window validation — so the per-round queries are
    pure functions of the round counter.
    """

    spec: Any                     # repro_torch.faults.FaultSpec
    m: int
    horizon: int | None = None

    def __post_init__(self):
        spec = self.spec
        m = int(self.m)
        if m < 1:
            raise ValueError(f"FaultSchedule needs m >= 1, got {m}")
        set_ = lambda k, v: object.__setattr__(self, k, v)  # noqa: E731

        # -- partitions: static (start, end, cut) windows ---------------------
        parts = _as_windows(spec.partitions, 3, "partition")
        for start, end, cut in parts:
            if not 0 <= start < end:
                raise ValueError(f"partition window [{start}, {end}) is "
                                 "empty or negative")
            if not 0 < cut < m:
                raise ValueError(f"partition cut {cut} must split the node "
                                 f"range (0, {m})")
        set_("partitions", parts)

        # -- crash windows: explicit + compile-time seeded draws --------------
        windows = list(_as_windows(spec.crashes, 3, "crash"))
        for node, start, end in windows:
            if not 0 <= node < m:
                raise ValueError(f"crash node {node} out of range for m={m}")
            if not 0 <= start < end:
                raise ValueError(f"crash window [{start}, {end}) is empty "
                                 "or negative")
        if spec.crash_rate > 0.0:
            if self.horizon is None:
                raise ValueError(
                    "seeded crashes (crash_rate > 0) need a horizon to draw "
                    "start rounds from — set RunSpec.horizon or use explicit "
                    "FaultSpec.crashes windows")
            length = int(spec.crash_rounds) or max(int(self.horizon) // 8, 1)
            rng = np.random.default_rng([int(spec.seed), 1])
            hit = rng.random(m) < float(spec.crash_rate)
            starts = rng.integers(0, max(int(self.horizon) - length, 1),
                                  size=m)
            for node in np.flatnonzero(hit):
                windows.append((int(node), int(starts[node]),
                                int(starts[node]) + length))
        set_("crash_windows", tuple(windows))

        # -- stragglers: per-node extra staleness (explicit + seeded) ---------
        extra = np.zeros(m, np.int32)
        if spec.straggler_rate > 0.0 and spec.straggler_delay > 0:
            rng = np.random.default_rng([int(spec.seed), 2])
            extra[rng.random(m) < float(spec.straggler_rate)] = \
                int(spec.straggler_delay)
        for node, lag in _as_windows(spec.stragglers, 2, "straggler"):
            if not 0 <= node < m:
                raise ValueError(f"straggler node {node} out of range for "
                                 f"m={m}")
            if lag < 0:
                raise ValueError(f"straggler delay must be >= 0, got {lag}")
            extra[node] = lag
        set_("extra", extra)

    # -- static shape of the schedule ----------------------------------------

    @property
    def has_crashes(self) -> bool:
        return len(self.crash_windows) > 0

    @property
    def max_extra(self) -> int:
        """Deepest straggler lag — widens the history ring by this much."""
        return int(self.extra.max()) if self.extra.size else 0

    # -- host-side draws and replay ------------------------------------------

    def link_keep(self, t: int, num_links: int) -> np.ndarray:
        """(num_links,) float32 keep mask for round ``t`` (1 = delivered),
        drawn on the host from ``default_rng([seed, 3, t])``.

        Always draws — at ``link_rate == 0`` the comparison ``u >= 0.0`` is
        identically True, so the mask is exactly 1.0 and the faulty mixers'
        arithmetic collapses bit for bit onto the clean path.
        """
        u = np.random.default_rng([int(self.spec.seed), 3, int(t)]).random(
            int(num_links), dtype=np.float32)
        return (u >= np.float32(self.spec.link_rate)).astype(np.float32)

    def link_keep_table(self, start: int, end: int,
                        num_links: int) -> np.ndarray:
        """(end - start, num_links) float32: ``link_keep`` of each round."""
        rows = [self.link_keep(t, num_links) for t in range(start, end)]
        return (np.stack(rows) if rows
                else np.zeros((0, int(num_links)), np.float32))

    def alive_table(self, start: int, end: int) -> np.ndarray:
        """(end - start, m) bool liveness table, replayed with numpy."""
        T = int(end) - int(start)
        alive = np.ones((max(T, 0), self.m), bool)
        for node, s, e in self.crash_windows:
            lo, hi = max(s - start, 0), min(e - start, T)
            if lo < hi:
                alive[lo:hi, node] = False
        return alive

    def participation(self, start: int, end: int) -> np.ndarray:
        """(m,) rounds each node actually participated in over
        ``[start, end)`` — what `PrivacyAccountant.step` charges."""
        return self.alive_table(start, end).sum(axis=0).astype(np.int64)

    # -- per-round queries on a device ---------------------------------------

    def _row(self, kind: tuple, t: int, device,
             table: Callable[[int, int], np.ndarray]) -> torch.Tensor:
        """Row ``t`` of a per-round table on ``device``, from a block of
        BLOCK_ROUNDS rounds (cut at the horizon) copied there once."""
        t = int(t)
        dev = torch.device(device)
        blocks = self.__dict__.setdefault("_blocks", {})
        key = (kind, dev)
        start, rows = blocks.get(key, (0, None))
        if rows is None or not start <= t < start + rows.shape[0]:
            start = t - t % BLOCK_ROUNDS
            end = start + BLOCK_ROUNDS
            if self.horizon is not None and t < self.horizon:
                end = min(end, int(self.horizon))
            rows = torch.as_tensor(table(start, end)).to(dev)
            blocks[key] = (start, rows)
        return rows[t - start]

    def keep(self, t: int, num_links: int,
             device: str | torch.device = "cpu") -> torch.Tensor:
        """``link_keep(t, num_links)`` as a float32 tensor on ``device``."""
        return self._row(("keep", int(num_links)), t, device,
                         lambda a, b: self.link_keep_table(a, b, num_links))

    def alive_f32(self, t: int,
                  device: str | torch.device = "cpu") -> torch.Tensor:
        """(m,) float32 on ``device``: 0.0 while a node sits inside a crash
        window, else 1.0."""
        return self._row(("alive",), t, device,
                         lambda a, b: self.alive_table(a, b).astype(
                             np.float32))

    def alive_mask(self, t: int,
                   device: str | torch.device = "cpu") -> torch.Tensor:
        """(m,) bool on ``device`` — False while a node is crashed."""
        return self.alive_f32(t, device) > 0.0
