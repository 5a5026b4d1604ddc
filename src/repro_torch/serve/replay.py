"""Replay client: heavy-tailed request arrivals from the `bursty` stream.

Counterpart of `repro.serve.replay`. The paper's regime is millions of
user events arriving at data centers in bursts. The `bursty` STREAMS
scenario already owns a seeded heavy-tailed arrival process — per-(round,
node) counts from a capped discrete Pareto (P(c >= k) ~ k^-tail) — so the
replay client derives the REQUEST load from exactly that process instead
of inventing a second one: tick t fires ``counts(t, i)`` prediction
requests at node i, each carrying that round's feature vector. The same
seed therefore replays the same burst pattern, and the admission layer is
exercised by genuinely bursty (not Poisson-smooth) arrivals.

The stream makes its counts and features on its device; ``ticks`` brings
them to the host once per call, and each request carries a numpy row.

>>> from repro_torch.api.streams import STREAMS
>>> from repro_torch.serve.replay import BurstyReplay
>>> stream = STREAMS.build("bursty", n=8, nodes=2, rounds=16, seed=3,
...                        device="cpu")
>>> replay = BurstyReplay(stream)
>>> ticks = list(replay.ticks(0, 16))
>>> len(ticks), replay.total_requests(0, 16) == sum(len(t) for t in ticks)
(16, True)
>>> max(len(t) for t in ticks) > min(len(t) for t in ticks)   # bursty
True
"""
from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

__all__ = ["BurstyReplay"]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class BurstyReplay:
    """Generates per-tick request groups from a BurstyStream-like stream.

    The stream must expose ``counts(t0, t1) -> (T, m)`` burst sizes and
    ``chunk(t0, t1) -> (xs, ys)`` features — i.e. the `bursty` STREAMS
    entry (or anything protocol-compatible).
    """

    def __init__(self, stream):
        if not hasattr(stream, "counts"):
            raise ValueError(
                "BurstyReplay needs a stream with a counts(t0, t1) arrival "
                "process (the 'bursty' STREAMS scenario)")
        self.stream = stream

    def total_requests(self, t0: int, t1: int) -> int:
        return int(_host(self.stream.counts(t0, t1)).sum())

    def ticks(self, t0: int,
              t1: int) -> Iterator[list[tuple[np.ndarray, int]]]:
        """One list of (features, node) requests per tick in [t0, t1).

        A (tick, node) with burst size c contributes c requests carrying
        that round's feature row — the arrival pattern the admission layer
        must absorb or shed.
        """
        counts = _host(self.stream.counts(t0, t1))             # (T, m)
        xs = _host(self.stream.chunk(t0, t1)[0])               # (T, m, n)
        for t in range(t1 - t0):
            group = []
            for i in range(counts.shape[1]):
                group.extend((xs[t, i], i) for _ in range(counts[t, i]))
            yield group

    def drive(self, service, t0: int, t1: int, *,
              rate_ticks_per_s: float | None = None,
              timeout_s: float = 60.0) -> dict:
        """Submit every tick's burst to ``service`` and wait for the tail.

        ``rate_ticks_per_s`` paces the replay (None = open throttle, the
        sustained-QPS measurement); the wall-clock window runs from the
        first submit to the last completion, so QPS counts COMPLETED
        requests per second. The ticks' requests are made before the
        window opens: making the client's data is not the service's time.
        """
        groups = list(self.ticks(t0, t1))
        requests = []
        tick_period = (1.0 / rate_ticks_per_s) if rate_ticks_per_s else 0.0
        t_start = time.perf_counter()
        next_tick = t_start
        for group in groups:
            if tick_period:
                delay = next_tick - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                next_tick += tick_period
            for features, node in group:
                requests.append(service.submit(features, node))
        for r in requests:
            if not r.done():
                r.wait(timeout=timeout_s)
        wall = time.perf_counter() - t_start
        served = [r for r in requests if r.status == "ok"]
        return {
            "ticks": t1 - t0,
            "submitted": len(requests),
            "served": len(served),
            "shed": sum(r.status == "shed" for r in requests),
            "refused": sum(r.status == "refused" for r in requests),
            "wall_s": wall,
            "qps": len(served) / wall if wall > 0 else float("inf"),
            "requests": requests,
        }
