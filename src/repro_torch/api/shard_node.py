"""The fixed sparse form behind a mixer, for the fused backend.

Counterpart of the piece of `repro.api.shard_node` that lowers a mixer to
its `SparseGraph` (``sparse_graph_and_delay``); the fused backend hands
that graph's CSR form (or, with many non-zeros per row, its dense (m, m) A)
to the ``round_update`` kernel it mixes with. The
node-sharded path itself waits in ROADMAP queue 1 (item 4).

>>> from repro_torch.api import MIXERS
>>> graph, delay = sparse_graph_and_delay(MIXERS.build("hypercube", m=8))
>>> graph.edges, delay
(32, 0)
"""
from __future__ import annotations

from typing import Any

from repro_torch.api.mixers import (DelayedMixer, DenseMatrixMixer,
                                    RingRollMixer, SparseMixer)
from repro_torch.core.graph import SparseGraph, ring_edges

__all__ = ["sparse_graph_and_delay"]


def sparse_graph_and_delay(mixer) -> tuple[Any, int]:
    """(SparseGraph, delay) behind a resolved mixer.

    Accepts `SparseMixer` (native), `RingRollMixer` (exact `ring_edges`
    form) and fixed single-matrix `DenseMatrixMixer` stacks (converted via
    `SparseGraph.from_dense`), optionally wrapped in `DelayedMixer`.
    Time-varying schedules, per-edge heterogeneous delays, the complete and
    the no-communication mixers have no fixed sparse form and raise
    ValueError.
    """
    delay = int(getattr(mixer, "delay", 0))
    inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
    if isinstance(inner, SparseMixer):
        return inner.graph, delay
    if isinstance(inner, RingRollMixer):
        return ring_edges(inner.m, self_weight=inner.self_weight), delay
    if isinstance(inner, DenseMatrixMixer):
        if inner.stack.shape[0] != 1:
            raise ValueError(
                f"mixer {inner.name!r} is a time-varying dense schedule "
                f"({inner.stack.shape[0]} matrices); a fixed sparse form "
                "needs one fixed topology — use mixer='sparse' or a "
                "single-matrix stack")
        return SparseGraph.from_dense(inner.stack[0].numpy(),
                                      name=inner.name), delay
    raise ValueError(
        f"{type(inner).__name__} has no fixed sparse form (use "
        "mixer='sparse' with a ring/torus/... topology)")
