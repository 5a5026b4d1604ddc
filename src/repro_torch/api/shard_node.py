"""The fixed sparse form behind a mixer, for the fused backend.

Counterpart of the piece of `repro.api.shard_node` that lowers a mixer to
its `SparseGraph` (``sparse_graph_and_delay``); the fused backend hands
that graph's CSR form (or, with many non-zeros per row, its dense (m, m) A)
to the ``round_update`` kernel it mixes with. The
node-sharded path itself waits in ROADMAP queue 1 (item 11).
"""
from __future__ import annotations

from typing import Any

from repro_torch.api.mixers import DelayedMixer, RingRollMixer
from repro_torch.core.graph import ring_edges

__all__ = ["sparse_graph_and_delay"]


def sparse_graph_and_delay(mixer) -> tuple[Any, int]:
    """(SparseGraph, delay) behind a resolved mixer.

    Accepts `RingRollMixer` (exact `ring_edges` form), optionally wrapped in
    `DelayedMixer`; anything else has no fixed sparse form here and raises
    ValueError.
    """
    delay = int(getattr(mixer, "delay", 0))
    inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
    if isinstance(inner, RingRollMixer):
        return ring_edges(inner.m, self_weight=inner.self_weight), delay
    raise ValueError(
        f"{type(inner).__name__} has no fixed sparse form in repro_torch "
        "(ported: the ring)")
