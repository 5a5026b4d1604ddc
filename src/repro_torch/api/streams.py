"""Stream — the data-scenario stage of the experiment pipeline.

Counterpart of `repro.api.streams`. A Stream owns where the per-round
samples come from; everything downstream (clip -> noise -> mix -> local
rule) is scenario-agnostic. Every stream emits fixed-shape chunks::

    xs, ys = stream.chunk(t0, t1)     # xs (t1-t0, m, n), ys (t1-t0, m)

keyed per ABSOLUTE round. A Stream instance may be passed to
``RunSpec(stream=...)`` in place of a name; the runner moves its chunks to
the run's device. This slice ports ``social_sparse`` (the paper's §V
workload); 'drift', 'heterogeneous' and 'bursty' wait in ROADMAP queue 1.

>>> from repro_torch.api.streams import STREAMS
>>> s = STREAMS.build("social_sparse", n=32, nodes=4, rounds=64,
...                   device="cpu")
>>> xs, ys = s.chunk(0, 8)
>>> tuple(xs.shape), tuple(ys.shape)
((8, 4, 32), (8, 4))
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.api.registry import STREAMS
from repro_torch.data.social import SocialStream

__all__ = ["Stream", "STREAMS", "SocialStream"]


@runtime_checkable
class Stream(Protocol):
    """Data-scenario stage: per-round samples for every node.

    ``disjoint`` declares whether round t touches only samples that arrive
    at round t — the Theorem-1 parallel-composition condition the runner
    hands to the PrivacyAccountant.
    """

    n: int        # feature dimension
    nodes: int    # m data centers
    rounds: int   # stream length (the run horizon)
    disjoint: bool

    def chunk(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Rounds [t0, t1): xs (t1-t0, m, n), ys (t1-t0, m) with y in ±1."""
        ...


@STREAMS.register("social_sparse")
def _social(n: int, nodes: int, rounds: int, seed: int = 0,
            sparsity_true: float = 0.05, label_noise: float = 0.0,
            device: str = "cuda") -> Stream:
    """The paper's §V workload: sparse w*, normalized gaussian features."""
    return SocialStream(n=n, nodes=nodes, rounds=rounds, seed=seed,
                        sparsity_true=sparsity_true, label_noise=label_noise,
                        device=str(device))
