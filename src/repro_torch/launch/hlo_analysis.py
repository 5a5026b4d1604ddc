"""Roofline terms for the H100, and the collective bytes a strategy moves.

Counterpart of `repro.launch.hlo_analysis`, whose constants are a TPU
v5e's and whose `collective_stats` parses the collectives out of compiled
HLO text. The port has no compiled program: its LM dry-run
(`launch.dryrun`) counts an eager step's flops and bytes by
`launch.op_cost`, and `collective_stats` derives, from the state's
partition specs and the mesh, the per-device bytes the distribution
strategy itself exchanges, under the reference's HLO kind names:

  gossip, ring (``RingRollMixer``)
              the reference's ``jnp.roll`` of the node axis lowers to
              ``collective-permute`` (`repro.core.gossip`'s notes): two
              neighbour copies of each device's theta shard, every leaf;
  gossip, ``ring_alternating``
              one ``collective-permute`` of the shard a round;
  gossip, a dense mixer (torus, complete, hypercube, ...)
              the node axis contracted: an ``all-gather`` of the shard;
  gossip with delays
              a uniform ``delay`` mixes the stale slot of the history ring
              through the same exchange as its inner mixer; per-edge delays
              (``delay_dist``) take the dense form over the ring: an
              ``all-gather`` of the (delay + 1) slots of the shard;
  allreduce   an ``all-reduce`` of each device's gradient shard;
  serve       (prefill, decode) nothing of the strategy's.

The operand bytes are the reference's measure (an all-gather counts its
operand, the local shard). The collectives GSPMD would insert *inside*
the model over the ``model`` axis (tensor parallelism's all-reduces and
all-gathers) depend on its partitioner and are not derivable from specs:
`CollectiveStats.summary` records them as ``None`` under
``model_axis_bytes``, never as 0, so ``total_bytes`` is a lower bound.

Roofline constants, one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit):
  peak 989e12 bf16 FLOP/s, 3.35e12 B/s HBM3;
  ``ICI_BW`` 50e9 B/s: one GPU's inter-host rate, one 400 Gb/s NDR
  InfiniBand port per GPU (NVIDIA DGX H100 data sheet). Both axes of the
  16 x 16 production mesh span more than one 8-GPU host, so a collective
  over either crosses hosts. Inside a host, NVLink 4 gives 450 GB/s per
  direction (900 GB/s in all) per GPU.

>>> t = roofline_terms(989e12, 3.35e12, 0.0)
>>> t["t_compute_s"], t["t_memory_s"], t["dominant"]
(1.0, 1.0, 'compute')
>>> model_flops(1e9, 2048) == 6 * 1e9 * 2048
True
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "CollectiveStats",
           "collective_stats", "shard_bytes", "roofline_terms",
           "model_flops"]

PEAK_FLOPS = 989e12       # bf16 FLOP/s per GPU (H100 SXM, dense)
HBM_BW = 3.35e12          # bytes/s per GPU (HBM3)
ICI_BW = 50e9             # bytes/s per GPU between hosts (one 400 Gb/s NDR)

_MODEL_AXIS_NOTE = ("the collectives GSPMD would insert inside the model "
                    "over the 'model' axis are not derivable from specs; "
                    "total_bytes counts the strategy's exchange only")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
            "model_axis_bytes": None,
            "model_axis_note": _MODEL_AXIS_NOTE,
        }


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    names = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([mesh.shape[a] for a in names]))


def shard_bytes(shape, itemsize: int, spec, mesh) -> int:
    """Bytes of one device's shard of a leaf: each dim split over the mesh
    axes its spec entry names (rounded up, as a padded shard is)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    n = 1
    for size, axis in zip(shape, dims):
        n *= -(-int(size) // _axis_size(mesh, axis))
    return n * itemsize


def _leaf_shards(leaves, specs, mesh) -> list:
    return [shard_bytes(tuple(t.shape), t.element_size(), s, mesh)
            for t, s in zip(leaves, specs)]


def collective_stats(leaves, specs, mesh, *, strategy: str = "gossip",
                     mixer: str = "RingRollMixer", delay: int = 0,
                     delay_dist: str | None = None) -> CollectiveStats:
    """The per-device bytes ``strategy`` exchanges in one step.

    ``leaves`` and ``specs`` are the exchanged tree's leaves (any objects
    with ``shape`` and ``element_size()``, e.g. ``meta`` tensors) and their
    partition specs on ``mesh``: the node-stacked theta for gossip, the
    parameters (whose gradients are reduced) for allreduce. ``mixer`` is
    the gossip mixer's class name (`repro_torch.api.mixers`), the inner
    one's for a `DelayedMixer`.
    """
    shards = _leaf_shards(leaves, specs, mesh) if leaves is not None else []
    kinds: dict = {}

    def add(kind: str, nbytes: int, count: int) -> None:
        kinds.setdefault(kind, [0, 0])
        kinds[kind][0] += nbytes
        kinds[kind][1] += count

    if strategy == "gossip":
        n = len(shards)
        if delay and delay_dist is not None:
            add("all-gather", (delay + 1) * sum(shards), n)
        elif mixer == "RingRollMixer":
            add("collective-permute", 2 * sum(shards), 2 * n)
        elif mixer == "AlternatingRingMixer":
            add("collective-permute", sum(shards), n)
        elif mixer != "DisconnectedMixer":
            add("all-gather", sum(shards), n)
    elif strategy == "allreduce":
        add("all-reduce", sum(shards), len(shards))
    elif strategy != "serve":
        raise ValueError(f"unknown strategy {strategy!r}")
    return CollectiveStats({k: v[0] for k, v in kinds.items()},
                           {k: v[1] for k, v in kinds.items()})


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int = 1) -> dict:
    """The three §Roofline terms, in seconds.

    Inputs are PER-DEVICE quantities, so each term divides by a single
    GPU's rate; ``chips`` is kept for callers that pass global totals."""
    t_compute = flops / (chips * PEAK_FLOPS)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_collective = collective_bytes / (chips * ICI_BW)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_collective), key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


def model_flops(n_params_active: float, tokens: float) -> float:
    """6 * N * D rule (N = active params, D = tokens this step)."""
    return 6.0 * n_params_active * tokens

