"""repro_torch — the PyTorch / CUDA port of `repro`.

The paper's private gossip learner (Algorithm 1 over a ring of data
centres: Laplace noise, per-node L2 clip, OMD with the L1 prox) in PyTorch,
with the round body on hand-written Hopper kernels (``backend="cuda"``).
It mirrors `repro`'s module layout and imports neither JAX nor `repro`.
Every entry point runs on CUDA unless the caller passes ``device="cpu"``.

    from repro_torch import ExecConfig, RunSpec, run
    spec = RunSpec(nodes=64, dim=10_000, horizon=1562, eps=1.0,
                   calibration="coordinate", alpha0=1.0, lam=1e-3,
                   backend="cuda")
    res = run(spec, exec=ExecConfig(chunk_rounds=256))     # simulator
    dist = run(spec, engine="dist")                        # GossipDP, same bits

The distributed engine also runs as a raw strategy on any node-stacked
pytree (``spec.build_distributed()``: ``GossipDP.init``/``update``), and
`ops` carries the seed kernels ``pdomd_update`` and ``hinge_grad`` with the
(rows, 128) tile plumbing of a parameter pytree.

Fault scenarios (`repro_torch.faults`: link drops, partitions, crashes,
stragglers) ride on the spec and run hybrid on the cuda backend:

    res = run(spec.replace(faults="dcn"))
    res.connectivity, res.metrics["faults"], res.privacy

Several seeds of one configuration run in step — one launch of each round
kernel a round for all of them, each seed's result equal to its own run —
and `repro_torch.sweep` runs grids of them into a results store:

    batch = run_batch(spec, seeds=(0, 1, 2))    # [RunResult] * 3

`run` also drives a caller's own loop (custom mode: ``step_fn(state,
batch)`` for ``horizon`` steps, ``RunResult.history``), writes one CSV row
a round with ``ExecConfig(log_path=...)`` (`repro_torch.metrics`), and with
``Telemetry(cost=True)`` predicts each chunk's time from an op count and
records the measured time beside it (`repro_torch.obs.cost`).

`repro_torch.serve` answers predictions from published snapshots while a
background thread keeps training (`ServeService`, `BurstyReplay`), and
`repro_torch.obs` records spans, metrics, run events and profiler traces
(``python -m repro_torch.launch.obs report`` renders a stream).
``python -m repro_torch.launch.train --stream ...`` and ``python -m
repro_torch.launch.dryrun --stream ...`` run and count the paper's
workload from the command line.
"""
from repro_torch.api import (FAULTS, ExecConfig, FaultSpec, GossipDP,
                             GossipState, RunResult, RunSpec, degradation,
                             gossip_mix_tree, ops, per_node_clip,
                             rounds_to_recover, run, run_batch,
                             seed_vectorizable, wrap_mixer)
from repro_torch import metrics

__all__ = ["ExecConfig", "RunResult", "RunSpec", "run", "run_batch",
           "seed_vectorizable", "GossipDP",
           "GossipState", "gossip_mix_tree", "per_node_clip", "ops",
           "FAULTS", "FaultSpec", "wrap_mixer", "degradation",
           "rounds_to_recover", "metrics"]
