"""Dry-run of a STREAMS scenario's chunk program: its cost, not its horizon.

Counterpart of `repro.launch.dryrun`'s ``--stream`` mode, on the port
(CUDA unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --stream bursty \
        --engine dist --nodes 4 --dim 64 --chunk-rounds 16 --device cpu

The reference lowers and compiles the chunk program `repro.api.run` scans
and reads its HLO cost. The port's chunk is a loop of eager rounds, so
`dryrun_stream` builds the chunk program `repro_torch.run` would drive,
counts ONE round of it on the stream's first round
(`repro_torch.obs.analyze_chunk`: torch ops by `hlo_cost`'s rules, each
kernel by its `kernels.work` numbers) and multiplies by the chunk's rounds
— the horizon never runs. It records the flops and bytes under the
reference's keys (``hlo_flops``, ``hlo_bytes``), the device's peak memory
over the counted round (and above what was allocated before it), and the
predicted chunk time on the calibrated
roofline, in ``experiments/dryrun/``. The ``--arch`` and ``--all`` modes
(LM architectures on production meshes) belong to the LM stack: they
raise, naming ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.api.spec import not_ported

__all__ = ["dryrun_stream", "main", "OUT_DIR"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")
_LM_STACK = ("the LM dry-run (--arch/--all: lowering every architecture x "
             "input shape on the production meshes; ROADMAP queue 1 item 5: "
             "the LM stack)")


def dryrun_stream(stream: str, *, engine: str = "sim", nodes: int = 8,
                  dim: int = 256, chunk_rounds: int = 64,
                  stream_options: dict | None = None, save: bool = True,
                  verbose: bool = True, device: str = "cuda") -> dict:
    """Count the chunk program `repro_torch.run` drives for a STREAMS
    scenario (one round, times ``chunk_rounds``) and record its cost —
    proves a declared scenario runs on either engine before you pay for
    the run. The round body is the fused kernels' (``backend="cuda"``)."""
    from repro_torch.api import RunSpec
    from repro_torch.api.runner import _stream_chunk, make_chunk_fn
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.obs import analyze_chunk, calibrate

    dev = resolve_device(device)
    model = calibrate(device=dev)      # before the peak-memory window
    spec = RunSpec(nodes=nodes, dim=dim, horizon=chunk_rounds, eps=1.0,
                   alpha0=0.5, lam=0.01, stream=stream,
                   stream_options=stream_options or {}, backend="cuda")
    fn, state = make_chunk_fn(spec, engine, dev)
    xs, ys = _stream_chunk(spec.resolve_stream(device=dev), 0, 1, dev)
    before = None
    if dev.type == "cuda":
        synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = int(torch.cuda.memory_allocated(dev))
    t0 = time.perf_counter()
    cc = analyze_chunk(fn, state, xs, ys, model=model, rounds=chunk_rounds)
    synchronize(dev)
    count_s = time.perf_counter() - t0
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)      # the process's, over the counted round
    rec = {
        "arch": f"stream-{stream}", "shape": f"chunk{chunk_rounds}",
        "mesh": "host", "strategy": engine, "status": "ok",
        "stream": stream, "engine": engine, "nodes": nodes, "dim": dim,
        "chunk_rounds": chunk_rounds, "compile_s": round(count_s, 1),
        "hlo_flops": cc.cost.flops, "hlo_bytes": cc.cost.hbm_bytes,
        "collectives": {"collective_bytes": cc.cost.collective_bytes},
        "device": str(dev),
        "memory_peak_bytes": peak,
        # what the counted round itself allocated above the state and data
        "memory_round_bytes": None if peak is None else peak - before,
        "predicted_chunk_s": cc.predicted_s,
        "model": cc.model.summary(),
    }
    if save:
        _save(rec)
    if verbose:
        print(f"[ok] stream={stream} engine={engine} m={nodes} n={dim} "
              f"chunk={chunk_rounds}: counted {count_s:.1f}s "
              f"flops={cc.cost.flops:.3g} bytes={cc.cost.hbm_bytes:.3g}")
    return rec


def _save(rec: dict) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    fn = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
          f"{rec['strategy']}.json")
    with open(os.path.join(OUT_DIR, fn), "w") as f:
        json.dump(rec, f, indent=2)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="count a STREAMS scenario's chunk program (--stream)")
    ap.add_argument("--arch", default=None,
                    help="LM architecture: not ported (ROADMAP queue 1 "
                         "item 5)")
    ap.add_argument("--shape", default=None, help="LM mode only")
    ap.add_argument("--all", action="store_true",
                    help="every LM architecture: not ported")
    ap.add_argument("--multi-pod", action="store_true", help="LM mode only")
    ap.add_argument("--strategy", default="gossip",
                    choices=["gossip", "allreduce"], help="LM mode only")
    ap.add_argument("--opt", default="", help="LM mode only")
    ap.add_argument("--delay", type=int, default=0, help="LM mode only")
    ap.add_argument("--delay-dist", default=None,
                    choices=["constant", "uniform", "geometric"],
                    help="LM mode only")
    ap.add_argument("--stream", default=None,
                    help="repro_torch.api STREAMS name: count the "
                         "repro_torch.run chunk program")
    ap.add_argument("--stream-opt", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--engine", default="sim", choices=["sim", "dist"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--chunk-rounds", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the counted round runs (default: the card)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.stream:
        from repro_torch.launch.train import parse_stream_options
        dryrun_stream(args.stream, engine=args.engine, nodes=args.nodes,
                      dim=args.dim, chunk_rounds=args.chunk_rounds,
                      stream_options=parse_stream_options(args.stream_opt),
                      device=args.device)
        return 0
    raise not_ported(_LM_STACK)


if __name__ == "__main__":
    sys.exit(main())
