"""Training launcher: the paper's linear workload on a STREAMS scenario.

Counterpart of `repro.launch.train`'s ``--stream`` mode, on the port
(CUDA unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --stream drift \
        --stream-opt period=32 --nodes 4 --dim 64 --steps 128 --engine sim \
        --device cpu

It builds the `TrainRecipe`'s `RunSpec` for the scenario and drives it
through `repro_torch.run` — the same call the benchmarks make, so the CLI
and the benchmarks cannot diverge — with ``--log`` as the per-round CSV
(``ExecConfig.log_path``) and ``--checkpoint-every``/``--checkpoint-dir``
as its checkpoints, and prints the reference's one-line summary. The
round body is the fused kernels' (``backend="cuda"``; their plain versions
with ``--device cpu``). The ``--arch`` mode trains an LM
architecture, which belongs to the LM stack: it raises, naming ROADMAP
queue 1 item 5.
"""
from __future__ import annotations

import argparse
import ast

from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.runner import run as api_run
from repro_torch.api.spec import not_ported
from repro_torch.launch import steps as steps_lib

__all__ = ["parse_stream_options", "train", "main"]

_LM_STACK = ("the LM training mode (--arch: models, configs, optim, the "
             "gossip/allreduce train steps; ROADMAP queue 1 item 5: the LM "
             "stack)")


def parse_stream_options(pairs: list[str] | None) -> dict:
    """['period=16', 'mode=rotate'] -> {'period': 16, 'mode': 'rotate'}."""
    opts = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise ValueError(f"--stream-opt expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            opts[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            opts[k] = v
    return opts


def train(arch: str | None = None, *, strategy: str = "gossip",
          nodes: int = 4, steps: int = 50, eps: float = 1.0,
          lam: float = 1e-4, log_path: str | None = None, seed: int = 0,
          microbatches: int = 1, topology: str = "ring",
          local_rule: str = "omd", mechanism: str = "laplace",
          clip_style: str = "coordinate", delay: int = 0,
          delay_dist: str | None = None, stream: str | None = None,
          stream_options: dict | None = None, dim: int = 256,
          engine: str = "dist", checkpoint_every: int | None = None,
          checkpoint_dir: str | None = None,
          device: str = "cuda") -> dict:
    """One ``--stream`` training run; returns ``{"result", "final",
    "history", "state"}`` as the reference's does."""
    recipe = steps_lib.TrainRecipe(strategy=strategy, eps=eps, lam=lam,
                                   microbatches=microbatches,
                                   topology=topology, local_rule=local_rule,
                                   mechanism=mechanism,
                                   clip_style=clip_style, delay=delay,
                                   delay_dist=delay_dist)
    if stream is None:
        if arch is None:
            raise ValueError("train() needs arch= (an LM config) or stream= "
                             "(a STREAMS scenario)")
        raise not_ported(_LM_STACK)

    # the paper's linear workload on a STREAMS scenario, via run()
    spec = recipe.to_runspec(nodes).replace(
        dim=dim, horizon=steps, seed=seed, stream=stream,
        stream_options=stream_options or {}, backend="cuda")
    result = api_run(spec, engine=engine,
                     exec=ExecConfig(log_path=log_path,
                                     checkpoint_every=checkpoint_every,
                                     checkpoint_dir=checkpoint_dir),
                     device=device)
    regret = (float(result.regret[-1]) if result.regret is not None
              else float("nan"))
    print(f"stream={stream} engine={engine} nodes={nodes} dim={dim} "
          f"rounds={result.rounds}: acc={result.accuracy:.3f} "
          f"regret={regret:.1f} "
          f"eps_total={result.privacy['eps_total']} "
          f"({result.rounds_per_sec:.1f} rounds/s)")
    return {"result": result, "final": result.summary(),
            "history": None, "state": result.final_state}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="the paper's linear workload on a STREAMS scenario "
                    "(--stream), on the port")
    ap.add_argument("--arch", default=None,
                    help="LM architecture: not ported (ROADMAP queue 1 "
                         "item 5)")
    ap.add_argument("--strategy", default="gossip",
                    choices=["gossip", "allreduce"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-per-node", type=int, default=2,
                    help="LM mode only")
    ap.add_argument("--seq-len", type=int, default=128, help="LM mode only")
    ap.add_argument("--eps", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--topology", default="ring",
                    help="repro_torch.api MIXERS registry name (ring, "
                         "complete, ring_alternating, disconnected, torus, "
                         "...)")
    ap.add_argument("--local-rule", default="omd",
                    help="repro_torch.api LOCAL_RULES registry name (omd, "
                         "tg, rda)")
    ap.add_argument("--mechanism", default="laplace",
                    help="repro_torch.api MECHANISMS registry name "
                         "(laplace, gaussian, none)")
    ap.add_argument("--clip-style", default="coordinate",
                    choices=["coordinate", "global"],
                    help="Laplace calibration (see TrainRecipe.clip_style)")
    ap.add_argument("--delay", type=int, default=0,
                    help="WAN gossip staleness in rounds")
    ap.add_argument("--delay-dist", default=None,
                    choices=["constant", "uniform", "geometric"],
                    help="per-edge delay distribution, capped at --delay")
    ap.add_argument("--stream", default=None,
                    help="repro_torch.api STREAMS registry name "
                         "(social_sparse, drift, heterogeneous, bursty)")
    ap.add_argument("--stream-opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="stream factory option, repeatable "
                         "(e.g. --stream-opt period=32)")
    ap.add_argument("--dim", type=int, default=256,
                    help="feature dimension for --stream runs")
    ap.add_argument("--engine", default="dist", choices=["sim", "dist"],
                    help="engine for --stream runs")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log", default=None,
                    help="per-round CSV (ExecConfig.log_path)")
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="LM mode only")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="LM mode only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run happens (default: the CUDA card)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.arch and not args.stream:
        ap.error("one of --arch or --stream is required")
    return train(args.arch, strategy=args.strategy, nodes=args.nodes,
                 steps=args.steps, eps=args.eps, lam=args.lam,
                 log_path=args.log, seed=args.seed,
                 microbatches=args.microbatches, topology=args.topology,
                 local_rule=args.local_rule, mechanism=args.mechanism,
                 clip_style=args.clip_style, delay=args.delay,
                 delay_dist=args.delay_dist, stream=args.stream,
                 stream_options=parse_stream_options(args.stream_opt),
                 dim=args.dim, engine=args.engine,
                 checkpoint_every=args.checkpoint_every,
                 checkpoint_dir=args.checkpoint_dir, device=args.device)


if __name__ == "__main__":
    main()
