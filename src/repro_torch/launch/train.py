"""Training launcher, on the port (CUDA unless ``--device cpu``).

Counterpart of `repro.launch.train`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 50 --strategy gossip --eps 1.0 --nodes 4 [--smoke] \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --stream drift \
        --stream-opt period=32 --nodes 4 --dim 64 --steps 128 --engine sim \
        --device cpu

Two workloads, one driving loop (`repro_torch.run`):

  * ``--arch`` trains an LM architecture with the GossipDP strategy
    ('gossip', the paper) or the classic data-parallel baseline
    ('allreduce'): `launch.steps` builds the model's step and state,
    `repro_torch.data.lm_batches` feeds it, and run()'s custom mode drives
    the per-step loop, metrics, eps accounting, the CSV log (``--log``)
    and checkpoints, printing ``step N loss=... ce=... sparsity=...``.
    ``--smoke`` (the default) trains the ``reduced()`` config; ``--full``
    the published one.
  * ``--stream`` runs the paper's linear workload on any STREAMS scenario
    under either engine — the same call the benchmarks make, so the CLI
    and the benchmarks cannot diverge — with the fused kernels' round body
    (``backend="cuda"``; their plain versions with ``--device cpu``), and
    prints the reference's one-line summary.
"""
from __future__ import annotations

import argparse
import ast
from typing import Any

import torch

from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.runner import run as api_run
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.lm import lm_batches
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model
from repro_torch.core import tree

__all__ = ["parse_stream_options", "train", "main"]

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
          nodes: int = 4, steps: int = 50, batch_per_node: int = 2,
          seq_len: int = 128, eps: float = 1.0, lam: float = 1e-4,
          smoke: bool = True, log_path: str | None = None, seed: int = 0,
          microbatches: int = 1, topology: str = "ring",
          local_rule: str = "omd", mechanism: str = "laplace",
          clip_style: str = "coordinate", delay: int = 0,
          delay_dist: str | None = None, stream: str | None = None,
          stream_options: dict | None = None, dim: int = 256,
          engine: str = "dist", checkpoint_every: int | None = None,
          checkpoint_dir: str | None = None,
          device: str = "cuda", state: Any = None) -> dict:
    """One training run; returns ``{"result", "final", "history",
    "state"}`` as the reference's does. An LM run starts from ``state``
    when given (the strategy's train state on ``device``, e.g. one
    carried from the reference by `repro_torch.convert.
    train_state_from_jax`), else from the strategy's init at ``seed``."""
    recipe = steps_lib.TrainRecipe(strategy=strategy, eps=eps, lam=lam,
                                   microbatches=microbatches,
                                   topology=topology, local_rule=local_rule,
                                   mechanism=mechanism,
                                   clip_style=clip_style, delay=delay,
                                   delay_dist=delay_dist)
    if stream is not None:
        return _train_stream(recipe, stream, stream_options, nodes=nodes,
                             steps=steps, seed=seed, dim=dim, engine=engine,
                             log_path=log_path,
                             checkpoint_every=checkpoint_every,
                             checkpoint_dir=checkpoint_dir, device=device)
    if arch is None:
        raise ValueError("train() needs arch= (an LM config) or stream= "
                         "(a STREAMS scenario)")
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    model = build_model(cfg, device)

    if strategy == "gossip":
        gdp = steps_lib.make_gossip_dp(nodes, recipe)
        step_fn = steps_lib.make_gossip_train_step(model, gdp, microbatches)
        if state is None:
            state = steps_lib.make_gossip_init(model, gdp, nodes)(seed)
        batch_nodes = nodes
        spec = recipe.to_runspec(nodes)
    else:
        step_fn, init = steps_lib.make_allreduce_train_step(model, recipe)
        if state is None:
            state = init(seed)
        batch_nodes = 1
        spec = None

    def add_frontend(batch):
        B_l = tuple(batch["tokens"].shape[:-1])
        dev = batch["tokens"].device
        if cfg.frontend is not None:
            batch["frontend"] = torch.zeros(
                B_l + (max(cfg.frontend_tokens, 1), cfg.d_model),
                dtype=cfg.tdtype, device=dev)
            batch["labels"][..., :cfg.frontend_tokens] = -1
        elif cfg.family == "encdec":
            batch["frontend"] = torch.zeros(
                B_l + (max(seq_len // 4, 8), cfg.d_model), dtype=cfg.tdtype,
                device=dev)
        return batch

    data = lm_batches(cfg.vocab_size, batch_per_node, seq_len,
                      nodes=batch_nodes, seed=seed, device=device)

    def batches():
        for raw in data:
            batch = add_frontend(raw)
            if strategy == "gossip" and batch_nodes == 1:
                batch = tree.tree_map(lambda x: x[None], batch)
            yield batch

    result = api_run(spec, engine=strategy, step_fn=step_fn, state=state,
                     batches=batches(),
                     horizon=steps,
                     exec=ExecConfig(log_path=log_path, print_every=10,
                                     checkpoint_every=checkpoint_every,
                                     checkpoint_dir=checkpoint_dir))
    return {"history": result.history, "final": result.metrics,
            "state": result.final_state, "result": result}


def _train_stream(recipe, stream, stream_options, *, nodes, steps, seed,
                  dim, engine, log_path, checkpoint_every, checkpoint_dir,
                  device) -> dict:
    """The paper's linear workload on a STREAMS scenario, via run()."""
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
        description="an LM architecture (--arch) or the paper's linear "
                    "workload on a STREAMS scenario (--stream), on the port")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS,
                    help="LM architecture (omit when using --stream)")
    ap.add_argument("--strategy", default="gossip",
                    choices=["gossip", "allreduce"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-per-node", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
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
                    help="LM mode: the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="LM mode: the published config")
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
                 steps=args.steps, batch_per_node=args.batch_per_node,
                 seq_len=args.seq_len, eps=args.eps, lam=args.lam,
                 smoke=args.smoke,
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
