"""Beyond-paper: train a transformer with the paper's private gossip
strategy on the port — the technique as a first-class distribution
strategy for modern architectures.

    python -m repro_torch.figures.gossip_lm_training --steps 200
    python -m repro_torch.figures.gossip_lm_training --steps 3 --device cpu

Counterpart of ``examples/gossip_lm_training.py``, with its arguments,
runs and summary lines: a 4-node gossip ring over the architecture's
``reduced()`` config on the synthetic Markov token stream, private (eps =
1) against non-private (eps = inf) against the all-reduce AdamW baseline
for the same token budget (batch 2 a node, T = 128, lam 1e-5). Each run is
`repro_torch.launch.train.train`, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import math

import numpy as np

from repro_torch.launch.train import train

__all__ = ["runs", "run_one", "main"]

BATCH_PER_NODE, SEQ_LEN, LAM = 2, 128, 1e-5


def runs(local_rule: str = "omd") -> dict:
    """The example's three runs: name -> `train` keywords."""
    return {
        "gossip eps=inf": dict(strategy="gossip", eps=math.inf,
                               local_rule=local_rule),
        "gossip eps=1.0": dict(strategy="gossip", eps=1.0,
                               local_rule=local_rule),
        "allreduce adamw": dict(strategy="allreduce"),
    }


def run_one(arch: str, nodes: int, steps: int, *, device: str = "cuda",
            state=None, **kw) -> dict:
    """One of the runs: `train`'s result (``state`` starts it from a given
    train state)."""
    return train(arch, nodes=nodes, steps=steps,
                 batch_per_node=BATCH_PER_NODE, seq_len=SEQ_LEN, lam=LAM,
                 smoke=True, device=device, state=state, **kw)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.figures.gossip_lm_training")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--local-rule", default="omd",
                    help="repro_torch.api LOCAL_RULES registry name for the "
                         "gossip runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the runs happen (default: the CUDA card)")
    args = ap.parse_args(argv)

    results = {}
    for name, kw in runs(args.local_rule).items():
        print(f"\n=== {name} ===")
        res = run_one(args.arch, args.nodes, args.steps, device=args.device,
                      **kw)
        ce = [h["ce"] for h in res["history"]]
        results[name] = ce
        print(f"  ce: start={np.mean(ce[:5]):.3f} end={np.mean(ce[-5:]):.3f}")

    print("\nsummary (lower is better):")
    for name, ce in results.items():
        print(f"  {name:18s} final ce {np.mean(ce[-5:]):.3f}  "
              f"improvement {np.mean(ce[:5]) - np.mean(ce[-5:]):+.3f}")
    return results


if __name__ == "__main__":
    main()
