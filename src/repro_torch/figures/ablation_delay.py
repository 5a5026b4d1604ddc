"""Beyond the paper: tolerance of communication delay (its §VI future
work), on the port.

Counterpart of ``benchmarks/ablation_delay.py``: the same delay axis, both
engines (the simulator for accuracy and regret, the distributed engine on
the same streams and seeds), JSON rows, bench rows and ``graceful`` check.
Neighbours' theta~ arrive ``delay`` rounds late through the engines'
history ring; on ``backend="cuda"`` that is ``round_update``'s received
branch. Two files, both under ``out_dir``:

  ablation_delay.json — the accuracy rows
  BENCH_delay.json    — per-delay wall clock and final regret
                        (``bench_path`` to put it elsewhere)

    python -m repro_torch.figures.ablation_delay --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep)

__all__ = ["DELAYS", "SMOKE_DELAYS", "BENCH_FILE", "run", "main"]

DELAYS = (0, 1, 4, 16, 64)
SMOKE_DELAYS = (0, 2)
BENCH_FILE = "BENCH_delay.json"


def run(scale: Scale | None = None, eps: float = math.inf,
        out_dir: str = FIGURES, bench_path: str | None = None,
        delays: tuple = DELAYS, seeds: tuple = SEEDS,
        from_store: bool = False, *, device: str = "cuda",
        store: str | None = STORE) -> dict:
    scale = scale or Scale()
    kw = dict(seeds=seeds, from_store=from_store, store=store, device=device,
              eps=eps, lam=0.01)
    sim = figure_sweep("ablation_delay_sim", scale, {"delay": delays}, **kw)
    dist = figure_sweep("ablation_delay_dist", scale, {"delay": delays},
                        engine="dist", compute_regret=False, **kw)
    rows, bench_rows = [], []
    for point, sim_rs, dist_rs in zip(sim.points, sim.results, dist.results):
        d = point.coords["delay"]
        sim_acc = np.asarray([r.accuracy for r in sim_rs])
        dist_acc = np.asarray([r.accuracy for r in dist_rs])
        regs = np.asarray([float(r.regret[-1]) for r in sim_rs])
        rows.append({"delay": d,
                     "accuracy": float(sim_acc.mean()),
                     "accuracy_std": float(sim_acc.std()),
                     "accuracy_distributed": float(dist_acc.mean()),
                     "seeds": list(seeds)})
        bench_rows.append({
            "delay": d,
            "accuracy": float(sim_acc.mean()),
            "regret_final": float(regs.mean()),
            "regret_final_std": float(regs.std()),
            "regret_per_round": float(regs.mean() / scale.T),
            "simulator_seconds": round(
                float(sum(r.wall_clock for r in sim_rs)), 3),
            "distributed_seconds": round(
                float(sum(r.wall_clock for r in dist_rs)), 3),
        })
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ablation_delay.json"), "w") as f:
        json.dump(rows, f, indent=1)
    bench = {
        "bench": "ablation_delay",
        "scale": {"n": scale.n, "m": scale.m, "T": scale.T},
        "eps": None if math.isinf(eps) else eps,
        "seeds": list(seeds),
        "rows": bench_rows,
    }
    with open(bench_path or os.path.join(out_dir, BENCH_FILE), "w") as f:
        json.dump(bench, f, indent=1)
    return {"rows": rows, "bench": bench,
            "graceful": rows[-1]["accuracy"] > 0.5 * rows[0]["accuracy"],
            "sim": sim, "dist": dist}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.figures.ablation_delay")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scale + delays (0, 2): seconds")
    ap.add_argument("--out", default=FIGURES)
    ap.add_argument("--bench-path", default=None,
                    help=f"default: {BENCH_FILE} under --out")
    ap.add_argument("--store", default=STORE)
    ap.add_argument("--from-store", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scale = Scale.smoke() if args.smoke else None
    delays = SMOKE_DELAYS if args.smoke else DELAYS
    res = run(scale, out_dir=args.out, bench_path=args.bench_path,
              delays=delays, from_store=args.from_store, device=args.device,
              store=args.store)
    for r in res["bench"]["rows"]:
        print(f"delay={r['delay']:3d}: acc={r['accuracy']:.3f} "
              f"regret/T={r['regret_per_round']:.4f} "
              f"sim={r['simulator_seconds']:.1f}s "
              f"dist={r['distributed_seconds']:.1f}s")
    print("graceful degradation:", res["graceful"])
    return res


if __name__ == "__main__":
    main()
