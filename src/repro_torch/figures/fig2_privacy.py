"""Fig. 2: privacy level (eps) vs regret, on the port.

Counterpart of ``benchmarks/fig2_privacy.py``: the same eps axis, JSON rows
and file name. Paper claim: non-private has the lowest regret; regret
approaches it as eps grows (weaker privacy).
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep)

__all__ = ["EPS_SWEEP", "run"]

EPS_SWEEP = (0.1, 1.0, 10.0, math.inf)


def run(scale: Scale | None = None, out_dir: str = FIGURES,
        clip_style: str = "coordinate", seeds: tuple = SEEDS,
        from_store: bool = False, *, device: str = "cuda",
        store: str | None = STORE) -> dict:
    scale = scale or Scale()
    out = figure_sweep(f"fig2_privacy_{clip_style}", scale,
                       {"eps": EPS_SWEEP}, seeds=seeds,
                       from_store=from_store, store=store, device=device,
                       eps=1.0, clip_style=clip_style)
    rows = {}
    for point, results in zip(out.points, out.results):
        regs = np.stack([np.asarray(r.regret) for r in results])   # (S, T)
        accs = np.asarray([r.accuracy for r in results])
        curve = regs.mean(axis=0)
        eps_total = results[0].privacy["eps_total"]
        rows[str(point.coords["eps"])] = {
            "regret_final": float(curve[-1]),
            "regret_final_std": float(regs[:, -1].std()),
            "regret_curve": curve[:: max(1, len(curve) // 200)].tolist(),
            "accuracy": float(accs.mean()),
            "accuracy_std": float(accs.std()),
            "seeds": list(seeds),
            "eps_total": None if math.isinf(eps_total) else eps_total,
            "seconds": float(sum(r.wall_clock for r in results)),
        }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"fig2_privacy_{clip_style}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)

    # the paper's ordering: higher eps (weaker privacy) => lower regret.
    # Tolerance: near-zero regrets (strong learner vs comparator) jitter.
    finals = [rows[str(e)]["regret_final"] for e in EPS_SWEEP]
    tol = max(50.0, 0.05 * abs(finals[0]))
    ordered = all(a >= b - tol for a, b in zip(finals, finals[1:]))
    accs = [rows[str(e)]["accuracy"] for e in EPS_SWEEP]
    acc_ordered = all(a <= b + 0.03 for a, b in zip(accs, accs[1:]))
    return {"rows": rows, "ordering_holds": ordered and acc_ordered,
            "sweep": out}
