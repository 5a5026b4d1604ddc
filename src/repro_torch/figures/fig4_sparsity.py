"""Fig. 4: the sparsity/accuracy trade-off, on the port.

Counterpart of ``benchmarks/fig4_sparsity.py``: the same lambda axis
(non-private, no regret), JSON rows and file name. Paper claim: an
appropriate sparsity gives the best accuracy; too much or too little hurts.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep)

__all__ = ["LAMBDAS", "run"]

LAMBDAS = (0.0, 1e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0)


def run(scale: Scale | None = None, out_dir: str = FIGURES,
        eps: float = math.inf, seeds: tuple = SEEDS,
        from_store: bool = False, *, device: str = "cuda",
        store: str | None = STORE) -> dict:
    scale = scale or Scale()
    out = figure_sweep("fig4_sparsity", scale, {"lam": LAMBDAS}, seeds=seeds,
                       from_store=from_store, store=store, device=device,
                       compute_regret=False, eps=eps)
    rows = []
    for point, results in zip(out.points, out.results):
        spars = np.asarray([float(np.asarray(r.sparsity)[-50:].mean())
                            for r in results])
        accs = np.asarray([r.accuracy for r in results])
        rows.append({
            "lambda": point.coords["lam"],
            "sparsity": float(spars.mean()),
            "sparsity_std": float(spars.std()),
            "accuracy": float(accs.mean()),
            "accuracy_std": float(accs.std()),
            "seeds": list(seeds),
            "seconds": float(sum(r.wall_clock for r in results)),
        })
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fig4_sparsity.json"), "w") as f:
        json.dump(rows, f, indent=1)
    best = max(rows, key=lambda r: r["accuracy"])
    return {"rows": rows, "best": best,
            "interior_best": 0.0 < best["sparsity"] < 0.99, "sweep": out}
