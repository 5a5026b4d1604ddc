"""Fig. 5: accuracy vs the number of data-center nodes, on the port.

Counterpart of ``benchmarks/fig5_nodes.py``: the same zipped
'nodes,horizon' axis (the node count and the horizon co-vary at the same
total samples), JSON rows and file name. Paper claim: more centers slightly
reduce accuracy.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep)

__all__ = ["NODE_SWEEP", "run"]

NODE_SWEEP = (4, 8, 16, 32)


def run(scale: Scale | None = None, out_dir: str = FIGURES,
        eps: float = 10.0, seeds: tuple = SEEDS,
        from_store: bool = False, *, device: str = "cuda",
        store: str | None = STORE) -> dict:
    base = scale or Scale()
    # same total samples per point: T scales inversely with m
    axis = tuple((m, base.T * base.m // m) for m in NODE_SWEEP)
    out = figure_sweep("fig5_nodes", base, {"nodes,horizon": axis},
                       seeds=seeds, from_store=from_store, store=store,
                       device=device, compute_regret=False, eps=eps)
    rows = []
    for point, results in zip(out.points, out.results):
        accs = np.asarray([r.accuracy for r in results])
        rows.append({"nodes": point.coords["nodes"],
                     "horizon": point.coords["horizon"],
                     "accuracy": float(accs.mean()),
                     "accuracy_std": float(accs.std()),
                     "seeds": list(seeds),
                     "seconds": float(sum(r.wall_clock for r in results))})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fig5_nodes.json"), "w") as f:
        json.dump(rows, f, indent=1)
    accs = [r["accuracy"] for r in rows]
    return {"rows": rows, "declines": accs[0] >= accs[-1] - 0.02,
            "sweep": out}
