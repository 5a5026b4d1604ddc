"""Fig. 3: topology (fixed or time-varying) has no significant effect on
utility, on the port.

Counterpart of ``benchmarks/fig3_topology.py``: the same topology axis,
JSON rows and file name. 'random' and 'time_varying' are seeded
topologies: the sweep engine runs their seeds one by one, each seed with
its own graph.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep)

__all__ = ["TOPOLOGIES", "run"]

TOPOLOGIES = ("ring", "complete", "hypercube", "random", "time_varying")


def run(scale: Scale | None = None, out_dir: str = FIGURES,
        eps: float = 1.0, seeds: tuple = SEEDS,
        from_store: bool = False, *, device: str = "cuda",
        store: str | None = STORE) -> dict:
    scale = scale or Scale()
    out = figure_sweep("fig3_topology", scale, {"mixer": TOPOLOGIES},
                       seeds=seeds, from_store=from_store, store=store,
                       device=device, eps=eps)
    rows = {}
    for point, results in zip(out.points, out.results):
        regs = np.asarray([float(r.regret[-1]) for r in results])
        accs = np.asarray([r.accuracy for r in results])
        rows[point.coords["mixer"]] = {
            "regret_final": float(regs.mean()),
            "regret_final_std": float(regs.std()),
            "accuracy": float(accs.mean()),
            "accuracy_std": float(accs.std()),
            "seeds": list(seeds),
            "seconds": float(sum(r.wall_clock for r in results)),
        }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fig3_topology.json"), "w") as f:
        json.dump(rows, f, indent=1)
    accs = [r["accuracy"] for r in rows.values()]
    return {"rows": rows, "spread": max(accs) - min(accs), "sweep": out}
