"""Ablation: the paper's OMD+Lasso against the two prior sparse online
learning families it cites (§I refs [11], [12]), on the port.

Counterpart of ``benchmarks/ablation_sparse_methods.py``: the same
methods, tuned lambdas, labels, JSON rows and file name. The fused round
hard-codes the paper's OMD rule, so the zipped axis carries each method's
backend too: ``omd`` runs on ``"cuda"`` (the hand-written kernels on a
card, their plain versions on the CPU), truncated gradient and RDA on
``"reference"`` (torch ops). As the port's figures do, ``run`` returns
the rows under ``"rows"`` and the `SweepResult` under ``"sweep"``.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep)

__all__ = ["METHODS", "BACKENDS", "run"]

# (registry name, tuned lambda, display label)
METHODS = (
    ("omd", 1.0, "omd (paper)"),
    ("tg", 0.003, "truncated-gradient [11]"),
    ("rda", 0.001, "rda [12]"),
)
# the backend each method runs on: only the paper's rule is fused
BACKENDS = {"omd": "cuda", "tg": "reference", "rda": "reference"}


def run(scale: Scale | None = None, eps: float = math.inf,
        out_dir: str = FIGURES, seeds: tuple = SEEDS,
        from_store: bool = False, *, device: str = "cuda",
        store: str | None = STORE) -> dict:
    scale = scale or Scale()
    axis = tuple((rule, lam, BACKENDS[rule]) for rule, lam, _ in METHODS)
    out = figure_sweep("ablation_sparse_methods", scale,
                       {"local_rule,lam,backend": axis}, seeds=seeds,
                       from_store=from_store, store=store, device=device,
                       compute_regret=False, eps=eps)
    labels = {rule: label for rule, _, label in METHODS}
    rows = {}
    for point, results in zip(out.points, out.results):
        accs = np.asarray([r.accuracy for r in results])
        spars = np.asarray([float(np.asarray(r.sparsity)[-50:].mean())
                            for r in results])
        rows[labels[point.coords["local_rule"]]] = {
            "accuracy": float(accs.mean()),
            "accuracy_std": float(accs.std()),
            "sparsity": float(spars.mean()),
            "sparsity_std": float(spars.std()),
            "seeds": list(seeds),
        }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ablation_sparse_methods.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return {"rows": rows, "sweep": out}
