"""Store-backed figure regeneration CLI.

Counterpart of `repro.sweep.plot`, over the port's store records:

    PYTHONPATH=src python -m repro_torch.sweep.plot          # every sweep
    PYTHONPATH=src python -m repro_torch.sweep.plot fig2_eps
    PYTHONPATH=src python -m repro_torch.sweep.plot --list

Every sweep run persists its (point, seed) records under
``experiments/store/<name>.jsonl`` — this CLI turns those records back into
figure data WITHOUT a single engine call: per sweep it aggregates each
metric over seeds at every coordinate (`aggregate_records`, the same
reduction the figure scripts use) and writes
``experiments/figures/<name>_plot.json``. When matplotlib is importable
(it is NOT in CI — the PNG path is best-effort by design) and the sweep
has exactly one varying axis, it also renders ``<name>_plot.png`` with
mean±std error bars.

>>> import tempfile
>>> from repro_torch.sweep.plot import figure_rows
>>> recs = [{"coords": {"eps": e}, "seed": s, "engine": "sim",
...          "result": {"accuracy": 0.5 + 0.1 * s}}
...         for e in (0.1, 1.0) for s in (0, 1)]
>>> rows = figure_rows(recs, metric="accuracy")
>>> [(r["eps"], r["mean"], r["n"]) for r in rows]
[(0.1, 0.55, 2), (1.0, 0.55, 2)]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.sweep.store import (DEFAULT_STORE, SweepStore, aggregate_records,
                               record_metric, result_from_record)

__all__ = ["figure_rows", "plot_sweep", "main"]

# scalar metrics every record carries; regret_final needs the decoded array
METRICS = ("accuracy", "regret_final", "rounds_per_sec")


def _metric_value(rec: dict, metric: str):
    if metric == "regret_final":
        try:
            res = result_from_record(rec)
        except Exception:
            return None
        if res.regret is None:
            return None
        return float(np.asarray(res.regret)[-1])
    return record_metric(rec, metric)


def coord_axes(records: list[dict]) -> tuple[str, ...]:
    """Every coordinate field any record carries, sorted."""
    return tuple(sorted({k for r in records
                         for k in (r.get("coords") or {})}))


def figure_rows(records: list[dict], *, metric: str = "accuracy",
                by: tuple[str, ...] | None = None) -> list[dict]:
    """Seed-aggregated (mean/std/n) rows of ``metric`` at every coordinate —
    the same reduction the figure scripts apply to live sweep results."""
    axes = coord_axes(records) if by is None else by
    rows = aggregate_records(records, axes, lambda r: _metric_value(r, metric))
    return sorted(rows, key=lambda r: json.dumps(
        {k: r.get(k) for k in axes}, sort_keys=True, default=str))


def _maybe_png(name: str, rows_by_metric: dict, axes: tuple[str, ...],
               out_dir: str) -> str | None:
    """Best-effort 1-axis PNG; None when matplotlib is unavailable (CI),
    the axis is not one-dimensional, or the axis is not numeric."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    varying = [a for a in axes
               if len({json.dumps(r.get(a), default=str)
                       for rows in rows_by_metric.values()
                       for r in rows}) > 1] or list(axes)
    if len(varying) != 1:
        return None
    axis = varying[0]
    panels = [(m, rows) for m, rows in rows_by_metric.items()
              if any(r["mean"] is not None for r in rows)]
    if not panels:
        return None
    fig, axs = plt.subplots(1, len(panels),
                            figsize=(4.5 * len(panels), 3.5), squeeze=False)
    for ax, (metric, rows) in zip(axs[0], panels):
        pts = [(r[axis], r["mean"], r["std"]) for r in rows
               if r["mean"] is not None
               and isinstance(r.get(axis), (int, float))]
        if not pts:
            continue
        pts.sort(key=lambda p: p[0])
        xs, means, stds = map(np.asarray, zip(*pts))
        ax.errorbar(xs, means, yerr=stds, marker="o", capsize=3)
        ax.set_xlabel(axis)
        ax.set_ylabel(metric)
        ax.grid(alpha=0.3)
    fig.suptitle(name)
    fig.tight_layout()
    path = os.path.join(out_dir, f"{name}_plot.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_sweep(name: str, *, store: SweepStore,
               out_dir: str = "experiments/figures",
               metrics: tuple[str, ...] = METRICS) -> dict | None:
    """Regenerate one sweep's figure data (and best-effort PNG) from the
    store. Returns the written summary, or None when no records exist."""
    records = store.load(name)
    if not records:
        return None
    axes = coord_axes(records)
    rows_by_metric = {}
    for metric in metrics:
        rows = figure_rows(records, metric=metric, by=axes)
        # drop the raw per-seed value lists from the JSON: seeds live in
        # the store; the figure file carries the aggregates
        rows_by_metric[metric] = [
            {k: v for k, v in r.items() if k != "values"} for r in rows]
    os.makedirs(out_dir, exist_ok=True)
    summary = {
        "sweep": name,
        "records": len(records),
        "axes": list(axes),
        "engines": sorted({r.get("engine") for r in records}),
        "metrics": rows_by_metric,
    }
    json_path = os.path.join(out_dir, f"{name}_plot.json")
    with open(json_path, "w") as f:
        json.dump(summary, f, indent=1)
    png = _maybe_png(name, rows_by_metric, axes, out_dir)
    summary["json_path"] = json_path
    summary["png_path"] = png
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep.plot",
        description="Regenerate figure JSON (and PNG when matplotlib is "
                    "available) from stored sweep records — no engine calls")
    ap.add_argument("names", nargs="*",
                    help="sweep names (default: every sweep in the store)")
    ap.add_argument("--store", default=DEFAULT_STORE)
    ap.add_argument("--out-dir", default="experiments/figures")
    ap.add_argument("--list", action="store_true",
                    help="list stored sweep names and exit")
    args = ap.parse_args(argv)

    store = SweepStore(args.store)
    available = store.names()
    if args.list:
        for name in available:
            print(f"{name}: {len(store.load(name))} records")
        return 0
    names = args.names or available
    if not names:
        print(f"plot: no sweeps in {args.store} — run a sweep first "
              f"(python -m repro_torch.launch.sweep)", file=sys.stderr)
        return 1
    missing = [n for n in names if n not in available]
    if missing:
        print(f"plot: no stored records for {', '.join(missing)} "
              f"(have: {', '.join(available) or 'none'})", file=sys.stderr)
        return 1
    for name in names:
        summary = plot_sweep(name, store=store, out_dir=args.out_dir)
        made = summary["json_path"] + (
            f" + {summary['png_path']}" if summary["png_path"] else "")
        print(f"{name}: {summary['records']} records "
              f"over axes {summary['axes']} -> {made}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
