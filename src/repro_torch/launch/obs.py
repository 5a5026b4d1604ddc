"""`python -m repro_torch.launch.obs report` — render run-event streams.

Counterpart of `repro.launch.obs`. Reads the JSONL event stream
`repro_torch.obs` writes next to the sweep store
(``experiments/store/events.jsonl`` by default, ``--events`` for another)
and renders one summary block per run: phase counts, rounds/sec, the eps
ledger endpoint, checkpoint/publish activity, the predicted-vs-measured
chunk cost (in a stream the JAX package wrote), sweep progress and — when
a serving run left its exit record — the full serving summary including
shed reasons. The stream format is the reference's, so this CLI renders a
stream `repro.obs` wrote exactly as `repro.launch.obs` does, and the
reverse. ``--json`` emits the same
structure machine-readably; ``--run`` narrows to one run id.

    PYTHONPATH=src python -m repro_torch.launch.obs report
    PYTHONPATH=src python -m repro_torch.launch.obs report --events e.jsonl \
        --json
    PYTHONPATH=src python -m repro_torch.launch.obs report --run 8d76664f

>>> import json, os, tempfile
>>> path = os.path.join(tempfile.mkdtemp(), "events.jsonl")
>>> from repro_torch.obs import EventLog
>>> log = EventLog(path)
>>> _ = log.emit("run_start", run_id="ab12", kind="run", engine="sim",
...              stream="drift", horizon=8)
>>> _ = log.emit("chunk", run_id="ab12", round_start=0, round_end=8,
...              seconds=0.5, eps=1.0)
>>> _ = log.emit("run_end", run_id="ab12", rounds=8, wall_clock_s=0.5,
...              rounds_per_sec=16.0, accuracy=0.75, eps_total=1.0)
>>> log.close()
>>> main(["report", "--events", path])
run ab12  (run, engine=sim, stream=drift)
  rounds: 8  wall: 0.500s  rounds/sec: 16
  chunks: 1  checkpoints: 0  publishes: 0
  accuracy: 0.75  eps_total: 1
0
>>> out = summarize_events(path)
>>> out["runs"]["ab12"]["rounds"], out["runs"]["ab12"]["chunks"]
(8, 1)
>>> main(["report", "--events", path, "--run", "nope"])
no events for run id 'nope'
1
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import DEFAULT_EVENTS_PATH, group_runs, read_events

__all__ = ["main", "summarize_events"]


def _summarize_run(events: list[dict]) -> dict:
    """One run's event list -> flat JSON-able summary."""
    out: dict = {"events": len(events)}
    counts = {"chunk": 0, "checkpoint": 0, "publish": 0, "sweep_point": 0}
    for e in events:
        kind = e.get("event")
        if kind in counts:
            counts[kind] += 1
        if kind == "run_start":
            for k in ("kind", "engine", "stream", "horizon", "seeds",
                      "devices"):
                if k in e:
                    out[k] = e[k]
        elif kind == "chunk":
            out["rounds"] = e.get("round_end", out.get("rounds"))
            if e.get("eps") is not None:
                out["eps_total"] = e["eps"]
        elif kind == "chunk_cost":
            out["cost"] = {k: e.get(k) for k in
                           ("predicted_s", "measured_mean_s", "error_ratio",
                            "flops", "hbm_bytes")}
        elif kind == "run_end":
            for k in ("rounds", "wall_clock_s", "rounds_per_sec", "accuracy",
                      "eps_total"):
                if e.get(k) is not None:
                    out[k] = e[k]
        elif kind == "serve_summary":
            out["serve"] = {k: v for k, v in e.items()
                            if k not in ("ts", "event", "run_id")}
    out["chunks"] = counts["chunk"]
    out["checkpoints"] = counts["checkpoint"]
    out["publishes"] = counts["publish"]
    if counts["sweep_point"]:
        out["sweep_points"] = counts["sweep_point"]
    return out


def summarize_events(path: str = DEFAULT_EVENTS_PATH,
                     run_id: str | None = None) -> dict:
    """{'events': N, 'runs': {run_id: summary}} for the whole stream (or one
    run). Events without a run_id — the serving layer's publish /
    serve_summary records — group under the id ``"-"``. Unknown ``run_id``
    yields an empty ``runs`` dict."""
    events = read_events(path)
    runs = {(rid or "-"): evs for rid, evs in group_runs(events).items()}
    if run_id is not None:
        runs = {run_id: runs[run_id]} if run_id in runs else {}
    return {"events": len(events), "path": path,
            "runs": {rid: _summarize_run(evs) for rid, evs in runs.items()}}


def _fmt(v, digits: int = 3):
    if isinstance(v, float):
        return f"{v:.{digits}f}".rstrip("0").rstrip(".") or "0"
    return v


def _render_text(summary: dict) -> list[str]:
    lines = []
    for rid, run in summary["runs"].items():
        head = ", ".join(f"{k}={run[k]}" for k in ("engine", "stream")
                         if k in run)
        lines.append(f"run {rid}  ({run.get('kind', 'run')}"
                     + (f", {head}" if head else "") + ")")
        row = [f"rounds: {run['rounds']}"] if "rounds" in run else []
        if "wall_clock_s" in run:
            row.append(f"wall: {run['wall_clock_s']:.3f}s")
        if "rounds_per_sec" in run:
            row.append(f"rounds/sec: {_fmt(run['rounds_per_sec'], 1)}")
        if row:
            lines.append("  " + "  ".join(row))
        lines.append(f"  chunks: {run['chunks']}  "
                     f"checkpoints: {run['checkpoints']}  "
                     f"publishes: {run['publishes']}")
        tail = [f"{k}: {_fmt(run[k])}" for k in ("accuracy", "eps_total")
                if run.get(k) is not None]
        if tail:
            lines.append("  " + "  ".join(tail))
        if "sweep_points" in run:
            lines.append(f"  sweep points: {run['sweep_points']}")
        cost = run.get("cost")
        if cost:
            lines.append(
                f"  cost: predicted {_fmt(cost['predicted_s'], 6)}s vs "
                f"measured {_fmt(cost['measured_mean_s'], 6)}s "
                f"(error ratio {_fmt(cost['error_ratio'])})")
        serve = run.get("serve")
        if serve:
            adm = serve.get("admission", {})
            lines.append(
                f"  serve: served={adm.get('served')} shed={adm.get('shed')} "
                f"refused={adm.get('refused')} "
                f"shed_reasons={adm.get('shed_reasons')}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.launch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="summarize a run-event stream")
    rep.add_argument("--events", default=DEFAULT_EVENTS_PATH,
                     help=f"events JSONL (default {DEFAULT_EVENTS_PATH})")
    rep.add_argument("--run", default=None, help="narrow to one run id")
    rep.add_argument("--json", action="store_true",
                     help="machine-readable output")
    args = parser.parse_args(argv)

    summary = summarize_events(args.events, run_id=args.run)
    try:
        if not summary["runs"]:
            what = (f"run id {args.run!r}" if args.run
                    else f"stream {args.events!r}")
            print(f"no events for {what}")
            return 1
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print("\n".join(_render_text(summary)))
    except BrokenPipeError:               # e.g. `report | head`
        sys.stderr.close()
    return 0


if __name__ == "__main__":             # pragma: no cover - CLI entry
    raise SystemExit(main())
