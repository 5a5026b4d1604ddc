"""Run-event streams: append-first JSONL, one event per line.

Counterpart of `repro.obs.events`, copied nearly whole: the stream format
is the same, so either package's reader and report CLI take the other's
streams.

The durable half of the telemetry story: spans and metrics live in process
memory, events land on disk NEXT TO the sweep store (``experiments/store/
events.jsonl`` by default) so any finished — or crashed — run can be
reconstructed after the fact. ``python -m repro_torch.launch.obs report``
renders a run's event stream into a text/JSON summary.

Schema: every event is one JSON object with at least ``ts`` (epoch seconds),
``event`` (kind) and — for runner-emitted events — ``run_id`` (random
8-hex token grouping one run's events). The kinds the port emits:

  run_start    engine, stream, nodes, dim, horizon, kind ('run'|'run_batch')
  chunk        round_start, round_end, seconds, rounds_per_sec, eps
  checkpoint   step
  publish      round, version, eps (serving snapshot publications)
  sweep_point  sweep, label, seeds, source ('ran'|'loaded')
  run_end      rounds, wall_clock_s, rounds_per_sec, accuracy, eps_total
  serve_summary  the serving service's stats on stop

(The reference also emits ``chunk_cost`` from its XLA cost loop, which is
not ported; the report CLI renders it from a reference stream.)

Readers tolerate a torn trailing line (a crashed writer), exactly like the
sweep store's JSONL log.

>>> import tempfile, os
>>> path = os.path.join(tempfile.mkdtemp(), "events.jsonl")
>>> log = EventLog(path)
>>> _ = log.emit("run_start", run_id="abc123", engine="sim")
>>> _ = log.emit("chunk", run_id="abc123", round_end=64)
>>> log.close()
>>> events = read_events(path)
>>> [e["event"] for e in events]
['run_start', 'chunk']
>>> events[1]["round_end"], sorted(events[0])[:2]
(64, ['engine', 'event'])
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["EventLog", "read_events", "group_runs", "DEFAULT_EVENTS_PATH"]

# next to the sweep store (repro_torch.sweep.store.DEFAULT_STORE), not
# imported from it — keeping repro_torch.obs free of the package's other
# modules avoids cycles
DEFAULT_EVENTS_PATH = os.path.join("experiments", "store", "events.jsonl")


class EventLog:
    """Append-only JSONL event writer; thread-safe; flushes per event so a
    crash loses at most the line being written."""

    def __init__(self, path: str = DEFAULT_EVENTS_PATH):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    def emit(self, event: str, **fields) -> dict:
        rec = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(rec)
        with self._lock:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_events(path: str = DEFAULT_EVENTS_PATH) -> list[dict]:
    """Every event in the stream, in write order. A torn trailing line
    (crashed writer) is dropped; a torn line in the MIDDLE raises — that is
    corruption, not a crash artifact."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break                      # torn tail from a crashed append
            raise
    return out


def group_runs(events: list[dict]) -> dict[str, list[dict]]:
    """Events grouped by ``run_id`` (insertion-ordered — latest run last).
    Events without a run_id are grouped under ``""``."""
    runs: dict[str, list[dict]] = {}
    for e in events:
        runs.setdefault(e.get("run_id", ""), []).append(e)
    return runs
