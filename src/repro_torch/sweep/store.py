"""Persistent sweep results store — one JSON-lines record per (point, seed).

Counterpart of `repro.sweep.store`, over the port's `RunResult` records.

Every record carries the RESOLVED spec, the axis coordinates, the seed, the
full `RunResult` record (trajectories, eps ledger, final_w — exact JSON
round-trip via `RunResult.to_record`/`from_record`), the wall-clock and the
git SHA, so figures regenerate from the store without re-running and a
record is auditable long after the code moved on.

Files live under ``experiments/store/<name>.jsonl``. Writes are upserts:
a new record REPLACES any stored record with the same identity
(coords, seed, engine, resolved spec), so re-running a sweep never
duplicates rows and a changed base spec never silently reuses stale data.

>>> import tempfile
>>> from repro_torch.api import RunSpec
>>> from repro_torch.sweep.store import SweepStore, spec_record
>>> store = SweepStore(tempfile.mkdtemp())
>>> spec = RunSpec(nodes=2, dim=8, horizon=4, eps=1.0)
>>> rec = {"sweep": "demo", "coords": {"eps": 1.0}, "seed": 0,
...        "engine": "sim", "spec": spec_record(spec),
...        "result": {"accuracy": 0.75}}
>>> store.upsert("demo", [rec])
>>> len(store.load("demo"))
1
>>> store.upsert("demo", [dict(rec, result={"accuracy": 0.5})])  # same key
>>> [r["result"]["accuracy"] for r in store.load("demo")]
[0.5]
>>> store.query("demo", eps=1.0)[0]["seed"]
0
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import time
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.api.runner import RunResult
from repro_torch.api.spec import RunSpec

__all__ = ["SweepStore", "spec_record", "spec_from_record", "git_sha",
           "record_key", "result_from_record", "aggregate_records",
           "DEFAULT_STORE"]

DEFAULT_STORE = "experiments/store"


def _jsonable(v: Any) -> bool:
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    if isinstance(v, (list, tuple)):
        return all(_jsonable(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _jsonable(x) for k, x in v.items())
    return False


def spec_record(spec: RunSpec) -> dict:
    """JSON-able dict of a RunSpec, field by field.

    Declarative fields (registry names, numbers, option dicts) serialize
    as-is; constructed protocol instances / callables can't round-trip and
    are recorded as ``{"__instance__": <type name>}`` markers — such records
    are kept for audit but never matched by the store-reuse path.
    """
    rec = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        rec[f.name] = v if _jsonable(v) else {"__instance__": type(v).__name__}
    return rec


def spec_from_record(rec: dict) -> RunSpec:
    """Rebuild a RunSpec from a declarative spec record."""
    kw = {}
    for k, v in rec.items():
        if isinstance(v, dict) and "__instance__" in v:
            raise ValueError(
                f"spec field {k!r} was a constructed {v['__instance__']} "
                "instance; the record is audit-only and cannot rebuild it")
        kw[k] = v
    return RunSpec(**kw)


def _normalize(obj: Any) -> Any:
    """Canonical JSON form (tuples -> lists, key order fixed) for matching."""
    return json.loads(json.dumps(obj, sort_keys=True))


def _canon(obj: Any) -> Any:
    """Numeric canonicalization for identity keys: ints become floats so
    eps=1 (CLI int parse) and eps=1.0 (Python API) produce the SAME key —
    string-level json comparison would otherwise defeat the upsert dedup."""
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, int):
        return float(obj)
    if isinstance(obj, list):
        return [_canon(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _canon(v) for k, v in obj.items()}
    return obj


def record_key(rec: dict) -> str:
    """Identity of a record: coords + seed + engine + resolved spec."""
    return json.dumps(_canon({
        "coords": _normalize(rec.get("coords") or {}),
        "seed": rec.get("seed"),
        "engine": rec.get("engine"),
        "spec": _normalize(rec.get("spec") or {}),
    }), sort_keys=True)


@functools.lru_cache(maxsize=8)
def git_sha(root: str | None = None) -> str | None:
    """HEAD SHA for record provenance; cached — a P-point x S-seed sweep
    stamps P*S records with the same constant, not P*S subprocess forks."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root or os.getcwd(),
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def result_from_record(rec: dict) -> RunResult:
    """The stored RunResult (exact round-trip) of one store record (an
    encoded engine state comes back on the run's device)."""
    return RunResult.from_record(rec["result"])


def record_metric(rec: dict, name: str) -> Any:
    """Scalar metric from a record: result top-level, then metrics dict."""
    result = rec.get("result") or {}
    if name in result and isinstance(result[name], (int, float, type(None))):
        return result[name]
    return (result.get("metrics") or {}).get(name)


def aggregate_records(records: Iterable[dict], by: tuple[str, ...],
                      value: str | Callable[[dict], Any]) -> list[dict]:
    """Group records by coord fields and reduce ``value`` to mean/std/n.

    ``value`` is a metric name (see `record_metric`) or a callable taking
    the whole record. std is the population std over seeds (ddof=0).
    """
    get = value if callable(value) else (lambda r: record_metric(r, value))
    groups: dict[str, tuple[dict, list]] = {}
    for rec in records:
        coords = rec.get("coords") or {}
        key = json.dumps({k: coords.get(k) for k in by}, sort_keys=True,
                         default=str)
        groups.setdefault(key, ({k: coords.get(k) for k in by}, []))
        groups[key][1].append(get(rec))
    rows = []
    for coords, values in groups.values():
        clean = [v for v in values if v is not None]
        rows.append({
            **coords,
            "mean": float(np.mean(clean)) if clean else None,
            "std": float(np.std(clean)) if clean else None,
            "n": len(values),
            "values": values,
        })
    return rows


class SweepStore:
    """JSONL store under one root directory; one file per sweep name."""

    def __init__(self, root: str = DEFAULT_STORE):
        self.root = root

    def path(self, name: str) -> str:
        safe = name.replace(os.sep, "_")
        return os.path.join(self.root, f"{safe}.jsonl")

    def names(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(f[:-6] for f in os.listdir(self.root)
                      if f.endswith(".jsonl"))

    def load(self, name: str) -> list[dict]:
        """All records, deduped by identity — the LAST write wins.

        The file is an append-first log: the sweep engine appends refreshed
        records immediately (durability) and compacts with `upsert` at the
        end of the sweep. Deduping on read means a crash between those two
        steps never surfaces duplicate (or stale) identities to readers.
        """
        path = self.path(name)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = [line for line in f if line.strip()]
        rows = []
        for i, line in enumerate(lines):
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break   # torn trailing line from a crashed append — the
                    #         record is lost but the store stays readable
                raise       # a torn MIDDLE line is real corruption: surface it
        by_key = {record_key(r): r for r in rows}   # later rows replace earlier
        return list(by_key.values())

    def keys(self, name: str) -> set:
        """Identity keys of every stored record (see `record_key`)."""
        return {record_key(r) for r in self.load(name)}

    def append(self, name: str, records: Iterable[dict]) -> None:
        """O(1) append. Safe even for colliding identities — `load` keeps
        the last write per identity — but the file grows until a compacting
        `upsert`; the sweep engine appends every record immediately and
        compacts once per sweep."""
        os.makedirs(self.root, exist_ok=True)
        path = self.path(name)
        self._heal_torn_tail(path)
        with open(path, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")

    @staticmethod
    def _heal_torn_tail(path: str) -> None:
        """Drop a partial trailing line left by a crashed append.

        Without this, the next append would fuse onto the torn fragment and
        turn it into an invalid MID-file line — which `load` rightly treats
        as corruption. A line write can only tear into a prefix, so 'last
        byte is newline' iff the last line is whole; the O(file) repair
        rewrite runs only in the rare post-crash case.
        """
        try:
            if os.path.getsize(path) == 0:
                return
        except OSError:
            return
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            data = f.read()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data[:data.rfind(b"\n") + 1])
        os.replace(tmp, path)

    def compact(self, name: str) -> None:
        """Rewrite the log without superseded duplicate identities."""
        self.upsert(name, [])

    def upsert(self, name: str, records: Iterable[dict]) -> None:
        """Append records, REPLACING stored rows with the same identity."""
        records = list(records)
        fresh = {record_key(r) for r in records}
        kept = [r for r in self.load(name) if record_key(r) not in fresh]
        os.makedirs(self.root, exist_ok=True)
        path = self.path(name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for rec in kept + records:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, path)

    def lookup(self, name: str, *, coords: dict, seed: int, engine: str,
               spec: dict | None = None,
               records: list[dict] | None = None) -> dict | None:
        """The stored record for one (point, seed), or None.

        When ``spec`` is given the record's resolved spec must match too —
        a changed base spec never silently reuses stale results. Records
        whose spec carries instance markers are never matched.

        Matching canonicalizes ints to floats exactly like `record_key`,
        so a record written from CLI-parsed values (eps=1) serves a reuse
        lookup with Python-API values (eps=1.0) — one identity for writes
        AND reads.
        """
        want_coords = _canon(_normalize(coords))
        want_spec = None if spec is None else _canon(_normalize(spec))
        for rec in (self.load(name) if records is None else records):
            if rec.get("seed") != seed or rec.get("engine") != engine:
                continue
            if _canon(_normalize(rec.get("coords") or {})) != want_coords:
                continue
            rspec = _normalize(rec.get("spec") or {})
            if any(isinstance(v, dict) and "__instance__" in v
                   for v in rspec.values()):
                continue
            if want_spec is not None and _canon(rspec) != want_spec:
                continue
            return rec
        return None

    def query(self, name: str, **filters: Any) -> list[dict]:
        """Records whose coords (or seed/engine) match every filter
        (int/float canonicalized like `lookup`)."""
        out = []
        for rec in self.load(name):
            coords = rec.get("coords") or {}
            view = {**coords, "seed": rec.get("seed"),
                    "engine": rec.get("engine")}
            if all(_canon(_normalize(view.get(k))) == _canon(_normalize(v))
                   for k, v in filters.items()):
                out.append(rec)
        return out

    def make_record(self, name: str, *, coords: dict, seed: int, engine: str,
                    spec: RunSpec, result: RunResult,
                    include_state: bool = False) -> dict:
        return {
            "sweep": name,
            "coords": dict(coords),
            "seed": seed,
            "engine": engine,
            "spec": spec_record(spec),
            "result": result.to_record(include_state=include_state),
            "wall_clock": result.wall_clock,
            "git_sha": git_sha(),
            "written_at": time.time(),
        }
