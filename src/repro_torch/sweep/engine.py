"""The sweep engine: SweepSpec -> batched runs -> store -> SweepResult.

Counterpart of `repro.sweep.engine`. For every grid point the engine runs
all seeds at once through the runner's seed batch (`repro_torch.api.run_batch`
— on ``backend="cuda"`` one launch of each round kernel a round serves
every seed) and falls back to sequential per-seed `run()` calls when the
point's resolved stages depend on the seed (seeded 'random' /
'time_varying' topologies, per-edge `delay_dist` draws) — outer axes that
change shapes (nodes / dim / mixer) are separate programs by construction,
which is why only the innermost seed axis is batched. Every run happens on
``device`` (CUDA unless the caller asks for the CPU).

Results persist through `repro_torch.sweep.store.SweepStore` (one JSONL
record per point x seed); ``reuse=True`` loads any already-stored record
with a matching resolved spec instead of re-running, so a figure
regenerates from the store for free. Under enabled ambient telemetry
(`repro_torch.obs`) each point is a ``sweep.point`` span and a
``sweep_point`` event, counted in ``sweep.points_ran`` or
``sweep.points_loaded``.

>>> import tempfile
>>> from repro_torch.api import RunSpec
>>> from repro_torch.sweep import SweepSpec, sweep
>>> base = RunSpec(nodes=2, dim=8, horizon=6, eps=1.0, alpha0=0.5, lam=0.01,
...                stream="drift", stream_options={"period": 3})
>>> sw = SweepSpec(base=base, axes={"eps": (0.5, 1.0)}, seeds=(0, 1),
...                name="doc_demo", chunk_rounds=6, compute_regret=False)
>>> out = sweep(sw, store=tempfile.mkdtemp(), warmup=False, device="cpu")
>>> len(out.points), [len(rs) for rs in out.results], out.ran_points
(2, [2, 2], 2)
>>> rows = out.aggregate("accuracy")
>>> [r["eps"] for r in rows], rows[0]["n"]
([0.5, 1.0], 2)
>>> again = sweep(sw, store=out.store.root, reuse=True, warmup=False,
...               device="cpu")
>>> again.ran_points, again.loaded_points     # regenerated, nothing re-run
(0, 2)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import obs as obslib
from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.runner import (RunResult, run, run_batch,
                                    seed_vectorizable)
from repro_torch.sweep.spec import SweepPoint, SweepSpec
from repro_torch.sweep.store import (DEFAULT_STORE, SweepStore, record_key,
                                     spec_record)

__all__ = ["sweep", "SweepResult", "SweepStoreMiss"]


class SweepStoreMiss(RuntimeError):
    """Raised by ``sweep(reuse=True, require_store=True)`` when the store has
    no matching record for one or more (point, seed) identities — instead of
    silently re-running (or worse, emitting a figure from nothing)."""


def _metric(res: RunResult, value: str | Callable) -> Any:
    if callable(value):
        return value(res)
    if value == "regret_final":
        return None if res.regret is None else float(res.regret[-1])
    v = getattr(res, value, None)
    if isinstance(v, (int, float)):
        return float(v)
    return res.metrics.get(value)


@dataclasses.dataclass
class SweepResult:
    """Everything a finished sweep knows: the grid, the per-point per-seed
    RunResults, the records as persisted, and where they went."""

    spec: SweepSpec
    points: list[SweepPoint]
    results: list[list[RunResult]]       # [point][seed]
    records: list[dict]                  # flat, as written/loaded
    store: SweepStore | None
    wall_clock: float
    ran_points: int                      # points actually executed
    loaded_points: int                   # points served from the store

    def aggregate(self, value: str | Callable[[RunResult], Any] = "accuracy",
                  ) -> list[dict]:
        """Per-point mean/std over seeds of one scalar metric.

        ``value`` is a RunResult attribute / metrics key (e.g. 'accuracy',
        'regret_final', 'wall_clock') or a callable RunResult -> float.
        Rows are ``{**coords, mean, std, n, values}`` in grid order.
        """
        import numpy as np
        rows = []
        for point, results in zip(self.points, self.results):
            values = [_metric(r, value) for r in results]
            clean = [v for v in values if v is not None]
            rows.append({
                **point.coords,
                "mean": float(np.mean(clean)) if clean else None,
                "std": float(np.std(clean)) if clean else None,
                "n": len(values),
                "values": values,
            })
        return rows

    def point_records(self, index: int) -> list[dict]:
        coords = self.points[index].coords
        return [r for r in self.records if r.get("coords") == coords]

    def summary(self) -> dict:
        return {
            "name": self.spec.store_name,
            "engine": self.spec.engine,
            "points": len(self.points),
            "seeds": list(self.spec.seeds),
            "ran_points": self.ran_points,
            "loaded_points": self.loaded_points,
            "wall_clock_s": round(self.wall_clock, 3),
            "store": None if self.store is None else self.store.path(
                self.spec.store_name),
        }


def _run_point(point: SweepPoint, spec: SweepSpec, *, warmup: bool,
               device) -> list[RunResult]:
    seeds = list(spec.seeds)
    vec = spec.vectorize_seeds
    if vec is None:
        vec = len(seeds) > 1 and seed_vectorizable(point.spec, seeds)
    cfg = ExecConfig(chunk_rounds=spec.chunk_rounds,
                     compute_regret=spec.compute_regret, warmup=warmup)
    if vec:
        # spec.vectorize_seeds=None means WE just verified vectorizability;
        # an explicit True still lets run_batch's own check raise. A
        # seed-dependent stage falls back to sequential runs below,
        # whatever spec.devices asks for
        return run_batch(point.spec, seeds, engine=spec.engine,
                         exec=cfg.replace(
                             check_vectorizable=spec.vectorize_seeds
                             is not None, devices=spec.devices),
                         device=device)
    return [run(point.spec.replace(seed=s), engine=spec.engine, exec=cfg,
                device=device)
            for s in seeds]


def sweep(spec: SweepSpec, *, store: str | SweepStore | None = DEFAULT_STORE,
          reuse: bool = False, warmup: bool = True,
          include_state: bool = False, verbose: bool = False,
          require_store: bool = False,
          device: str | torch.device = "cuda") -> SweepResult:
    """Run (or reload) every grid point x seed; persist; return SweepResult.

    store:   store root (or SweepStore, or None to skip persistence).
    reuse:   serve a point from the store when ALL its seeds have records
             whose resolved spec matches exactly — the regenerate-figures-
             without-re-running path.
    warmup:  run one throwaway round of each point outside its timed
             region (library load, allocator).
    include_state: persist the raw engine state inside each record.
    require_store: with ``reuse``, raise `SweepStoreMiss` (naming the
             missing points) instead of re-running anything when the store
             cannot serve every point — the contract behind --from-store.
    device:  where the runs happen: CUDA unless the caller passes "cpu".
    """
    if require_store and not reuse:
        raise ValueError(
            "require_store=True is only meaningful with reuse=True — "
            "without reuse every point re-runs, the exact thing "
            "require_store promises to prevent")
    store_obj = (store if isinstance(store, SweepStore)
                 else SweepStore(store) if store is not None else None)
    name = spec.store_name
    existing = store_obj.load(name) if store_obj else []
    # every finished point APPENDS immediately (O(1), durable under a
    # mid-sweep crash); identity collisions are resolved on read (load keeps
    # the last write) and compacted away once at the end of the sweep —
    # a P-point sweep stays O(P) I/O, not O(P^2)
    existing_keys = {record_key(r) for r in existing}

    def _cached(point: SweepPoint) -> list[dict] | None:
        """The point's stored records (one per seed), or None on any miss."""
        if store_obj is None:
            return None
        found = [store_obj.lookup(
                     name, coords=point.coords, seed=s, engine=spec.engine,
                     spec=spec_record(point.spec.replace(seed=s)),
                     records=existing)
                 for s in spec.seeds]
        # a record stored by a compute_regret=False sweep has no regret
        # trajectory — it cannot serve a sweep that asks for one
        if spec.compute_regret:
            found = [r if r is not None
                     and r["result"].get("regret") is not None else None
                     for r in found]
        return found if all(r is not None for r in found) else None

    points = spec.points()
    cached_points = [_cached(p) if reuse else None for p in points]
    if reuse and require_store:
        missing = [p.label() for p, c in zip(points, cached_points)
                   if c is None]
        if missing:
            where = (store_obj.path(name) if store_obj is not None
                     else "no store configured")
            shown = ", ".join(missing[:5]) + ("..." if len(missing) > 5
                                              else "")
            raise SweepStoreMiss(
                f"sweep {name!r}: the store ({where}) has no record "
                f"matching the resolved spec for {len(missing)}/"
                f"{len(points)} point(s) [{shown}] x seeds "
                f"{tuple(spec.seeds)}; run once without --from-store to "
                f"populate it (records also go stale when the base spec "
                f"changes)")

    # ambient telemetry (repro_torch.obs): a no-op unless the caller enabled
    # it — each point gets a sweep.point span and a sweep_point event, and
    # the runs inside _run_point pick up the same ambient Telemetry
    tel = obslib.active()

    results: list[list[RunResult]] = []
    records: list[dict] = []
    needs_compaction = False
    ran = loaded = 0
    t0 = time.time()
    for point, cached in zip(points, cached_points):
        if cached is not None:
            loaded += 1
            with tel.span("sweep.point", sweep=name, label=point.label(),
                          source="loaded"):
                point_results = [RunResult.from_record(r["result"])
                                 for r in cached]
            point_records = cached
        else:
            ran += 1
            with tel.span("sweep.point", sweep=name, label=point.label(),
                          source="ran"):
                point_results = _run_point(point, spec, warmup=warmup,
                                           device=device)
            point_records = [
                store_obj.make_record(
                    name, coords=point.coords, seed=s, engine=spec.engine,
                    spec=point.spec.replace(seed=s), result=res,
                    include_state=include_state)
                if store_obj is not None else
                {"sweep": name, "coords": dict(point.coords), "seed": s,
                 "engine": spec.engine,
                 "result": res.to_record(include_state=include_state)}
                for s, res in zip(spec.seeds, point_results)]
            if store_obj is not None:
                store_obj.append(name, point_records)
                fresh_keys = [record_key(r) for r in point_records]
                if any(k in existing_keys for k in fresh_keys):
                    needs_compaction = True
                existing_keys.update(fresh_keys)
        if tel.enabled:
            source = "loaded" if cached is not None else "ran"
            tel.metrics.counter(f"sweep.points_{source}").inc()
            tel.emit("sweep_point", sweep=name, label=point.label(),
                     seeds=list(spec.seeds), source=source)
        if verbose:
            accs = [r.accuracy for r in point_results]
            print(f"[sweep {name}] {point.label()}: "
                  f"{'loaded' if cached is not None else 'ran'} "
                  f"{len(point_results)} seeds, acc={accs}")
        results.append(point_results)
        records.extend(point_records)
    if store_obj is not None and needs_compaction:
        store_obj.compact(name)
    return SweepResult(spec=spec, points=points, results=results,
                       records=records, store=store_obj,
                       wall_clock=time.time() - t0,
                       ran_points=ran, loaded_points=loaded)
