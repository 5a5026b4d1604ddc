"""SweepSpec — a declarative grid of RunSpecs plus a batched seed axis.

Counterpart of `repro.sweep.spec`. A sweep names axes over
`repro_torch.api.RunSpec` fields; the engine (`repro_torch.sweep.engine.sweep`)
resolves the cartesian product into concrete points via `RunSpec.replace`,
runs every point under all seeds (the seed axis goes through
`repro_torch.api.run_batch` — one launch of each round kernel a round for
all seeds), and persists one JSONL record per (point, seed) into the
results store.

Axis keys are RunSpec field names. A comma-joined key zips several fields
into ONE axis (its values are tuples), for quantities that must co-vary —
e.g. Fig. 5's node count with its same-total-samples horizon:

>>> from repro_torch.api import RunSpec
>>> from repro_torch.sweep import SweepSpec
>>> base = RunSpec(nodes=4, dim=16, horizon=32, eps=1.0, lam=0.01)
>>> sw = SweepSpec(base=base, axes={"eps": (0.1, 1.0)}, seeds=(0, 1, 2))
>>> [p.coords for p in sw.points()]
[{'eps': 0.1}, {'eps': 1.0}]
>>> sw.points()[0].spec.eps, len(sw.seeds)
(0.1, 3)
>>> zipped = SweepSpec(base=base,
...                    axes={"nodes,horizon": ((4, 32), (8, 16)),
...                          "eps": (0.1, 1.0)})
>>> [p.coords for p in zipped.points()]   # doctest: +NORMALIZE_WHITESPACE
[{'nodes': 4, 'horizon': 32, 'eps': 0.1},
 {'nodes': 4, 'horizon': 32, 'eps': 1.0},
 {'nodes': 8, 'horizon': 16, 'eps': 0.1},
 {'nodes': 8, 'horizon': 16, 'eps': 1.0}]
>>> zipped.points()[2].spec.nodes
8
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping, Sequence

from repro_torch.api.spec import RunSpec

__all__ = ["SweepSpec", "SweepPoint"]

_RUNSPEC_FIELDS = {f.name for f in dataclasses.fields(RunSpec)}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One resolved grid point: its axis coordinates and the concrete spec
    (base spec with the coordinates applied; the seed axis is NOT applied —
    the engine fans the point out over ``SweepSpec.seeds``)."""

    coords: dict[str, Any]
    spec: RunSpec

    def label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.coords.items()) or "base"


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative experiment grid over RunSpec fields.

    base:    the RunSpec every point starts from (`RunSpec.replace`).
    axes:    ordered mapping axis-key -> sequence of values. A key that is
             a RunSpec field name sweeps that field; a comma-joined key
             ("nodes,horizon") zips several fields as one axis, each value a
             tuple with one entry per field. The grid is the cartesian
             product of the axes, last axis fastest.
    seeds:   the innermost, BATCHED axis — every point runs under all
             seeds in one `run_batch` when the point's resolved stages
             allow it (see `repro_torch.api.runner.seed_vectorizable`).
    engine:  'sim' | 'dist' — which engine drives every point.
    name:    store group (the JSONL file stem under experiments/store/).
    chunk_rounds / compute_regret: forwarded to the runner per point.
    vectorize_seeds: True forces the batched path (error when
             impossible), False forces sequential per-seed run() calls,
             None (default) picks automatically per point.
    devices: shard the batched seed axis over this many devices
             (`repro_torch.api.run_batch(exec=ExecConfig(devices=))` — a
             ("seed",) mesh); None / 1 keeps the one-device batch,
             "auto" uses every visible device.
    """

    base: RunSpec
    axes: Mapping[str, Sequence] = dataclasses.field(default_factory=dict)
    seeds: Sequence[int] = (0,)
    engine: str = "sim"
    name: str | None = None
    chunk_rounds: int = 512
    compute_regret: bool = True
    vectorize_seeds: bool | None = None
    devices: int | str | None = None

    def __post_init__(self):
        if not self.seeds:
            raise ValueError("SweepSpec needs at least one seed")
        if self.devices is not None and self.devices != "auto":
            if not isinstance(self.devices, int) or self.devices < 1:
                raise ValueError(
                    f"devices must be None, 'auto' or a positive int, got "
                    f"{self.devices!r}")
        if len(set(self.seeds)) != len(tuple(self.seeds)):
            raise ValueError(f"duplicate seeds: {tuple(self.seeds)}")
        if self.engine not in ("sim", "dist"):
            raise ValueError(f"unknown engine {self.engine!r}")
        for key, values in self.axes.items():
            fields = self._axis_fields(key)
            unknown = [f for f in fields if f not in _RUNSPEC_FIELDS]
            if unknown:
                raise ValueError(
                    f"axis {key!r} names unknown RunSpec field(s) {unknown}; "
                    f"valid fields: {sorted(_RUNSPEC_FIELDS)}")
            if "seed" in fields:
                raise ValueError(
                    "'seed' is not a sweepable axis — use SweepSpec.seeds "
                    "(the batched innermost axis)")
            if len(values) == 0:
                raise ValueError(f"axis {key!r} has no values")
            if len(fields) > 1:
                bad = [v for v in values
                       if not isinstance(v, (tuple, list))
                       or len(v) != len(fields)]
                if bad:
                    raise ValueError(
                        f"zipped axis {key!r} needs {len(fields)}-tuples, "
                        f"got {bad[0]!r}")

    @staticmethod
    def _axis_fields(key: str) -> list[str]:
        return [f.strip() for f in key.split(",")]

    @property
    def store_name(self) -> str:
        if self.name:
            return self.name
        stem = "-".join(k.replace(",", "+") for k in self.axes) or "point"
        return f"sweep_{stem}"

    def points(self) -> list[SweepPoint]:
        """The resolved grid, in cartesian-product order (last axis fastest).

        Each point's coords flatten zipped keys into their individual
        fields, so store records are queryable per plain field name.
        """
        keys = list(self.axes.keys())
        pts = []
        for combo in itertools.product(*(self.axes[k] for k in keys)):
            coords: dict[str, Any] = {}
            for key, value in zip(keys, combo):
                fields = self._axis_fields(key)
                if len(fields) == 1:
                    coords[fields[0]] = value
                else:
                    coords.update(dict(zip(fields, value)))
            pts.append(SweepPoint(coords=coords,
                                  spec=self.base.replace(**coords)))
        return pts

    def replace(self, **kw: Any) -> "SweepSpec":
        return dataclasses.replace(self, **kw)
