"""Scalar metric logging: CSV files + in-memory moving windows.

Counterpart of `repro.metrics.logging`, copied nearly whole (the ambient
registry is `repro_torch.obs`'s).

`CSVLogger` is resume-safe: logging into an existing file APPENDS under the
file's own header instead of clobbering it, and a row carrying keys outside
the header raises instead of silently dropping them — a schema change
between passes is a bug to surface, not data to lose. Each logged row is
also mirrored into the ambient `repro_torch.obs` metrics registry
(``log.<field>`` gauges), so the CSV file and the telemetry snapshot can
never disagree.

>>> import os, tempfile
>>> path = os.path.join(tempfile.mkdtemp(), "m.csv")
>>> lg = CSVLogger(path)
>>> lg.log(0, {"loss": 1.0}); lg.close()
>>> lg2 = CSVLogger(path)                      # "resume": same file
>>> lg2.log(1, {"loss": 0.5}); lg2.close()
>>> print(open(path).read().strip())
step,loss
0,1.0
1,0.5
>>> lg3 = CSVLogger(path)
>>> lg3.log(2, {"loss": 0.2, "extra": 9.0})
Traceback (most recent call last):
    ...
ValueError: CSVLogger: row keys ['extra'] are not in the header ['step', 'loss'] of ...m.csv
>>> tr = MetricTracker(window=2)
>>> tr.means()                                 # empty window: no keys
{}
>>> for v in (1.0, 2.0, 3.0):
...     tr.update({"loss": v})
>>> tr.means()                                 # only the last `window` values
{'loss': 2.5}
"""
from __future__ import annotations

import collections
import os
from typing import Mapping

import numpy as np

from repro_torch import obs as obslib

__all__ = ["CSVLogger", "MetricTracker"]


class CSVLogger:
    """One row a step: ``step`` then the metric columns (sorted names, or
    ``fieldnames``), each value as ``str(float(v))``."""

    def __init__(self, path: str, fieldnames: list[str] | None = None):
        self.path = path
        self.fieldnames = fieldnames
        self._fh = None

    def _open(self, metrics: Mapping[str, float]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        header = None
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            with open(self.path) as f:
                header = f.readline().strip()
        if header:
            # resume: the file's own header is the schema — appending under
            # a different one would silently misalign every later column
            existing = header.split(",")
            if self.fieldnames is not None and self.fieldnames != existing:
                raise ValueError(
                    f"CSVLogger: requested fieldnames {self.fieldnames} do "
                    f"not match the existing header {existing} of {self.path}")
            self.fieldnames = existing
            self._fh = open(self.path, "a")
        else:
            self.fieldnames = self.fieldnames or ["step", *sorted(metrics)]
            self._fh = open(self.path, "a")
            self._fh.write(",".join(self.fieldnames) + "\n")

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        if self._fh is None:
            self._open(metrics)
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        extra = sorted(set(row) - set(self.fieldnames))
        if extra:
            raise ValueError(
                f"CSVLogger: row keys {extra} are not in the header "
                f"{self.fieldnames} of {self.path}")
        self._fh.write(",".join(str(row.get(f, ""))
                                for f in self.fieldnames) + "\n")
        self._fh.flush()
        tel = obslib.active()
        if tel.enabled:
            for k, v in metrics.items():
                tel.metrics.gauge(f"log.{k}").set(float(v))

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class MetricTracker:
    """Windowed means for console reporting."""

    def __init__(self, window: int = 50):
        self.window = window
        self.data: dict[str, collections.deque] = {}

    def update(self, metrics: Mapping[str, float]) -> None:
        for k, v in metrics.items():
            self.data.setdefault(k, collections.deque(
                maxlen=self.window)).append(float(v))

    def means(self) -> dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self.data.items() if v}
