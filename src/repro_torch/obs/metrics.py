"""Thread-safe metrics registry: counters, gauges, histograms.

Counterpart of `repro.obs.metrics`, copied nearly whole.

One registry per :class:`~repro_torch.obs.Telemetry`; every subsystem publishes
into it under dotted names — ``run.rounds`` / ``run.eps_total`` from the
runner, ``serve.served`` / ``serve.shed.timeout`` from the admission layer,
``faults.mean_connectivity`` from fault-injected runs — so a single
``snapshot()`` answers "what is the fleet doing" without reaching into any
subsystem's internals.

Instruments share the registry's lock (updates are a dict write under one
mutex — cheap enough for per-chunk cadence, and the serving threads hammer
the counters concurrently without losing increments).

>>> reg = MetricsRegistry()
>>> reg.counter("run.rounds").inc(64)
>>> reg.counter("run.rounds").inc(64)      # get-or-create: same instrument
>>> reg.counter("run.rounds").value
128
>>> reg.gauge("run.eps_total").set(1.0)
>>> h = reg.histogram("run.chunk_seconds")
>>> for v in (0.1, 0.2, 0.3):
...     h.observe(v)
>>> h.count, round(h.mean, 3)
(3, 0.2)
>>> snap = reg.snapshot()
>>> snap["run.rounds"], snap["run.eps_total"]
(128, 1.0)
>>> snap["run.chunk_seconds"]["count"]
3
>>> reg.gauge("run.rounds")
Traceback (most recent call last):
    ...
TypeError: metric 'run.rounds' is already a Counter, not a Gauge
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic count (served requests, completed rounds, shed reasons)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (eps burn, queue depth, connectivity)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Sampled distribution (chunk seconds, batch sizes, latencies).

    Keeps running count/sum exactly plus a bounded sample reservoir for the
    percentiles — ``max_samples`` caps memory on long-lived services (the
    first ``max_samples`` observations are retained, like ServeStats).
    """

    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max",
                 "_samples", "max_samples")

    def __init__(self, name: str, lock: threading.Lock,
                 max_samples: int = 65536):
        self.name = name
        self._lock = lock
        self.max_samples = max_samples
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._samples: list[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._samples) < self.max_samples:
                self._samples.append(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float | None:
        with self._lock:
            return self._sum / self._count if self._count else None

    def percentile(self, p: float) -> float | None:
        with self._lock:
            if not self._samples:
                return None
            return float(np.percentile(np.asarray(self._samples), p))

    def summary(self) -> dict:
        with self._lock:
            if not self._count:
                return {"count": 0}
            arr = np.asarray(self._samples) if self._samples else None
            return {
                "count": self._count,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": float(np.percentile(arr, 50)) if arr is not None
                       else None,
                "p99": float(np.percentile(arr, 99)) if arr is not None
                       else None,
            }


class MetricsRegistry:
    """Get-or-create instruments by dotted name; one lock for all of them.

    Asking for an existing name with a different instrument type raises —
    two subsystems silently aliasing one metric is a bug, not a feature.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                # instruments reuse the registry lock: they only take it for
                # dict-free scalar updates, so one mutex keeps ordering simple
                inst = self._instruments[name] = cls(name, self._lock, **kw)
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} is already a "
                            f"{type(inst).__name__}, not a {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 65536) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """{name: value | histogram-summary} for every instrument, JSON-able
        — the payload `obs report` and the run-event stream carry."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in sorted(items):
            out[name] = (inst.summary() if isinstance(inst, Histogram)
                         else inst.value)
        return out
