"""Host-side span tracer: nested, thread-safe, Chrome-trace exportable.

Counterpart of `repro.obs.trace`, grown a second sink.

Every phase of a run — compile, chunk execution, a round and its parts, a
kernel wrapper, the parts of an LM step, checkpoint write, snapshot
publication — is wrapped in a :class:`Span` so "where did the wall-clock
go?" has an answer that survives the run. Spans nest through a thread-local
stack (a chunk span inside a run span keeps its parent's name and id),
carry arbitrary JSON-able attributes, and export to the Chrome/Perfetto
``trace.json`` format (``chrome://tracing``, https://ui.perfetto.dev).

A span is live while its tracer is enabled, while a ``torch.profiler``
session is recording, or both; it goes to each sink that is on:

  * an enabled tracer keeps it in memory (`summary`, `export_chrome`);
  * a recording profiler gets it as a host range named ``PREFIX + name``
    (``"repro_torch:round.noise"``), opened like an op's: it stands among
    the profiler's host events on the profiler's own clock, so every kernel
    launched inside it can be linked to it through its launch, it adds no
    event to the device's timeline, and the prefix tells the program's
    spans from torch's ops and annotations. With the tracer off nothing is
    kept in memory.

Durations come from ``time.perf_counter_ns``. Each tracer pins one
``(time.time_ns(), time.perf_counter_ns())`` anchor when it is made, and
the Chrome export writes ``ts`` as that anchor plus the offset, in epoch
microseconds, which is the profiler's clock: a tracer's ``trace.json`` and a
``torch.profiler`` trace of the same run open together in Perfetto.

A span is a pure host-side observer: it never synchronises the device nor
touches device values, so a traced run is bit-identical to an untraced one
(the tests and ``chip_smoke.py`` hold telemetry to that). A dead span is
the shared no-op `NULL_SPAN`.

>>> tracer = Tracer()
>>> with tracer.span("run", engine="sim"):
...     for i in range(3):
...         with tracer.span("chunk", index=i):
...             pass
>>> [s.name for s in tracer.spans]
['chunk', 'chunk', 'chunk', 'run']
>>> tracer.spans[0].parent, tracer.spans[-1].parent
('run', None)
>>> tracer.spans[0].parent_id == tracer.spans[-1].id
True
>>> sorted(tracer.summary()["chunk"])
['count', 'max_s', 'mean_s', 'total_s']
>>> tracer.summary()["chunk"]["count"]
3
>>> off = Tracer(enabled=False)
>>> with off.span("never"):
...     pass
>>> off.spans
[]
"""
from __future__ import annotations

import itertools
import json
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Span", "Tracer", "NULL_SPAN", "PREFIX"]

PREFIX = "repro_torch:"

_ids = itertools.count(1)
# a host range of the profiler's function scope: no dispatcher op around it
# (as record_function has), and no device-side copy (as a user annotation
# has), so a span adds no event to the device's timeline
_Range = torch._C._profiler._RecordFunctionFast


class Span:
    """One timed region. ``t0``/``t1`` are ``perf_counter_ns`` stamps;
    ``id`` is unique in the process, ``parent_id`` the id of the span open
    around it on its thread (None at the top), ``parent`` that span's name;
    ``args`` are the JSON-able attributes given at creation."""

    __slots__ = ("name", "id", "t0", "t1", "parent", "parent_id", "depth",
                 "thread", "args")

    def __init__(self, name: str, *, parent: str | None = None,
                 depth: int = 0, thread: int = 0, args: dict | None = None):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.parent_id = None
        self.depth = depth
        self.thread = thread
        self.args = args or {}
        self.t0 = 0
        self.t1 = 0

    @property
    def duration_s(self) -> float:
        return max(self.t1 - self.t0, 0) * 1e-9

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"depth={self.depth})")


class _NullSpan:
    """Shared no-op context manager for a dead span."""

    __slots__ = ()
    name = None
    duration_s = 0.0
    args: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """A live span: into ``tracer`` (None: the profiler only) and, while
    the profiler records, a prefixed host range."""

    __slots__ = ("_tracer", "_span", "_range")

    def __init__(self, tracer: "Tracer | None", span: Span):
        self._tracer = tracer
        self._span = span
        self._range = None

    def __enter__(self) -> Span:
        span = self._span
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(PREFIX + span.name)
            self._range.__enter__()
        tracer = self._tracer
        if tracer is not None:
            stack = tracer._stack()
            if stack:
                span.parent, span.parent_id = stack[-1].name, stack[-1].id
            span.depth = len(stack)
            stack.append(span)
        span.t0 = time.perf_counter_ns()
        return span

    def __exit__(self, *exc) -> bool:
        span = self._span
        span.t1 = time.perf_counter_ns()
        if self._tracer is not None:
            self._tracer._stack().pop()
            self._tracer._record(span)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Tracer:
    """Collects spans; thread-safe; exports Chrome ``trace.json``.

    Spans are recorded on EXIT (so the list is completion-ordered); nesting
    is tracked per thread, which is what the serving layer needs — trainer,
    batcher and client threads each keep their own span stack but land in
    one trace with their thread names attached.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 1_000_000):
        self.enabled = enabled
        self.max_spans = max_spans
        self.dropped = 0
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # the profiler stamps epoch nanoseconds: one pair of readings maps
        # perf_counter_ns onto that clock
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        span.thread = threading.get_ident()
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return
            self.spans.append(span)

    def span(self, name: str, **args):
        """Context manager timing one region; yields the live :class:`Span`
        (the shared no-op when the tracer is disabled and no profiler is
        recording; a profiler-only span when only the profiler is)."""
        if self.enabled:
            return _SpanCtx(self, Span(name, args=args))
        if _autograd_profiler._is_profiler_enabled:
            return _SpanCtx(None, Span(name, args=args))
        return NULL_SPAN

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.dropped = 0

    def summary(self) -> dict:
        """Per-name aggregate: {name: {count, total_s, mean_s, max_s}}."""
        with self._lock:
            spans = list(self.spans)
        out: dict[str, dict] = {}
        for s in spans:
            agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.duration_s
            agg["max_s"] = max(agg["max_s"], s.duration_s)
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
            agg["total_s"] = round(agg["total_s"], 6)
            agg["mean_s"] = round(agg["mean_s"], 6)
            agg["max_s"] = round(agg["max_s"], 6)
        return out

    def epoch_us(self, t_ns: int) -> float:
        """A ``perf_counter_ns`` stamp in epoch microseconds (the
        profiler's clock)."""
        return (self.anchor[0] + (t_ns - self.anchor[1])) / 1e3

    def chrome_events(self) -> list[dict]:
        """The spans as Chrome trace ``X`` (complete) events plus thread
        metadata; timestamps in epoch microseconds, durations in
        microseconds."""
        with self._lock:
            spans = list(self.spans)
        tids: dict[int, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.thread, len(tids))
            events.append({
                "ph": "X", "name": s.name, "pid": 0, "tid": tid,
                "ts": round(self.epoch_us(s.t0), 3),
                "dur": round(s.duration_s * 1e6, 3),
                "args": dict(s.args, parent=s.parent, id=s.id,
                             parent_id=s.parent_id),
            })
        meta = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                 "args": {"name": f"thread-{tid}"}}
                for tid in sorted(tids.values())]
        return meta + events

    def export_chrome(self, path: str) -> str:
        """Write ``trace.json`` (open in chrome://tracing or Perfetto)."""
        payload = {"displayTimeUnit": "ms",
                   "traceEvents": self.chrome_events()}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path
