"""Host-side span tracer: nested, thread-safe, Chrome-trace exportable.

Counterpart of `repro.obs.trace`, copied nearly whole.

Every phase of a run — compile, chunk execution, checkpoint write, snapshot
publication — is wrapped in a :class:`Span` so "where did the wall-clock
go?" has an answer that survives the run. Spans nest through a thread-local
stack (a chunk span inside a run span keeps its parent), carry arbitrary
JSON-able attributes, and export to the Chrome/Perfetto ``trace.json``
format (``chrome://tracing``, https://ui.perfetto.dev).

The tracer is a pure host-side observer: it never touches device values,
so a traced run is bit-identical to an untraced one (the tests and
``chip_smoke.py`` hold telemetry to that). A disabled tracer hands
out a shared no-op span — the hot loop pays one attribute check.

>>> tracer = Tracer()
>>> with tracer.span("run", engine="sim"):
...     for i in range(3):
...         with tracer.span("chunk", index=i):
...             pass
>>> [s.name for s in tracer.spans]
['chunk', 'chunk', 'chunk', 'run']
>>> tracer.spans[0].parent, tracer.spans[-1].parent
('run', None)
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

import json
import threading
import time

__all__ = ["Span", "Tracer", "NULL_SPAN"]


class Span:
    """One timed region. ``t0``/``t1`` are ``perf_counter`` stamps; ``args``
    are the JSON-able attributes given at creation."""

    __slots__ = ("name", "t0", "t1", "parent", "depth", "thread", "args")

    def __init__(self, name: str, *, parent: str | None = None,
                 depth: int = 0, thread: int = 0, args: dict | None = None):
        self.name = name
        self.parent = parent
        self.depth = depth
        self.thread = thread
        self.args = args or {}
        self.t0 = 0.0
        self.t1 = 0.0

    @property
    def duration_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"depth={self.depth})")


class _NullSpan:
    """Shared no-op context manager for a disabled tracer."""

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
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        stack = self._tracer._stack()
        span = self._span
        span.parent = stack[-1].name if stack else None
        span.depth = len(stack)
        stack.append(span)
        span.t0 = time.perf_counter()
        return span

    def __exit__(self, *exc) -> bool:
        span = self._span
        span.t1 = time.perf_counter()
        self._tracer._stack().pop()
        self._tracer._record(span)
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
        # perf_counter has an arbitrary origin; pin one per tracer so the
        # chrome timeline starts near 0
        self._origin = time.perf_counter()

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
        (a shared no-op when the tracer is disabled)."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanCtx(self, Span(name, args=args))

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

    def chrome_events(self) -> list[dict]:
        """The spans as Chrome trace ``X`` (complete) events plus thread
        metadata; timestamps/durations in microseconds from tracer start."""
        with self._lock:
            spans = list(self.spans)
        tids: dict[int, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.thread, len(tids))
            events.append({
                "ph": "X", "name": s.name, "pid": 0, "tid": tid,
                "ts": round((s.t0 - self._origin) * 1e6, 3),
                "dur": round(s.duration_s * 1e6, 3),
                "args": dict(s.args, parent=s.parent),
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
