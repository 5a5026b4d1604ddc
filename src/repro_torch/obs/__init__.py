"""repro_torch.obs — telemetry: spans, metrics, run events, device traces.

Counterpart of `repro.obs`. One :class:`Telemetry` object bundles what the
port publishes into:

  * a span :class:`~repro_torch.obs.trace.Tracer` (run, chunk, round,
    kernel-wrapper, LM-step, checkpoint and publish phases; Chrome
    ``trace.json`` export);
  * a thread-safe :class:`~repro_torch.obs.metrics.MetricsRegistry` (eps
    burn, rounds/sec, serve counters, fault connectivity);
  * an optional JSONL :class:`~repro_torch.obs.events.EventLog` run-event
    stream (rendered by ``python -m repro_torch.launch.obs report``; the
    format is the reference's, so either package's CLI renders the
    other's streams);
  * the optional predicted-vs-measured :mod:`~repro_torch.obs.cost` loop
    (``cost=True``): each run's chunk program is counted once before the
    timed loop (`repro_torch.launch.op_cost`) and its roofline prediction
    recorded beside every chunk's measured time;
  * an opt-in ``torch.profiler`` device trace: with ``profile_dir`` set,
    the runner wraps its chunk loop in :meth:`Telemetry.profile`, which
    writes a Chrome trace of the host ops and the card's kernels there.

Telemetry is OFF by default and ambient: `repro_torch.run`, `run_batch`,
`repro_torch.sweep` and `repro_torch.serve` consult :func:`active` and do
nothing unless a caller installed an enabled instance with :func:`enable`
(or passed ``ExecConfig(obs=...)``). It never touches device math — a run
with it on is bit-identical to one with it off.

Spans have two sinks (`repro_torch.obs.trace`). :func:`span` is the hot
path's entry, used inside the round, the kernel wrappers and the LM step:
a span is live when the ambient telemetry is enabled, when a
``torch.profiler`` session is recording, or both. Enabled telemetry keeps
it in its tracer; a recording profiler gets it as a host range named
``"repro_torch:" + name`` (`trace.PREFIX`) on the profiler's clock, which
the device events launched inside it link to through their launches; with
the profiler alone nothing is kept in memory. Otherwise :func:`span` returns
the shared `NULL_SPAN` after reading two module globals. The tracer's
Chrome export writes epoch microseconds, the profiler's clock, so both
traces of one run open together in Perfetto. :meth:`Telemetry.span` (the
runner's ``run.*`` spans, into the telemetry it was given) reaches the
profiler the same way.

>>> import repro_torch.obs as obs
>>> obs.active().enabled                   # ambient default: off
False
>>> tel = obs.Telemetry()
>>> with tel.span("phase", k=1):
...     tel.metrics.counter("demo.count").inc()
>>> tel.tracer.summary()["phase"]["count"]
1
>>> tel.metrics.snapshot()["demo.count"]
1
>>> prev = obs.enable()                    # install ambient telemetry...
>>> obs.active().enabled
True
>>> obs.disable()                          # ...and restore the default
>>> obs.active().enabled
False
>>> obs.span("round") is obs.NULL_SPAN     # off, and no profiler recording
True
"""
from __future__ import annotations

import contextlib
import os
import uuid

from repro_torch.obs.cost import (ChunkCost, CostModel, analyze_chunk,
                                  calibrate)
from repro_torch.obs.events import (DEFAULT_EVENTS_PATH, EventLog,
                                    group_runs, read_events)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import NULL_SPAN, PREFIX, Span, Tracer  # noqa: F401

import torch.autograd.profiler as _profiler  # noqa: E402

__all__ = [
    "Telemetry", "enable", "disable", "active",
    "Tracer", "Span", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "EventLog", "read_events", "group_runs", "DEFAULT_EVENTS_PATH",
    "CostModel", "ChunkCost", "analyze_chunk", "calibrate",
]


@contextlib.contextmanager
def _profile_session(directory: str):
    """A ``torch.profiler`` session (host ops, and the card's kernels when
    there is one) whose Chrome trace lands in ``directory`` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        directory, f"trace_{os.getpid()}_{uuid.uuid4().hex[:8]}.json"))


class Telemetry:
    """One run-scoped (or process-scoped) telemetry bundle.

    enabled:      master switch — False makes every hook a no-op (the
                  ambient default).
    events:       an :class:`EventLog`, a path for one, or None (no stream).
    cost:         True turns on the predicted-vs-measured chunk-cost loop
                  (one counted round per chunk program, outside the timed
                  region, on copies of the state).
    cost_model:   pin the roofline peaks instead of calibrating.
    profile_dir:  opt-in ``torch.profiler`` capture directory — the runner
                  wraps its chunk loop in :meth:`profile`, which writes a
                  Chrome trace (``trace_*.json``) there.
    """

    def __init__(self, *, enabled: bool = True,
                 events: "EventLog | str | None" = None,
                 cost: bool = False, cost_model: CostModel | None = None,
                 profile_dir: str | None = None,
                 max_spans: int = 1_000_000):
        self.enabled = enabled
        self.tracer = Tracer(enabled=enabled, max_spans=max_spans)
        self.metrics = MetricsRegistry()
        if isinstance(events, str):
            events = EventLog(events)
        self.events = events if enabled else None
        self.cost_enabled = bool(cost) and enabled
        self.cost_model = cost_model
        self.profile_dir = profile_dir if enabled else None

    # -- hooks the instrumented code calls ----------------------------------

    def span(self, name: str, **args):
        """Timed region (no-op when disabled) — see `Tracer.span`."""
        return self.tracer.span(name, **args)

    def emit(self, event: str, **fields) -> None:
        """Append one run event to the JSONL stream (no-op without one)."""
        if self.events is not None:
            self.events.emit(event, **fields)

    def profile(self):
        """Context manager capturing a ``torch.profiler`` trace into
        ``profile_dir`` (a no-op when it is unset). Unlike the reference,
        a profiler that cannot start raises rather than records nothing."""
        if not self.profile_dir:
            return contextlib.nullcontext()
        return _profile_session(self.profile_dir)

    @staticmethod
    def new_run_id() -> str:
        """8-hex token grouping one run's events."""
        return uuid.uuid4().hex[:8]

    # -- introspection ------------------------------------------------------

    def export_chrome(self, path: str) -> str:
        return self.tracer.export_chrome(path)

    def summary(self) -> dict:
        return {"enabled": self.enabled,
                "spans": self.tracer.summary(),
                "metrics": self.metrics.snapshot()}

    def close(self) -> None:
        if self.events is not None:
            self.events.close()


_DISABLED = Telemetry(enabled=False)
_active: Telemetry = _DISABLED


def span(name: str, **args):
    """A span of the ambient telemetry (see the module docstring): the
    shared `NULL_SPAN` while telemetry is off and no profiler records."""
    if _active is _DISABLED and not _profiler._is_profiler_enabled:
        return NULL_SPAN
    return _active.tracer.span(name, **args)


def active() -> Telemetry:
    """The ambient Telemetry (a shared disabled instance by default)."""
    return _active


def enable(**kwargs) -> Telemetry:
    """Install (and return) an enabled ambient Telemetry; kwargs as for
    :class:`Telemetry`. The previous instance is replaced, not stacked."""
    global _active
    _active = Telemetry(enabled=True, **kwargs)
    return _active


def disable() -> None:
    """Restore the disabled ambient default (closes an open event stream)."""
    global _active
    if _active is not _DISABLED:
        _active.close()
    _active = _DISABLED
