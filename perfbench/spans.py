"""The program's spans in a device trace, and what happened inside them.

While a ``torch.profiler`` session records, the port opens a
``record_function`` range named ``"repro_torch:" + name`` for each of its
spans (`repro_torch.obs`), and `perfbench.trace` keeps those ranges among
a `Trace`'s host events, on the profiler's clock. This module reads them:

* `program_spans`: the ranges as (name, start_us, end_us), prefix dropped;
* `device_stacks`: for each device event, the names of the spans open when
  the host launched it, outermost first (empty: outside any span). A
  device event is paired with its launch, the host's runtime call that put
  it on the device, by order: on one stream the device runs its work in
  the order it was launched, and `Trace` keeps no correlation ids. A trace
  whose launches and device events do not pair one to one, kind for kind
  (kernel, copy, set), has no answer (None). "Open" is judged by interval
  alone, so a launch from the autograd engine's own thread while the
  caller waits inside ``step.backward`` goes to ``step.backward``;
* `device_s_in`: the device time of the events launched inside a span;
* `idle_by_span`: the device's idle time, each gap put down to the
  innermost span open when it began.

A trace of a program without spans (an older commit) has none of them:
every reader then returns None, and the metrics built on it report
nothing.
"""
from __future__ import annotations

__all__ = ["PREFIX", "OUTSIDE", "program_spans", "device_stacks",
           "device_s_in", "idle_by_span", "span_device_s"]

PREFIX = "repro_torch:"
OUTSIDE = "outside any span"


def program_spans(trace) -> list:
    """[(name, start_us, end_us)] of the program's spans in ``trace``,
    by start (an enclosing span before the spans it holds)."""
    return sorted(((n[len(PREFIX):], s, e) for n, s, e in trace.host
                   if n.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))


def open_stacks(spans: list, times: list) -> list:
    """For each time of ``times`` (ascending), the tuple of span names
    open at it, outermost first. ``spans`` as `program_spans` gives them:
    nested on one thread."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(tuple(s[0] for s in stack))
    return out


def device_kind(name: str) -> str:
    """"copy", "set" or "kernel", from a device event's name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


def launch_kind(name: str) -> str | None:
    """The kind of device work a host runtime call puts on the device, or
    None for a call that puts none (a sync, an event, an allocation)."""
    if name.startswith(("cuda", "cu")):
        if "Memcpy" in name:
            return "copy"
        if "Memset" in name:
            return "set"
        if "Launch" in name:
            return "kernel"
    return None


def device_stacks(trace) -> list | None:
    """For each device event of ``trace`` (in its order), the spans open
    at its launch, outermost first; None where the trace has no program
    span or no device event, or its launches and device events do not
    pair kind for kind."""
    spans = program_spans(trace)
    if not spans or not trace.device:
        return None
    launches = [(s, k) for n, s, _ in trace.host
                if (k := launch_kind(n)) is not None]
    launches.sort()
    kinds = [device_kind(n) for n, _, _ in trace.device]
    if [k for _, k in launches] != kinds:
        return None
    return open_stacks(spans, [s for s, _ in launches])


def device_s_in(trace, name: str) -> float | None:
    """Seconds of device work launched inside a span named ``name`` (at
    any depth); None where the trace holds no such span or cannot be
    paired (`device_stacks`)."""
    stacks = device_stacks(trace)
    if stacks is None or not any(s[0] == name for s in program_spans(trace)):
        return None
    return sum(e - s for (_, s, e), st in zip(trace.device, stacks)
               if name in st) * 1e-6


def span_device_s(trace) -> dict | None:
    """{span name or OUTSIDE: seconds of device work whose launch it was
    the innermost open span of}; None as `device_stacks`."""
    stacks = device_stacks(trace)
    if stacks is None:
        return None
    out = {}
    for (_, s, e), st in zip(trace.device, stacks):
        key = st[-1] if st else OUTSIDE
        out[key] = out.get(key, 0.0) + (e - s) * 1e-6
    return out


def idle_by_span(trace) -> list | None:
    """[[span name or OUTSIDE, seconds]]: the device's idle time inside
    the slice, each gap put down to the innermost span open when it
    began, the longest first; None where the trace has no program span."""
    spans = program_spans(trace)
    if not spans:
        return None
    gaps, prev = [], trace.start_us
    for s, e in trace.busy_intervals():
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if trace.end_us > prev:
        gaps.append((prev, trace.end_us))
    tot = {}
    for (g0, g1), st in zip(gaps, open_stacks(spans, [g[0] for g in gaps])):
        key = st[-1] if st else OUTSIDE
        tot[key] = tot.get(key, 0.0) + (g1 - g0) * 1e-6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])]
