"""A device trace of one slice of a run, reduced to what the metrics read.

`Tracer.slice()` runs a block under `torch.profiler` (host and CUDA
activity) inside a marker span, and keeps a `Trace`: the device events
(kernels, copies, sets) and the host events that overlap the marker, in
microseconds on the profiler's clock. A run without ``--trace 1`` gets a
tracer whose slice is a plain block and whose trace stays None.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

__all__ = ["Trace", "Tracer", "short_name"]

MARKER = "perfbench.slice"


def short_name(name: str, limit: int = 96) -> str:
    """A kernel or op name without its return type, anonymous namespace
    and argument list, at most ``limit`` characters."""
    cut = name.replace("(anonymous namespace)::", "")
    if cut.startswith("void "):
        cut = cut[5:]
    cut = cut.split("(", 1)[0].strip() or name
    return cut[:limit]


@dataclasses.dataclass
class Trace:
    device: list      # [(name, start_us, end_us)] sorted by start
    host: list        # [(name, start_us, end_us)] sorted by start
    start_us: float
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, in order."""
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_s(self, keep=lambda name: True) -> float:
        """Seconds of device events whose name ``keep`` accepts."""
        return sum(e - s for n, s, e in self.device if keep(n)) * 1e-6

    def count(self, keep=lambda name: True) -> int:
        return sum(1 for n, _, _ in self.device if keep(n))

    def idle_share(self, traced, untraced, wall_untraced_s):
        """100 x (1 - the device's busy time a unit (round or step) of the
        ``traced`` units / the wall time a unit of the window's
        ``untraced`` units); None where either is missing. The untraced
        wall is the divisor because the profiler slows the host, not the
        device."""
        if not self.device or not traced or not untraced \
                or not wall_untraced_s:
            return None
        return 100.0 * (1.0 - (self.busy_s / traced)
                        / (wall_untraced_s / untraced))

    def top_device_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        tot = {}
        for n, s, e in self.device:
            key = short_name(n)
            tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
        return [[n, v] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host op, seconds]]: the device's idle time inside the slice,
        summed by the innermost host op open when each gap began (or
        "host, outside any op"), the longest first."""
        busy = self.busy_intervals()
        gaps, prev = [], self.start_us
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end_us > prev:
            gaps.append((prev, self.end_us))
        host = [h for h in self.host if h[0] != MARKER]
        starts = [h[1] for h in host]
        tot = {}
        for g0, g1 in gaps:
            # the latest-starting host op that is still open at g0
            i = bisect.bisect_right(starts, g0) - 1
            name = "host, outside any op"
            for j in range(i, max(i - 64, -1), -1):
                if host[j][2] > g0:
                    name = short_name(host[j][0])
                    break
            tot[name] = tot.get(name, 0.0) + (g1 - g0) * 1e-6
        return [[n, v] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(prof):
    """(name, is_device, start_us, end_us) of every profiler event. Device
    events are kernels, copies and sets; the device's copy of an annotation
    (a span that covers kernels, no work of its own) is neither."""
    results = prof.profiler.kineto_results
    from torch.autograd import DeviceType
    for ev in results.events():
        if hasattr(ev, "start_ns"):
            s = ev.start_ns() / 1e3
            e = s + ev.duration_ns() / 1e3
        else:
            s = float(ev.start_us())
            e = s + float(ev.duration_us())
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            yield name, False, s, e
            continue
        kind = ev.activity_type() if hasattr(ev, "activity_type") else None
        if kind is not None and str(kind) not in DEVICE_KINDS:
            continue
        if kind is None and name == MARKER:
            continue
        yield name, True, s, e


class Tracer:
    """``enabled``: profile the blocks run under `slice` (the last one is
    kept); otherwise `slice` only runs them."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None

    @contextlib.contextmanager
    def slice(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(MARKER):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.trace = self._reduce(prof)

    @staticmethod
    def _reduce(prof) -> Trace:
        dev, host, window = [], [], None
        for name, on_device, s, e in _events(prof):
            if on_device:
                dev.append((name, s, e))
            elif name == MARKER:
                window = (s, e)
            else:
                host.append((name, s, e))
        if window is None:
            lo = min((x[1] for x in dev + host), default=0.0)
            hi = max((x[2] for x in dev + host), default=0.0)
            window = (lo, hi)
        s0, s1 = window
        # device work launched inside the marker may end after it: the
        # window closes at the later of the two
        s1 = max([s1] + [e for _, s, e in dev if s0 <= s <= s1])
        dev = sorted(((n, max(s, s0), min(e, s1)) for n, s, e in dev
                      if e > s0 and s < s1), key=lambda x: x[1])
        host = sorted((h for h in host if h[2] > s0 and h[1] < s1),
                      key=lambda x: x[1])
        return Trace(device=dev, host=host, start_us=s0, end_us=s1)
