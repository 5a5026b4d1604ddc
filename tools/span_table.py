#!/usr/bin/env python3
"""Where one cell of the benchmark spends its time, by the program's spans.

    python3 tools/span_table.py --workload <cell> --seed <n> [--pairs 6] \
        [--out spans.json]

Builds the cell as ``perfbench/run.py`` does (set-up included), then runs
its traffic in units, one run of ``ring_online`` or two steps of an LM
cell:

1. one unit under ``torch.profiler``, kept as the benchmark's ``--trace 1``
   slice keeps it (`perfbench.trace`), and read by `perfbench.spans`: the
   device time launched inside each span, the device's idle time by span.
   The raw profiler events are kept beside it, and each device event's
   span is found a second way, by the correlation id of its launch: the
   share of device events on which the two ways agree is printed;
2. one unit with ``repro_torch.obs.enable()`` and no profiler: each span's
   host time (the profiler inflates host time about tenfold);
3. ``--pairs`` units with the ambient telemetry on and as many with it off,
   in turns: each unit's wall; then profiled units with the program's
   spans and without them (the profiler's flag hidden from the spans), in
   turns: each profiled unit's wall, and the slice's wall with the
   profiler's stop and the benchmark's reduction; then the host cost of a
   dead span.

Prints the span table (spans by host time: count, host seconds, device
seconds launched inside, innermost device seconds, idle seconds) and a
summary line; ``--out`` writes every number as JSON. Needs the card the
cell asks for; ``--device cpu`` drives it at the tests' toy size.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
import timeit
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness, spans  # noqa: E402
from perfbench import trace as ptrace  # noqa: E402


class KeepingTracer(ptrace.Tracer):
    """The benchmark's slice, keeping the raw events beside its `Trace`:
    (name, on device, start_us, end_us, correlation id)."""

    raw: list = []

    def _reduce(self, prof):
        from torch.autograd import DeviceType
        keep = []
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns() / 1e3
            kind = (str(ev.activity_type()) if hasattr(ev, "activity_type")
                    else None)
            on_device = ev.device_type() != DeviceType.CPU and (
                kind in ptrace.DEVICE_KINDS if kind is not None
                else ev.name() != ptrace.MARKER)
            keep.append((ev.name(), on_device, s, s + ev.duration_ns() / 1e3,
                         ev.correlation_id()))
        self.raw = keep
        return ptrace.Tracer._reduce(prof)


def correlated_stacks(trace, raw) -> list | None:
    """Each device event's open spans found by its launch's correlation
    id, in ``trace.device``'s order; None where an event has no launch."""
    launch_at = {c: s for n, dev, s, _, c in raw
                 if not dev and spans.launch_kind(n) is not None}
    s0, s1 = trace.start_us, trace.end_us
    dev = sorted(((s, c) for n, d, s, e, c in raw
                  if d and e > s0 and s < s1), key=lambda x: x[0])
    if len(dev) != len(trace.device) or any(c not in launch_at
                                            for _, c in dev):
        return None
    times = [launch_at[c] for _, c in dev]
    order = sorted(range(len(times)), key=times.__getitem__)
    got = spans.open_stacks(spans.program_spans(trace),
                            [times[i] for i in order])
    out = [None] * len(times)
    for i, st in zip(order, got):
        out[i] = st
    return out


@contextlib.contextmanager
def spans_hidden():
    """The program's spans dead while a profiler records: its modules see
    the profiler's flag as down."""
    import repro_torch.obs as obs
    down = types.SimpleNamespace(_is_profiler_enabled=False)
    saved = obs._profiler, obs.trace._autograd_profiler
    obs._profiler = obs.trace._autograd_profiler = down
    try:
        yield
    finally:
        obs._profiler, obs.trace._autograd_profiler = saved


class Units:
    """The cell's traffic in units, as its driver runs them: one run (its
    stream made first) or two steps."""

    def __init__(self, box):
        self.box = box
        self.linear = hasattr(box, "runs")
        self.k = 0

    def __call__(self, around=None):
        """(the unit's wall, its rounds or steps, the wall of the unit
        inside ``around``, a context such as a profiled slice, with its
        exit)."""
        box = self.box
        self.k += 1
        around = around or contextlib.nullcontext()
        if self.linear:
            mod = sys.modules["perfbench_driver_linear_runs"]
            seed = box.ctx.seed * 1000 + 500 + self.k
            stream = mod.make_stream(box.cfg, seed, box.dev)
            box._sync()
        t0 = time.perf_counter()
        with around:
            a = time.perf_counter()
            if self.linear:
                n = box.program(seed, stream).rounds
            else:
                for i in range(2):
                    box.state, _ = box.step(
                        box.state, box.batch(box.done + 2 * self.k + i))
                box._sync()
                n = 2
            wall = time.perf_counter() - a
        return wall, n, time.perf_counter() - t0


def host_table(summary: dict) -> dict:
    """Host seconds and counts by span name from a tracer's summary."""
    return {n: {"count": a["count"], "host_s": a["total_s"]}
            for n, a in summary.items()}


def host_metrics(tracer) -> dict:
    """The host-side readings of a ring run's spans: each kernel wrapper's
    host time a launch, the round's host time outside its kernel wrappers,
    and run()'s time outside its chunks; where the round replays from a
    CUDA graph, the host time a replay and a capture's."""
    by = {}
    for s in tracer.spans:
        by.setdefault(s.name, []).append(s.duration_s)
    kern = [d for n, ds in by.items() if n.startswith("kernel.") for d in ds]
    rounds = by.get("round", [])
    out = {}
    if kern:
        out["kernel_host_us_per_launch"] = sum(kern) / len(kern) * 1e6
    if rounds:
        out["torch_ops_host_us_per_round"] = \
            (sum(rounds) - sum(kern)) / len(rounds) * 1e6
    if by.get("round.replay"):
        out["replay_host_us_per_round"] = \
            sum(by["round.replay"]) / len(by["round.replay"]) * 1e6
    if by.get("round.capture"):
        out["capture_host_ms"] = \
            sum(by["round.capture"]) / len(by["round.capture"]) * 1e3
    if by.get("run"):
        out["run_overhead_ms_per_run"] = \
            (sum(by["run"]) - sum(by.get("run.chunk", []))) \
            / len(by["run"]) * 1e3
        out["run_chunk_s"] = sum(by.get("run.chunk", []))
        out["round_s"] = sum(rounds)
        out["run_s"] = sum(by["run"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--profiled-pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch
    import repro_torch.obs as obs
    over = None
    if args.device == "cpu":
        sys.path.insert(0, str(ROOT / "perfbench" / "tests"))
        from toy_sizes import toy
        over = toy(harness, args.workload)
    box, _, _ = harness.make_cell(args.workload, args.seed, True,
                                  device=args.device, overrides=over)
    box.ctx.tracer = KeepingTracer(True)
    box.setup()
    unit = Units(box)
    unit()                                  # one more warm unit
    out = {"cell": args.workload, "seed": args.seed,
           "device": (torch.cuda.get_device_name()
                      if args.device == "cuda" else "cpu"),
           "power_limit": harness.power_limit(),
           "torch": torch.__version__}

    # 1. the profiled unit
    wall, n, _ = unit(box.ctx.tracer.slice())
    tr = box.ctx.tracer.trace
    stacks = spans.device_stacks(tr)
    by_corr = correlated_stacks(tr, box.ctx.tracer.raw)
    out["profiled"] = {"wall_s": wall, "units": n, "busy_s": tr.busy_s,
                       "window_s": tr.window_s,
                       "device_events": len(tr.device),
                       "device_s": tr.device_s(),
                       "paired": stacks is not None,
                       "correlated": by_corr is not None}
    if stacks is not None and by_corr is not None:
        out["profiled"]["pairing_agrees"] = sum(
            a == b for a, b in zip(stacks, by_corr)) / max(len(stacks), 1)
    names = sorted({s[0] for s in spans.program_spans(tr)})
    out["device_s_inside"] = {
        nm: v for nm in names
        if (v := spans.device_s_in(tr, nm)) is not None}
    out["device_s_innermost"] = spans.span_device_s(tr) or {}
    out["idle_by_span"] = spans.idle_by_span(tr)

    # 2. the spans-only unit
    tel = obs.enable()
    try:
        wall, n, _ = unit()
    finally:
        obs.disable()
    out["spans_only"] = {"wall_s": wall, "units": n,
                         "spans": host_table(tel.tracer.summary()),
                         **host_metrics(tel.tracer)}

    # 3. what the spans cost
    on, off = [], []
    for _ in range(args.pairs):
        obs.enable()
        try:
            on.append(unit()[0])
        finally:
            obs.disable()
        off.append(unit()[0])
    out["telemetry_pairs"] = {"on_s": on, "off_s": off}
    walls = {"spans_s": [], "no_spans_s": [], "spans_slice_s": [],
             "no_spans_slice_s": []}
    for _ in range(args.profiled_pairs):
        for key, hide in (("spans", contextlib.nullcontext()),
                          ("no_spans", spans_hidden())):
            with hide:
                wall, _, whole = unit(box.ctx.tracer.slice())
            walls[key + "_s"].append(wall)
            walls[key + "_slice_s"].append(whole)
    out["profiled_pairs"] = walls

    def dead():
        with obs.span("round"):
            pass

    def bare():
        pass
    reps = 200_000
    out["dead_span_ns"] = (min(timeit.repeat(dead, number=reps, repeat=5))
                           - min(timeit.repeat(bare, number=reps,
                                               repeat=5))) / reps * 1e9

    show(out, names)
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


def show(out: dict, names: list) -> None:
    host = out["spans_only"]["spans"]
    idle = dict(out["idle_by_span"] or [])
    rows = sorted(set(names) | set(host), key=lambda n: -host.get(
        n, {}).get("host_s", 0.0))[:16]
    print(f"{out['cell']} on {out['device']} ({out['power_limit']}), "
          f"torch {out['torch']}")
    print(f"{'span':<20} {'count':>7} {'host s':>10} {'device s':>10} "
          f"{'innermost':>10} {'idle s':>10}")
    for n in rows + [spans.OUTSIDE]:
        h = host.get(n, {})
        print(f"{n:<20} {h.get('count', ''):>7} "
              f"{h.get('host_s', float('nan')):>10.6f} "
              f"{out['device_s_inside'].get(n, 0.0):>10.6f} "
              f"{out['device_s_innermost'].get(n, 0.0):>10.6f} "
              f"{idle.get(n, 0.0):>10.6f}")
    summary = {k: v for k, v in out.items()
               if k not in ("device_s_inside", "device_s_innermost",
                            "idle_by_span", "spans_only")}
    summary["host"] = {k: v for k, v in out["spans_only"].items()
                       if k != "spans"}
    for k in ("on_s", "off_s"):
        summary["telemetry_pairs"][k + "_median"] = statistics.median(
            out["telemetry_pairs"][k])
    print(json.dumps(summary))


if __name__ == "__main__":
    sys.exit(main())
