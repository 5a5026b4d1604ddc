"""Run one cell of ``BENCHMARK.json`` once and build its result line.

`main` is the measuring entry (``perfbench/run.py``): it refuses to run
without the cards the cell asks for. `run_cell` does the rest and is what
the tests call on the CPU at a toy size. A cell is found by name:

* ``BENCHMARK.json``: the cell's configuration, traffic and chips, and the
  metrics (an end-to-end metric without ``workloads`` belongs to every
  cell, a per-layer one to the cells in its ``workloads``);
* ``workloads/<cell>.json``: the cell's configuration and traffic names,
  its driver, the driver's parameters and the limits of its comparison;
* ``configs/<config>.json``: the sizes as run, with an optional ``env``
  set before CUDA starts;
* ``drivers/<driver>.py``: the general generator (class ``Cell``);
* ``reference/<config>.py``: the plain reference;
* ``metrics/<metric>.py``: ``read(trace, counts)``, a number or None.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["main", "run_cell", "load_manifest", "cell_files", "merge"]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """The module at ``path``, loaded once a process under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys, nested dicts merged key by key."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def cell_files(manifest: dict, cell: str, bench: Path = HERE) -> dict:
    """The cell's entry and files, each checked against the manifest."""
    entry = {w["name"]: w for w in manifest["workloads"]}.get(cell)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    workload = json.loads((bench / "workloads" / f"{cell}.json").read_text())
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{cell}.json says {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = json.loads(
        (bench / "configs" / f"{entry['config']}.json").read_text())
    return {"entry": entry, "workload": workload, "config": config}


def cell_metrics(manifest: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` that the cell reports."""
    return [m for m in manifest[section]
            if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Context:
    """What a driver gets: its files, the seed, the device, the tracer and
    the configuration's reference module."""
    config: dict
    workload: dict
    seed: int
    device: object
    tracer: object
    reference: object
    control: bool = False     # the reference in the program's place


def make_cell(cell: str, seed: int, trace: bool, *, device: str = "cuda",
              overrides: dict | None = None, bench: Path = HERE,
              manifest: dict | None = None, control: bool = False):
    """(the driver's Cell of ``cell``, its workload file, the manifest).

    ``overrides`` merges into the configuration (``config``) and the
    cell's file (``workload``): the tests' toy sizes. ``control`` puts the
    configuration's reference, one precision lower, in the program's
    place (the tests and ``calibrate.py``; never a measuring run)."""
    manifest = manifest or load_manifest(bench.parent)
    files = cell_files(manifest, cell, bench)
    over = overrides or {}
    config = merge(files["config"], over.get("config"))
    workload = merge(files["workload"], over.get("workload"))
    for key, value in config.get("env", {}).items():
        os.environ.setdefault(key, str(value))
    import torch
    from perfbench.trace import Tracer

    dev = torch.device(device)
    src = str(bench.parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    reference = load_module(bench / "reference" / f"{workload['config']}.py",
                            f"perfbench_reference_{workload['config']}")
    driver = load_module(bench / "drivers" / f"{workload['driver']}.py",
                         f"perfbench_driver_{workload['driver']}")
    ctx = Context(config, workload, int(seed), dev, Tracer(bool(trace)),
                  reference, control)
    return driver.Cell(ctx), workload, manifest


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None,
             overrides: dict | None = None, bench: Path = HERE,
             manifest: dict | None = None, control: bool = False) -> dict:
    """Set up, measure, free and judge one cell; the result as a dict.
    ``t0`` is the process's start on `time.perf_counter`'s clock."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    box, workload, manifest = make_cell(
        cell, seed, trace, device=device, overrides=overrides, bench=bench,
        manifest=manifest, control=control)
    dev, tracer = box.ctx.device, box.ctx.tracer
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    box.setup()
    # time a driver spent keeping readings for the check is not set-up
    setup_s = time.perf_counter() - t0 - getattr(box, "check_s", 0.0)
    measured = box.measure(seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    box.release()
    numbers = box.check()
    limits = workload["limits"]
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics = {}
    device_info = device_block(dev, peak)
    if trace:
        tr = tracer.trace
        counts = getattr(box, "counts", {})
        for m in cell_metrics(manifest, cell, "per_layer"):
            mod = load_module(bench / "metrics" / f"{m['name']}.py",
                              "perfbench_metric_"
                              + m["name"].replace(".", "_"))
            value = mod.read(tr, counts) if tr is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device_info["busy_s"] = tr.busy_s if tr is not None else 0.0
        device_info["window_s"] = tr.window_s if tr is not None else 0.0
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        for m in cell_metrics(manifest, cell, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    if measured.get("walls"):
        print("window: each call's wall (s) " + " ".join(
            f"{w:.4f}" for w in measured["walls"]), file=sys.stderr)
    out = {"correct": correct, "attempted": measured["attempted"],
           "failed": measured["failed"], "metrics": metrics,
           "device": device_info}
    if trace and tracer.trace is not None:
        out["breakdown"] = {"device_ops": tracer.trace.top_device_ops(),
                            "idle_gaps": tracer.trace.idle_gaps()}
    out["checks"] = {k: {f: finite(v) for f, v in c.items()}
                     for k, c in checks.items()}
    found = sorted({k for k in sys.modules if k.split(".")[0] in FORBIDDEN})
    if found:
        raise ForbiddenImport(found)
    return out


def finite(v):
    """A number for the JSON line: inf and nan as strings."""
    return v if math.isfinite(v) else str(v)


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("modules of JAX or of the JAX package are loaded: "
                         + ", ".join(found))


def device_block(dev, peak: int) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = root / "build" / "perfbench-cache"
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[key] = str(cache / sub)


def main(args, t0: float) -> int:
    """Measure one cell on the card and print its result line; exit codes
    other than 0 print no result."""
    cache_env()
    try:
        manifest = load_manifest()
        entry = {w["name"]: w for w in manifest["workloads"]}[args.workload]
        config = json.loads(
            (HERE / "configs" / f"{entry['config']}.json").read_text())
        for key, value in config.get("env", {}).items():
            os.environ[key] = str(value)
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures only on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(entry["chips"]):
            print(f"the cell asks for {entry['chips']} cards, "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 2
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t0=t0,
                       manifest=manifest)
    except ForbiddenImport as err:
        print(str(err), file=sys.stderr)
        return 3
    except Exception:  # noqa: BLE001  (any failure: no result line)
        traceback.print_exc()
        return 1
    emit(out)
    return 0


def emit(out: dict) -> None:
    """The card and each compared number beside its limit as the last
    lines of standard error, then the result as the last line of standard
    output."""
    dev = out["device"]
    print(f"device {dev['kind']}, power limit {dev.get('power_limit')}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
