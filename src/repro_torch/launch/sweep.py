"""Sweep CLI: declarative axes over RunSpec fields from the command line.

Counterpart of `repro.launch.sweep`, on the port (CUDA unless ``--device
cpu``). The paper's Fig. 2 axis at its scale (m = 64, n = 10,000, 1,562
rounds = 100,000 samples; the ring, Laplace with the coordinate
calibration, alpha0 = 1, lam = 1e-3) on the fused kernels:

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --nodes 64 --dim 10000 --horizon 1562 --lam 1e-3 --backend cuda \
        --axis eps=0.1,1.0,10.0,inf --seeds 0,1,2 --chunk-rounds 256 \
        --name fig2_eps

Zipped axes co-vary several fields as one axis (values are ':'-joined):

    python -m repro_torch.launch.sweep --axis nodes,horizon=4:800,8:400 ...

Every (point, seed) lands as one JSONL record in the store
(--store, default experiments/store/); --from-store reuses matching
records instead of re-running, so the same command regenerates its
summary for free. The seed axis is batched per point (`run_batch`) unless
--no-vmap or a seed-dependent stage forces the sequential fallback.
"""
from __future__ import annotations

import argparse
import json
from typing import Any

from repro_torch.api import RunSpec
from repro_torch.sweep import DEFAULT_STORE, SweepSpec, SweepStoreMiss, sweep


def _value(text: str) -> Any:
    """int -> float (inf included) -> bare string, in that order."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def parse_axis(arg: str) -> tuple[str, tuple]:
    """'eps=0.1,1,inf' -> ('eps', (0.1, 1.0, inf));
    'nodes,horizon=4:800,8:400' -> ('nodes,horizon', ((4, 800), (8, 400)))."""
    if "=" not in arg:
        raise argparse.ArgumentTypeError(
            f"--axis needs NAME=V1,V2,... (got {arg!r})")
    key, _, raw = arg.partition("=")
    key = key.strip()
    zipped = "," in key
    values = []
    for item in raw.split(","):
        if zipped:
            values.append(tuple(_value(v) for v in item.split(":")))
        else:
            values.append(_value(item))
    return key, tuple(values)


def parse_opts(items: list[str]) -> dict:
    out = {}
    for item in items or []:
        k, _, v = item.partition("=")
        out[k] = _value(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep",
        description="Declarative RunSpec sweep -> batched multi-seed runs "
                    "-> persistent JSONL store")
    # base RunSpec
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=500)
    ap.add_argument("--eps", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.01)
    ap.add_argument("--alpha0", type=float, default=1.0)
    ap.add_argument("--mixer", default="ring")
    ap.add_argument("--mechanism", default="laplace")
    ap.add_argument("--local-rule", default="omd")
    ap.add_argument("--calibration", default="coordinate",
                    choices=["global", "coordinate"])
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--delay", type=int, default=0)
    ap.add_argument("--delay-dist", default=None)
    ap.add_argument("--stream", default="social_sparse")
    ap.add_argument("--stream-opt", action="append", default=[],
                    metavar="K=V")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "reference"],
                    help="round body: the fused kernels (default), or the "
                         "torch-op oracle")
    # sweep shape
    ap.add_argument("--axis", action="append", default=[], metavar="NAME=V,V",
                    help="sweep axis over RunSpec field(s); repeatable; "
                         "comma-joined names zip fields (values ':'-joined)")
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated seed list (batched axis)")
    ap.add_argument("--engine", default="sim", choices=["sim", "dist"])
    ap.add_argument("--name", default=None, help="store group name")
    ap.add_argument("--chunk-rounds", type=int, default=512)
    ap.add_argument("--no-regret", action="store_true")
    ap.add_argument("--no-vmap", action="store_true",
                    help="force the sequential per-seed fallback")
    ap.add_argument("--force-vmap", action="store_true",
                    help="error instead of falling back on seed-dependent "
                         "stages")
    ap.add_argument("--devices", default=None, metavar="N|auto",
                    help="not ported: sharding the seed axis over several "
                         "devices waits in ROADMAP queue 1 item 4")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the runs happen (default: the CUDA card)")
    # store
    ap.add_argument("--store", default=DEFAULT_STORE)
    ap.add_argument("--no-store", action="store_true")
    ap.add_argument("--from-store", action="store_true",
                    help="reuse matching stored records instead of running")
    ap.add_argument("--metric", default="accuracy",
                    help="metric to aggregate in the printed table")
    return ap


def main(argv: list[str] | None = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.devices is not None:
        ap.error("--devices: sharding a seed batch over several devices is "
                 "not ported to repro_torch yet; it waits in ROADMAP queue 1 "
                 "item 4 (multi-device)")
    axes = dict(parse_axis(a) for a in args.axis)
    base = RunSpec(
        nodes=args.nodes, dim=args.dim, horizon=args.horizon, eps=args.eps,
        lam=args.lam, alpha0=args.alpha0, mixer=args.mixer,
        mechanism=args.mechanism, local_rule=args.local_rule,
        calibration=args.calibration, clip_norm=args.clip_norm,
        delay=args.delay, delay_dist=args.delay_dist, stream=args.stream,
        stream_options=parse_opts(args.stream_opt), backend=args.backend)
    vectorize = (False if args.no_vmap
                 else True if args.force_vmap else None)
    spec = SweepSpec(
        base=base, axes=axes,
        seeds=tuple(int(s) for s in args.seeds.split(",")),
        engine=args.engine, name=args.name,
        chunk_rounds=args.chunk_rounds,
        compute_regret=not args.no_regret, vectorize_seeds=vectorize)
    try:
        out = sweep(spec, store=None if args.no_store else args.store,
                    reuse=args.from_store, verbose=True,
                    require_store=args.from_store, device=args.device)
    except SweepStoreMiss as e:
        # --from-store promises regeneration WITHOUT re-running; dying with
        # the miss explained beats silently emitting an empty/recomputed table
        raise SystemExit(f"error: {e}")

    rows = out.aggregate(args.metric)
    print(json.dumps(out.summary(), indent=1))
    header = list(out.points[0].coords.keys()) if out.points else []
    print("  ".join(header + [f"{args.metric}(mean±std over "
                              f"{len(spec.seeds)} seeds)"]))
    for row in rows:
        coords = "  ".join(str(row[k]) for k in header)
        if row["mean"] is None:
            print(f"{coords}  n/a")
        else:
            print(f"{coords}  {row['mean']:.4f} ± {row['std']:.4f}")
    return {"summary": out.summary(), "rows": rows}


if __name__ == "__main__":
    main()
